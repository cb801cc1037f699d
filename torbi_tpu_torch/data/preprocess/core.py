"""Preprocess audio into pitch posteriorgrams with penn.

Counterpart of ``torbi_tpu/data/preprocess/core.py``: every ``.wav`` of
``CACHE_DIR/<dataset>`` becomes a log-softmax pitch posteriorgram
``.pt`` beside it, (frames, states), the logits of all of penn's inference
batches concatenated. penn and torchaudio are optional dependencies.
Inference runs on ``cuda:{gpu}`` (cuda:0 when ``gpu`` is None) or, when
asked with ``gpu='cpu'``, on the CPU.
"""
import torbi_tpu_torch
from ...utils import io, progress
from ...utils.convert import resolve_device
from ...utils.notify import notify_on_finish


@notify_on_finish('preprocess')
def datasets(datasets=None, gpu=None):
    """Preprocess datasets: audio -> log-softmax pitch posteriorgram .pt"""
    if datasets is None:
        datasets = torbi_tpu_torch.DATASETS
    try:
        import penn
        import torch
    except ImportError as error:
        raise ImportError(
            'penn is required for preprocessing; install the evaluate '
            'extras') from error
    device = resolve_device(gpu)

    for dataset in datasets:
        directory = torbi_tpu_torch.CACHE_DIR / dataset
        files = sorted(directory.rglob('*.wav'))
        for file in progress.iterator(files, f'preprocess/{dataset}'):
            import torchaudio
            audio, sample_rate = torchaudio.load(file)

            # Infer the pitch posteriorgram, batch by batch
            logits = []
            for frames in penn.preprocess(
                audio,
                sample_rate,
                batch_size=2048,
                center='half-hop'
            ):
                frames = frames.to(device)
                logits.append(penn.infer(frames).detach().cpu())
            logits = torch.cat(logits, dim=0).squeeze(2)
            observation = torch.nn.functional.log_softmax(logits, dim=1)
            io.save(observation.numpy(), file.with_suffix('.pt'))
