"""Accuracy and speed evaluation over pitch posteriorgram corpora.

Counterpart of ``torbi_tpu/evaluate/core.py``: decode every partition stem
with this package and with the reference decoder (``reference/``, run
once, its outputs kept on disk), score RPA agreement at
``PITCH_ERROR_THRESHOLDS`` and report the decode's speed as a real-time
factor and timesteps per second. The steps (stems, targets, decode,
scores, speed) are the functions below; ``EVAL_BACKEND`` picks the decode
backend.

Single process only: the JAX package's shard and aggregate steps across
host processes wait for the batch scale-out (ROADMAP.md, A15), and a
``torch.distributed`` world of more than one process raises.
"""
import json

import torch

import torbi_tpu_torch
from ..models import pitch
from ..utils import io, timing
from ..utils.convert import resolve_device
from ..utils.notify import notify_on_finish


def _transition_file():
    """The band-diagonal pitch transition matrix (models/pitch.py), saved
    on first use under this package's ``ASSETS_DIR/stats``"""
    path = torbi_tpu_torch.PITCH_TRANSITION_MATRIX
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        io.save(pitch.transition_matrix(), path)
    return path


def _stems(dataset):
    with open(torbi_tpu_torch.PARTITION_DIR / f'{dataset}.json') as file:
        return json.load(file)


def _require_single_process():
    """Raise in a torch.distributed world of more than one process: each
    rank would decode and score the whole corpus"""
    if (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            'the evaluation harness runs in one process; sharding the '
            'corpus across processes is not ported yet (ROADMAP.md, queue '
            'A, item A15: batch scale-out)')


def _paths(dataset, subdir, stems):
    """Output paths under EVAL_DIR/<dataset>/<subdir>/, directories ready"""
    root = torbi_tpu_torch.EVAL_DIR / dataset / subdir
    root.mkdir(parents=True, exist_ok=True)
    return [root / f'{stem}.pt' for stem in stems]


def _ensure_targets(dataset, stems, input_files, num_threads):
    """Decoded targets to score against.

    COMPARE_WITH_REFERENCE selects the reference decoder, run only for the
    files that have no output yet, so that an interrupted run resumes file
    by file. Otherwise the targets are this package's outputs under its
    default CONFIG (``EVAL_DIR/<dataset>/torbi_tpu_torch/``), which turns
    the harness into a measurement of chunked against unchunked decoding.
    """
    if not torbi_tpu_torch.COMPARE_WITH_REFERENCE:
        return _paths(dataset, 'torbi_tpu_torch', stems)
    targets = _paths(dataset, 'reference', stems)
    missing = [
        (infile, outfile)
        for infile, outfile in zip(input_files, targets)
        if not outfile.exists()]
    if missing:
        torbi_tpu_torch.reference.from_files_to_files(
            [pair[0] for pair in missing],
            [pair[1] for pair in missing],
            transition_file=_transition_file(),
            log_probs=True,
            num_threads=num_threads)
    return targets


def _score(output_files, target_files):
    metrics = torbi_tpu_torch.evaluate.Metrics()
    for predicted_file, target_file in zip(output_files, target_files):
        metrics.update(io.load(predicted_file), io.load(target_file))
    return metrics


def _speed(frames):
    """Real-time factor and timesteps/second per timing context"""
    seconds = pitch.frames_to_seconds(frames)
    timings = timing.results()
    return (
        {key: float(seconds / value) for key, value in timings.items()},
        {key: float(frames / value) for key, value in timings.items()})


def _evaluate_dataset(dataset, device, num_threads):
    timing.reset()
    stems = _stems(dataset)
    input_files = [
        torbi_tpu_torch.CACHE_DIR / dataset / f'{stem}.pt'
        for stem in stems]

    target_files = _ensure_targets(dataset, stems, input_files, num_threads)

    output_files = _paths(dataset, torbi_tpu_torch.CONFIG, stems)
    torbi_tpu_torch.from_files_to_files(
        input_files,
        output_files,
        transition_file=_transition_file(),
        log_probs=True,
        gpu=device,
        num_threads=num_threads,
        backend=torbi_tpu_torch.EVAL_BACKEND)

    metrics = _score(output_files, target_files)
    rtf, timesteps_per_second = _speed(metrics.rpas[0].count)
    return metrics() | {
        'frames': metrics.rpas[0].count,
        'rtf': rtf,
        'timesteps_per_second': timesteps_per_second,
    }


@notify_on_finish('evaluate')
def datasets(datasets=None, gpu=None, num_threads=1):
    """Evaluate Viterbi decoding over the configured corpora; writes
    EVAL_DIR/<CONFIG>.json and returns the results dict.

    ``gpu`` is the decode device: None is cuda:0, an integer a CUDA index,
    'cpu' the CPU (the kernels' plain versions); without CUDA only 'cpu'
    works. ``num_threads`` is the reference pass's process count."""
    _require_single_process()
    device = resolve_device(gpu)
    if device.type == 'cuda':
        # The kernels build once per checkout at first use and the CUDA
        # context starts at the first operation; done here, neither counts
        # in the first dataset's decode time
        from ..csrc import build

        build.build(build.DECODE_SOURCES)
        torch.zeros((), device=device)
    if datasets is None:
        datasets = torbi_tpu_torch.DATASETS

    results = {
        dataset: _evaluate_dataset(dataset, device, num_threads)
        for dataset in datasets}

    torbi_tpu_torch.EVAL_DIR.mkdir(parents=True, exist_ok=True)
    with open(
            torbi_tpu_torch.EVAL_DIR / f'{torbi_tpu_torch.CONFIG}.json',
            'w') as file:
        json.dump(results, file)
    return results
