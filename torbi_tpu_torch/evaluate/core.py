"""Accuracy and speed evaluation over pitch posteriorgram corpora.

Counterpart of ``torbi_tpu/evaluate/core.py``: decode every partition stem
with this package and with the reference decoder (``reference/``, run
once, its outputs kept on disk), score RPA agreement at
``PITCH_ERROR_THRESHOLDS`` and report the decode's speed as a real-time
factor and timesteps per second. The steps (stems, targets, decode,
scores, speed) are the functions below; ``EVAL_BACKEND`` picks the decode
backend ('kernel', 'scan', or 'lse', the approximate smoothed-max decode).

In a ``torch.distributed`` world of more than one process each rank
decodes and scores its share of every corpus (balanced by file length, as
``parallel/files.py`` splits files) on its own card; the ranks then sum
the scores, take the slowest rank's seconds per timing context, and rank
0 alone writes the results, which every rank returns.
"""
import json
import os

import torch
import torch.distributed as dist

import torbi_tpu_torch
from ..models import pitch
from ..ops import dispatch
from ..parallel import mesh
from ..utils import io, timing
from ..utils.notify import notify_on_finish


def _transition_file():
    """The band-diagonal pitch transition matrix (models/pitch.py), saved
    on first use under this package's ``ASSETS_DIR/stats``"""
    path = torbi_tpu_torch.PITCH_TRANSITION_MATRIX
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        # The ranks of a world may write it at once: each writes a file of
        # its own and renames it, so that no rank reads a partial file
        partial = path.with_name(
            f'{path.stem}.{os.getpid()}.partial{path.suffix}')
        io.save(pitch.transition_matrix(), partial)
        os.replace(partial, path)
    return path


def _stems(dataset):
    with open(torbi_tpu_torch.PARTITION_DIR / f'{dataset}.json') as file:
        return json.load(file)


def _process_shard(stems, input_files):
    """This rank's share of (stems, input_files): the ranks of a world
    decode disjoint shares, balanced by probed file lengths (LPT) so that
    the heavy-tailed speech corpus does not leave one rank last; a single
    process keeps everything"""
    if mesh.shards()[0] == 1:
        return stems, input_files
    from ..parallel.files import shard_files_balanced

    return shard_files_balanced(input_files, stems)[::-1]


def _all_gather(value):
    """Every rank's ``value`` (a picklable object), by rank. The objects
    travel as tensors on the group's device: with NCCL, the card that
    ``datasets`` made current"""
    gathered = [None] * mesh.shards()[0]
    dist.all_gather_object(gathered, value)
    return gathered


def _aggregate_metrics(metrics):
    """Sum each RPA's (total, count) over the ranks; a no-op in a single
    process"""
    if mesh.shards()[0] == 1:
        return
    local = [(rpa.total, rpa.count) for rpa in metrics.rpas]
    for rpa, *pairs in zip(metrics.rpas, *_all_gather(local)):
        rpa.total = float(sum(total for total, _ in pairs))
        rpa.count = int(sum(count for _, count in pairs))


def _union_keys(keys):
    """The union of every rank's string keys, sorted. Ranks can hold
    different timing contexts (one rank's reference targets may be on disk
    already, so it never enters the 'librosa' context)."""
    union = set()
    for ranks_keys in _all_gather(sorted(keys)):
        union.update(ranks_keys)
    return sorted(union)


def _aggregate_seconds(timings):
    """Wall seconds per timing context over the ranks: the slowest rank
    bounds the world, so the max; a context a rank lacks counts 0 there"""
    if mesh.shards()[0] == 1:
        return timings
    keys = _union_keys(timings)
    local = [timings.get(key, 0.0) for key in keys]
    return dict(zip(keys, map(max, zip(*_all_gather(local)))))


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
    """Real-time factor and timesteps/second per timing context.

    ``frames`` is the world's frame count; the seconds of each context the
    slowest rank's.
    """
    seconds = pitch.frames_to_seconds(frames)
    timings = _aggregate_seconds(timing.results())
    return (
        {key: float(seconds / value) for key, value in timings.items()},
        {key: float(frames / value) for key, value in timings.items()})


def _evaluate_dataset(dataset, device, num_threads):
    timing.reset()
    stems = _stems(dataset)
    input_files = [
        torbi_tpu_torch.CACHE_DIR / dataset / f'{stem}.pt'
        for stem in stems]
    stems, input_files = _process_shard(stems, input_files)

    target_files = _ensure_targets(dataset, stems, input_files, num_threads)

    output_files = _paths(dataset, torbi_tpu_torch.CONFIG, stems)
    # One rank's share: its decodes join no collective
    with dispatch.rank_share():
        torbi_tpu_torch.from_files_to_files(
            input_files,
            output_files,
            transition_file=_transition_file(),
            log_probs=True,
            gpu=device,
            num_threads=num_threads,
            backend=torbi_tpu_torch.EVAL_BACKEND)

    metrics = _score(output_files, target_files)
    _aggregate_metrics(metrics)
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

    ``gpu`` is the decode device: None is the card of ``LOCAL_RANK`` when
    ``torchrun`` sets it, else cuda:0 (``parallel.mesh.local_device``), an
    integer a CUDA index, 'cpu' the CPU (the kernels' plain versions);
    without CUDA only 'cpu' works. ``num_threads`` is the reference pass's
    process count. In a world of more than one process every rank calls
    this and returns the aggregated results; rank 0 writes them."""
    device = mesh.local_device(gpu)
    if device.type == 'cuda':
        # The kernels build once per checkout at first use and the CUDA
        # context starts at the first operation; done here, neither counts
        # in the first dataset's decode time. NCCL's object gathers run on
        # the current card
        from ..csrc import build

        build.build(build.DECODE_SOURCES)
        torch.cuda.set_device(device)
        torch.zeros((), device=device)
    if datasets is None:
        datasets = torbi_tpu_torch.DATASETS

    results = {
        dataset: _evaluate_dataset(dataset, device, num_threads)
        for dataset in datasets}
    if mesh.shards()[1] is None or dist.get_rank() == 0:
        _write(results)
    return results


def _write(results):
    """EVAL_DIR/<CONFIG>.json; one writer, rank 0, in a world"""
    torbi_tpu_torch.EVAL_DIR.mkdir(parents=True, exist_ok=True)
    with open(
            torbi_tpu_torch.EVAL_DIR / f'{torbi_tpu_torch.CONFIG}.json',
            'w') as file:
        json.dump(results, file)
