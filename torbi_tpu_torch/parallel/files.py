"""File workloads split over the ranks of a process group.

Counterpart of ``torbi_tpu/parallel/files.py``: each rank of the default
``torch.distributed`` group decodes a disjoint share of the file list on
its own card (``mesh.local_device``), where each JAX host decodes a share
on its local devices. Only the evaluation's metrics cross ranks. Output
files are what the ranks share: the evaluation harness skips files that
already have an output, so an interrupted job resumes file by file.
"""
import os

import numpy as np
import torch.distributed as dist

import torbi_tpu_torch
from . import mesh
from ..ops import dispatch


def _probe_npy_frames(file):
    """Frame count from a ``.npy`` header (the native probe, then numpy's
    public header readers), None if it does not parse as two-dimensional"""
    from ..data import native

    probed = native.probe(file)
    if probed is None:
        try:
            with open(file, 'rb') as handle:
                major, _ = np.lib.format.read_magic(handle)
                read_header = (
                    np.lib.format.read_array_header_1_0 if major == 1
                    else np.lib.format.read_array_header_2_0)
                shape, _, _ = read_header(handle)
            if len(shape) == 2:
                probed = shape
        except (OSError, ValueError):
            probed = None
    return probed[0] if probed is not None else None


def probe_lengths(files):
    """Per-file lengths for the LPT split, in one unit for the whole list.

    ``.npy`` headers give frame counts. If any file's does not (another
    format, an unusual header), the whole list falls back to byte sizes:
    mixing frames and bytes would mis-weight the split, and every rank must
    compute the same partition, or some files are decoded by no rank. Byte
    sizes are proportional to frames for a corpus of one state count, and
    the split needs lengths only up to a common scale. None when the sizes
    cannot be read either (the split is then round-robin).
    """
    lengths = [
        _probe_npy_frames(file) if str(file).endswith('.npy') else None
        for file in files]
    if any(frames is None for frames in lengths):
        try:
            lengths = [os.path.getsize(file) for file in files]
        except OSError:
            return None
    return lengths


def shard_files_balanced(input_files, output_files, process_index=None,
                         process_count=None):
    """``shard_files`` with lengths probed from the input files (LPT when
    the probe succeeds, round-robin otherwise)"""
    if process_count is None:
        process_count = mesh.shards()[0]
    lengths = (
        probe_lengths(input_files) if process_count > 1 else None)
    return shard_files(
        input_files, output_files, process_index=process_index,
        process_count=process_count, lengths=lengths)


def shard_files(input_files, output_files, process_index=None,
                process_count=None, lengths=None):
    """This rank's share of a file workload: (inputs, outputs).

    With ``lengths`` (per-file frame counts or sizes), a greedy
    longest-processing-time split, so that heavy-tailed speech data does
    not leave one rank last; otherwise round-robin. The rank and count
    default to the default process group's (0 and 1 without one).
    """
    count, group = mesh.shards()
    if process_index is None:
        process_index = 0 if group is None else dist.get_rank()
    if process_count is None:
        process_count = count
    if process_count == 1:
        return list(input_files), list(output_files)

    if lengths is None:
        return (
            list(input_files[process_index::process_count]),
            list(output_files[process_index::process_count]))

    # Greedy LPT assignment: the longest file first, each to the least
    # loaded rank (the lowest rank on ties)
    order = sorted(
        range(len(input_files)), key=lambda i: -lengths[i])
    loads = [0] * process_count
    mine_in, mine_out = [], []
    for i in order:
        target = min(range(process_count), key=lambda p: loads[p])
        loads[target] += lengths[i]
        if target == process_index:
            mine_in.append(input_files[i])
            mine_out.append(output_files[i])
    return mine_in, mine_out


def from_files_to_files(
        input_files,
        output_files,
        transition_file=None,
        initial_file=None,
        log_probs=False,
        gpu=None,
        num_threads=None):
    """``torbi_tpu_torch.from_files_to_files`` over this rank's share of the
    files (``shard_files_balanced``), on this rank's card
    (``mesh.local_device(gpu)``). Its decodes are one rank's share
    (``dispatch.rank_share``): none joins a collective."""
    mine_in, mine_out = shard_files_balanced(
        list(input_files), list(output_files))
    with dispatch.rank_share():
        torbi_tpu_torch.from_files_to_files(
            mine_in,
            mine_out,
            transition_file=transition_file,
            initial_file=initial_file,
            log_probs=log_probs,
            gpu=mesh.local_device(gpu),
            num_threads=num_threads)
