"""Batch collation and chunk re-joining.

Counterpart of ``torbi_tpu/data/collate.py``, in the natural (rows,
frames, states) layout only: chunked items (one list of chunk arrays per
file) flatten into extra batch rows whose per-file counts are recorded so
that ``separate`` can join the decoded rows again, and observations
zero-pad to the longest row of the batch, with the true lengths in
``batch_frames``. Frame padding never changes a path: the posterior
freezes at each row's length, and ``separate`` and ``core.save_masked``
cut the padding off. The JAX package's mod-M packed layout, its lane
padding of the states and its frame buckets serve its TPU kernels only.
"""
import itertools

import numpy as np


def _flatten(observations):
    """Flatten per-file chunk lists into rows + per-file chunk counts"""
    if not isinstance(observations[0], list):
        return list(observations), [1] * len(observations)
    counts = [len(chunks) for chunks in observations]
    return list(itertools.chain.from_iterable(observations)), counts


def collate(batch):
    """Collate (observation, input_file) items into a zero-padded batch.

    Returns (observation (rows, frames, states), batch_frames (rows,) int32,
    batch_chunks per file, input_files), ``frames`` the longest row's.
    """
    observations, input_files = zip(*batch)
    rows, batch_chunks = _flatten(observations)
    if not rows:
        raise ValueError('batch must contain at least 1 item')

    lengths = np.array([row.shape[0] for row in rows], dtype=np.int32)
    padded = np.zeros(
        (len(rows), int(lengths.max()), rows[0].shape[-1]),
        dtype=np.asarray(rows[0]).dtype)
    for row, out, n in zip(rows, padded, lengths):
        out[:n] = row
    return padded, lengths, batch_chunks, input_files


def separate(indices, batch_chunks, batch_frames):
    """Re-concatenate decoded chunk rows into per-file sequences"""
    indices = np.asarray(indices)
    lengths = np.asarray(batch_frames)
    bounds = np.cumsum([0] + list(batch_chunks))
    return [
        np.concatenate([
            indices[row, :lengths[row]]
            for row in range(lo, hi)])
        for lo, hi in zip(bounds[:-1], bounds[1:])]
