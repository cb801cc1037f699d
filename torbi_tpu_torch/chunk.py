"""Chunked Viterbi decoding: split long sequences at low-entropy frames.

The port's own copy of ``torbi_tpu/chunk.py``, with the same split
boundaries: sequences split at pairs of adjacent low-entropy frames (where
decoding is locally near-deterministic, so severing the trellis rarely
changes the global path), with chunks at least ``MIN_CHUNK_SIZE`` frames
apart. Takes numpy arrays or tensors; split points are python ints.
"""
from typing import List

import numpy as np
import torch

import torbi_tpu_torch


def chunk(
    observation,
    min_chunk_size: int = None,
    entropy_threshold: float = None,
) -> List:
    """Split one (frames, states) log-space observation into a list of
    views at low-entropy points (see ``split``), each at least
    ``min_chunk_size`` frames except possibly the last."""
    if not isinstance(observation, torch.Tensor):
        observation = np.asarray(observation)
    start = 0
    chunks = []
    for split_point in split(
        observation,
        min_chunk_size=min_chunk_size,
        entropy_threshold=entropy_threshold,
    ):
        chunks.append(observation[start:split_point])
        start = split_point

    # Last chunk
    chunks.append(observation[start:])
    return chunks


###############################################################################
# Utilities
###############################################################################


def split(
    observation,
    min_chunk_size=None,
    entropy_threshold=None,
) -> List[int]:
    """Split points of a (frames, states) log-space observation: pairs of
    adjacent low-entropy frames at least ``min_chunk_size`` apart"""
    if min_chunk_size is None:
        min_chunk_size = torbi_tpu_torch.MIN_CHUNK_SIZE
    if entropy_threshold is None:
        entropy_threshold = torbi_tpu_torch.ENTROPY_THRESHOLD
    return splits_from_entropy(
        entropy(observation.T), min_chunk_size, entropy_threshold)


def splits_from_entropy(
    entropy_values,
    min_chunk_size,
    entropy_threshold,
) -> List[int]:
    """Split points from precomputed framewise normalized entropy.

    Shared by ``split`` and the dispatcher's batch-1 auto-chunking (which
    computes the entropy on the device): frames where both the frame and
    its predecessor fall below ``entropy_threshold``, greedily kept at
    least ``min_chunk_size`` apart.
    """
    if isinstance(entropy_values, torch.Tensor):
        entropy_values = entropy_values.cpu().numpy()
    entropy_values = np.asarray(entropy_values)
    candidates = entropy_values < entropy_threshold
    # Byte k is 1 where frames k and k + 1 are both candidates: frame k + 1
    # is splittable
    pairs = (candidates[1:] & candidates[:-1]).tobytes()

    # Greedy selection: each split is the first splittable frame at least
    # min_chunk_size after the previous one (frame 0 to start); bytes.find
    # scans for the next one in C
    split_points = []
    pair = pairs.find(b'\x01', max(min_chunk_size - 1, 0))
    while pair >= 0:
        split_points.append(pair + 1)
        pair = pairs.find(b'\x01', pair + min_chunk_size)
    return split_points


def entropy(observation):
    """Framewise normalized entropy of log-space categorical distributions

    observation: (states, frames), a numpy array or a tensor. Returns
    (frames,) of the same kind.
    """
    if isinstance(observation, torch.Tensor):
        return -(
            (torch.exp(observation) * observation).sum(dim=0)
            / float(np.log(observation.shape[0])))
    observation = np.asarray(observation)
    return -(
        (np.exp(observation) * observation).sum(axis=0)
        / np.log(observation.shape[0]))
