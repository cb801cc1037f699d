"""The port's chunk module against torbi_tpu.chunk.

Inputs are made with numpy from a seed and handed to both packages. Split
points are compared exactly. The framewise entropy of numpy input runs the
same numpy code in both packages and is compared bitwise; the torch version
sums in another order and is held within rtol 1e-5 and atol 1e-6 (the
tolerance of tests/test_autochunk.py for the JAX package's own device
entropy).
"""
import numpy as np
import pytest
import torch

import torbi_tpu
import torbi_tpu_torch
from torbi_tpu.chunk import entropy as jax_entropy
from torbi_tpu.chunk import split as jax_split
from torbi_tpu.chunk import splits_from_entropy as jax_splits
from torbi_tpu_torch.chunk import entropy, split, splits_from_entropy

TINY = np.finfo(np.float32).tiny


def random_observation(seed, frames, states, concentration):
    rng = np.random.default_rng(seed)
    return np.log(
        rng.dirichlet(np.ones(states) * concentration, size=frames)
        .astype(np.float32) + TINY).astype(np.float32)


@pytest.mark.parametrize('concentration', [0.05, 0.3, 3.0])
def test_entropy_matches(concentration):
    """Normalized framewise entropy: numpy bitwise, torch within rtol 1e-5
    and atol 1e-6 of torbi_tpu.chunk.entropy"""
    obs = random_observation(5, 300, 24, concentration)
    expected = jax_entropy(obs.T)
    np.testing.assert_array_equal(entropy(obs.T), expected)
    got = entropy(torch.from_numpy(obs).T)
    assert isinstance(got, torch.Tensor) and got.shape == (300,)
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('trial', range(8))
def test_split_matches(trial):
    """Split points equal to torbi_tpu.chunk.split on random observations,
    thresholds and minimum chunk sizes (numpy and tensor input)"""
    rng = np.random.default_rng(100 + trial)
    frames = int(rng.integers(5, 400))
    obs = random_observation(
        trial, frames, 12, [0.05, 0.3, 3.0][trial % 3])
    min_chunk = int(rng.integers(1, 50))
    threshold = float(rng.uniform(0.05, 0.9))
    expected = jax_split(
        obs, min_chunk_size=min_chunk, entropy_threshold=threshold)
    got = split(obs, min_chunk_size=min_chunk, entropy_threshold=threshold)
    assert got == expected
    assert all(isinstance(point, int) for point in got)
    # The tensor entropy rounds differently; on these inputs no frame sits
    # within its tolerance of the threshold, so the points agree
    got_tensor = split(
        torch.from_numpy(obs), min_chunk_size=min_chunk,
        entropy_threshold=threshold)
    assert got_tensor == expected


def test_splits_from_entropy_matches():
    """The greedy selection on precomputed entropy, as torbi_tpu's"""
    rng = np.random.default_rng(9)
    for _ in range(20):
        values = rng.uniform(0, 1, size=int(rng.integers(2, 500)))
        min_chunk = int(rng.integers(1, 40))
        threshold = float(rng.uniform(0.1, 0.9))
        expected = jax_splits(values, min_chunk, threshold)
        assert splits_from_entropy(values, min_chunk, threshold) == expected
        assert splits_from_entropy(
            torch.from_numpy(values), min_chunk, threshold) == expected


def test_chunk_matches(monkeypatch):
    """chunk() cuts at the same points as torbi_tpu.chunk and the chunks
    rejoin to the input; the knobs default from the package"""
    obs = random_observation(3, 120, 8, 0.05)
    monkeypatch.setattr(torbi_tpu_torch, 'MIN_CHUNK_SIZE', 10)
    monkeypatch.setattr(torbi_tpu, 'MIN_CHUNK_SIZE', 10)
    expected = torbi_tpu.chunk(obs)
    got = torbi_tpu_torch.chunk(obs)
    assert len(got) == len(expected) > 1
    for mine, theirs in zip(got, expected):
        np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(np.concatenate(got), obs)
    tensors = torbi_tpu_torch.chunk(torch.from_numpy(obs))
    assert [len(t) for t in tensors] == [len(c) for c in expected]
    assert all(isinstance(t, torch.Tensor) for t in tensors)
