"""K1's plan launches after its first as programmatic dependents, on the
CPU.

The kernel runs only on the card, so here ``band._library`` is a fake
whose ``band_forward`` records its arguments, and the card holds 15
clusters at every size (an H100 at 1440 states and the pitch band, width
175). Each plan entry must reach the library with its own rows and size,
and only the entries after the first with ``dependent`` set. On CPU
tensors the wrapper keeps running its plain version and launches nothing.
Tolerance: bitwise.
"""
import contextlib
import ctypes

import numpy as np
import pytest
import torch

from torbi_tpu_torch.ops import band, dispatch

STATES, WIDTH, LO = 1440, 175, -87


def h100(sequences):
    """The clusters of 8 CTAs an H100 holds at once at 1440 x 175"""
    return 15


class FakeLibrary:
    """Records every band_forward call; every launch succeeds"""

    def __init__(self):
        self.calls = []

    def band_forward(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def counters(monkeypatch):
    """K1's launch counters from zero, restored afterwards"""
    wrapper = band.viterbi_forward_band
    monkeypatch.setattr(wrapper, 'launches', 0)
    monkeypatch.setattr(wrapper, 'size_launches',
                        dict.fromkeys(band.CLUSTER_TILES, 0))
    monkeypatch.setattr(wrapper, 'dependent_launches', 0)
    return wrapper


@pytest.fixture
def fake_card(monkeypatch, counters):
    """The wrapper's card-side steps on CPU tensors: the arguments pass as
    checked, the card holds 15 clusters, the library records its calls"""
    library = FakeLibrary()
    monkeypatch.setattr(band, '_library', lambda: library)
    monkeypatch.setattr(band, '_check_band_args', lambda *args: True)
    monkeypatch.setattr(
        band, 'resident_clusters',
        lambda states, width, sequences, device: h100(sequences))
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(band.build, 'stream',
                        lambda device: ctypes.c_void_p(0))
    return library


@pytest.mark.parametrize('batch, flags, dependents', [
    (8, [0], 0), (128, [0], 0), (256, [0], 0), (512, [0, 1], 1),
    (1024, [0, 1], 1)])
def test_dependent_flags_follow_the_plan(fake_card, counters, batch, flags,
                                         dependents):
    """One launch per plan entry, each on its entry's rows and cluster
    size; only the rest of a batch past its whole waves (512 rows: 32 in
    clusters of 4; 1024 rows: 64 in clusters of 8) launches as a
    dependent, counted by ``dependent_launches``"""
    frames = 1
    obs = torch.zeros((batch, frames, STATES))
    batch_frames = torch.ones(batch, dtype=torch.int32)
    initial = torch.zeros(STATES)
    band_matrix = torch.zeros((WIDTH, STATES))
    post_seq, posterior = band.viterbi_forward_band(
        obs, batch_frames, initial, (LO, WIDTH, None), band_matrix)
    plan = band.cluster_plan(batch, STATES, WIDTH, h100)
    calls = fake_card.calls
    assert [call[15] for call in calls] == flags
    assert counters.dependent_launches == dependents
    assert counters.launches == len(plan)
    row = frames * STATES * 4
    assert [(call[0].value - obs.data_ptr()) // row for call in calls] == [
        start for start, _, _ in plan]
    assert [(call[1].value - batch_frames.data_ptr()) // 4
            for call in calls] == [start for start, _, _ in plan]
    assert [(call[4].value - post_seq.data_ptr()) // row
            for call in calls] == [start for start, _, _ in plan]
    assert [(call[5], call[14]) for call in calls] == [
        (count, size) for _, count, size in plan]
    assert all(call[6:10] == (frames, STATES, LO, WIDTH) for call in calls)
    assert posterior.shape == (batch, STATES)


def test_one_size_launch_is_never_dependent(fake_card, counters):
    """``_forward_band_clusters`` (one launch at a chosen size, whatever
    the plan) launches nothing as a dependent"""
    batch = 512
    band._forward_band_clusters(
        torch.zeros((batch, 1, STATES)), torch.ones(batch, dtype=torch.int32),
        torch.zeros(STATES), (LO, WIDTH, None), torch.zeros((WIDTH, STATES)),
        4)
    assert [(call[5], call[14], call[15]) for call in fake_card.calls] == [
        (batch, 4, 0)]
    assert counters.dependent_launches == 0


def triangular(states, halfwidth):
    bins = np.arange(states)
    tri = np.clip(halfwidth + 1.0 - np.abs(bins[:, None] - bins[None, :]),
                  0, None)
    tiny = np.finfo(np.float32).tiny
    return np.log((tri / tri.sum(axis=1, keepdims=True)).astype(np.float32)
                  + tiny).astype(np.float32)


@pytest.mark.parametrize('batch', [2, 40, 600])
def test_plain_paths_unchanged(counters, batch):
    """On CPU tensors the banded decode runs the plain versions: its paths
    equal the scan route's, and no launch of any kind is counted"""
    states, frames = 37, 6
    rng = np.random.default_rng(batch)
    obs = torch.from_numpy(np.log(
        rng.dirichlet(np.ones(states), size=(batch, frames))
        .astype(np.float32) + np.finfo(np.float32).tiny))
    trans = torch.from_numpy(triangular(states, 3))
    init = torch.full((states,), float(np.log(1.0 / states)))
    batch_frames = torch.from_numpy(
        rng.integers(1, frames + 1, batch).astype(np.int32))
    gated = band.gate_band(band.detect_band(trans), init,
                           finite_observation=True)
    assert dispatch.kernel_route(trans, gated, batch)[0][0] == 'band_forward'
    out = dispatch.decode(obs, batch_frames, trans, init,
                          finite_observation=True, device='cpu')
    scan = dispatch.decode(obs, batch_frames, trans, init, backend='scan',
                           device='cpu')
    assert torch.equal(out, scan)
    assert counters.launches == 0
    assert counters.dependent_launches == 0
    assert counters.size_launches == dict.fromkeys(band.CLUSTER_TILES, 0)
