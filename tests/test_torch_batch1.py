"""The port's batch-1 kernels (K4, K5, K6) and routes against torbi_tpu.

The cases of tests/test_parity.py for the JAX package's batch-1 kernels:
the spread forward at 1 x 61 x 384 with an asymmetric band of +-9, with and
without a floor; the fused and window chases at 1 x 200 x 384 with a flat
asymmetric band and batch_frames 157. Inputs are made with numpy from a
seed. The port runs on the CPU (the kernels' plain versions), torbi_tpu
through ``dispatch.decode(..., backend='pallas')`` in interpret mode with
the stitched layout, which is where its batch-1 kernels run. Spies on the
wrappers show which route each decode took. Paths and streams are
compared bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torbi_tpu
import torbi_tpu_torch
from torbi_tpu.ops import backtrace as jax_backtrace
from torbi_tpu.ops import oracle
from torbi_tpu.ops.dispatch import decode as jax_decode
from torbi_tpu_torch.ops import backtrace, band, dispatch

from test_torch_band import jax_forward

TINY = np.finfo(np.float32).tiny


def log_dirichlet(seed, frames, states):
    rng = np.random.default_rng(seed)
    return np.log(
        rng.dirichlet(np.ones(states), size=(1, frames))
        .astype(np.float32) + TINY)


def spread_case(with_floor):
    """tests/test_parity.py::test_spread_batch1_kernel_matches_oracle"""
    frames, states, halfwidth = 61, 384, 9
    obs = log_dirichlet(91, frames, states)
    xx, yy = np.meshgrid(np.arange(states), np.arange(states), indexing='ij')
    probs = np.clip(halfwidth + 1.0 - np.abs(xx - yy + 3), 0, None)
    probs = probs + np.eye(states, dtype=np.float32) * 1e-3
    probs = (probs / probs.sum(axis=1, keepdims=True)).astype(np.float32)
    with np.errstate(divide='ignore'):
        trans = (np.log(probs + TINY) if with_floor
                 else np.log(probs)).astype(np.float32)
    init = np.log(np.full(states, 1.0 / states, dtype=np.float32) + TINY)
    return obs, np.array([frames], np.int32), trans, init


def chase_case(with_floor, seed):
    """tests/test_parity.py's window and fused chase cases: a flat
    asymmetric band (every in-band candidate ties on the transition term),
    two 128-frame tiles, a frozen tail"""
    frames, states, halfwidth = 200, 384, 11
    obs = log_dirichlet(seed, frames, states)
    xx, yy = np.meshgrid(np.arange(states), np.arange(states), indexing='ij')
    probs = (np.abs(xx - yy + 4) <= halfwidth).astype(np.float32)
    probs = (probs / probs.sum(axis=1, keepdims=True)).astype(np.float32)
    with np.errstate(divide='ignore'):
        trans = (np.log(probs + TINY) if with_floor
                 else np.log(probs)).astype(np.float32)
    init = np.log(np.full(states, 1.0 / states, dtype=np.float32) + TINY)
    return obs, np.array([157], np.int32), trans, init


def b6_case():
    """The repro of ROADMAP.md B6: a +-11 band over a log(tiny) floor and an
    observation peaked at state 50, then at state 300, so the best path
    jumps through the floor"""
    states, halfwidth = 384, 11
    xx, yy = np.meshgrid(np.arange(states), np.arange(states), indexing='ij')
    probs = np.clip(halfwidth + 1.0 - np.abs(xx - yy), 0, None)
    probs = (probs / probs.sum(axis=1, keepdims=True)).astype(np.float32)
    trans = np.log(probs + TINY).astype(np.float32)
    obs = np.zeros((1, 6, states), dtype=np.float32)
    obs[0, :3, 50] = obs[0, 3:, 300] = 1.0
    obs = np.log(obs + TINY).astype(np.float32)
    init = np.log(np.full(states, 1.0 / states, dtype=np.float32) + TINY)
    return obs, np.array([6], np.int32), trans, init


@pytest.fixture
def knobs(monkeypatch):
    """Set a batch-1 knob on both packages"""
    monkeypatch.setattr(
        torbi_tpu, 'BAND_KERNEL_LAYOUT', 'stitched', raising=False)

    def set_knob(name, value):
        for package in (torbi_tpu, torbi_tpu_torch):
            monkeypatch.setattr(package, name, value, raising=False)

    return set_knob


def spy_kernels(monkeypatch):
    calls = []
    for module, name, label in (
            (band, 'viterbi_forward_band', 'K1'),
            (band, 'viterbi_forward_band_spread', 'K4'),
            (dispatch, 'backtrace_posteriors', 'K3'),
            (dispatch, 'backtrace_fused1', 'K5'),
            (dispatch, 'backtrace_window', 'K6')):
        orig = getattr(module, name)

        def spy(*args, _orig=orig, _label=label, **kwargs):
            calls.append(_label)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)
    return calls


def port_decode(case, log_input=True, apply_epsilon=False):
    obs, bf, trans, init = case
    out = dispatch.decode(
        torch.from_numpy(obs), torch.from_numpy(bf), torch.from_numpy(trans),
        torch.from_numpy(init), finite_observation=True, log_input=log_input,
        apply_epsilon=apply_epsilon, device='cpu')
    return out.numpy()


def reference_decode(case, log_input=True, apply_epsilon=False):
    obs, bf, trans, init = case
    return np.asarray(jax_decode(
        jnp.asarray(obs), jnp.asarray(bf), jnp.asarray(trans),
        jnp.asarray(init), backend='pallas', finite_observation=True,
        log_input=log_input, apply_epsilon=apply_epsilon))


@pytest.mark.parametrize('with_floor', [False, True])
def test_spread_forward_matches(knobs, monkeypatch, with_floor):
    """BAND_BATCH1_SPREAD: K4 decodes the single banded sequence, and the
    path is torbi_tpu's spread-kernel path and the oracle's"""
    knobs('BAND_BATCH1_SPREAD', True)
    calls = spy_kernels(monkeypatch)
    case = spread_case(with_floor)
    assert (band.detect_band(torch.from_numpy(case[2]))[2] is None) == (
        not with_floor)
    got = port_decode(case)
    assert calls == ['K4', 'K5']
    expected = oracle.viterbi_numpy(*case)
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(reference_decode(case), expected)


@pytest.mark.parametrize('with_floor', [False, True])
def test_spread_plain_version_matches_jax_forward(with_floor):
    """Plain K4 (and its wrapper on CPU tensors) gives the stream of
    torbi_tpu's banded forward kernel for the one sequence, bitwise"""
    obs, bf, trans, init = spread_case(with_floor)
    band_tuple = band.detect_band(torch.from_numpy(trans))
    expected_seq, expected_post = jax_forward(obs, bf, trans, init,
                                              band_tuple)
    band_matrix = band.build_band_matrix(
        torch.from_numpy(trans), band_tuple[0], band_tuple[1])
    args = (torch.from_numpy(obs), torch.from_numpy(bf),
            torch.from_numpy(init), band_tuple, band_matrix)
    for fn in (band.band_spread_reference, band.viterbi_forward_band_spread):
        post_seq, posterior = fn(*args)
        np.testing.assert_array_equal(post_seq.numpy(), expected_seq)
        np.testing.assert_array_equal(posterior.numpy(), expected_post)


@pytest.mark.parametrize('spread', [False, True])
def test_fused_chase_matches(knobs, monkeypatch, spread):
    """BACKTRACE_BATCH1_FUSED: K5 chases the single sequence (ties on a
    flat band, a frozen tail), after K4 or K1; the path is torbi_tpu's
    fused-chase path and the oracle's"""
    knobs('BAND_BATCH1_SPREAD', spread)
    knobs('BACKTRACE_BATCH1_FUSED', True)
    calls = spy_kernels(monkeypatch)
    case = chase_case(with_floor=True, seed=31)
    got = port_decode(case)
    assert calls == ['K4' if spread else 'K1', 'K5']
    expected = oracle.viterbi_numpy(*case)
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(reference_decode(case), expected)


@pytest.mark.parametrize('spread', [False, True])
def test_window_chase_matches(knobs, monkeypatch, spread):
    """BACKTRACE_BATCH1_WINDOW with the fused chase off: K6 chases a pure
    -inf band (ties on a flat band, a frozen tail); the path is torbi_tpu's
    window-chase path and the oracle's"""
    knobs('BAND_BATCH1_SPREAD', spread)
    knobs('BACKTRACE_BATCH1_FUSED', False)
    knobs('BACKTRACE_BATCH1_WINDOW', True)
    calls = spy_kernels(monkeypatch)
    case = chase_case(with_floor=False, seed=29)
    got = port_decode(case)
    assert calls == ['K4' if spread else 'K1', 'K6']
    expected = oracle.viterbi_numpy(*case)
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(reference_decode(case), expected)


def test_window_off_or_floor_keeps_full_chase(knobs, monkeypatch):
    """With both batch-1 chases off, or the window on over a floor band,
    the chase is K3, and the path still the oracle's"""
    knobs('BACKTRACE_BATCH1_FUSED', False)
    knobs('BACKTRACE_BATCH1_WINDOW', False)
    calls = spy_kernels(monkeypatch)
    pure = chase_case(with_floor=False, seed=29)
    np.testing.assert_array_equal(
        port_decode(pure), oracle.viterbi_numpy(*pure))
    knobs('BACKTRACE_BATCH1_WINDOW', True)
    floor = chase_case(with_floor=True, seed=29)
    np.testing.assert_array_equal(
        port_decode(floor), oracle.viterbi_numpy(*floor))
    assert calls == ['K4', 'K3', 'K4', 'K3']


def test_b6_floor_band_never_takes_the_window(knobs, monkeypatch):
    """Hazard B6: with a finite floor the best path leaves the band window.
    With the window chase asked for, the port still returns the oracle's
    path, because dispatch keeps the window chase off a floor band"""
    knobs('BACKTRACE_BATCH1_FUSED', False)
    knobs('BACKTRACE_BATCH1_WINDOW', True)
    calls = spy_kernels(monkeypatch)
    case = b6_case()
    expected = oracle.viterbi_numpy(*case)
    np.testing.assert_array_equal(expected, [[50, 50, 50, 300, 300, 300]])
    np.testing.assert_array_equal(port_decode(case), expected)
    assert 'K6' not in calls
    with pytest.raises(ValueError, match='floor'):
        backtrace.backtrace_window(
            torch.zeros((1, 6, 384)), torch.from_numpy(case[2]),
            torch.zeros((1, 384)), torch.tensor([6], dtype=torch.int32),
            band.detect_band(torch.from_numpy(case[2])))


def test_batch1_chase_gate():
    """The chase choice follows the JAX gates, plus the no-floor rule"""
    assert dispatch._batch1_chase((-5, 11, None), 384) == 'fused'
    old = (torbi_tpu_torch.BACKTRACE_BATCH1_FUSED,
           torbi_tpu_torch.BACKTRACE_BATCH1_WINDOW)
    try:
        torbi_tpu_torch.BACKTRACE_BATCH1_FUSED = False
        torbi_tpu_torch.BACKTRACE_BATCH1_WINDOW = True
        assert dispatch._batch1_chase((-5, 11, None), 384) == 'window'
        assert dispatch._batch1_chase((-5, 11, -87.3), 384) is None
        # A window wider than the 128-state rows of the JAX kernel allow
        assert dispatch._batch1_chase((-150, 301, None), 384) is None
        torbi_tpu_torch.BACKTRACE_BATCH1_WINDOW = False
        assert dispatch._batch1_chase((-5, 11, None), 384) is None
    finally:
        (torbi_tpu_torch.BACKTRACE_BATCH1_FUSED,
         torbi_tpu_torch.BACKTRACE_BATCH1_WINDOW) = old
    states = backtrace.FUSED1_MAX_STATES + 1
    assert dispatch._batch1_chase((-5, 11, None), states) is None


@pytest.mark.parametrize('width', [1, 23, 128, 129, 175, 301])
def test_window_rows_matches(width):
    assert backtrace.window_rows(width) == jax_backtrace.window_rows(width)


@pytest.mark.parametrize('with_floor', [False, True])
def test_chase_plain_versions_match_k3(with_floor):
    """Plain K5 and K6, and their wrappers on CPU tensors, give K3's
    plain path on the stream of a frozen-tail sequence"""
    obs, bf, trans, init = chase_case(with_floor, seed=7)
    band_tuple = band.detect_band(torch.from_numpy(trans))
    band_matrix = band.build_band_matrix(
        torch.from_numpy(trans), band_tuple[0], band_tuple[1])
    post_seq, posterior = band.band_spread_reference(
        torch.from_numpy(obs), torch.from_numpy(bf), torch.from_numpy(init),
        band_tuple, band_matrix)
    args = (post_seq, torch.from_numpy(trans), posterior,
            torch.from_numpy(bf))
    expected = backtrace.backtrace_reference(*args)
    np.testing.assert_array_equal(
        expected.numpy(), oracle.viterbi_numpy(obs, bf, trans, init))
    for fn in (backtrace.backtrace_fused1_reference,
               backtrace.backtrace_fused1):
        torch.testing.assert_close(fn(*args), expected, rtol=0, atol=0)
    if not with_floor:
        for fn in (backtrace.backtrace_window_reference,
                   backtrace.backtrace_window):
            torch.testing.assert_close(
                fn(*args, band_tuple), expected, rtol=0, atol=0)


def test_batch1_wrappers_reject_batches():
    """The batch-1 kernels take one sequence"""
    obs = torch.zeros((2, 4, 8))
    bf = torch.full((2,), 4, dtype=torch.int32)
    trans = torch.zeros((8, 8))
    with pytest.raises(ValueError, match='one sequence'):
        band.viterbi_forward_band_spread(
            obs, bf, torch.zeros(8), (-1, 3, None), torch.zeros((3, 8)))
    with pytest.raises(ValueError, match='one sequence'):
        backtrace.backtrace_fused1(obs, trans, obs[:, -1], bf)
    with pytest.raises(ValueError, match='one sequence'):
        backtrace.backtrace_window(obs, trans, obs[:, -1], bf, (-1, 3, None))


def test_batch2_keeps_k1_and_k3(knobs, monkeypatch):
    """A batch of two takes the batch kernels whatever the batch-1 knobs"""
    calls = spy_kernels(monkeypatch)
    obs, _, trans, init = spread_case(with_floor=True)
    obs2 = np.concatenate([obs, obs[:, ::-1]]).copy()
    bf = np.array([61, 40], np.int32)
    got = port_decode((obs2, bf, trans, init))
    assert calls == ['K1', 'K3']
    np.testing.assert_array_equal(
        got, oracle.viterbi_numpy(obs2, bf, trans, init))


def test_state_limits_fall_back(knobs, monkeypatch):
    """A band K4 cannot hold in shared memory, and more states than K5
    holds, take K1 and K3, with the same path"""
    calls = spy_kernels(monkeypatch)
    case = spread_case(with_floor=True)
    expected = oracle.viterbi_numpy(*case)
    width = band.detect_band(case[2])[1]
    monkeypatch.setattr(
        band, 'SPREAD_SMEM_BYTES', band.spread_smem_bytes(384, width) - 1)
    np.testing.assert_array_equal(port_decode(case), expected)
    monkeypatch.setattr(backtrace, 'FUSED1_MAX_STATES', 383)
    monkeypatch.setattr(dispatch, 'FUSED1_MAX_STATES', 383)
    np.testing.assert_array_equal(port_decode(case), expected)
    assert calls == ['K1', 'K5', 'K1', 'K3']


@pytest.mark.parametrize('width, fits', [(175, True), (256, True),
                                         (257, False), (720, False)])
def test_spread_fits_pitch_states(width, fits):
    """At 1440 states K4's cluster of 16 CTAs holds the pitch band (175)
    and bands up to 256 in its register tile (8 lanes x 32 offsets at 192
    threads of the 256 the tile allows). Its shared memory: two mbarriers,
    two windows of 4 slices of 92 (the most at any lo) plus 8 x 24 slack,
    two outgoing slices, two tables of 16 CTA maxima and 6 warp maxima, a
    ring of 4 x 192 observation values"""
    layout = band.spread_layout(1440, width)
    assert layout['fits'] is fits
    assert band.spread_fits(1440, width) is fits
    assert layout['threads'] == 192
    assert band.spread_smem_bytes(1440, 175) == 4 * (
        4 + 2 * (4 * 92 + 8 * 24) + 2 * 92 + 32 + 12 + 4 * 192)


def test_wide_band_takes_k1(knobs, monkeypatch):
    """A single sequence under a band too wide for K4 at 1440 states takes
    K1, then K5, with the oracle's path"""
    calls = spy_kernels(monkeypatch)
    states, halfwidth, frames = 1440, 130, 6
    bins = np.arange(states)
    probs = np.clip(
        halfwidth + 1.0 - np.abs(bins[:, None] - bins[None, :]), 0, None)
    probs = (probs / probs.sum(axis=1, keepdims=True)).astype(np.float32)
    trans = np.log(probs + TINY).astype(np.float32)
    assert band.detect_band(trans)[1] == 2 * halfwidth + 1
    obs = log_dirichlet(7, frames, states)
    init = np.log(np.full(states, 1.0 / states, dtype=np.float32) + TINY)
    case = (obs, np.array([frames], np.int32), trans, init)
    np.testing.assert_array_equal(
        port_decode(case), oracle.viterbi_numpy(*case))
    assert calls == ['K1', 'K5']
