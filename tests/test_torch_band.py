"""The port's band detection and banded forward pass against torbi_tpu.

Inputs are made with numpy from a seed and handed to both packages. The
JAX banded kernel runs in interpret mode on the CPU, with its inputs padded
as its dispatcher pads them (batch and frames to multiples of 8, states to
a multiple of 128 with -inf). Tolerance: bitwise everywhere -- every
forward candidate is one fp32 add and max does not depend on order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torbi_tpu.models import pitch as jax_pitch
from torbi_tpu.ops import band as jax_band
from torbi_tpu_torch.models import pitch
from torbi_tpu_torch.ops import band

TINY = np.finfo(np.float32).tiny


def _round_up(value, multiple):
    return -(-value // multiple) * multiple


def banded_probabilities(states, halfwidth):
    xx, yy = np.meshgrid(np.arange(states), np.arange(states), indexing='ij')
    trans = np.clip(halfwidth + 1.0 - np.abs(xx - yy), 0, None)
    return (trans / trans.sum(axis=1, keepdims=True)).astype(np.float32)


def log_transition(probabilities, floor):
    """log(p + tiny) (constant floor outside the band) or log(p) (-inf)"""
    if floor:
        return np.log(probabilities + TINY).astype(np.float32)
    with np.errstate(divide='ignore'):
        return np.log(probabilities).astype(np.float32)


def log_dirichlet(rng, shape, states):
    return np.log(
        rng.dirichlet(np.ones(states), size=shape).astype(np.float32)
        + TINY).astype(np.float32)


def test_pitch_copy_matches():
    """The port's own copy of the pitch transition is the JAX package's"""
    np.testing.assert_array_equal(
        pitch.transition_matrix(), jax_pitch.transition_matrix())


@pytest.mark.parametrize('kind', ['pitch', 'pure', 'uniform', 'dense'])
def test_detect_band_matches(kind):
    """(lo, width, floor) equal to torbi_tpu's detect_band"""
    rng = np.random.default_rng(3)
    if kind == 'pitch':
        trans = log_transition(pitch.transition_matrix(), floor=True)
    elif kind == 'pure':
        trans = log_transition(banded_probabilities(300, 9), floor=False)
    elif kind == 'uniform':
        trans = np.full((40, 40), np.log(1. / 40), dtype=np.float32)
    else:
        trans = log_dirichlet(rng, 40, 40)
    expected = jax_band.detect_band(jnp.asarray(trans))
    got = band.detect_band(torch.from_numpy(trans))
    assert got == expected
    if kind == 'pitch':
        assert got == (-87, 175, float(np.float32(np.log(TINY))))
    if kind == 'pure':
        assert got[2] is None
    if kind == 'uniform':
        assert got[1] == 0
    if kind == 'dense':
        assert got is None


@pytest.mark.parametrize('states,halfwidth,floor', [
    (1440, None, True), (200, 6, True), (130, 4, False)])
def test_build_band_matrix_matches(states, halfwidth, floor):
    """Bitwise equal to torbi_tpu's build_band_matrix, cut to (width, S)"""
    probs = (pitch.transition_matrix() if halfwidth is None
             else banded_probabilities(states, halfwidth))
    trans = log_transition(probs, floor)
    lo, width, _ = band.detect_band(torch.from_numpy(trans))
    states_p = _round_up(states, 128)
    trans_p = np.full((states_p, states_p), -np.inf, dtype=np.float32)
    trans_p[:states, :states] = trans
    expected = np.asarray(
        jax_band.build_band_matrix(jnp.asarray(trans_p), lo, width))
    got = band.build_band_matrix(torch.from_numpy(trans), lo, width)
    assert got.shape == (width, states)
    np.testing.assert_array_equal(got.numpy(), expected[:width, :states])


def jax_forward(obs, bf, trans, init, band_tuple):
    """torbi_tpu's banded kernel (interpret mode) on dispatch-padded
    inputs, cut back to the real (batch, frames, states)"""
    batch, frames, states = obs.shape
    batch_p, frames_p = _round_up(batch, 8), _round_up(frames, 8)
    states_p = _round_up(states, 128)
    obs_p = np.full((batch_p, frames_p, states), -np.inf, dtype=np.float32)
    obs_p[:batch, :frames] = obs
    bf_p = np.ones(batch_p, dtype=np.int32)
    bf_p[:batch] = bf
    trans_p = np.full((states_p, states_p), -np.inf, dtype=np.float32)
    trans_p[:states, :states] = trans
    init_p = np.full(states_p, -np.inf, dtype=np.float32)
    init_p[:states] = init
    post_seq, posterior = jax_band.viterbi_forward_band(
        jnp.asarray(obs_p), jnp.asarray(bf_p), jnp.asarray(trans_p),
        jnp.asarray(init_p), band_tuple, interpret=True)
    return (np.asarray(post_seq)[:batch, :frames, :states],
            np.asarray(posterior)[:batch, :states])


@pytest.mark.parametrize('batch,frames,states,halfwidth,floor,padded', [
    (3, 12, 200, 6, True, False),
    (5, 10, 200, 6, True, True),
    (4, 9, 130, 4, False, True),
    (2, 16, 256, 20, True, True),
])
def test_band_forward_matches_jax(batch, frames, states, halfwidth, floor,
                                  padded):
    """Plain K1 (and its wrapper on CPU tensors) bitwise equal to the JAX
    banded kernel, with a floor band and a pure -inf band, full and padded
    batch_frames"""
    rng = np.random.default_rng(batch * 100 + frames + states)
    obs = log_dirichlet(rng, (batch, frames), states)
    trans = log_transition(banded_probabilities(states, halfwidth), floor)
    init = log_dirichlet(rng, (), states)
    if padded:
        bf = rng.integers(1, frames + 1, size=batch).astype(np.int32)
        bf[0] = frames
    else:
        bf = np.full(batch, frames, dtype=np.int32)
    band_tuple = band.detect_band(torch.from_numpy(trans))
    assert band_tuple is not None and (band_tuple[2] is None) == (not floor)
    expected_seq, expected_post = jax_forward(obs, bf, trans, init,
                                              band_tuple)

    band_matrix = band.build_band_matrix(
        torch.from_numpy(trans), band_tuple[0], band_tuple[1])
    args = (torch.from_numpy(obs), torch.from_numpy(bf),
            torch.from_numpy(init), band_tuple, band_matrix)
    for fn in (band.band_forward_reference, band.viterbi_forward_band):
        post_seq, posterior = fn(*args)
        np.testing.assert_array_equal(post_seq.numpy(), expected_seq)
        np.testing.assert_array_equal(posterior.numpy(), expected_post)


def test_band_wrapper_rejects_width0_pure_band():
    """A width-0 band needs a floor, as the JAX builder asserts"""
    obs = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError):
        band.viterbi_forward_band(
            obs, torch.ones(1, dtype=torch.int32), torch.zeros(4),
            (0, 0, None), torch.zeros((0, 4)))


def test_gate_band_matches():
    """gate_band's initial-distribution preconditions, as torbi_tpu's"""
    rng = np.random.default_rng(11)
    init = log_dirichlet(rng, (), 16)
    partial = init.copy()
    partial[3] = -np.inf
    all_inf = np.full(16, -np.inf, dtype=np.float32)
    for band_tuple in [(-2, 5, None), (-2, 5, -87.0)]:
        for initial in (init, partial, all_inf):
            expected = jax_band.gate_band(
                band_tuple, jnp.asarray(initial), finite_observation=True)
            got = band.gate_band(
                band_tuple, torch.from_numpy(initial),
                finite_observation=True)
            assert got == expected
