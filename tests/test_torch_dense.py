"""The port's dense forward pass against torbi_tpu's Pallas kernel.

Inputs are made with numpy from a seed and handed to both packages. The
JAX dense kernel runs in interpret mode on the CPU, with its inputs padded
as its dispatcher pads them (batch and frames to multiples of 8, states to
a multiple of 128 with -inf). Tolerance: bitwise -- every candidate is one
fp32 add and max does not depend on order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torbi_tpu.ops.pallas import viterbi_forward_pallas
from torbi_tpu_torch.ops import dense

TINY = np.finfo(np.float32).tiny


def _round_up(value, multiple):
    return -(-value // multiple) * multiple


def log_dirichlet(rng, shape, states):
    return np.log(
        rng.dirichlet(np.ones(states), size=shape).astype(np.float32)
        + TINY).astype(np.float32)


def jax_forward(obs, bf, trans, init):
    """torbi_tpu's dense kernel (interpret mode) on dispatch-padded inputs,
    cut back to the real (batch, frames, states)"""
    batch, frames, states = obs.shape
    batch_p, frames_p = _round_up(batch, 8), _round_up(frames, 8)
    states_p = _round_up(states, 128)
    obs_p = np.full((batch_p, frames_p, states_p), -np.inf, dtype=np.float32)
    obs_p[:batch, :frames, :states] = obs
    bf_p = np.ones(batch_p, dtype=np.int32)
    bf_p[:batch] = bf
    trans_p = np.full((states_p, states_p), -np.inf, dtype=np.float32)
    trans_p[:states, :states] = trans
    init_p = np.full(states_p, -np.inf, dtype=np.float32)
    init_p[:states] = init
    post_seq, posterior = viterbi_forward_pallas(
        jnp.asarray(obs_p), jnp.asarray(bf_p), jnp.asarray(trans_p),
        jnp.asarray(init_p), interpret=True)
    return (np.asarray(post_seq)[:batch, :frames, :states],
            np.asarray(posterior)[:batch, :states])


def toy_log():
    obs = np.log(np.array([[
        [0.25, 0.5, 0.25],
        [0.25, 0.25, 0.5],
        [0.33, 0.33, 0.33]]], dtype=np.float32))
    trans = np.log(np.array([
        [0.5, 0.25, 0.25],
        [0.33, 0.34, 0.33],
        [0.25, 0.25, 0.5]], dtype=np.float32))
    init = np.log(np.array([0.4, 0.35, 0.25], dtype=np.float32))
    return obs, np.array([3], dtype=np.int32), trans, init


@pytest.mark.parametrize('batch,frames,states,padded', [
    (1, 3, 3, False),
    (2, 16, 8, False),
    (4, 9, 17, True),
    (3, 12, 130, True),
])
def test_dense_forward_matches_jax(batch, frames, states, padded):
    """Plain K2 (and its wrapper on CPU tensors) bitwise equal to
    torbi_tpu's viterbi_forward_pallas"""
    rng = np.random.default_rng(batch * 1000 + frames * 10 + states)
    obs = log_dirichlet(rng, (batch, frames), states)
    trans = log_dirichlet(rng, states, states)
    init = log_dirichlet(rng, (), states)
    if padded:
        bf = rng.integers(1, frames + 1, size=batch).astype(np.int32)
        bf[0] = frames
    else:
        bf = np.full(batch, frames, dtype=np.int32)
    expected_seq, expected_post = jax_forward(obs, bf, trans, init)
    args = (torch.from_numpy(obs), torch.from_numpy(bf),
            torch.from_numpy(trans), torch.from_numpy(init))
    for fn in (dense.dense_forward_reference, dense.viterbi_forward_dense):
        post_seq, posterior = fn(*args)
        np.testing.assert_array_equal(post_seq.numpy(), expected_seq)
        np.testing.assert_array_equal(posterior.numpy(), expected_post)


def test_dense_forward_toy_matches_jax():
    """The README toy's posterior stream, bitwise"""
    obs, bf, trans, init = toy_log()
    expected_seq, _ = jax_forward(obs, bf, trans, init)
    post_seq, _ = dense.viterbi_forward_dense(
        torch.from_numpy(obs), torch.from_numpy(bf), torch.from_numpy(trans),
        torch.from_numpy(init))
    np.testing.assert_array_equal(post_seq.numpy(), expected_seq)


@pytest.mark.parametrize('case', ['ragged-one-frame', 'ties'])
def test_dense_forward_matches_jax_edges(case):
    """Plain K2 bitwise equal to torbi_tpu's dense kernel on a ragged batch
    with a one-frame sequence (its stream holds frame 0 throughout), and on
    a transition and observation of small integers, where candidates tie
    exactly"""
    rng = np.random.default_rng(11)
    if case == 'ragged-one-frame':
        batch, frames, states = 5, 11, 40
        obs = log_dirichlet(rng, (batch, frames), states)
        trans = log_dirichlet(rng, states, states)
        bf = np.array([11, 1, 6, 2, 11], dtype=np.int32)
    else:
        batch, frames, states = 3, 9, 33
        obs = rng.integers(-3, 1, size=(batch, frames, states)).astype(
            np.float32)
        trans = rng.integers(-2, 1, size=(states, states)).astype(np.float32)
        bf = np.array([9, 9, 4], dtype=np.int32)
    init = log_dirichlet(rng, (), states)
    expected_seq, expected_post = jax_forward(obs, bf, trans, init)
    args = (torch.from_numpy(obs), torch.from_numpy(bf),
            torch.from_numpy(trans), torch.from_numpy(init))
    for fn in (dense.dense_forward_reference, dense.viterbi_forward_dense):
        post_seq, posterior = fn(*args)
        np.testing.assert_array_equal(post_seq.numpy(), expected_seq)
        np.testing.assert_array_equal(posterior.numpy(), expected_post)
    if case == 'ragged-one-frame':
        np.testing.assert_array_equal(
            post_seq[1].numpy(), np.broadcast_to(
                post_seq[1, 0].numpy(), (frames, states)))
