"""The port's backtrace against torbi_tpu's Pallas backtrace kernel.

Inputs are made with numpy from a seed and handed to both packages. The JAX
kernel runs in interpret mode on the CPU; its inputs are padded as its
dispatcher pads them: batch to a multiple of 8, states to a multiple of 128
with -inf, frames to at most 128 and a multiple of 8 (the padding frames
repeat the last one, as a frozen forward stream does). Tolerance: identical
indices.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torbi_tpu.ops.backtrace import backtrace_posteriors as jax_backtrace
from torbi_tpu_torch.ops import backtrace, dense

TINY = np.finfo(np.float32).tiny


def _round_up(value, multiple):
    return -(-value // multiple) * multiple


def jax_indices(post_seq, trans, bf):
    batch, frames, states = post_seq.shape
    assert frames <= 128
    batch_p, frames_p = _round_up(batch, 8), _round_up(frames, 8)
    states_p = _round_up(states, 128)
    seq_p = np.zeros((batch_p, frames_p, states_p), dtype=np.float32)
    seq_p[..., states:] = -np.inf
    seq_p[:batch, :frames, :states] = post_seq
    seq_p[:batch, frames:, :states] = post_seq[:, -1:, :]
    trans_p = np.full((states_p, states_p), -np.inf, dtype=np.float32)
    trans_p[:states, :states] = trans
    bf_p = np.ones(batch_p, dtype=np.int32)
    bf_p[:batch] = bf
    out = jax_backtrace(
        jnp.asarray(seq_p), jnp.asarray(trans_p),
        jnp.asarray(seq_p[:, -1]), jnp.asarray(bf_p), interpret=True)
    return np.asarray(out)[:batch, :frames]


def port_indices(post_seq, trans, bf):
    seq = torch.from_numpy(post_seq)
    args = (seq, torch.from_numpy(trans), seq[:, -1], torch.from_numpy(bf))
    ref = backtrace.backtrace_reference(*args)
    wrapped = backtrace.backtrace_posteriors(*args)
    assert ref.dtype == torch.int32
    np.testing.assert_array_equal(ref.numpy(), wrapped.numpy())
    return ref.numpy()


@pytest.mark.parametrize('batch,frames,states,padded', [
    (2, 16, 8, False),
    (4, 33, 17, True),
    (3, 20, 130, True),
])
def test_backtrace_matches_jax(batch, frames, states, padded):
    """Plain K3 on a dense forward stream, identical to torbi_tpu's"""
    rng = np.random.default_rng(7 * batch + frames + states)

    def log_dirichlet(shape):
        return np.log(
            rng.dirichlet(np.ones(states), size=shape).astype(np.float32)
            + TINY).astype(np.float32)

    obs, trans, init = log_dirichlet((batch, frames)), log_dirichlet(
        states), log_dirichlet(())
    if padded:
        bf = rng.integers(1, frames + 1, size=batch).astype(np.int32)
        bf[0] = frames
    else:
        bf = np.full(batch, frames, dtype=np.int32)
    post_seq, _ = dense.dense_forward_reference(
        torch.from_numpy(obs), torch.from_numpy(bf), torch.from_numpy(trans),
        torch.from_numpy(init))
    post_seq = post_seq.numpy()
    np.testing.assert_array_equal(
        port_indices(post_seq, trans, bf), jax_indices(post_seq, trans, bf))


@pytest.mark.parametrize('seed', [0, 1])
def test_backtrace_exact_ties(seed):
    """Small-integer scores tie exactly at many indices, not only at 0: the
    lowest index wins, as in torbi_tpu"""
    rng = np.random.default_rng(seed)
    batch, frames, states = 5, 24, 40
    post_seq = rng.integers(-2, 1, size=(batch, frames, states)).astype(
        np.float32)
    trans = rng.integers(-2, 1, size=(states, states)).astype(np.float32)
    bf = np.array([24, 24, 13, 2, 1], dtype=np.int32)
    got = port_indices(post_seq, trans, bf)
    np.testing.assert_array_equal(got, jax_indices(post_seq, trans, bf))
    assert len(np.unique(got)) > 1


def test_backtrace_all_inf_row_gives_zero():
    """A frame whose every candidate is -inf chases to index 0, as argmax
    does"""
    rng = np.random.default_rng(5)
    batch, frames, states = 2, 8, 20
    post_seq = rng.standard_normal((batch, frames, states)).astype(np.float32)
    post_seq[:, 3, :] = -np.inf
    trans = rng.standard_normal((states, states)).astype(np.float32)
    bf = np.full(batch, frames, dtype=np.int32)
    got = port_indices(post_seq, trans, bf)
    assert (got[:, 3] == 0).all()
    np.testing.assert_array_equal(got, jax_indices(post_seq, trans, bf))
