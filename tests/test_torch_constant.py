"""The constant transition's closed form and its recurrence (K7).

``ops/constant.py::recurrence_reference`` is K7's plain version: the loop
the closed form ran before K7, one frame per iteration. It is held here,
with ragged lengths (some past the stream), against that loop written out
independently, and the closed form as a whole against torbi_tpu's (its
constant branch, taken on its kernel backend; no Pallas kernel runs
there) and against the oracle. On CPU tensors the wrapper runs the plain
version and counts no launch.
"""
import numpy as np
import pytest
import torch

from torbi_tpu.ops import dispatch as jax_dispatch
from torbi_tpu_torch.ops import constant, dispatch, oracle

TINY = np.finfo(np.float32).tiny


def loop(maxima, g0, batch_frames, floor):
    """The recurrence frame by frame in numpy float32"""
    batch, frames = maxima.shape
    ms = np.empty((batch, frames - 1), np.float32)
    g = g0.astype(np.float32).copy()
    floor = np.float32(floor)
    for t in range(1, frames):
        gm = g + floor
        ms[:, t - 1] = gm
        g = np.where(t < batch_frames, maxima[:, t] + gm, g)
    return ms


@pytest.mark.parametrize('batch,frames', [(1, 300), (7, 129), (40, 33)])
def test_recurrence_reference_equals_loop(batch, frames):
    rng = np.random.default_rng(batch)
    maxima = rng.standard_normal((batch, frames)).astype(np.float32) * 30
    g0 = rng.standard_normal(batch).astype(np.float32)
    bf = rng.integers(1, frames + 4, size=batch).astype(np.int32)
    floor = float(np.log(np.float32(1.0 / 1440)))
    constant.recurrence.launches = 0
    got = constant.recurrence(
        torch.from_numpy(maxima), torch.from_numpy(g0),
        torch.from_numpy(bf), floor)
    assert constant.recurrence.launches == 0
    np.testing.assert_array_equal(got.numpy(), loop(maxima, g0, bf, floor))


@pytest.mark.parametrize('states', [40, 129])
def test_closed_form_equals_jax_and_oracle(states):
    """Ragged lengths, one past the end of the stream: the port decodes it
    as ``frames`` (the clamp), so torbi_tpu gets the clamped lengths"""
    rng = np.random.default_rng(states)
    batch, frames = 6, 50
    obs = np.log(rng.dirichlet(
        np.ones(states), size=(batch, frames)).astype(np.float32) + TINY)
    trans = np.full((states, states), np.log(np.float32(1.0 / states)),
                    np.float32)
    init = np.log(rng.dirichlet(np.ones(states)).astype(np.float32) + TINY)
    bf = np.array([frames, 1, 17, 2, frames + 5, 33], np.int32)
    clamped = np.minimum(bf, frames)
    got = dispatch.decode(obs, bf, trans, init, device='cpu').numpy()
    np.testing.assert_array_equal(
        got, oracle.viterbi_numpy(obs, clamped, trans, init))
    np.testing.assert_array_equal(got, np.asarray(jax_dispatch.decode(
        obs, clamped, trans, init, backend='pallas')))


def test_closed_form_launches_nothing_on_the_cpu():
    constant.recurrence.launches = 0
    obs = np.log(np.random.default_rng(0).dirichlet(
        np.ones(17), size=(2, 9)).astype(np.float32))
    trans = np.zeros((17, 17), np.float32)
    dispatch.decode(obs, np.array([9, 4], np.int32), trans,
                    np.zeros(17, np.float32), device='cpu')
    assert constant.recurrence.launches == 0
