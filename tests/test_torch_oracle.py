"""The port's numpy oracle (``torbi_tpu_torch/ops/oracle.py``) against
torbi_tpu's, bitwise, on seeded dense, banded and floor cases: the float32
recursion ``viterbi_numpy`` (ragged lengths, ties) and the float64
probability-space ``viterbi_librosa_style``, whose banded route the pitch
transition takes."""
import numpy as np
import pytest

from torbi_tpu.ops import oracle as jax_oracle
from torbi_tpu_torch.models import pitch
from torbi_tpu_torch.ops import oracle

TINY = np.finfo(np.float32).tiny


def transition(kind, states, rng):
    """Probability-space transition of one kind"""
    if kind == 'dense':
        return rng.dirichlet(np.ones(states), size=states).astype(np.float32)
    bins = np.arange(states)
    band = np.clip(5.0 - np.abs(bins[:, None] - bins[None, :]), 0, None)
    return (band / band.sum(axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize('kind', ['dense', 'band', 'floor', 'ties'])
def test_viterbi_numpy_equals_jax(kind):
    rng = np.random.default_rng(11)
    states, batch, frames = 33, 4, 40
    obs = np.log(rng.dirichlet(np.ones(states), size=(batch, frames))
                 .astype(np.float32) + TINY)
    probs = transition('dense' if kind == 'dense' else 'band', states, rng)
    with np.errstate(divide='ignore'):
        trans = np.log(probs + (TINY if kind == 'floor' else 0))
    if kind == 'ties':
        obs = rng.integers(-2, 1, size=obs.shape).astype(np.float32)
        trans = -rng.integers(0, 2, size=trans.shape).astype(np.float32)
    init = np.log(rng.dirichlet(np.ones(states)).astype(np.float32))
    bf = np.array([frames, 1, 17, 29], np.int32)
    got = oracle.viterbi_numpy(obs, bf, trans, init)
    np.testing.assert_array_equal(
        got, jax_oracle.viterbi_numpy(obs, bf, trans, init))


@pytest.mark.parametrize('kind', ['dense', 'band', 'pitch'])
def test_librosa_style_equals_jax(kind):
    """The pitch transition (1440 states) takes the banded route"""
    rng = np.random.default_rng(5)
    if kind == 'pitch':
        probs = pitch.transition_matrix()
        obs = np.exp(pitch.synthetic_posteriorgrams(1, 60, seed=2)[0])
    else:
        probs = transition(kind, 48, rng)
        obs = rng.dirichlet(np.ones(48), size=70).astype(np.float32)
    states = probs.shape[0]
    init = np.full(states, 1.0 / states, np.float32)
    got = oracle.viterbi_librosa_style(obs, probs, init)
    np.testing.assert_array_equal(
        got, jax_oracle.viterbi_librosa_style(obs, probs, init))
    if kind != 'dense':
        np.testing.assert_array_equal(
            got, oracle._viterbi_librosa_dense(
                obs.astype(np.float64), probs.astype(np.float64),
                init.astype(np.float64)))
