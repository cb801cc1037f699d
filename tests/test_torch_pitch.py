"""The port's pitch model (torbi_tpu_torch/models/pitch.py): the transition
of the synthetic pitch corpus and the corpus's files, on the CPU.

At 1440 states the transition is torbi_tpu's pitch matrix, bitwise; at other
state counts a row-normalized triangular band. The corpus's files load back
as the generator's arrays, bitwise.
"""
import numpy as np
import pytest

from torbi_tpu.models import pitch as jax_pitch
from torbi_tpu_torch.models import pitch


@pytest.mark.parametrize('states', [1440, 64, 96])
def test_transition_probabilities(states):
    trans = pitch.transition_probabilities(states)
    assert trans.dtype == np.float32 and trans.shape == (states, states)
    if states == pitch.PITCH_BINS:
        np.testing.assert_array_equal(trans, jax_pitch.transition_matrix())
        return
    np.testing.assert_allclose(
        trans.astype(np.float64).sum(axis=1), 1.0, rtol=0,
        atol=np.finfo(np.float32).eps)
    halfwidth = max(states // 16, 4)
    bins = np.arange(states)
    distance = np.abs(bins[:, None] - bins[None, :])
    assert (trans[distance <= halfwidth] > 0).all()
    assert (trans[distance > halfwidth] == 0).all()


def test_write_corpus_round_trip(tmp_path):
    lengths, states = (7, 30, 1, 12), 64
    inputs, outputs, trans_path = pitch.write_corpus(
        str(tmp_path), lengths, states)
    assert len(inputs) == len(outputs) == len(lengths)
    for i, (path, length) in enumerate(zip(inputs, lengths)):
        expected = pitch.synthetic_posteriorgrams(
            1, length, states, seed=1000 + i)[0]
        np.testing.assert_array_equal(np.load(path), expected)
        assert outputs[i] == str(tmp_path / f'{i:05d}_out.npy')
    np.testing.assert_array_equal(
        np.load(trans_path), pitch.transition_probabilities(states))
