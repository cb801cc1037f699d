"""The port's decode through K1's wide-band design against torbi_tpu, on
the CPU.

Bands that no layout of K1's cluster design holds (wider than 301 at 1440
states, any width at 4096 states) take the wide-band design
(``band.viterbi_forward_band_wide``); on CPU tensors it runs the plain
version, and the decode around it (K3, or K5 for one sequence) is the
port's. The same inputs, made with numpy from a seed, go through
torbi_tpu's ``from_probabilities`` on its scan route (``backend='xla'``)
and through the port's ``from_probabilities`` on the CPU; the paths are
compared bitwise, and the port must have run the wide-band design.
Probability-space inputs are peaked pitch posteriorgrams (clear margins:
``torch.log`` and ``jnp.log`` differ by one ulp on some inputs).
"""
import numpy as np
import pytest
import torch

import torbi_tpu
import torbi_tpu_torch
from torbi_tpu_torch.models import pitch
from torbi_tpu_torch.ops import band
from torbi_tpu_torch.utils.fixtures import triangular_band, triangular_log

TINY = np.finfo(np.float32).tiny


def pitch_20ms(seed):
    """4 x 48 x 1440 pitch posteriorgrams (log space) under the pitch
    transition of a 20 ms hop (width 347) over log(tiny), ragged"""
    obs = pitch.synthetic_posteriorgrams(4, 48, pitch.PITCH_BINS, seed=seed)
    trans = np.log(pitch.transition_matrix(hopsize=160) + TINY)
    return obs, np.array([48, 30, 1, 47], np.int32), trans, True


def serial_401_probabilities(seed):
    """One 300-frame pitch sequence as probabilities under a width-401
    band over a floor of tiny, also as probabilities"""
    obs = np.exp(pitch.synthetic_posteriorgrams(
        1, 300, pitch.PITCH_BINS, seed=seed))
    return obs, np.array([300], np.int32), triangular_band(
        pitch.PITCH_BINS, 200), False


def pure_401(seed):
    """3 x 40 x 1440 pitch posteriorgrams under a pure -inf band of width
    401 (log space)"""
    obs = pitch.synthetic_posteriorgrams(3, 40, pitch.PITCH_BINS, seed=seed)
    trans = triangular_log(pitch.PITCH_BINS, 200, 0)
    return obs, np.array([40, 40, 17], np.int32), trans, True


def states_4096(seed):
    """2 x 32 x 4096 log-Dirichlet observations under a width-175 band
    over log(tiny)"""
    rng = np.random.default_rng(seed)
    obs = np.log(rng.dirichlet(np.ones(4096), size=(2, 32)).astype(
        np.float32) + TINY).astype(np.float32)
    return obs, np.array([32, 21], np.int32), triangular_log(
        4096, 87), True


CASES = {
    'pitch-20ms-w347-floor': (pitch_20ms, 347),
    'serial-w401-probabilities': (serial_401_probabilities, 401),
    'pure-w401': (pure_401, 401),
    'S4096-w175-floor': (states_4096, 175),
}


@pytest.mark.parametrize('name', list(CASES))
def test_wide_band_decode_matches_torbi_tpu(monkeypatch, name):
    make, width = CASES[name]
    obs, bf, trans, log_probs = make(sum(map(ord, name)))
    trans = trans.astype(np.float32)
    log_trans = trans if log_probs else np.log(trans)
    detected = band.detect_band(log_trans)
    assert detected is not None and detected[1] == width
    assert band.forward_kernel(obs.shape[2], width)[0] == 'band_forward_wide'
    calls = []
    orig = band.viterbi_forward_band_wide

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return orig(*args, **kwargs)

    monkeypatch.setattr(band, 'viterbi_forward_band_wide', spy)
    got = torbi_tpu_torch.from_probabilities(
        obs, batch_frames=bf, transition=trans, log_probs=log_probs,
        gpu='cpu')
    assert calls == [obs.shape]
    expected = np.asarray(torbi_tpu.from_probabilities(
        obs, batch_frames=bf, transition=trans, log_probs=log_probs,
        backend='xla'))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expected)
