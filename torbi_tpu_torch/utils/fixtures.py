"""Committed reference paths: what ``torbi_tpu`` decodes on the CPU.

The kernels' plain versions are held against ``torbi_tpu`` on the CPU by
the tests, and the kernels against their plain versions on the card by
``chip_smoke.py``; neither compares what the card decodes with the
reference. These cases close that gap. Each case's inputs are made here
with numpy from a seed; ``tests/test_torch_fixtures.py`` decodes them
through ``torbi_tpu`` (its ``from_probabilities`` on the CPU) and keeps the
paths, as int16, in ``assets/reference_paths.npz`` beside a SHA-256 of the
inputs (``python tests/test_torch_fixtures.py --write`` rewrites the file;
the test fails when it is not current). The test also holds this
package's CPU route against the file, and ``chip_smoke.py`` decodes every
case on the card through the same entry point and holds each path against
it, bitwise.

The cases:

- ``edge-*``: every shape of the edge list (``utils/edges.py``), in log
  space, through the banded route (K1, K3);
- ``pitch-log``, ``pitch-prob``: peaked pitch posteriorgrams
  (``models/pitch.py``, the headline's generator) at 1440 states, three
  sequences of ragged length, once in log space over the ``log(p + tiny)``
  transition, once as probabilities (clear margins: ``torch.log`` and
  ``jnp.log`` differ by one ulp on some inputs) over the probability
  transition, whose log is a pure -inf band; both hold ``log(tiny)``
  entries, the second ``0 < p < tiny`` ones;
- ``tiny-entries``: a banded case whose observation holds ``log(tiny)``
  entries and whole frames of them (the epsilon step's subnormal ``exp``);
- ``dense``: a random dense transition (K2, K3);
- ``autochunk-pitch``: one pitch sequence of 4096 frames, which both
  packages decode as entropy-chunk rows at their default settings;
- ``serial-pitch``, ``serial-ties``: single sequences under 4096 frames,
  which both packages decode on their serial batch-1 route (the spread
  forward, then the fused chase: K4 and K5 here): one pitch sequence of
  1000 frames in log space whose valid length stops at 870, and a
  40-state band over the floor whose observation and band hold small
  integers, so that candidates tie, with a valid length of 19 of 24.

Every case decodes through ``from_probabilities`` with its ``log_probs``.
"""
import hashlib
from collections import namedtuple
from pathlib import Path

import numpy as np

from . import edges
from ..models import pitch

TINY = np.finfo(np.float32).tiny
ASSET = Path(__file__).resolve().parent.parent / 'assets' / \
    'reference_paths.npz'

# make(seed) -> (observation, batch_frames, transition, initial), numpy;
# transition and initial may be None (the entry point's uniform defaults)
Case = namedtuple('Case', 'name log_probs seed make')


def _edge(edge):
    def make(seed):
        return edges.band_edge_inputs(edge, seed)
    return make


def _pitch_log(seed):
    obs = pitch.synthetic_posteriorgrams(3, 192, pitch.PITCH_BINS, seed=seed)
    trans = np.log(pitch.transition_matrix() + TINY).astype(np.float32)
    return obs, np.array([192, 131, 40], np.int32), trans, None


def _pitch_prob(seed):
    obs = np.exp(pitch.synthetic_posteriorgrams(
        3, 192, pitch.PITCH_BINS, seed=seed))
    return (obs.astype(np.float32), np.array([91, 192, 150], np.int32),
            pitch.transition_matrix(), None)


def _tiny_entries(seed):
    rng = np.random.default_rng(seed)
    batch, frames, states, halfwidth = 4, 40, 96, 4
    obs = np.log(rng.dirichlet(np.ones(states), size=(batch, frames))
                 .astype(np.float32) + TINY).astype(np.float32)
    log_tiny = np.log(np.float32(TINY))
    obs[rng.random(obs.shape) < 0.3] = log_tiny
    obs[:, 5] = log_tiny
    obs[1:, 17] = log_tiny
    bins = np.arange(states)
    tri = np.clip(halfwidth + 1.0 - np.abs(bins[:, None] - bins[None, :]),
                  0, None)
    trans = np.log((tri / tri.sum(axis=1, keepdims=True)).astype(np.float32)
                   + TINY).astype(np.float32)
    init = np.log(np.full(states, 1.0 / states, dtype=np.float32) + TINY)
    return (obs, np.array([40, 17, 1, 33], np.int32), trans,
            init.astype(np.float32))


def _dense(seed):
    rng = np.random.default_rng(seed)
    states = 256

    def log_dirichlet(shape):
        return np.log(rng.dirichlet(np.ones(states), size=shape)
                      .astype(np.float32) + TINY).astype(np.float32)

    return (log_dirichlet((2, 64)), np.array([64, 29], np.int32),
            log_dirichlet(states), log_dirichlet(()))


def _autochunk_pitch(seed):
    obs = pitch.synthetic_posteriorgrams(1, 4096, pitch.PITCH_BINS, seed=seed)
    trans = np.log(pitch.transition_matrix() + TINY).astype(np.float32)
    return obs, np.array([4096], np.int32), trans, None


def _serial_pitch(seed):
    obs = pitch.synthetic_posteriorgrams(1, 1000, pitch.PITCH_BINS, seed=seed)
    trans = np.log(pitch.transition_matrix() + TINY).astype(np.float32)
    return obs, np.array([870], np.int32), trans, None


def _serial_ties(seed):
    rng = np.random.default_rng(seed)
    frames, states, lo, width = 24, 40, -4, 9
    obs = rng.integers(-3, 1, size=(1, frames, states)).astype(np.float32)
    trans = np.full((states, states), np.log(np.float32(TINY)), np.float32)
    rows = np.arange(states)
    for d in range(width):
        cols = rows + lo + d
        keep = (cols >= 0) & (cols < states)
        trans[rows[keep], cols[keep]] = rng.integers(
            -2, 1, size=int(keep.sum()))
    return obs, np.array([19], np.int32), trans, None


# The cases decoded on the serial batch-1 route
SERIAL = ('serial-pitch', 'serial-ties')

CASES = tuple(
    Case(f'edge-{edge.name}', True, 0, _edge(edge))
    for edge in edges.BAND_EDGES) + (
    Case('pitch-log', True, 11, _pitch_log),
    Case('pitch-prob', False, 12, _pitch_prob),
    Case('tiny-entries', True, 13, _tiny_entries),
    Case('dense', True, 14, _dense),
    Case('autochunk-pitch', True, 15, _autochunk_pitch),
    Case('serial-pitch', True, 16, _serial_pitch),
    Case('serial-ties', True, 17, _serial_ties),
)


def case_inputs(case):
    """The case's inputs: (observation, batch_frames, transition, initial)
    numpy arrays, transition and initial None for the defaults"""
    return case.make(case.seed)


def inputs_hash(case, inputs):
    """SHA-256 (hex) of the case's inputs and ``log_probs``"""
    digest = hashlib.sha256(f'{case.name} {case.log_probs}'.encode())
    for array in inputs:
        if array is None:
            digest.update(b'default')
        else:
            array = np.ascontiguousarray(array)
            digest.update(f'{array.dtype} {array.shape}'.encode())
            digest.update(array.tobytes())
    return digest.hexdigest()


def decode(case, inputs, gpu):
    """The case through this package's ``from_probabilities`` on ``gpu``
    (an index or 'cpu'): (batch, frames) int32 on that device"""
    import torbi_tpu_torch

    observation, batch_frames, transition, initial = inputs
    return torbi_tpu_torch.from_probabilities(
        observation, batch_frames=batch_frames, transition=transition,
        initial=initial, log_probs=case.log_probs, gpu=gpu)


def load(path=ASSET):
    """{case name: (paths int32 (batch, frames), inputs hash)} of the
    committed file"""
    with np.load(path) as data:
        return {name[:-len('.paths')]: (
                    data[name].astype(np.int32),
                    str(data[name[:-len('.paths')] + '.sha256']))
                for name in data.files if name.endswith('.paths')}


def save(records, path=ASSET):
    """Write {case name: (paths, inputs hash)}; paths are stored as int16"""
    arrays = {}
    for name, (paths, digest) in records.items():
        paths = np.asarray(paths)
        if paths.min() < 0 or paths.max() > np.iinfo(np.int16).max:
            raise ValueError(f'{name}: paths do not fit int16')
        arrays[f'{name}.paths'] = paths.astype(np.int16)
        arrays[f'{name}.sha256'] = np.array(digest)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)
