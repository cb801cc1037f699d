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
  integers, so that candidates tie, with a valid length of 19 of 24;
- ``wide-*``: bands that no layout of K1's cluster design holds, so they
  take its wide-band design: a batch of three pitch sequences under the
  pitch transition of a 20 ms hop (width 347; then K3), one sequence of
  300 frames under a band of width 401 over the floor (a single sequence
  under 4096 frames: the serial batch-1 route, the band too wide for K4,
  so K1 and then K5), a batch of two at 4096 states under a band of
  the pitch band's width (175), and 192 pitch sequences of up to 12 frames
  as probabilities under the 20 ms hop's transition (a pure band of width
  347): on 132 SMs its launch plan gives each output fewer than four
  lanes, so the kernel converts the observation on its straight-run
  branch, which the smaller batches do not reach.

Every case decodes through ``from_probabilities`` with its ``log_probs``.

The file cases (``FILE_CASES``) decode through ``from_files_to_files``
instead: their observations are written as log-space ``.npy`` files and
the transition as a probability file (which the file API takes to
``log(p + tiny)``), and their paths are the output files joined in input
order:

- ``files-pitch``: five pitch sequences of mixed lengths (1 to 192 frames)
  at 1440 states, one batch of the native loader (K1, K3);
- ``files-chunked``: one pitch sequence of 1024 frames decoded with
  ``MIN_CHUNK_SIZE`` 128, so that its chunks decode as rows of one batch
  and are joined again.
"""
import hashlib
import tempfile
from collections import namedtuple
from pathlib import Path

import numpy as np

from . import edges
from . import io
from ..models import pitch

TINY = np.finfo(np.float32).tiny
ASSET = Path(__file__).resolve().parent.parent / 'assets' / \
    'reference_paths.npz'

# make(seed) -> (observation, batch_frames, transition, initial), numpy;
# transition and initial may be None (the entry point's uniform defaults)
Case = namedtuple('Case', 'name log_probs seed make')


def triangular_band(states, halfwidth, tiny=TINY):
    """A row-normalized triangular band transition of the given half-width
    (``tests/test_autochunk.py``'s) in probability space, float32, plus
    ``tiny`` everywhere: 0 gives a pure band"""
    bins = np.arange(states)
    tri = np.clip(halfwidth + 1.0 - np.abs(bins[:, None] - bins[None, :]),
                  0, None)
    return ((tri / tri.sum(axis=1, keepdims=True)).astype(np.float32)
            + np.float32(tiny))


def triangular_log(states, halfwidth, tiny=TINY):
    """log of ``triangular_band``: a band over log(tiny), or at tiny 0 a
    pure -inf band"""
    with np.errstate(divide='ignore'):
        return np.log(triangular_band(states, halfwidth, tiny))


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
    trans = triangular_log(states, halfwidth)
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


def _wide_pitch_20ms(seed):
    obs = pitch.synthetic_posteriorgrams(3, 128, pitch.PITCH_BINS, seed=seed)
    trans = np.log(pitch.transition_matrix(hopsize=160) + TINY).astype(
        np.float32)
    return obs, np.array([128, 77, 1], np.int32), trans, None


def _wide_serial(seed):
    obs = pitch.synthetic_posteriorgrams(1, 300, pitch.PITCH_BINS, seed=seed)
    return (obs, np.array([300], np.int32),
            triangular_log(pitch.PITCH_BINS, 200), None)


def _wide_4096(seed):
    rng = np.random.default_rng(seed)
    states = 4096
    obs = np.log(rng.dirichlet(np.ones(states), size=(2, 32))
                 .astype(np.float32) + TINY).astype(np.float32)
    return obs, np.array([32, 21], np.int32), triangular_log(
        states, 87), None


def _wide_batch_prob(seed):
    batch, frames = 192, 12
    obs = np.exp(pitch.synthetic_posteriorgrams(
        batch, frames, pitch.PITCH_BINS, seed=seed))
    lengths = np.random.default_rng(seed).integers(
        1, frames + 1, size=batch).astype(np.int32)
    lengths[:2] = (frames, 1)
    return (obs.astype(np.float32), lengths,
            pitch.transition_matrix(hopsize=160), None)


# The cases decoded on the serial batch-1 route
SERIAL = ('serial-pitch', 'serial-ties')
# The cases that take K1's wide-band design; the first also K5
WIDE_SERIAL = ('wide-serial',)
WIDE = WIDE_SERIAL + ('wide-pitch-20ms', 'wide-4096', 'wide-batch-prob')

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
    Case('wide-pitch-20ms', True, 18, _wide_pitch_20ms),
    Case('wide-serial', True, 19, _wide_serial),
    Case('wide-4096', True, 20, _wide_4096),
    Case('wide-batch-prob', False, 21, _wide_batch_prob),
)


# make(seed) -> (observations, a list of (frames, states) numpy arrays;
# the transition in probability space, or None for the uniform default);
# min_chunk_size is MIN_CHUNK_SIZE during the decode
FileCase = namedtuple('FileCase', 'name log_probs seed min_chunk_size make')


def _files_pitch(seed):
    lengths = (192, 37, 1, 150, 96)
    return ([pitch.synthetic_posteriorgrams(
                1, frames, pitch.PITCH_BINS, seed=seed + i)[0]
             for i, frames in enumerate(lengths)],
            pitch.transition_matrix())


def _files_chunked(seed):
    return ([pitch.synthetic_posteriorgrams(
                1, 1024, pitch.PITCH_BINS, seed=seed)[0]],
            pitch.transition_matrix())


FILE_CASES = (
    FileCase('files-pitch', True, 22, None, _files_pitch),
    FileCase('files-chunked', True, 23, 128, _files_chunked),
)


def file_inputs_hash(case, inputs):
    """SHA-256 (hex) of a file case's inputs, ``log_probs`` and
    ``min_chunk_size``"""
    observations, transition = inputs
    return inputs_hash(case, (
        *observations, transition,
        np.array([case.min_chunk_size or 0], np.int64)))


def decode_files(package, case, inputs, **kwargs):
    """A file case through ``package.from_files_to_files`` (this package or
    the JAX one, with ``MIN_CHUNK_SIZE`` set to the case's for the call),
    in a temporary directory: the output files' paths joined in input
    order, int32 numpy"""
    observations, transition = inputs
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        input_files, output_files = [], []
        for i, observation in enumerate(observations):
            np.save(tmp / f'{i}.npy', observation)
            input_files.append(tmp / f'{i}.npy')
            output_files.append(tmp / f'{i}_out.npy')
        transition_file = None
        if transition is not None:
            transition_file = tmp / 'transition.npy'
            np.save(transition_file, transition)
        saved = package.MIN_CHUNK_SIZE
        package.MIN_CHUNK_SIZE = case.min_chunk_size
        try:
            package.from_files_to_files(
                input_files, output_files, transition_file=transition_file,
                log_probs=case.log_probs, **kwargs)
        finally:
            package.MIN_CHUNK_SIZE = saved
        return np.concatenate([
            io.load(path) for path in output_files]).astype(np.int32)


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
