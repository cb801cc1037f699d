"""The committed reference paths (torbi_tpu_torch/assets/reference_paths.npz)
against torbi_tpu, and the port's CPU route against them.

Each case of ``torbi_tpu_torch/utils/fixtures.py`` is decoded through
``torbi_tpu.from_probabilities`` on the CPU, as the port's other tests run
it: the scan route for every case but two kinds. The long pitch sequence
goes through the kernel backend in interpret mode as
``tests/test_torch_autochunk.py`` runs it, with the JAX package's default
frame buckets (the ones the port's auto-chunk rule copies), so that both
packages decode it as entropy-chunk rows. The serial cases go through its
serial batch-1 route (spread forward, fused chase) in interpret mode, as
the port's go through K4 and K5. The file cases go through
``torbi_tpu.from_files_to_files`` on the scan route (``backend='xla'``) and
the port's ``from_files_to_files`` on the CPU. The committed file must
equal those paths and hold the hash of the inputs they came from; the
port's entry points on the CPU must return the same paths, bitwise.
``chip_smoke.py`` holds the card to the same file.

    python tests/test_torch_fixtures.py --write

rewrites the file (the writer lives here: only tests import torbi_tpu).
"""
import os
import sys

if __name__ == '__main__':
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import torbi_tpu  # noqa: E402
import torbi_tpu_torch  # noqa: E402
from torbi_tpu.config import defaults as jax_defaults  # noqa: E402
from torbi_tpu.ops import autochunk as jax_autochunk  # noqa: E402
from torbi_tpu_torch.ops import autochunk, dispatch  # noqa: E402
from torbi_tpu_torch.utils import fixtures  # noqa: E402

AUTOCHUNK = 'autochunk-pitch'
CASES = {case.name: case for case in fixtures.CASES}
FILE_CASES = {case.name: case for case in fixtures.FILE_CASES}


def _engaged(module):
    """Wrap ``module.decode_chunked``; returns (restore, engaged list)"""
    orig = module.decode_chunked
    engaged = []

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        engaged.append(out is not None)
        return out

    module.decode_chunked = spy
    return (lambda: setattr(module, 'decode_chunked', orig)), engaged


def serial_reference_paths(case):
    """torbi_tpu's path for a serial case, through its serial batch-1
    route (the spread forward, then the fused chase) in interpret mode"""
    from torbi_tpu.ops import backtrace as jax_backtrace

    observation, batch_frames, transition, initial = fixtures.case_inputs(case)
    orig = jax_backtrace.backtrace_posteriors12_fused1
    engaged = []

    def spy(*args, **kwargs):
        engaged.append(True)
        return orig(*args, **kwargs)

    jax_backtrace.backtrace_posteriors12_fused1 = spy
    try:
        paths = np.asarray(torbi_tpu.from_probabilities(
            observation, batch_frames=batch_frames, transition=transition,
            initial=initial, log_probs=case.log_probs, backend='pallas'))
    finally:
        jax_backtrace.backtrace_posteriors12_fused1 = orig
    assert engaged, 'torbi_tpu did not take its fused batch-1 chase'
    return paths


def reference_paths(case):
    """torbi_tpu's path for ``case`` on the CPU, int32 numpy"""
    observation, batch_frames, transition, initial = fixtures.case_inputs(case)
    if case.name in fixtures.SERIAL:
        return serial_reference_paths(case)
    if case.name != AUTOCHUNK:
        return np.asarray(torbi_tpu.from_probabilities(
            observation, batch_frames=batch_frames, transition=transition,
            initial=initial, log_probs=case.log_probs, backend='xla'))
    saved = {name: getattr(torbi_tpu, name)
             for name in ('FRAME_BUCKETS', 'BAND_KERNEL_LAYOUT')}
    restore, engaged = _engaged(jax_autochunk)
    try:
        torbi_tpu.FRAME_BUCKETS = tuple(jax_defaults.FRAME_BUCKETS)
        # The natural-layout kernel computes the stitched one's values and
        # builds faster in interpret mode
        torbi_tpu.BAND_KERNEL_LAYOUT = 'rolled'
        paths = np.asarray(torbi_tpu.from_probabilities(
            observation, batch_frames=batch_frames, transition=transition,
            initial=initial, log_probs=case.log_probs, backend='pallas'))
    finally:
        restore()
        for name, value in saved.items():
            setattr(torbi_tpu, name, value)
    assert engaged == [True], 'torbi_tpu did not auto-chunk the sequence'
    return paths


def file_reference_paths(case):
    """torbi_tpu's joined output paths for a file case, through its
    from_files_to_files on the scan route"""
    return fixtures.decode_files(
        torbi_tpu, case, fixtures.case_inputs(case), backend='xla')


@pytest.fixture(scope='module')
def committed():
    return fixtures.load()


def test_file_lists_every_case(committed):
    assert sorted(committed) == sorted([*CASES, *FILE_CASES])


@pytest.mark.parametrize('name', list(FILE_CASES))
def test_committed_file_paths_are_current(committed, name):
    """The file holds torbi_tpu's joined output paths for the file case's
    current inputs"""
    case = FILE_CASES[name]
    paths, digest = committed[name]
    assert digest == fixtures.file_inputs_hash(
        case, fixtures.case_inputs(case)), (
        f'{name}: the inputs changed; rewrite the file with '
        '`python tests/test_torch_fixtures.py --write`')
    np.testing.assert_array_equal(paths, file_reference_paths(case))


@pytest.mark.parametrize('name', list(FILE_CASES))
def test_port_cpu_files_match(committed, name):
    """The port's from_files_to_files on the CPU writes the committed
    paths, bitwise; the chunked case as chunk rows joined again"""
    case = FILE_CASES[name]
    inputs = fixtures.case_inputs(case)
    got = fixtures.decode_files(torbi_tpu_torch, case, inputs, gpu='cpu')
    assert got.shape == (sum(len(obs) for obs in inputs[0]),)
    np.testing.assert_array_equal(got, committed[name][0])


@pytest.mark.parametrize('name', list(CASES))
def test_committed_paths_are_current(committed, name):
    """The file holds torbi_tpu's path for the case's current inputs"""
    case = CASES[name]
    paths, digest = committed[name]
    assert digest == fixtures.inputs_hash(case, fixtures.case_inputs(case)), (
        f'{name}: the inputs changed; rewrite the file with '
        '`python tests/test_torch_fixtures.py --write`')
    np.testing.assert_array_equal(paths, reference_paths(case))


@pytest.mark.parametrize('name', list(CASES))
def test_port_cpu_route_matches(committed, name):
    """The port's from_probabilities on the CPU returns the committed path,
    bitwise; the long sequence through its auto-chunk route, the single
    sequences through the fused batch-1 chase"""
    case = CASES[name]
    restore, engaged = _engaged(autochunk)
    chases = []
    orig = dispatch.backtrace_fused1
    dispatch.backtrace_fused1 = lambda *args: chases.append(1) or orig(*args)
    try:
        got = fixtures.decode(case, fixtures.case_inputs(case), 'cpu')
    finally:
        restore()
        dispatch.backtrace_fused1 = orig
    assert got.dtype == torch.int32 and got.device.type == 'cpu'
    assert engaged == ([True] if name == AUTOCHUNK else [])
    assert bool(chases) == (name in fixtures.SERIAL + fixtures.WIDE_SERIAL)
    np.testing.assert_array_equal(got.numpy(), committed[name][0])


def test_cases_hold_the_subnormal_inputs():
    """The pitch cases hold log(tiny) entries (log space) and 0 < p < tiny
    entries (probability space); tiny-entries whole frames of log(tiny)"""
    tiny = np.finfo(np.float32).tiny
    log_obs = fixtures.case_inputs(CASES['pitch-log'])[0]
    prob_obs = fixtures.case_inputs(CASES['pitch-prob'])[0]
    tiny_obs = fixtures.case_inputs(CASES['tiny-entries'])[0]
    assert (log_obs == np.log(np.float32(tiny))).any()
    assert ((prob_obs > 0) & (prob_obs < tiny)).any()
    assert (tiny_obs[:, 5] == np.log(np.float32(tiny))).all()


def test_save_load_round_trip(tmp_path):
    records = {'a': (np.array([[0, 1439, 7]]), 'x' * 64)}
    fixtures.save(records, tmp_path / 'paths.npz')
    loaded = fixtures.load(tmp_path / 'paths.npz')
    assert list(loaded) == ['a'] and loaded['a'][1] == 'x' * 64
    assert loaded['a'][0].dtype == np.int32
    np.testing.assert_array_equal(loaded['a'][0], records['a'][0])
    with pytest.raises(ValueError):
        fixtures.save({'b': (np.array([40000]), '')}, tmp_path / 'bad.npz')


def write():
    """Rewrite the committed file from torbi_tpu's paths"""
    records = {}
    for case in fixtures.CASES:
        inputs = fixtures.case_inputs(case)
        records[case.name] = (reference_paths(case),
                              fixtures.inputs_hash(case, inputs))
        print(f'{case.name}: {records[case.name][0].shape}', flush=True)
    for case in fixtures.FILE_CASES:
        records[case.name] = (
            file_reference_paths(case),
            fixtures.file_inputs_hash(case, fixtures.case_inputs(case)))
        print(f'{case.name}: {records[case.name][0].shape}', flush=True)
    fixtures.save(records)
    print(f'wrote {fixtures.ASSET}')


if __name__ == '__main__':
    if sys.argv[1:] != ['--write']:
        sys.exit('usage: python tests/test_torch_fixtures.py --write')
    import jax

    jax.config.update('jax_platforms', 'cpu')
    write()
