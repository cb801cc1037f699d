"""The port's command line, ``python -m torbi_tpu_torch``, against
``python -m torbi_tpu`` on the same files, and its ``--config`` overrides.

Each CLI runs in a subprocess, the port's with ``--gpu cpu`` (the kernels'
plain versions); the output files must be equal bitwise. The port's
subprocess also reports the modules it loaded: neither JAX nor torbi_tpu.
"""
import json
import subprocess
import sys

import numpy as np
import pytest

import torbi_tpu_torch
from torbi_tpu_torch import __main__ as cli
from torbi_tpu_torch.config import core as config_core
from torbi_tpu_torch.models import pitch
from torbi_tpu_torch.utils import io

STATES = 192

# Runs a module as __main__ with the given argv, then prints the JAX and
# torbi_tpu modules loaded (the port's CLI must load none)
RUN = (
    'import json, runpy, sys; '
    'sys.argv = json.loads(sys.argv[1]); '
    'runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True); '
    'print(json.dumps([m for m in sys.modules if m == "jax" '
    'or m.startswith("jax.") or m == "torbi_tpu" '
    'or m.startswith("torbi_tpu.")]))')

JAX_ENV = (
    "import os; os.environ['JAX_PLATFORMS'] = 'cpu'; "
    "import jax; jax.config.update('jax_platforms', 'cpu'); ")


def run(module, args, preamble=''):
    result = subprocess.run(
        [sys.executable, '-c', preamble + RUN,
         json.dumps([module, *map(str, args)])],
        capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-4000:]
    return result


def corpus(tmp_path, lengths=(60, 1, 140, 33)):
    files = []
    for i, frames in enumerate(lengths):
        files.append(tmp_path / f'obs{i}.npy')
        np.save(files[-1], pitch.synthetic_posteriorgrams(
            1, frames, STATES, seed=i)[0])
    transition = tmp_path / 'transition.npy'
    bins = np.arange(STATES)
    trans = np.clip(9.0 - np.abs(bins[:, None] - bins[None, :]), 0, None)
    np.save(transition, (trans / trans.sum(axis=1, keepdims=True)).astype(
        np.float32))
    return files, transition


def decode_both(tmp_path, extra=()):
    files, transition = corpus(tmp_path)
    results = {}
    for module, preamble, device in (
            ('torbi_tpu_torch', '', ['--gpu', 'cpu']),
            ('torbi_tpu', JAX_ENV, [])):
        out = [tmp_path / f'{f.stem}-{module}.npy' for f in files]
        result = run(module, [
            '--input_files', *files, '--output_files', *out,
            '--transition_file', transition, '--log_probs', *device,
            *extra], preamble)
        results[module] = (out, result)
    for got, want in zip(results['torbi_tpu_torch'][0],
                         results['torbi_tpu'][0]):
        got, want = io.load(got), io.load(want)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    loaded = json.loads(
        results['torbi_tpu_torch'][1].stdout.strip().splitlines()[-1])
    assert loaded == [], f'the port\'s CLI loaded {loaded}'
    return results


def test_cli_equals_jax_cli(tmp_path):
    results = decode_both(tmp_path)
    assert 'torbi_tpu_torch: 4/4' in results['torbi_tpu_torch'][1].stderr


def test_cli_with_config_equals_jax_cli(tmp_path):
    """A --config file that sets BATCH_SIZE (several batches), chunking and
    the experiment name applies in both CLIs before the decode"""
    config = tmp_path / 'over.py'
    config.write_text(
        'BATCH_SIZE = 2\nMIN_CHUNK_SIZE = 32\nCONFIG = "custom"\n')
    results = decode_both(tmp_path, ['--config', config])
    assert 'custom: 4/4' in results['torbi_tpu_torch'][1].stderr


def test_cli_config_missing_file_fails_clearly(tmp_path):
    files, _ = corpus(tmp_path, (5,))
    result = subprocess.run(
        [sys.executable, '-m', 'torbi_tpu_torch', '--input_files', *map(
            str, files), '--output_files', str(tmp_path / 'o.npy'),
         '--gpu', 'cpu', '--config', 'not-a-file'],
        capture_output=True, text=True, timeout=300)
    assert result.returncode != 0
    assert 'FileNotFoundError' in result.stderr
    assert 'override file' in result.stderr


@pytest.mark.parametrize('argv, gpu', [
    ([], None), (['--gpu', 'cpu'], 'cpu'), (['--gpu', '1'], 1)])
def test_cli_arguments(argv, gpu):
    """The reference's flags map onto from_files_to_files; --gpu takes a
    CUDA index or cpu"""
    args = cli.parse_args(
        ['--input_files', 'a.npy', 'b.npy', '--output_files', 'c.npy',
         'd.npy', '--log_probs', *argv])
    assert vars(args) == {
        'input_files': [cli.Path('a.npy'), cli.Path('b.npy')],
        'output_files': [cli.Path('c.npy'), cli.Path('d.npy')],
        'transition_file': None, 'initial_file': None, 'log_probs': True,
        'gpu': gpu, 'num_threads': 1}


def test_configure_applies_files_in_order(tmp_path, monkeypatch):
    """Later files override earlier ones; CONFIGURING is True while a file
    runs"""
    monkeypatch.setattr(torbi_tpu_torch, 'BATCH_SIZE',
                        torbi_tpu_torch.BATCH_SIZE)
    monkeypatch.setattr(torbi_tpu_torch, 'CONFIG', torbi_tpu_torch.CONFIG)
    for name in ('SEEN', 'CONFIGURING'):
        monkeypatch.setattr(torbi_tpu_torch, name, None, raising=False)
    first, second = tmp_path / 'first.py', tmp_path / 'second.py'
    first.write_text(
        'import torbi_tpu_torch\n'
        'SEEN = torbi_tpu_torch.CONFIGURING\n'
        'BATCH_SIZE = 3\nCONFIG = "first"\n_private = 1\nlower = 2\n')
    second.write_text('BATCH_SIZE = 5\n')
    config_core.configure([first, second])
    assert torbi_tpu_torch.BATCH_SIZE == 5
    assert torbi_tpu_torch.CONFIG == 'first'
    assert torbi_tpu_torch.SEEN is True
    assert torbi_tpu_torch.CONFIGURING is None
    assert not hasattr(torbi_tpu_torch, 'lower')
