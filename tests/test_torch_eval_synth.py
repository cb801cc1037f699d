"""The port's synthetic evaluation script
(``torbi_tpu_torch/scripts/eval_synth.py``): its corpus files are bitwise
the repo's JAX script's for the same seed, its default work directory is
its own, and the artifact's name follows ``--config-name``, else the
CONFIG of a ``--config`` file, else ``synth-h100`` (so a composed run
never overwrites the canonical file)."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import torbi_tpu_torch
from torbi_tpu_torch.scripts import eval_synth
from torbi_tpu_torch.utils import io

_JAX_SCRIPT = (Path(__file__).resolve().parent.parent / 'scripts'
               / 'eval_synth.py')
_NAMES = (
    'CONFIG', 'ROOT_DIR', 'CACHE_DIR', 'EVAL_DIR', 'PARTITION_DIR',
    'PITCH_TRANSITION_MATRIX', 'DATASETS', 'EVALUATION_SAMPLES',
    'BATCH_SIZE', 'MIN_CHUNK_SIZE', 'EVAL_BACKEND')


def jax_script():
    spec = importlib.util.spec_from_file_location('jax_eval_synth', _JAX_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_corpus_equals_jax_script(tmp_path):
    jax = jax_script()
    assert eval_synth.DATASET_SEEDS == jax.DATASET_SEEDS
    assert eval_synth.DATASET_FILES == jax.DATASET_FILES
    seed = eval_synth.DATASET_SEEDS['synthdaps']
    port = eval_synth.build_corpus(
        tmp_path / 'port', 'synthdaps', 3, 128, 512, seed)
    want = jax.build_corpus(tmp_path / 'jax', 'synthdaps', 3, 128, 512, seed)
    assert port == want
    for name in ('partitions/synthdaps.json', 'cache/synthdaps_meta.json'):
        assert ((tmp_path / 'port' / name).read_bytes()
                == (tmp_path / 'jax' / name).read_bytes())
    for stem in port[0]:
        path = f'cache/synthdaps/{stem}.pt'
        got = io.load(tmp_path / 'port' / path)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, io.load(tmp_path / 'jax' / path))


def test_default_workdir_is_its_own(monkeypatch):
    """The stale-corpus cleanup never reaches the JAX script's corpora"""
    seen = {}
    monkeypatch.setattr(
        eval_synth, 'build_corpus',
        lambda workdir, *args, **kwargs: seen.setdefault('workdir', workdir)
        and ([], []))
    monkeypatch.setattr(eval_synth, 'reference_pass', lambda *args: None)
    for name in _NAMES:
        monkeypatch.setattr(
            torbi_tpu_torch, name, getattr(torbi_tpu_torch, name))
    eval_synth.main(['--reference-only', '--datasets', 'synthdaps'])
    assert seen['workdir'].parts[-3:] == (
        '.cache', 'torbi_tpu_torch', 'synth_eval')


@pytest.mark.parametrize('flags,name', [
    ([], 'synth-h100'),
    (['--config', 'OVER'], 'composed-run'),
    (['--config', 'OVER', '--config-name', 'named'], 'named'),
])
def test_artifact_name(tmp_path, monkeypatch, flags, name):
    for key in _NAMES:
        monkeypatch.setattr(
            torbi_tpu_torch, key, getattr(torbi_tpu_torch, key))
    monkeypatch.setattr(torbi_tpu_torch, 'ROOT_DIR', tmp_path / 'root')
    (tmp_path / 'root').mkdir()
    override = tmp_path / 'over.py'
    override.write_text("CONFIG = 'composed-run'\nBATCH_SIZE = 2\n")
    flags = [str(override) if flag == 'OVER' else flag for flag in flags]
    results = eval_synth.main(flags + [
        '--files', '3', '--min-frames', '6', '--max-frames', '12',
        '--datasets', 'synthdaps', '--workdir', str(tmp_path / 'work'),
        '--gpu', 'cpu'])
    assert results['synthdaps']['rpa']['0'] == pytest.approx(1.0)
    written = sorted(p.name for p in (tmp_path / 'root' / 'eval').iterdir())
    assert written == [f'{name}.json']
    assert json.loads((tmp_path / 'root' / 'eval' / f'{name}.json')
                      .read_text()) == results
