"""The port's evaluation harness (``torbi_tpu_torch.evaluate``) against
torbi_tpu's, on the CPU.

A synthetic corpus of 1440-state pitch posteriorgrams (the clipped walks
of ``models/pitch.py``) goes through both harnesses, each with its own
reference pass: the scores, the frame counts and every output file are
equal. Also: the chunked self-consistency mode, the resume path (kept
reference outputs are reused) and the refusal to run without CUDA unless
the CPU is asked for. A multi-process world: tests/test_torch_multiprocess.py.
"""
import json

import numpy as np
import pytest
import torch

import torbi_tpu
import torbi_tpu_torch
from torbi_tpu.utils import io as jax_io
from torbi_tpu_torch.evaluate import core
from torbi_tpu_torch.models import pitch
from torbi_tpu_torch.utils import io

DATASET = 'synth'


def corpus(root, lengths, seed=0):
    """The cache and partition of a corpus under ``root``; returns stems"""
    cache = root / 'cache' / DATASET
    cache.mkdir(parents=True)
    stems = [f'{i:06d}' for i in range(len(lengths))]
    for i, (stem, frames) in enumerate(zip(stems, lengths)):
        obs = pitch.synthetic_posteriorgrams(1, frames, seed=seed + i)[0]
        torch.save(torch.from_numpy(obs), cache / f'{stem}.pt')
    (root / 'partitions').mkdir()
    with open(root / 'partitions' / f'{DATASET}.json', 'w') as file:
        json.dump(stems, file)
    return stems


def point(monkeypatch, package, root, work):
    """Point a package's harness at the corpus under ``root``, its outputs
    under ``work``"""
    monkeypatch.setattr(package, 'CACHE_DIR', root / 'cache')
    monkeypatch.setattr(package, 'EVAL_DIR', work / 'eval')
    monkeypatch.setattr(package, 'PARTITION_DIR', root / 'partitions')
    monkeypatch.setattr(
        package, 'PITCH_TRANSITION_MATRIX', work / 'stats' / 'transition.pt')


def test_datasets_equal_jax(tmp_path, monkeypatch):
    stems = corpus(tmp_path, (64, 97, 128, 80, 71))
    point(monkeypatch, torbi_tpu_torch, tmp_path, tmp_path / 'port')
    point(monkeypatch, torbi_tpu, tmp_path, tmp_path / 'jax')
    got = torbi_tpu_torch.evaluate.datasets([DATASET], gpu='cpu')[DATASET]
    want = torbi_tpu.evaluate.datasets([DATASET], num_threads=1)[DATASET]
    assert got['rpa'] == want['rpa']
    assert got['rpa']['0'] == pytest.approx(1.0)
    assert got['frames'] == want['frames'] == 64 + 97 + 128 + 80 + 71
    assert {'torbi', 'librosa'} <= set(got['rtf'])
    assert got['timesteps_per_second']['torbi'] > 0
    for subdir, jax_subdir in (('torbi_tpu_torch', 'torbi_tpu'),
                               ('reference', 'reference')):
        for stem in stems:
            path = io.load(
                tmp_path / 'port' / 'eval' / DATASET / subdir / f'{stem}.pt')
            expected = jax_io.load(
                tmp_path / 'jax' / 'eval' / DATASET / jax_subdir
                / f'{stem}.pt')
            assert path.dtype == expected.dtype == np.int32
            np.testing.assert_array_equal(path, expected)
    written = json.loads(
        (tmp_path / 'port' / 'eval' / 'torbi_tpu_torch.json').read_text())
    assert written[DATASET]['rpa'] == got['rpa']


def test_chunked_self_consistency(tmp_path, monkeypatch):
    """COMPARE_WITH_REFERENCE False scores chunked decoding against the
    package's own unchunked outputs: entropy chunking of peaked
    posteriorgrams keeps the path"""
    corpus(tmp_path, (48, 48), seed=5)
    point(monkeypatch, torbi_tpu_torch, tmp_path, tmp_path)
    monkeypatch.setattr(torbi_tpu_torch, 'COMPARE_WITH_REFERENCE', False)
    torbi_tpu_torch.evaluate.datasets([DATASET], gpu='cpu')
    monkeypatch.setattr(torbi_tpu_torch, 'CONFIG', 'chunked')
    monkeypatch.setattr(torbi_tpu_torch, 'MIN_CHUNK_SIZE', 16)
    results = torbi_tpu_torch.evaluate.datasets([DATASET], gpu='cpu')
    assert results[DATASET]['rpa']['0'] == pytest.approx(1.0)
    assert (tmp_path / 'eval' / DATASET / 'chunked').is_dir()


def test_resume_reuses_reference_outputs(tmp_path, monkeypatch):
    stems = corpus(tmp_path, (20, 33, 27))
    point(monkeypatch, torbi_tpu_torch, tmp_path, tmp_path)
    decoded = []
    original = torbi_tpu_torch.reference.from_files_to_files

    def spy(input_files, output_files, **kwargs):
        decoded.append([p.stem for p in output_files])
        return original(input_files, output_files, **kwargs)

    monkeypatch.setattr(torbi_tpu_torch.reference, 'from_files_to_files', spy)
    first = torbi_tpu_torch.evaluate.datasets([DATASET], gpu='cpu')
    torbi_tpu_torch.evaluate.datasets([DATASET], gpu='cpu')
    (tmp_path / 'eval' / DATASET / 'reference' / f'{stems[1]}.pt').unlink()
    third = torbi_tpu_torch.evaluate.datasets([DATASET], gpu='cpu')
    assert decoded == [stems, [stems[1]]]
    assert first[DATASET]['rpa'] == third[DATASET]['rpa']


def test_no_cuda_raises_without_cpu_request(tmp_path, monkeypatch):
    corpus(tmp_path, (8,))
    point(monkeypatch, torbi_tpu_torch, tmp_path, tmp_path)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        torbi_tpu_torch.evaluate.datasets([DATASET])
    assert not (tmp_path / 'eval').exists()


def test_transition_is_cached_under_the_port(tmp_path, monkeypatch):
    """The default cache of the pitch transition lies in the port's assets;
    the file holds the pitch matrix"""
    default = torbi_tpu_torch.config.defaults.PITCH_TRANSITION_MATRIX
    assert default.parent.parent == torbi_tpu_torch.ASSETS_DIR
    assert 'torbi_tpu_torch' in default.parts
    monkeypatch.setattr(
        torbi_tpu_torch, 'PITCH_TRANSITION_MATRIX', tmp_path / 's' / 't.pt')
    np.testing.assert_array_equal(
        io.load(core._transition_file()), pitch.transition_matrix())


def test_main_applies_config_when_parsing(tmp_path, monkeypatch):
    from torbi_tpu_torch.evaluate import __main__ as cli

    override = tmp_path / 'over.py'
    override.write_text("DATASETS = ['vctk']\nCONFIG = 'over'\n")
    for name in ('DATASETS', 'CONFIG'):
        monkeypatch.setattr(
            torbi_tpu_torch, name, getattr(torbi_tpu_torch, name))
    args = cli.parse_args(['--config', str(override), '--gpu', 'cpu'])
    assert vars(args) == {'datasets': None, 'gpu': 'cpu', 'num_threads': 1}
    assert torbi_tpu_torch.DATASETS == ['vctk']
    assert torbi_tpu_torch.CONFIG == 'over'
