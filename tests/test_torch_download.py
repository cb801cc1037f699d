"""The port's downloaders (``data/download``) with stubs: the fetch step
copies a prepared archive (nothing goes to the network) and a minimal
torchaudio stands in for the real one, so that the extract, rename and
normalize steps run. The URLs are torbi_tpu's."""
import json
import sys
import tarfile
import types
import zipfile

import pytest
import torch

import torbi_tpu_torch
from torbi_tpu.data.download import core as jax_download
from torbi_tpu_torch.data.download import core as download


class _FakeTorchaudio(types.ModuleType):
    """Just enough of torchaudio for the download formatters"""

    def __init__(self):
        super().__init__('torchaudio')
        self.saved = {}
        self.functional = types.SimpleNamespace(
            resample=lambda audio, sr, target: audio)

    def load(self, path):
        return torch.full((1, 100), 0.1), 22050

    def save(self, path, audio, sample_rate):
        self.saved[str(path)] = (audio.clone(), sample_rate)


@pytest.fixture
def fake_torchaudio(monkeypatch, tmp_path):
    fake = _FakeTorchaudio()
    monkeypatch.setitem(sys.modules, 'torchaudio', fake)
    monkeypatch.setitem(sys.modules, 'torchaudio.functional', fake.functional)
    monkeypatch.setattr(torbi_tpu_torch, 'DATA_DIR', tmp_path / 'data')
    monkeypatch.setattr(torbi_tpu_torch, 'CACHE_DIR', tmp_path / 'cache')
    return fake


def stub_fetch(monkeypatch, url, archive):
    def fetch(got_url, target):
        assert got_url == url
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_bytes(archive.read_bytes())

    monkeypatch.setattr(download, '_fetch', fetch)


def test_urls_are_jax():
    assert download.DAPS_URL == jax_download.DAPS_URL
    assert download.VCTK_URL == jax_download.VCTK_URL


def test_daps_formats_archive(fake_torchaudio, monkeypatch, tmp_path):
    src = tmp_path / 'src'
    src.mkdir()
    for name in ['f1_script1_clean.wav', 'f1_script2_clean.wav',
                 'm3_script1_clean.wav']:
        (src / name).write_bytes(b'RIFFfake')
    archive = tmp_path / 'daps-segmented.tar.gz'
    with tarfile.open(archive, 'w:gz') as tar:
        for file in sorted(src.iterdir()):
            tar.add(file, arcname=f'daps-segmented/{file.name}')
    stub_fetch(monkeypatch, download.DAPS_URL, archive)
    download.datasets(['daps'])

    cache = torbi_tpu_torch.CACHE_DIR / 'daps'
    # Two speakers (f1, m3), renamed {speaker:04d}/{count:06d}.wav
    assert sorted(p.name for p in cache.iterdir()) == ['0000', '0001']
    saved = sorted(fake_torchaudio.saved)
    assert [path[-15:] for path in saved] == [
        '0000/000000.wav', '0000/000001.wav', '0001/000000.wav']
    # Quiet audio (peak 0.1 < 0.35) is normalized up to 0.35
    audio, _ = fake_torchaudio.saved[saved[0]]
    assert float(audio.abs().max()) == pytest.approx(0.35)


def test_vctk_formats_archive(fake_torchaudio, monkeypatch, tmp_path):
    archive = tmp_path / 'vctk.zip'
    with zipfile.ZipFile(archive, 'w') as zfile:
        zfile.writestr('wav48/p225/p225_001_mic2.flac', b'fLaCfake')
        zfile.writestr('wav48/p226/p226_001_mic2.flac', b'fLaCfake')
    stub_fetch(monkeypatch, download.VCTK_URL, archive)
    download.datasets(['vctk'])

    cache = torbi_tpu_torch.CACHE_DIR / 'vctk'
    correspondence = json.loads(
        (cache / 'correspondence.json').read_text())
    assert correspondence == {
        '0000/000000': 'p225_001_mic2', '0001/000000': 'p226_001_mic2'}
    assert all(rate == torbi_tpu_torch.SAMPLE_RATE
               for _, rate in fake_torchaudio.saved.values())


def test_datasets_rejects_unknown():
    with pytest.raises(ValueError):
        download.datasets(['nonsense'])
