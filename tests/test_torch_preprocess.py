"""The port's preprocessing (``data/preprocess``) with a stubbed penn: the
audio -> batched inference -> log-softmax -> cache pipeline runs on the
CPU when asked, and its saved posteriorgram is the normalized
concatenation of every inference batch, as torbi_tpu's. Without CUDA and
without a CPU request it raises."""
import sys
import types

import numpy as np
import pytest
import torch

import torbi_tpu
import torbi_tpu_torch
from torbi_tpu.data.preprocess import core as jax_preprocess
from torbi_tpu_torch.data.preprocess import core as preprocess
from torbi_tpu_torch.utils import io


@pytest.fixture
def stub_modules(monkeypatch, tmp_path):
    batches = [torch.randn(3, 5, 1, generator=torch.Generator().manual_seed(
        i)) for i in range(2)]
    devices = []

    def infer(frames):
        devices.append(frames.device)
        return frames

    penn = types.ModuleType('penn')
    penn.preprocess = lambda audio, sample_rate, batch_size, center: iter(
        batches)
    penn.infer = infer
    monkeypatch.setitem(sys.modules, 'penn', penn)
    torchaudio = types.ModuleType('torchaudio')
    torchaudio.load = lambda path: (torch.zeros(1, 160), 16000)
    monkeypatch.setitem(sys.modules, 'torchaudio', torchaudio)
    for package, name in ((torbi_tpu_torch, 'port'), (torbi_tpu, 'jax')):
        (tmp_path / name / 'stub').mkdir(parents=True)
        (tmp_path / name / 'stub' / '000000.wav').write_bytes(b'RIFFfake')
        monkeypatch.setattr(package, 'CACHE_DIR', tmp_path / name)
    return devices


def test_preprocess_equals_jax(stub_modules, tmp_path):
    preprocess.datasets(['stub'], gpu='cpu')
    jax_preprocess.datasets(['stub'])
    saved = io.load(tmp_path / 'port' / 'stub' / '000000.pt')
    assert saved.shape == (6, 5)
    np.testing.assert_array_equal(
        saved, io.load(tmp_path / 'jax' / 'stub' / '000000.pt'))
    np.testing.assert_allclose(np.exp(saved).sum(axis=1), 1.0, rtol=1e-5)
    assert {device.type for device in stub_modules} == {'cpu'}


def test_no_cuda_raises_without_cpu_request(stub_modules, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        preprocess.datasets(['stub'])
    assert stub_modules == []


def test_without_penn_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, 'penn', None)
    with pytest.raises(ImportError, match='penn is required'):
        preprocess.datasets(['stub'], gpu='cpu')
