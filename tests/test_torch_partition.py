"""The port's partitions against torbi_tpu's: the same stems sample to the
same JSON file, and the shipped partitions are copies of torbi_tpu's."""
import pytest

import torbi_tpu
import torbi_tpu_torch


@pytest.mark.parametrize('samples', [3, 8192])
def test_same_stems_give_the_same_file(tmp_path, monkeypatch, samples):
    for speaker in ('0000', '0001', '0002'):
        (tmp_path / 'cache' / 'daps' / speaker).mkdir(parents=True)
        for utterance in range(4):
            (tmp_path / 'cache' / 'daps' / speaker
             / f'{utterance:06d}.wav').write_bytes(b'RIFF')
    for package, name in ((torbi_tpu, 'jax'), (torbi_tpu_torch, 'port')):
        monkeypatch.setattr(package, 'CACHE_DIR', tmp_path / 'cache')
        monkeypatch.setattr(package, 'PARTITION_DIR', tmp_path / name)
        monkeypatch.setattr(package, 'EVALUATION_SAMPLES', samples)
        package.partition.datasets(['daps'])
    port = (tmp_path / 'port' / 'daps.json').read_bytes()
    assert port == (tmp_path / 'jax' / 'daps.json').read_bytes()
    assert port.count(b'"') == 2 * min(samples, 12)


@pytest.mark.parametrize('dataset', ['daps', 'vctk'])
def test_shipped_partitions_are_copies(dataset):
    assert torbi_tpu_torch.PARTITION_DIR.parent == torbi_tpu_torch.ASSETS_DIR
    port = (torbi_tpu_torch.PARTITION_DIR / f'{dataset}.json').read_bytes()
    assert port == (
        torbi_tpu.PARTITION_DIR / f'{dataset}.json').read_bytes()
