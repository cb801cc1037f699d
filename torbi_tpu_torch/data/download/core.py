"""Dataset download.

Counterpart of ``torbi_tpu/data/download/core.py``: downloads the daps and
vctk evaluation corpora and formats them as ``CACHE_DIR/<dataset>/
{speaker:04d}/{count:06d}.wav``. Needs network access and torchaudio, both
optional: decoding never needs them.
"""
import tarfile
import urllib.request
import zipfile

import torbi_tpu_torch
from ...utils import progress
from ...utils.notify import notify_on_finish

DAPS_URL = 'https://zenodo.org/record/4783456/files/daps-segmented.tar.gz?download=1'
VCTK_URL = (
    'https://datashare.ed.ac.uk/bitstream/handle/10283/3443/'
    'VCTK-Corpus-0.92.zip')


@notify_on_finish('download')
def datasets(datasets=None):
    """Download datasets"""
    if datasets is None:
        datasets = torbi_tpu_torch.DATASETS
    for dataset in datasets:
        if dataset == 'daps':
            daps()
        elif dataset == 'vctk':
            vctk()
        else:
            raise ValueError(f'Dataset {dataset} is not defined')


def _fetch(url, target):
    target.parent.mkdir(parents=True, exist_ok=True)
    urllib.request.urlretrieve(url, target)


def daps():
    """Download and format the daps dataset"""
    import torchaudio

    directory = torbi_tpu_torch.DATA_DIR / 'daps'
    directory.mkdir(parents=True, exist_ok=True)
    archive = directory / 'daps-segmented.tar.gz'
    if not archive.exists():
        _fetch(DAPS_URL, archive)
    with tarfile.open(archive, 'r:gz') as tar:
        tar.extractall(directory, filter='data')

    # Rename to {speaker_index:04d}/{count:06d}.wav, quiet audio
    # normalized up to a peak of 0.35
    cache = torbi_tpu_torch.CACHE_DIR / 'daps'
    cache.mkdir(parents=True, exist_ok=True)
    files = sorted(directory.rglob('*.wav'))
    speakers = {}
    counts = {}
    for file in progress.iterator(files, 'daps'):
        speaker = file.stem.split('_')[0]
        index = speakers.setdefault(speaker, len(speakers))
        count = counts.get(index, 0)
        counts[index] = count + 1
        audio, sample_rate = torchaudio.load(file)
        maximum = audio.abs().max()
        if maximum < 0.35:
            audio = audio * (0.35 / max(maximum, 1e-8))
        output = cache / f'{index:04d}'
        output.mkdir(exist_ok=True)
        torchaudio.save(output / f'{count:06d}.wav', audio, sample_rate)


def vctk():
    """Download and format the vctk dataset"""
    import json

    import torchaudio

    directory = torbi_tpu_torch.DATA_DIR / 'vctk'
    directory.mkdir(parents=True, exist_ok=True)
    archive = directory / 'vctk.zip'
    if not archive.exists():
        _fetch(VCTK_URL, archive)
    with zipfile.ZipFile(archive) as zfile:
        zfile.extractall(directory)

    cache = torbi_tpu_torch.CACHE_DIR / 'vctk'
    cache.mkdir(parents=True, exist_ok=True)
    files = sorted(directory.rglob('*.flac')) + sorted(
        directory.rglob('*.wav'))
    speakers = {}
    counts = {}
    correspondence = {}
    for file in progress.iterator(files, 'vctk'):
        speaker = file.stem.split('_')[0]
        index = speakers.setdefault(speaker, len(speakers))
        count = counts.get(index, 0)
        counts[index] = count + 1
        audio, sample_rate = torchaudio.load(file)
        audio = resample(audio, sample_rate, torbi_tpu_torch.SAMPLE_RATE)
        output = cache / f'{index:04d}'
        output.mkdir(exist_ok=True)
        name = f'{index:04d}/{count:06d}'
        torchaudio.save(
            cache / f'{name}.wav', audio, torbi_tpu_torch.SAMPLE_RATE)
        correspondence[name] = file.stem
    with open(cache / 'correspondence.json', 'w') as file:
        json.dump(correspondence, file, indent=4)


def resample(audio, sample_rate, target_rate):
    """Resample audio to the target rate"""
    import torchaudio.functional
    if sample_rate == target_rate:
        return audio
    return torchaudio.functional.resample(audio, sample_rate, target_rate)
