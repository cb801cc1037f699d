"""Evaluation partitions.

Counterpart of ``torbi_tpu/partition/core.py``: each dataset's partition
is the seeded random sample of preprocessed stems that the evaluation
harness decodes (at most ``EVALUATION_SAMPLES``). The sampling is the JAX
package's, ``random.seed(RANDOM_SEED)`` then ``random.shuffle``, so the
same stems give the same file, and this package's copies of the shipped
partitions (``assets/partitions``) serve both.
"""
import json
import random

import torbi_tpu_torch


def _audio_stems(dataset):
    """Relative speaker/utterance stems of a dataset's audio cache"""
    root = torbi_tpu_torch.CACHE_DIR / dataset
    return [
        f'{wav.parent.name}/{wav.stem}' for wav in root.rglob('*.wav')]


def _sample(stems):
    """Seeded shuffle, truncated to the evaluation budget"""
    random.seed(torbi_tpu_torch.RANDOM_SEED)
    random.shuffle(stems)
    del stems[torbi_tpu_torch.EVALUATION_SAMPLES:]
    return stems


def _write(dataset, stems):
    path = torbi_tpu_torch.PARTITION_DIR / f'{dataset}.json'
    path.parent.mkdir(exist_ok=True, parents=True)
    with open(path, 'w') as file:
        json.dump(stems, file, indent=4)


def datasets(datasets=None):
    """Create and save evaluation partitions for the given datasets"""
    for dataset in (
            datasets if datasets is not None else torbi_tpu_torch.DATASETS):
        _write(dataset, _sample(_audio_stems(dataset)))
