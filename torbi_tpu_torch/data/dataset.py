"""Observation-file dataset.

Counterpart of ``torbi_tpu/data/dataset.py``: each item is
``(observation, input_file)``, where the observation is one (frames,
states) numpy array or, when entropy chunking is set by ``MIN_CHUNK_SIZE``,
the list of its chunks (``chunk.py``), which ``collate`` flattens into
extra batch rows.
"""
import torbi_tpu_torch
from ..utils import io


class Dataset:
    """Lazily loaded sequence of observation files"""

    def __init__(self, input_files):
        self.input_files = list(input_files)

    def __len__(self):
        return len(self.input_files)

    def __getitem__(self, index):
        path = self.input_files[index]
        observation = io.load(path)
        if torbi_tpu_torch.MIN_CHUNK_SIZE is None:
            return observation, path
        return torbi_tpu_torch.chunk(observation), path
