"""Tensor file IO.

The port's own copy of ``torbi_tpu/utils/io.py``: observations and decoded
indices are ``.pt`` files (``torch.load``/``torch.save``) or ``.npy`` files
(numpy). Loading returns a numpy array; saving takes a tensor (on any
device) or an array and writes it with its dtype, so decoded indices are
the int32 tensor or array that ``torbi_tpu`` writes, and a file from either
package loads through the other to the same dtype and values.
"""
from pathlib import Path

import numpy as np
import torch


def load(file):
    """Load a tensor file as a numpy array"""
    file = Path(file)
    if file.suffix == '.npy':
        return np.load(file)
    return torch.load(file, map_location='cpu', weights_only=True).numpy()


def save(array, file):
    """Save a tensor or array to a tensor file"""
    file = Path(file)
    if isinstance(array, torch.Tensor):
        array = array.detach().cpu().numpy()
    array = np.asarray(array)
    if file.suffix == '.npy':
        np.save(file, array)
        return
    torch.save(torch.from_numpy(np.ascontiguousarray(array)), file)
