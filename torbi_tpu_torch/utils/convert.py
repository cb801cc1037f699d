"""Tensor conversion and device resolution.

``to_tensor`` accepts numpy arrays, torch tensors and any array-like (a JAX
array included, through ``np.asarray``) without importing JAX.
"""
import numpy as np
import torch


def to_tensor(array, dtype=None, device=None):
    """Convert a tensor, numpy array or array-like to a torch tensor.

    ``device=None`` leaves a tensor where it is and puts anything else on
    the host (numpy arrays are wrapped without a copy where the dtype
    already matches). Returns the input object itself when nothing needs
    to change, so identity caches keep hitting. A copy from the host to
    the card does not wait for the work queued on the card: from pageable
    memory CUDA stages the data before the call returns, and a buffer of
    PyTorch's pinned allocator is reused only after the copy.
    """
    if array is None:
        return None
    if not isinstance(array, torch.Tensor):
        host = np.asarray(array)
        if not (host.flags.c_contiguous and host.flags.writeable):
            host = np.array(host, order='C')
        array = torch.from_numpy(host)
    return array.to(dtype=dtype, device=device,
                    non_blocking=array.device.type == 'cpu')


def resolve_device(gpu=None):
    """The decode device for the reference's flexible ``gpu`` argument.

    None is ``cuda:0``; an integer is a CUDA index; a string or
    ``torch.device`` names a device ('cpu', 'cuda', 'cuda:1'; the aliases
    'gpu' and 'mps' mean CUDA). Decoding never moves to the CPU unless
    asked: a CUDA device without CUDA raises ``RuntimeError``.
    """
    if gpu is None:
        device = torch.device('cuda', 0)
    elif isinstance(gpu, torch.device):
        device = gpu
    elif isinstance(gpu, int):
        device = torch.device('cuda', gpu)
    else:
        platform, _, index = str(gpu).partition(':')
        if platform in ('gpu', 'mps'):
            platform = 'cuda'
        device = torch.device(
            f'{platform}:{index}' if index else platform)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                f'decoding on {device} needs a CUDA device and none is '
                "available; pass gpu='cpu' to decode on the CPU")
        if device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
    elif device.type != 'cpu':
        raise ValueError(f'unsupported decode device {device}')
    return device


def device_argument(value):
    """A command line's ``--gpu``: a CUDA index, or 'cpu'"""
    return 'cpu' if value == 'cpu' else int(value)
