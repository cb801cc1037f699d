"""Backtrace over stored posterior columns.

Counterpart of ``torbi_tpu/ops/backtrace.py::backtrace_posteriors``, in the
natural (batch, frames, states) layout. The forward passes (ops/band.py,
ops/dense.py) store the posterior of every frame instead of backpointers;
the backtrace recovers each backpointer where it is needed, along the one
chosen path per sequence:

    pred[b] = lowest-index argmax_i(post[b, t-1, i] + transition[cur[b], i])

which is bitwise the backpointer the dense recursion would have recorded,
lowest source index first on ties. The chase starts from the lowest-index
argmax of the final posterior, and positions at or beyond
``batch_frames[b] - 1`` hold that seed.
"""
import ctypes

import torch

from ..csrc import build


def backtrace_reference(post_seq, transition, posterior, batch_frames):
    """Plain PyTorch version of the backtrace kernel (K3).

    post_seq: (batch, frames, states) float32 from a forward pass
    transition: (states, states) float32, row = destination
    posterior: (batch, states) float32 final posterior
    batch_frames: (batch,) int32

    Returns (batch, frames) int32 decoded indices.
    """
    batch, frames, _ = post_seq.shape
    # torch.argmax returns the first maximal index, on the CPU and on CUDA
    index = posterior.argmax(dim=1)
    indices = torch.empty(
        (batch, frames), dtype=torch.int32, device=post_seq.device)
    indices[:, frames - 1] = index.to(torch.int32)
    for t in range(frames - 1, 0, -1):
        pred = (post_seq[:, t - 1, :] + transition[index]).argmax(dim=1)
        index = torch.where(t <= batch_frames - 1, pred, index)
        indices[:, t - 1] = index.to(torch.int32)
    return indices


def backtrace_posteriors(post_seq, transition, posterior, batch_frames):
    """Backtrace: the K3 kernel (csrc/backtrace.cu) on CUDA tensors, its
    plain version on CPU tensors. Arguments and result as in
    ``backtrace_reference``; ``posterior`` may be a row-strided view (such
    as ``post_seq[:, -1]``), the others are contiguous."""
    device = post_seq.device
    if device.type == 'cpu':
        return backtrace_reference(
            post_seq, transition, posterior, batch_frames)
    batch, frames, states = post_seq.shape
    build.check('post_seq', post_seq, (batch, frames, states), torch.float32,
                device)
    build.check('transition', transition, (states, states), torch.float32,
                device)
    build.check('batch_frames', batch_frames, (batch,), torch.int32, device)
    if (posterior.device != device or posterior.dtype != torch.float32
            or tuple(posterior.shape) != (batch, states)
            or (states > 1 and posterior.stride(1) != 1)):
        raise ValueError(
            'posterior must be a (batch, states) float32 tensor on '
            f'{device} with contiguous rows')
    indices = torch.empty(
        (batch, frames), dtype=torch.int32, device=device)
    if batch and frames:
        lib = _library()
        with torch.cuda.device(device):
            code = lib.backtrace(
                build.pointer(post_seq), build.pointer(posterior),
                posterior.stride(0), build.pointer(transition),
                build.pointer(batch_frames), build.pointer(indices),
                batch, frames, states, build.stream(device))
        build.raise_on_error(lib, 'backtrace', code)
        backtrace_posteriors.launches += 1
    return indices


backtrace_posteriors.launches = 0


def _library():
    lib = build.library('backtrace')
    lib.backtrace.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.backtrace.restype = ctypes.c_int
    return lib
