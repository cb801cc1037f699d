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

One sequence on its own (batch 1) takes a chase of its own, with the same
result: ``backtrace_fused1`` (K5, every state) or ``backtrace_window`` (K6,
the band window only, for a pure -inf band).
"""
import ctypes

import torch

from ..csrc import build

# K5 gives each of at most 1024 threads 8 states; dispatch sends a larger
# single sequence to K3, which has no such limit
FUSED1_MAX_STATES = 8192


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


def window_rows(width):
    """128-state rows the JAX package's window chase spans for a band of
    ``width``: the window base rounds down to a row boundary, so the span
    is (width - 1) + up to 127 alignment slack. Dispatch gates the window
    chase on it as the JAX dispatcher does; K6 itself reads exactly the
    ``width`` sources."""
    return (width - 1 + 127) // 128 + 1


def backtrace_fused1_reference(post_seq, transition, posterior,
                               batch_frames):
    """Plain PyTorch version of the batch-1 fused chase (K5):
    ``backtrace_reference`` on the one sequence"""
    _require_batch1(post_seq)
    return backtrace_reference(post_seq, transition, posterior, batch_frames)


def backtrace_window_reference(post_seq, transition, posterior, batch_frames,
                               band):
    """Plain PyTorch version of the batch-1 windowed chase (K6):
    ``backtrace_reference`` on the one sequence. On a pure -inf band every
    candidate outside the window is -inf, so the full-width chase is the
    function the windowed one computes."""
    _require_batch1(post_seq)
    _require_pure_band(band)
    return backtrace_reference(post_seq, transition, posterior, batch_frames)


def backtrace_fused1(post_seq, transition, posterior, batch_frames):
    """Batch-1 chase over every state: the K5 kernel
    (csrc/backtrace_batch1.cu) on CUDA tensors, its plain version on CPU
    tensors. Arguments and result as in ``backtrace_posteriors`` with
    batch 1."""
    if post_seq.device.type == 'cpu':
        return backtrace_fused1_reference(
            post_seq, transition, posterior, batch_frames)
    indices = _batch1_launch(
        'backtrace_fused1', post_seq, transition, posterior, batch_frames)
    backtrace_fused1.launches += 1
    return indices


backtrace_fused1.launches = 0


def backtrace_window(post_seq, transition, posterior, batch_frames, band):
    """Batch-1 chase over the band window only: the K6 kernel
    (csrc/backtrace_batch1.cu) on CUDA tensors, its plain version on CPU
    tensors. Each step takes the argmax over the sources
    ``[index + lo, index + lo + width)`` cut to ``[0, states)``. Exact only
    on a pure -inf band (``band[2] is None``): with a finite floor a path
    can leave the window, so a floor band raises. Arguments and result as
    in ``backtrace_posteriors`` with batch 1, plus ``band`` from
    ``detect_band``."""
    if post_seq.device.type == 'cpu':
        return backtrace_window_reference(
            post_seq, transition, posterior, batch_frames, band)
    _require_pure_band(band)
    indices = _batch1_launch(
        'backtrace_window', post_seq, transition, posterior, batch_frames,
        band[0], band[1])
    backtrace_window.launches += 1
    return indices


backtrace_window.launches = 0


def _require_batch1(post_seq):
    if post_seq.shape[0] != 1:
        raise ValueError(
            f'the batch-1 chase takes one sequence, got batch '
            f'{post_seq.shape[0]}')


def _require_pure_band(band):
    lo, width, floor = band
    if floor is not None or width <= 0:
        raise ValueError(
            f'the window chase needs a pure -inf band of width > 0, got '
            f'{band}: a finite floor lets the path leave the window')


def _batch1_launch(kernel, post_seq, transition, posterior, batch_frames,
                   *window):
    """Check the arguments of a batch-1 chase and launch ``kernel`` of
    csrc/backtrace_batch1.cu; returns the (1, frames) int32 indices"""
    _require_batch1(post_seq)
    device = post_seq.device
    _, frames, states = post_seq.shape
    build.check('post_seq', post_seq, (1, frames, states), torch.float32,
                device)
    build.check('transition', transition, (states, states), torch.float32,
                device)
    build.check('batch_frames', batch_frames, (1,), torch.int32, device)
    if (posterior.device != device or posterior.dtype != torch.float32
            or tuple(posterior.shape) != (1, states)
            or (states > 1 and posterior.stride(1) != 1)):
        raise ValueError(
            f'posterior must be a (1, states) float32 tensor on {device} '
            'with contiguous rows')
    indices = torch.empty((1, frames), dtype=torch.int32, device=device)
    if frames:
        lib = _batch1_library()
        with torch.cuda.device(device):
            code = getattr(lib, kernel)(
                build.pointer(post_seq), build.pointer(posterior),
                build.pointer(transition), build.pointer(batch_frames),
                build.pointer(indices), frames, states, *window,
                build.stream(device))
        build.raise_on_error(lib, kernel, code)
    return indices


def _library():
    lib = build.library('backtrace')
    lib.backtrace.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.backtrace.restype = ctypes.c_int
    return lib


def _batch1_library():
    lib = build.library('backtrace_batch1')
    pointers = [ctypes.c_void_p] * 5
    lib.backtrace_fused1.argtypes = pointers + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.backtrace_window.argtypes = pointers + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.backtrace_fused1.restype = ctypes.c_int
    lib.backtrace_window.restype = ctypes.c_int
    return lib
