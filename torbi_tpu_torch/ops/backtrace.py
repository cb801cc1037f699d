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
the band window only, for a pure -inf band). Both run in two phases, each
with a plain version: ``backtrace_pointers`` computes every backpointer of
the sequence in parallel from the gated band (phase 1; K6's phase 1 is the
same pass without the floor term), and ``chase_pointers`` follows them in
blocks of frames (phase 2).
"""
import ctypes

import torch

from ..csrc import build

NEG_INF = float('-inf')

# K5's phase 2 chases every state of a block on at most 1024 threads x 8
# (and its table is int16); dispatch sends a larger single sequence to K3,
# which has no such limit
FUSED1_MAX_STATES = 8192
# Phase 2's blocks: B frames of backpointers (B x states int16) in a CTA's
# shared memory, at most CHASE_BLOCK_FRAMES and CHASE_SMEM_BYTES (two CTAs
# per SM)
CHASE_BLOCK_FRAMES = 32
CHASE_SMEM_BYTES = 96 * 1024


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


def full_band(states):
    """The band of every offset with no floor, (-(states - 1), 2 states -
    1, None): a dense transition as a band, for K5's phase 1"""
    return (-(states - 1), 2 * states - 1, None)


def chase_block(states):
    """Frames per block of K5's phase 2 at this many states"""
    return max(1, min(CHASE_BLOCK_FRAMES, CHASE_SMEM_BYTES // (2 * states)))


def _top_frame(batch_frames, frames):
    return min(int(batch_frames[0]), frames) - 1


def backtrace_pointers_reference(post_seq, band, band_matrix, batch_frames):
    """Plain PyTorch version of K5's phase 1: every backpointer of one
    sequence,

        bp[t, j] = lowest-index argmax_i (post_seq[0, t-1, i]
                                          + transition[j, i])

    for 1 <= t <= min(batch_frames[0], frames) - 1, from the gated band
    (``band.detect_band``: the floor is the transition's global minimum and
    every entry outside the band equals it) and its band matrix. The
    in-band candidates post[t-1, j + d + lo] + band[d, j] give the in-band
    winner (M, i_in); with a floor, the row's lowest-index argmax g of
    fl(post[t-1, i] + floor), value F, is the one other candidate: the
    winner is i_in when M > F, g when M < F, the lower of the two on a tie,
    and 0 when the row's maximum is -inf. A dense transition passes as
    ``full_band``.

    Returns (frames, states) int16, rows 0 and past the chase 0."""
    _require_batch1(post_seq)
    lo, width, floor = band
    _, frames, states = post_seq.shape
    device = post_seq.device
    table = torch.zeros((frames, states), dtype=torch.int16, device=device)
    t_top = _top_frame(batch_frames, frames)
    if t_top < 1:
        return table
    left = max(0, -lo)
    right = max(0, lo + width - 1)
    start = lo + left
    band_t = band_matrix.t()  # (states, width)
    j = torch.arange(states, device=device)
    # Rows in chunks: the candidates of a chunk are (rows, states, width)
    rows = max(1, (1 << 24) // max(1, states * width))
    for t0 in range(1, t_top + 1, rows):
        post = post_seq[0, t0 - 1:min(t_top, t0 + rows - 1)]
        padded = torch.nn.functional.pad(post, (left, right), value=NEG_INF)
        windows = padded.unfold(1, width, 1)[:, start:start + states]
        cand = windows + band_t[None]
        # argmax returns the first maximal offset: the lowest source
        best = cand.amax(dim=-1)
        index = j[None] + lo + cand.argmax(dim=-1)
        if floor is not None:
            shifted = post + torch.tensor(floor, dtype=torch.float32,
                                          device=device)
            f_val = shifted.amax(dim=1, keepdim=True)
            f_idx = shifted.argmax(dim=1, keepdim=True)
            index = torch.where(best < f_val, f_idx, torch.where(
                best == f_val, torch.minimum(index, f_idx), index))
            best = torch.maximum(best, f_val)
        index = torch.where(best == NEG_INF, 0, index)
        table[t0:t0 + len(post)] = index.to(torch.int16)
    return table


def chase_pointers_reference(pointers, posterior, batch_frames, block=None):
    """Plain PyTorch version of K5's phase 2: the path along the table of
    ``backtrace_pointers_reference``, chased as the kernel chases it, in
    blocks of ``block`` frames (default every frame in one block): every
    state at each block's top to the block's bottom, then the block
    boundaries from the seed (the lowest-index argmax of ``posterior``,
    (1, states)), then each block's frames. Positions from
    min(batch_frames[0], frames) - 1 on hold the seed.

    Returns (1, frames) int32."""
    frames, states = pointers.shape
    device = pointers.device
    block = max(1, frames - 1) if block is None else block
    if block < 1:
        raise ValueError(f'block must be 1 or more, got {block}')
    seed = int(posterior.reshape(-1, states)[0].argmax())
    out = torch.full((1, frames), seed, dtype=torch.int32, device=device)
    t_top = _top_frame(batch_frames, frames)
    if t_top < 1:
        return out
    table = pointers.long()
    bounds = list(range(1, t_top + 1, block))
    ends = []
    for t_lo in bounds:
        x = torch.arange(states, device=device)
        for t in range(min(t_lo + block - 1, t_top), t_lo - 1, -1):
            x = table[t][x]
        ends.append(x)
    tops = [0] * len(bounds)
    x = seed
    for k in range(len(bounds) - 1, -1, -1):
        tops[k] = x
        x = int(ends[k][x])
    for k, t_lo in enumerate(bounds):
        x = tops[k]
        for t in range(min(t_lo + block - 1, t_top), t_lo - 1, -1):
            x = int(table[t][x])
            out[0, t - 1] = x
    return out


def backtrace_pointers(post_seq, band, band_matrix, batch_frames):
    """K5's phase 1: its kernels (csrc/backtrace_batch1.cu,
    backtrace_pointers) on CUDA tensors, ``backtrace_pointers_reference``
    on CPU tensors. Arguments and result as there; the band has width >=
    1. Counts one launch per call on the card."""
    if post_seq.device.type == 'cpu':
        return backtrace_pointers_reference(
            post_seq, band, band_matrix, batch_frames)
    _require_batch1(post_seq)
    lo, width, floor = band
    device = post_seq.device
    _, frames, states = post_seq.shape
    build.check('post_seq', post_seq, (1, frames, states), torch.float32,
                device)
    build.check('band_matrix', band_matrix, (width, states), torch.float32,
                device)
    build.check('batch_frames', batch_frames, (1,), torch.int32, device)
    table = torch.empty((frames, states), dtype=torch.int16, device=device)
    floor_val = torch.empty((frames,), dtype=torch.float32, device=device)
    floor_idx = torch.empty((frames,), dtype=torch.int32, device=device)
    if frames:
        lib = _batch1_library()
        with torch.cuda.device(device):
            code = lib.backtrace_pointers(
                build.pointer(post_seq), build.pointer(band_matrix),
                build.pointer(batch_frames), build.pointer(floor_val),
                build.pointer(floor_idx), build.pointer(table), frames,
                states, lo, width, 0.0 if floor is None else floor,
                int(floor is not None), build.stream(device))
        build.raise_on_error(lib, 'backtrace_pointers', code)
        backtrace_pointers.launches += 1
    return table


backtrace_pointers.launches = 0


def chase_pointers(pointers, posterior, batch_frames):
    """K5's phase 2: its kernels (csrc/backtrace_batch1.cu, chase_pointers)
    on CUDA tensors, ``chase_pointers_reference`` on CPU tensors, in blocks
    of ``chase_block(states)`` frames. ``pointers`` from
    ``backtrace_pointers``; ``posterior`` (1, states) with contiguous rows.
    Returns (1, frames) int32. Counts one launch per call on the card."""
    frames, states = pointers.shape
    block = chase_block(states)
    device = pointers.device
    if device.type == 'cpu':
        return chase_pointers_reference(
            pointers, posterior, batch_frames, block)
    build.check('pointers', pointers, (frames, states), torch.int16, device)
    build.check('batch_frames', batch_frames, (1,), torch.int32, device)
    _check_posterior(posterior, 1, states, device)
    out = torch.empty((1, frames), dtype=torch.int32, device=device)
    blocks = max(1, -(-(frames - 1) // block))
    ends = torch.empty((blocks, states), dtype=torch.int16, device=device)
    tops = torch.empty((blocks,), dtype=torch.int32, device=device)
    if frames:
        lib = _batch1_library()
        with torch.cuda.device(device):
            code = lib.chase_pointers(
                build.pointer(pointers), build.pointer(posterior),
                build.pointer(batch_frames), build.pointer(ends),
                build.pointer(tops), build.pointer(out), frames, states,
                block, build.stream(device))
        build.raise_on_error(lib, 'chase_pointers', code)
        chase_pointers.launches += 1
    return out


chase_pointers.launches = 0


def backtrace_fused1(post_seq, transition, posterior, batch_frames,
                     band=None, band_matrix=None):
    """Batch-1 chase over every state: the K5 kernels
    (csrc/backtrace_batch1.cu: phase 1 ``backtrace_pointers``, phase 2
    ``chase_pointers``) on CUDA tensors, their plain versions on CPU
    tensors. Arguments and result as in ``backtrace_posteriors`` with
    batch 1, plus the gated ``band`` of the transition (from
    ``band.detect_band``) and its band matrix (built here when None);
    without a band, or with a width-0 one, every offset (``full_band``).
    Each phase counts its own launches."""
    _require_batch1(post_seq)
    states = post_seq.shape[2]
    if band is None or band[1] < 1:
        band = full_band(states)
        band_matrix = None
    if band_matrix is None:
        from .band import build_band_matrix

        band_matrix = build_band_matrix(transition, band[0], band[1])
    pointers = backtrace_pointers(post_seq, band, band_matrix, batch_frames)
    return chase_pointers(pointers, posterior, batch_frames)


def window_pointers(post_seq, band, band_matrix, batch_frames):
    """K6's phase 1: every backpointer of one sequence from a pure -inf band
    (csrc/backtrace_batch1.cu, backtrace_window: K5's phase-1 pass without
    the floor term, and no floor pass) on CUDA tensors,
    ``backtrace_pointers_reference`` on CPU tensors. Arguments and result
    as there. Each launch counts in ``backtrace_window.launches``, K6's
    counter."""
    _require_batch1(post_seq)
    _require_pure_band(band)
    if post_seq.device.type == 'cpu':
        return backtrace_pointers_reference(
            post_seq, band, band_matrix, batch_frames)
    lo, width, _ = band
    device = post_seq.device
    _, frames, states = post_seq.shape
    build.check('post_seq', post_seq, (1, frames, states), torch.float32,
                device)
    build.check('band_matrix', band_matrix, (width, states), torch.float32,
                device)
    build.check('batch_frames', batch_frames, (1,), torch.int32, device)
    table = torch.empty((frames, states), dtype=torch.int16, device=device)
    if frames:
        lib = _batch1_library()
        with torch.cuda.device(device):
            code = lib.backtrace_window(
                build.pointer(post_seq), build.pointer(band_matrix),
                build.pointer(batch_frames), build.pointer(table), frames,
                states, lo, width, build.stream(device))
        build.raise_on_error(lib, 'backtrace_window', code)
        backtrace_window.launches += 1
    return table


def backtrace_window(post_seq, transition, posterior, batch_frames, band,
                     band_matrix=None):
    """Batch-1 chase over the band window only (K6), in two phases:
    ``window_pointers`` (every backpointer from the band) and K5's phase 2
    ``chase_pointers``, each its kernel on CUDA tensors and its plain
    version on CPU tensors. Each step takes the argmax over the sources
    ``[index + lo, index + lo + width)`` cut to ``[0, states)``. Exact only
    on a pure -inf band (``band[2] is None``): with a finite floor a path
    can leave the window, so a floor band raises. Arguments and result as
    in ``backtrace_posteriors`` with batch 1, plus ``band`` from
    ``detect_band`` and its band matrix (built here when None). Its phase 1
    counts in ``backtrace_window.launches``, its phase 2 in
    ``chase_pointers.launches``."""
    _require_batch1(post_seq)
    _require_pure_band(band)
    if band_matrix is None:
        from .band import build_band_matrix

        band_matrix = build_band_matrix(transition, band[0], band[1])
    pointers = window_pointers(post_seq, band, band_matrix, batch_frames)
    return chase_pointers(pointers, posterior, batch_frames)


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


def _check_posterior(posterior, batch, states, device):
    if (posterior.device != device or posterior.dtype != torch.float32
            or tuple(posterior.shape) != (batch, states)
            or (states > 1 and posterior.stride(1) != 1)):
        raise ValueError(
            f'posterior must be a ({batch}, states) float32 tensor on '
            f'{device} with contiguous rows')


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
    lib.backtrace_pointers.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.chase_pointers.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.backtrace_window.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.backtrace_pointers.restype = ctypes.c_int
    lib.chase_pointers.restype = ctypes.c_int
    lib.backtrace_window.restype = ctypes.c_int
    return lib
