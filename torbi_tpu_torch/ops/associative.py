"""Exact parallel Viterbi via an associative max-plus scan.

Counterpart of ``torbi_tpu/ops/associative.py``. The Viterbi forward
recursion is a linear recurrence in the (max, +) semiring, so its
T-sequential dependency breaks into an associative scan over (S, S)
max-plus matrix products (Temporal Parallelization of HMM Inference,
arXiv:2102.05743). The work grows from O(T S^2) to O(T S^3), so this pays
for small state counts or when the frames are sharded over many ranks
(parallel/timesharded.py); at 1440 states the serial kernels win.

The product is the kernel K8 (``csrc/maxplus.cu``) on the card, launched
by the plan ``maxplus_plan``, and its plain version
``maxplus_matmul_reference`` on the CPU. ``associative_scan``
combines in the tree of ``jax.lax.associative_scan``: each candidate of a
product is one fp32 add and the fp32 maximum does not depend on order, so
every product is exact whatever the order over k, and only the tree
decides the rounding; with the same tree the posteriors are bitwise the
JAX package's. The decode's chase is the backtrace kernel K3
(``ops/backtrace.py::backtrace_posteriors``) at batch 1.
"""
import ctypes
import functools
import math

import torch

from ..csrc import build
from .backtrace import backtrace_posteriors
from .dense import _sms

# K8's tile designs (csrc/maxplus.cu, with_tile, in this order): (ty, tx,
# ri, rj, kd, stages, registers): TY x TX threads of RI x RJ running
# maxima each, an (RI TY) x (RJ TX) output tile; k in slabs of KD through a
# ring of STAGES shared-memory buffers; at most REGISTERS a thread
MAXPLUS_TILES = (
    (16, 16, 4, 4, 64, 2, 80),    # 64 x 64, a 64-deep product a stage
    (18, 14, 8, 8, 32, 3, 128),   # 144 x 112: 130 tiles at 1440^3, one wave
)
# The plan's model of an SM: its rate grows with the running maxima its
# CTAs hold up to FULL_RATE_MAXIMA (16 warps of 4 x 4 maxima; one CTA of
# the 144 x 112 design holds 16,128), fitted to K8's times on an H100
FULL_RATE_MAXIMA = 8192
SM_SMEM_BYTES = 233472       # an SM's shared memory (228 KB)
BLOCK_SMEM_BYTES = 232448    # a CTA's most
CTA_SMEM_RESERVED = 1024     # the runtime's own share of each CTA's
SM_THREADS = 2048
SM_CTAS = 32
SM_REGISTERS = 65536


def maxplus_matmul_reference(a, b):
    """Plain PyTorch version of K8: the (max, +) matrix product
    ``out[..., j, i] = max_k a[..., j, k] + b[..., k, i]``.

    a: (..., M, K) float32; b: (..., K, N) float32; the leading
    dimensions broadcast. Returns (..., M, N) float32. It takes one k at a
    time into a running maximum, so it never holds the M x K x N
    candidates. A NaN candidate makes its output NaN (torch.maximum keeps
    it).
    """
    out = a[..., :, 0, None] + b[..., None, 0, :]
    for kk in range(1, a.shape[-1]):
        torch.maximum(out, a[..., :, kk, None] + b[..., None, kk, :], out=out)
    return out


def maxplus_layout(tile, resident=None, slabs=1):
    """Shared memory and occupancy of K8's tile design ``tile`` (an index
    of MAXPLUS_TILES), as csrc/maxplus.cu lays it out: a ring of
    ``stages`` slabs, a's (rows x (kd + 4) floats, rows padded) and b's (kd
    x cols), with the ``resident`` operand ('a', 'b' or None), all its
    ``slabs`` slabs, before the ring; a thread holds at most the design's
    ``registers`` (the kernel's launch bounds). Returns a
    dict: rows, cols, depth, stages, threads, registers, smem_bytes,
    ctas_per_sm (the CTAs an SM holds at once by shared memory, threads
    and registers; 0 if none) and fits (within a CTA's shared memory)."""
    ty, tx, ri, rj, depth, stages, registers = MAXPLUS_TILES[tile]
    rows, cols = ri * ty, rj * tx
    a_floats, b_floats = rows * (depth + 4), depth * cols
    stage = ((0 if resident == 'a' else a_floats)
             + (0 if resident == 'b' else b_floats))
    held = slabs * {'a': a_floats, 'b': b_floats}.get(resident, 0)
    smem = 4 * (stages * stage + held)
    threads = ty * tx
    warp_threads = -(-threads // 32) * 32
    ctas = min(SM_SMEM_BYTES // (smem + CTA_SMEM_RESERVED),
               SM_THREADS // warp_threads,
               SM_REGISTERS // (warp_threads * registers), SM_CTAS)
    return {'rows': rows, 'cols': cols, 'depth': depth, 'stages': stages,
            'threads': threads, 'registers': registers, 'smem_bytes': smem,
            'ctas_per_sm': ctas, 'fits': smem <= BLOCK_SMEM_BYTES}


def _aligned(address, batch, batch_stride, rows, row_stride):
    """Whether every row of a (batch, rows, ...) float32 operand starts on
    16 bytes"""
    return (address % 16 == 0 and (rows == 1 or row_stride % 4 == 0)
            and (batch == 1 or batch_stride % 4 == 0))


def maxplus_tile_plan(tile, batch, m, k, n, a_batch, a_row, b_batch, b_row,
                      a_address=0, b_address=0, sms=132):
    """K8's launch with tile design ``tile`` for a (batch, m, k) by (batch,
    k, n) product whose operands have batch strides ``a_batch``,
    ``b_batch`` (0 broadcasts), row strides ``a_row``, ``b_row`` and
    addresses ``a_address``, ``b_address``, on ``sms`` SMs.

    The persistent grid walks ``items`` = batch x tiles_m x tiles_n
    output tiles, CTA c taking items c, c + grid, ...; each item's k in
    ``slabs`` of the design's depth. An operand of batch stride 0 whose
    whole product one tile row or column holds is ``resident`` ('a' or
    'b'), all its slabs, where they fit beside the ring.
    ``vec_a``, ``vec_b``: 16-byte copies (every row starts on 16 bytes),
    else 4-byte ones. ``cost``: the time of the busiest SM in candidates
    (padding included): its CTAs' items in ``rounds``, each round its CTAs
    at the SM's rate (FULL_RATE_MAXIMA). ``grid``: of the grids of one
    CTA an SM up to as many as an SM holds, the one of least cost (the
    larger on ties): a grid of fewer CTAs an SM can take fewer rounds.
    Returns a dict of these with maxplus_layout's."""
    layout = maxplus_layout(tile)
    rows, cols, depth = layout['rows'], layout['cols'], layout['depth']
    tiles_m, tiles_n = -(-m // rows), -(-n // cols)
    slabs = -(-k // depth)
    resident = None
    if batch > 1:
        for operand, stride, tiles in (('b', b_batch, tiles_n),
                                       ('a', a_batch, tiles_m)):
            held = maxplus_layout(tile, operand, slabs)
            if stride == 0 and tiles == 1 and held['fits']:
                resident, layout = operand, held
                break
    items = batch * tiles_m * tiles_n
    ty, tx, ri, rj = MAXPLUS_TILES[tile][:4]
    # A CTA's share of the SM's rate, and one item's candidates
    share = FULL_RATE_MAXIMA / (ty * tx * ri * rj)
    candidates = rows * cols * slabs * depth
    cost = None
    for per_sm in range(layout['ctas_per_sm'], 0, -1):
        option = min(items, sms * per_sm)
        ctas = -(-option // sms)
        option_cost = -(-items // option) * candidates * max(ctas, share)
        if cost is None or option_cost < cost:
            grid, cost = option, option_cost
    return {**layout, 'tile': tile, 'tiles_m': tiles_m, 'tiles_n': tiles_n,
            'slabs': slabs, 'items': items, 'grid': grid,
            'rounds': -(-items // grid), 'resident': resident,
            'vec_a': _aligned(a_address, batch, a_batch, m, a_row),
            'vec_b': _aligned(b_address, batch, b_batch, k, b_row),
            'cost': cost}


def maxplus_plan(batch, m, k, n, a_batch, a_row, b_batch, b_row,
                 a_address=0, b_address=0, sms=132):
    """K8's launch plan: of ``maxplus_tile_plan`` for each tile design,
    the one of least cost (the first on ties). Plans are cached by shape,
    strides and alignment (a scan launches the same few shapes many
    times); the returned dict is shared, not to be changed."""
    return _cached_plan(batch, m, k, n, a_batch, a_row, b_batch, b_row,
                        a_address % 16, b_address % 16, sms)


@functools.lru_cache(maxsize=4096)
def _cached_plan(batch, m, k, n, a_batch, a_row, b_batch, b_row, a_address,
                 b_address, sms):
    plans = [maxplus_tile_plan(tile, batch, m, k, n, a_batch, a_row,
                               b_batch, b_row, a_address, b_address, sms)
             for tile in range(len(MAXPLUS_TILES))]
    return min(plans, key=lambda plan: plan['cost'])


def _batched(x, lead, rows, cols):
    """``x`` broadcast to (*lead, rows, cols) as a (batch, rows, cols) view
    where one batch stride (0 for a broadcast operand) describes it, its
    columns contiguous; a copy otherwise"""
    x = x.expand(*lead, rows, cols).reshape(-1, rows, cols)
    if cols > 1 and x.stride(2) != 1:
        x = x.contiguous()
    return x


def maxplus_matmul(a, b):
    """The (max, +) matrix product: K8 (csrc/maxplus.cu) on CUDA tensors,
    launched by ``maxplus_plan``;
    ``maxplus_matmul_reference`` on CPU tensors. Arguments and result as
    there; the operands may be strided views (a batch stride of 0
    broadcasts). Counts one launch per call on the card (none for an empty
    result)."""
    device = a.device
    if device.type == 'cpu' and b.device.type == 'cpu':
        return maxplus_matmul_reference(a, b)
    if b.device != device:
        raise ValueError(f'a is on {device}, b on {b.device}')
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f'a and b must be float32, got {a.dtype}, {b.dtype}')
    if a.ndim < 2 or b.ndim < 2 or a.shape[-1] != b.shape[-2]:
        raise ValueError(
            f'cannot multiply {tuple(a.shape)} by {tuple(b.shape)}')
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if k == 0:
        raise ValueError('the (max, +) product needs k >= 1')
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    out = torch.empty((*lead, m, n), dtype=torch.float32, device=device)
    batch = math.prod(lead)
    if not (batch and m and n):
        return out
    a3 = _batched(a, lead, m, k)
    b3 = _batched(b, lead, k, n)
    plan = maxplus_plan(
        batch, m, k, n, a3.stride(0), a3.stride(1), b3.stride(0),
        b3.stride(1), a3.data_ptr(), b3.data_ptr(), _sms(device))
    lib = _library()
    with torch.cuda.device(device):
        code = lib.maxplus_matmul(
            build.pointer(a3), a3.stride(0), a3.stride(1),
            build.pointer(b3), b3.stride(0), b3.stride(1),
            build.pointer(out), batch, m, k, n, plan['tile'], plan['grid'],
            RESIDENT_CODES[plan['resident']], plan['vec_a'], plan['vec_b'],
            build.stream(device))
    build.raise_on_error(lib, 'maxplus_matmul', code)
    maxplus_matmul.launches += 1
    return out


maxplus_matmul.launches = 0


def associative_scan(fn, elems, reverse=False):
    """Inclusive scan of ``elems`` along dimension 0 with the associative
    combine ``fn(earlier, later)``, in the combine tree of
    ``jax.lax.associative_scan`` (reduce adjacent pairs, scan those
    recursively, combine the evens, interleave; ``reverse`` flips before
    and after)."""
    if reverse:
        elems = elems.flip(0)

    def scan(elems):
        count = elems.shape[0]
        if count < 2:
            return elems
        odd = scan(fn(elems[0:-1:2], elems[1::2]))
        if count % 2 == 0:
            even = fn(odd[:-1], elems[2::2])
        else:
            even = fn(odd, elems[2::2])
        out = torch.empty_like(elems)
        out[0] = elems[0]
        out[2::2] = even
        out[1::2] = odd
        return out

    scans = scan(elems)
    return scans.flip(0) if reverse else scans


def viterbi_posteriors_scan(observation, transition, initial):
    """All per-step posteriors of one sequence via the associative scan.

    observation: (T, S) float32 log-probs
    transition: (S, S) float32 log-probs (row = destination)
    initial: (S,) float32 log-probs

    Returns posteriors: (T, S), bitwise the JAX package's. Equal to the
    sequential forward recursion in exact arithmetic; in float32 the
    reassociated adds can differ from the sequential order by ulps, so
    near-exact ties may resolve differently from the serial kernels.
    """
    frames = observation.shape[0]
    post0 = observation[0] + initial
    if frames == 1:
        return post0[None]
    # Step matrices for t = 1..T-1: A_t[j, i] = transition[j, i] + obs[t, j]
    steps = transition[None, :, :] + observation[1:, :, None]
    # Prefix products M_t = A_t x ... x A_1: the later element (b) goes on
    # the left of the product
    prefixes = associative_scan(lambda a, b: maxplus_matmul(b, a), steps)
    del steps
    # posterior_t = maxplus(M_t, post0)
    posts = (prefixes + post0[None, None, :]).amax(dim=-1)
    return torch.cat([post0[None], posts])


def viterbi_decode_scan(observation, transition, initial):
    """Exact Viterbi decode of one (T, S) sequence: the associative scan for
    the forward pass, then the chase over its posteriors (K3 on the card).
    Returns (T,) int32, the lowest-index argmax rule at every step; bitwise
    the JAX package's."""
    frames = observation.shape[0]
    posts = viterbi_posteriors_scan(observation, transition, initial)
    batch_frames = torch.full(
        (1,), frames, dtype=torch.int32, device=observation.device)
    return backtrace_posteriors(
        posts[None].contiguous(), transition.contiguous(), posts[-1:],
        batch_frames)[0]


# The C entry's code of a resident operand
RESIDENT_CODES = {None: 0, 'a': 1, 'b': 2}


def maxplus_occupancy(tile, resident=None, slabs=1):
    """The CTAs of K8's tile design ``tile`` one SM holds at once, and its
    dynamic shared memory in bytes, as the card reports them (the CUDA
    occupancy query); maxplus_layout's ctas_per_sm and smem_bytes are the
    plan's model of them"""
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    lib = _library()
    code = lib.maxplus_occupancy(tile, RESIDENT_CODES[resident], slabs,
                                 ctypes.byref(blocks), ctypes.byref(smem))
    build.raise_on_error(lib, 'maxplus_occupancy', code)
    return blocks.value, smem.value


def _library():
    lib = build.library('maxplus')
    lib.maxplus_matmul.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.maxplus_matmul.restype = ctypes.c_int
    lib.maxplus_occupancy.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.maxplus_occupancy.restype = ctypes.c_int
    return lib
