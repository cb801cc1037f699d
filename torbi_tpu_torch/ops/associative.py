"""Exact parallel Viterbi via an associative max-plus scan.

Counterpart of ``torbi_tpu/ops/associative.py``. The Viterbi forward
recursion is a linear recurrence in the (max, +) semiring, so its
T-sequential dependency breaks into an associative scan over (S, S)
max-plus matrix products (Temporal Parallelization of HMM Inference,
arXiv:2102.05743). The work grows from O(T S^2) to O(T S^3), so this pays
for small state counts or when the frames are sharded over many ranks
(parallel/timesharded.py); at 1440 states the serial kernels win.

The product is the kernel K8 (``csrc/maxplus.cu``) on the card and its
plain version ``maxplus_matmul_reference`` on the CPU. ``associative_scan``
combines in the tree of ``jax.lax.associative_scan``: each candidate of a
product is one fp32 add and the fp32 maximum does not depend on order, so
every product is exact whatever the order over k, and only the tree
decides the rounding; with the same tree the posteriors are bitwise the
JAX package's. The decode's chase is the backtrace kernel K3
(``ops/backtrace.py::backtrace_posteriors``) at batch 1.
"""
import ctypes
import math

import torch

from ..csrc import build
from .backtrace import backtrace_posteriors


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
    lib = _library()
    with torch.cuda.device(device):
        code = lib.maxplus_matmul(
            build.pointer(a3), a3.stride(0), a3.stride(1),
            build.pointer(b3), b3.stride(0), b3.stride(1),
            build.pointer(out), batch, m, k, n, build.stream(device))
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


def _library():
    lib = build.library('maxplus')
    lib.maxplus_matmul.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.maxplus_matmul.restype = ctypes.c_int
    return lib
