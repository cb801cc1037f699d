"""Banded Viterbi forward pass (pure band, or band over a constant floor).

Counterpart of ``torbi_tpu/ops/band.py``. The pitch transition taken to
``log(p + tiny)`` is a diagonal band of ~175 of 1440 columns over a
constant floor ``log(tiny)``, so the forward recursion computes values only:

    score[j] = max_d(posterior[j + d + lo] + band[d, j])        (in-band)
    score[j] = max(score[j], floor + max_i posterior[i])        (floor mode)

The out-of-band candidates all share the constant floor, and an in-band
source counted again at ``floor + posterior[i]`` is dominated by its in-band
candidate (the floor is the global minimum), so the floor contributes one
max of the posterior per frame. The forward pass streams the posterior of
every frame; the backtrace (ops/backtrace.py) recovers the backpointers
along the chosen path only. One sequence on its own (batch 1) takes the
K4 kernel, ``viterbi_forward_band_spread``, with the same values.

Exactness preconditions (``gate_band`` enforces them; dispatch falls back to
the dense kernel otherwise): a pure -inf exterior needs an all-finite
initial distribution, a constant finite floor at least one finite initial
entry, and both a finite observation.
"""
import ctypes

import numpy as np
import torch

from ..csrc import build
from ..utils.cache import identity_cached as _identity_cached

NEG_INF = float('-inf')

# The shared memory a Hopper block may opt in to (227 KB). K4 refuses a
# band whose layout (spread_smem_bytes) exceeds the card's; dispatch sends
# such a single sequence to K1
SPREAD_SMEM_BYTES = 227 * 1024

# Detection and gating results cached per live, unmodified tensor
_detect_cache = {}
_initial_gate_cache = {}


def detect_band(transition):
    """Detect a diagonal band (with -inf or constant-floor exterior).

    transition: (states, states) log-probabilities, a tensor or array.

    Returns (lo, width, floor) with python-int lo/width and floor either
    None (exterior is -inf) or a finite python float (exterior is exactly
    constant), or None when the banded kernel does not apply.
    """
    import torbi_tpu_torch

    states = transition.shape[0]

    def stats():
        # Exterior entries (outside [lo, hi]) must all equal the floor
        # exactly; since floor is the global min and `above` is defined by
        # > floor, no above-floor entry lies outside [lo, hi] by
        # construction. Computed on the host, once per transition: one
        # device-to-host copy of the matrix
        if isinstance(transition, torch.Tensor):
            host = transition.detach().cpu().numpy()
        else:
            host = np.asarray(transition)
        floor = host.min()
        rows, cols = np.nonzero(host > floor)
        d = cols.astype(np.int64) - rows.astype(np.int64)
        n_above = d.size
        lo = d.min() if n_above else 0
        hi = d.max() if n_above else 0
        return floor, lo, hi, n_above

    floor, lo, hi, n_above = _identity_cached(
        _detect_cache, transition, stats)

    result = None
    if n_above > 0:
        lo, hi = int(lo), int(hi)
        width = hi - lo + 1
        floor = float(floor)
        if width <= torbi_tpu_torch.BAND_MAX_FRACTION * states:
            if floor == NEG_INF:
                result = (lo, width, None)
            elif np.isfinite(floor):
                result = (lo, width, floor)
    elif np.isfinite(floor):
        # Constant transition matrix (e.g. the uniform default): a width-0
        # band whose every candidate is the floor
        result = (0, 0, float(floor))
    return result


def _initial_finite_ok(initial, need_all):
    def compute():
        finite = torch.isfinite(torch.as_tensor(initial))
        return bool(finite.all() if need_all else finite.any())

    return _identity_cached(
        _initial_gate_cache, initial, compute, extra_key=bool(need_all))


def gate_band(band, initial, observation=None, finite_observation=False):
    """Enforce the exactness preconditions (module docstring); returns band
    or None (fall back to dense).

    - pure -inf band: initial must be all-finite
    - constant floor: at least one finite initial entry
    - both: finite observation (``finite_observation=True`` asserts it
      without scanning)
    """
    if band is None:
        return None
    if not _initial_finite_ok(initial, need_all=band[2] is None):
        return None
    if not finite_observation and observation is not None:
        if not bool(torch.isfinite(observation).all()):
            return None
    return band


def build_band_matrix(transition, lo, width):
    """Compress a dense transition into the (width, states) band matrix.

    band[d, j] = transition[j, j + d + lo], -inf where the source
    j + d + lo lies outside [0, states).
    """
    states = transition.shape[0]
    device = transition.device
    j = torch.arange(states, device=device)[None, :]
    dd = torch.arange(width, device=device)[:, None]
    i = j + dd + lo
    valid = (i >= 0) & (i < states)
    gathered = transition[j.expand_as(i), i.clamp(0, states - 1)]
    return torch.where(
        valid, gathered, torch.tensor(NEG_INF, device=device)).contiguous()


def band_forward_reference(observation, batch_frames, initial, band,
                           band_matrix):
    """Plain PyTorch version of the banded forward kernel (K1).

    observation: (batch, frames, states) float32 log-probabilities
    batch_frames: (batch,) int32
    initial: (states,) float32
    band: (lo, width, floor) from detect_band
    band_matrix: (width, states) float32 from build_band_matrix

    Returns
        post_seq: (batch, frames, states) float32; post_seq[:, t] is the
            posterior after consuming frame t, frozen for t >= batch_frames
        posterior: (batch, states) float32 final posterior (post_seq[:, -1])
    """
    lo, width, floor = band
    batch, frames, states = observation.shape
    device = observation.device
    post = observation[:, 0, :] + initial[None, :]
    post_seq = torch.empty_like(observation)
    post_seq[:, 0] = post
    if floor is not None:
        floor_t = torch.tensor(floor, dtype=torch.float32, device=device)
    # Source windows: padded[:, start + j + d] = post[:, j + d + lo], -inf
    # outside [0, states)
    left = max(0, -lo)
    right = max(0, lo + width - 1)
    start = lo + left
    band_t = band_matrix.t()  # (states, width)
    for t in range(1, frames):
        if width:
            padded = torch.nn.functional.pad(
                post, (left, right), value=NEG_INF)
            windows = padded.unfold(1, width, 1)[:, start:start + states]
            score = (windows + band_t[None]).amax(dim=-1)
        else:
            score = torch.full_like(post, NEG_INF)
        if floor is not None:
            score = torch.maximum(
                score, post.amax(dim=1, keepdim=True) + floor_t)
        valid = (t < batch_frames)[:, None]
        post = torch.where(valid, observation[:, t, :] + score, post)
        post_seq[:, t] = post
    return post_seq, post_seq[:, -1]


def viterbi_forward_band(observation, batch_frames, initial, band,
                         band_matrix):
    """Banded forward pass: the K1 kernel (csrc/band_forward.cu) on CUDA
    tensors, its plain version on CPU tensors. Arguments and results as in
    ``band_forward_reference``; all tensors contiguous on one device."""
    lo, width, floor = band
    if width == 0 and floor is None:
        raise ValueError(
            'band width 0 requires a finite floor (constant transition)')
    device = observation.device
    if device.type == 'cpu':
        return band_forward_reference(
            observation, batch_frames, initial, band, band_matrix)
    batch, frames, states = observation.shape
    build.check('observation', observation, (batch, frames, states),
                torch.float32, device)
    build.check('batch_frames', batch_frames, (batch,), torch.int32, device)
    build.check('initial', initial, (states,), torch.float32, device)
    build.check('band_matrix', band_matrix, (width, states), torch.float32,
                device)
    post_seq = torch.empty_like(observation)
    if batch and frames:
        lib = _library()
        with torch.cuda.device(device):
            code = lib.band_forward(
                build.pointer(observation), build.pointer(batch_frames),
                build.pointer(initial), build.pointer(band_matrix),
                build.pointer(post_seq), batch, frames, states, lo, width,
                0.0 if floor is None else floor, int(floor is not None),
                build.stream(device))
        build.raise_on_error(lib, 'band_forward', code)
        viterbi_forward_band.launches += 1
    return post_seq, post_seq[:, -1]


viterbi_forward_band.launches = 0


def spread_smem_bytes(states, width):
    """Shared memory per CTA of K4 (csrc/band_spread.cu, make_layout and
    smem_floats): a cluster of 8 CTAs, 8 destinations per warp, each CTA
    holding two copies of the posterior, two tables of warp maxima, a ring
    of 4 staged observation rows and its (width, stride) band slice"""
    per_cta = -(-states // 8)
    warps = min(32, -(-per_cta // 8))
    slots = -(-per_cta // (warps * 8))
    stride = -(-max(per_cta - 8, 0) // 32) * 32 + 8
    floats = (2 * states + 2 * 8 * warps + 4 * slots * warps * 32
              + width * stride)
    return 4 * floats


def spread_fits(states, width):
    """Whether K4 takes a band of this width at this many states"""
    return spread_smem_bytes(states, width) <= SPREAD_SMEM_BYTES


def band_spread_reference(observation, batch_frames, initial, band,
                          band_matrix):
    """Plain PyTorch version of the batch-1 banded forward kernel (K4):
    ``band_forward_reference`` on the one sequence"""
    if observation.shape[0] != 1:
        raise ValueError(
            f'the batch-1 forward takes one sequence, got batch '
            f'{observation.shape[0]}')
    return band_forward_reference(
        observation, batch_frames, initial, band, band_matrix)


def viterbi_forward_band_spread(observation, batch_frames, initial, band,
                                band_matrix):
    """Batch-1 banded forward pass: the K4 kernel (csrc/band_spread.cu),
    which spreads one sequence over a cluster of CTAs, on CUDA tensors; its
    plain version on CPU tensors. Arguments and results as in
    ``band_forward_reference`` with batch 1. On the card it raises when
    the band does not fit (``spread_fits``)."""
    lo, width, floor = band
    if width == 0 and floor is None:
        raise ValueError(
            'band width 0 requires a finite floor (constant transition)')
    device = observation.device
    if device.type == 'cpu':
        return band_spread_reference(
            observation, batch_frames, initial, band, band_matrix)
    _, frames, states = observation.shape
    build.check('observation', observation, (1, frames, states),
                torch.float32, device)
    build.check('batch_frames', batch_frames, (1,), torch.int32, device)
    build.check('initial', initial, (states,), torch.float32, device)
    build.check('band_matrix', band_matrix, (width, states), torch.float32,
                device)
    post_seq = torch.empty_like(observation)
    if frames:
        lib = _spread_library()
        with torch.cuda.device(device):
            code = lib.band_spread(
                build.pointer(observation), build.pointer(batch_frames),
                build.pointer(initial), build.pointer(band_matrix),
                build.pointer(post_seq), frames, states, lo, width,
                0.0 if floor is None else floor, int(floor is not None),
                build.stream(device))
        build.raise_on_error(lib, 'band_spread', code)
        viterbi_forward_band_spread.launches += 1
    return post_seq, post_seq[:, -1]


viterbi_forward_band_spread.launches = 0


def _library():
    lib = build.library('band_forward')
    lib.band_forward.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.band_forward.restype = ctypes.c_int
    return lib


def _spread_library():
    lib = build.library('band_spread')
    lib.band_spread.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.band_spread.restype = ctypes.c_int
    return lib
