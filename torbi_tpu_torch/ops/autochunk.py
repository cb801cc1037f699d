"""Batch-1 auto-chunking: one long sequence becomes parallel chunk rows.

Counterpart of ``torbi_tpu/ops/autochunk.py``. A single sequence is a
serial chain of dependent frames in the forward pass and in the chase. The
reference's own answer for long sequences is entropy chunking: split at
adjacent low-entropy (locally near-deterministic) frame pairs and decode the
chunks as independent batch rows. ``dispatch.decode`` applies that here for
a single long banded sequence:

1. the framewise normalized entropy runs as torch ops on the decode device
   and comes back as a (frames,) array;
2. split points are planned on the host (``chunk.splits_from_entropy``, the
   greedy boundaries of the user-facing chunker) and cached per device
   observation and ``batch_frames`` tensor (identity and version): a caller
   who decodes one resident buffer again, with the same ``batch_frames``
   tensor, skips the entropy pass, its host round trip, the plan and the
   plan's copies to the device. Every other call (a new observation, a
   host array, the default ``batch_frames`` that ``from_probabilities``
   builds per call) computes its plan afresh. A user decoding a new
   recording pays for the plan on every call, so the benchmark's long
   recordings pass no ``batch_frames``;
3. the chunk rows are gathered out of the sequence at the longest chunk's
   length (lengths mask the rest), decoded as one batch through the banded
   route (K1, in the design ``band.forward_kernel`` picks for the rows,
   converting the raw rows as it loads them, then K3), and the per-row
   paths gathered back into the (1, frames)
   sequence, frames past the valid length frozen at the last decoded state
   (the reference's padded-batch freeze).

Spans (``utils/timing.py``): ``torbi.autochunk.entropy`` (the entropy pass
and its copy to the host), ``torbi.autochunk.plan`` (the host plan, its
arrays and their copies to the device), both inside the plan cache's
``torbi.build``, and ``torbi.autochunk.stitch`` (the paths gathered back).
Counters on ``decode_chunked``, beside the kernels' ``.launches``:
``plans`` (plans computed; cache hits compute none), ``rows`` (chunk rows
decoded) and ``declines`` (calls handed back to the serial route, by
reason: ``memory``, ``frames`` for fewer valid frames than
``BATCH1_AUTO_CHUNK_MIN_FRAMES``, ``plan`` for no plan that pays).

The result is the reference's chunked mode: each chunk decodes with the
caller's initial distribution, so it is bitwise the oracle run per chunk,
and equals the full-sequence path whenever the split frames are
near-deterministic (peaked pitch posteriorgrams). Diffuse observations give
no plan and decode serially; ``torbi_tpu_torch.BATCH1_AUTO_CHUNK = False``
pins the serial decode for every input.
"""
import math

import numpy as np
import torch

import torbi_tpu_torch
from . import backtrace as backtrace_ops
from . import band as band_ops
from ..chunk import splits_from_entropy
from ..utils import timing
from ..utils.cache import identity_cached as _identity_cached

# The JAX package's frame buckets and 8-row backtrace tile, used here only
# to decide whether chunking pays, so that both packages make the same plan
# (torbi_tpu/config/defaults.py FRAME_BUCKETS; its ops/autochunk.py
# plan_splits). This package pads nothing to them.
_FRAME_BUCKETS = (
    64, 128, 256, 512, 640, 1024, 1536, 2048, 4096, 8192, 10240, 16384)
_ROW_TILE = 8

# The JAX package's DECODE_MEMORY_BUDGET (torbi_tpu/config/defaults.py),
# used here only for the auto-chunk size rule, so that both packages chunk
# the same sequences
_JAX_AUTOCHUNK_BUDGET = 4_500_000_000

# Split plans per (observation, batch_frames) tensor, keyed on identity and
# version (utils/cache.py)
_plan_cache = {}


def _bucket_frames(frames):
    for bucket in _FRAME_BUCKETS:
        if frames <= bucket:
            return bucket
    largest = _FRAME_BUCKETS[-1]
    return -(-frames // largest) * largest


def framewise_entropy(observation, states, log_input):
    """Normalized entropy of each frame of a (1, frames, states_in)
    observation, as torch ops on its device: (frames,) float32.

    -inf (log space) or 0.0 (probability space) entries contribute exactly
    zero, as in the JAX package's device entropy pass.
    """
    obs = observation[0, :, :states]
    if log_input:
        terms = torch.where(
            torch.isfinite(obs), torch.exp(obs) * obs, 0.0)
    else:
        terms = torch.where(obs > 0, obs * torch.log(obs), 0.0)
    return -terms.sum(dim=1) / math.log(states)


def plan_splits(entropy_values, valid, target):
    """Host-side split plan: (starts, lengths) int32 arrays, or None when
    chunking cannot pay.

    Aims for about ``target`` frames per chunk and at least 8 rows,
    requires at least 4 rows, and declines unless the 8-row tiles times
    the longest chunk's frame bucket are at most half the bucket of the
    whole sequence (the JAX package's rule, with its buckets). Diffuse
    observations with few confident split points decline.
    """
    n_target = max(8, -(-valid // int(target)))
    min_chunk = max(2, valid // n_target)
    points = splits_from_entropy(
        entropy_values[:valid], min_chunk,
        float(torbi_tpu_torch.ENTROPY_THRESHOLD))
    if len(points) < 3:
        return None
    starts = np.concatenate([[0], points]).astype(np.int32)
    lengths = np.diff(np.concatenate([starts, [valid]])).astype(np.int32)
    bucket = _bucket_frames(int(lengths.max()))
    tiles = -(-len(starts) // _ROW_TILE)
    if tiles * bucket * 2 > _bucket_frames(valid):
        return None
    return starts, lengths


def declines_for_memory(obs_bytes):
    """Whether the route declines an observation of ``obs_bytes``: it may
    take at most 2/5 of the budget, the JAX package's rule (there the
    gathered rows and their converted copy sit beside it; here the rows
    alone, converted in K1). The budget is the smaller of the JAX package's
    (both packages then chunk the same sequences: at 1440 states, up to
    312,500 frames) and this package's ``DECODE_MEMORY_BUDGET``."""
    budget = min(_JAX_AUTOCHUNK_BUDGET,
                 int(torbi_tpu_torch.DECODE_MEMORY_BUDGET))
    return obs_bytes * 5 > budget * 2


def _cached_plan(observation, batch_frames, compute, extra_key):
    per_observation = _identity_cached(_plan_cache, observation, dict)
    return _identity_cached(
        per_observation, batch_frames, compute, extra_key=extra_key)


def decode_chunked(observation, batch_frames, transition, initial, *, states,
                   band, band_matrix, log_input, apply_epsilon, device):
    """Auto-chunked batch-1 decode, or None to fall back to the serial
    kernels (no viable split plan, or the rows would not fit the memory
    budget). Called by ``dispatch.decode`` only, where its preconditions
    hold: batch 1, a banded transition of width > 0, the finiteness the
    band gate needs.

    observation: (1, frames, states_in) float32 on ``device``
    batch_frames: (1,) int32 on ``device``
    transition, initial, band_matrix: on ``device``, as the banded route
        takes them

    Returns (1, frames) int32 decoded indices on ``device``.
    """
    frames = observation.shape[1]
    # A sequence too big for the route decodes serially
    if declines_for_memory(observation.numel() * 4):
        _counters.declines['memory'] += 1
        return None
    target = int(torbi_tpu_torch.BATCH1_CHUNK_FRAMES)
    min_frames = int(torbi_tpu_torch.BATCH1_AUTO_CHUNK_MIN_FRAMES)

    def compute():
        """The plan's device arrays, or the reason the route declines"""
        valid = min(int(batch_frames[0]), frames)
        if valid < min_frames:
            return 'frames'
        _counters.plans += 1
        with timing.span('torbi.autochunk.entropy'):
            entropy = framewise_entropy(
                observation, states, log_input).cpu().numpy()
        with timing.span('torbi.autochunk.plan'):
            split_plan = plan_splits(entropy, valid, target)
            if split_plan is None:
                return 'plan'
            starts, lengths = split_plan
            longest = int(lengths.max())
            # Frame k of row r reads sequence frame starts[r] + k; the
            # frames past a row's length are masked by its length
            gather = np.minimum(
                starts[:, None] + np.arange(longest)[None, :], frames - 1)
            # Output frame t reads row(t) at t - starts[row(t)]; the tail
            # past the valid length holds the last decoded state
            t = np.minimum(np.arange(frames), valid - 1)
            row = np.searchsorted(starts, t, side='right') - 1
            return (torch.from_numpy(gather).to(device),
                    torch.from_numpy(lengths).to(device),
                    torch.from_numpy(row).to(device),
                    torch.from_numpy(t - starts[row]).to(device))

    plan = _cached_plan(
        observation, batch_frames, compute,
        extra_key=(target, float(torbi_tpu_torch.ENTROPY_THRESHOLD),
                   min_frames, states, bool(log_input), str(device)))
    if isinstance(plan, str):
        _counters.declines[plan] += 1
        return None
    gather, lengths, row, column = plan
    _counters.rows += int(gather.shape[0])

    # The gather is a copy; K1 converts the raw rows as it loads them
    rows = observation[0, :, :states][gather]
    name, forward = band_ops.forward_kernel(states, band[1])
    with timing.span(f'torbi.forward.{name}'):
        post_seq, posterior = forward(
            rows, lengths, initial, band, band_matrix, log_input,
            apply_epsilon)
    with timing.span('torbi.chase.backtrace'):
        indices = backtrace_ops.backtrace_posteriors(
            post_seq, transition, posterior, lengths)
    with timing.span('torbi.autochunk.stitch'):
        return indices[row, column][None]


decode_chunked.plans = 0
decode_chunked.rows = 0
decode_chunked.declines = {'memory': 0, 'frames': 0, 'plan': 0}
# The route counts on this function object, not through the module's
# name, which a wrapper (the tests' spies) may rebind
_counters = decode_chunked
