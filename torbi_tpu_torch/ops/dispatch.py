"""Backend dispatch for Viterbi decoding.

Counterpart of ``torbi_tpu/ops/dispatch.py::decode``, with its order of
decisions. One decode takes one of these routes:

- ``backend='scan'``: the plain PyTorch recursion with an int32 trellis
  (ops/scan.py);
- a constant transition (a width-0 band over a finite floor, such as the
  uniform default): a closed form of parallel torch passes, no kernel;
- a banded transition: the banded forward kernel, then a chase kernel;
- any other transition: the dense forward kernel (K2), then the backtrace
  kernel (K3).

A banded transition at batch > 1 takes K1 (its cluster design, or its
per-CTA design where no cluster layout fits: ``band.forward_kernel``),
then K3. One banded sequence (batch 1, band width > 0) routes as in the
JAX package:

1. auto-chunking first: a sequence of ``BATCH1_AUTO_CHUNK_MIN_FRAMES`` or
   more frames decodes as entropy-chunk rows through K1 and K3
   (ops/autochunk.py) when ``BATCH1_AUTO_CHUNK`` is set and a plan pays;
2. otherwise the forward pass is K4 (``BAND_BATCH1_SPREAD``, when its
   layout holds the band, ``band.spread_fits``) or K1;
3. then the chase: K5 (``BACKTRACE_BATCH1_FUSED``, up to
   ``backtrace.FUSED1_MAX_STATES`` states; its backpointers come from the
   gated band and the band matrix K4 reads), else K6
   (``BACKTRACE_BATCH1_WINDOW``, only for a band with no floor whose
   window fits, as the JAX gate measures it), else K3.

The probability->log conversion and the epsilon step fold into the banded
forward kernels (K1, K4), which convert each value as they load it, as in
the JAX package (its ``fold_obs``): the banded and auto-chunk routes make
no converted copy of the observation. The constant closed form, the dense
route and ``'scan'`` convert first (``convert``), as the JAX package does.

CUDA kernels take runtime shapes, so the JAX package's frame and batch
buckets, state padding, packed mod-M input, ``shard_map`` mesh and
time-sharded route have no counterpart here. On a CPU device the kernel
routes run the kernels' plain versions.
"""
import numpy as np
import torch

from . import autochunk
from . import band as band_ops
from .backtrace import (
    FUSED1_MAX_STATES, backtrace_fused1, backtrace_posteriors,
    backtrace_window, window_rows)
from .dense import viterbi_forward_dense
from .scan import decode_scan
from ..utils.cache import identity_cached as _identity_cached
from ..utils.convert import resolve_device, to_tensor

FP32_TINY = float(np.finfo(np.float32).tiny)

# The band matrix depends only on the transition, so it is built once per
# (live, unmodified) transition tensor
_band_matrix_cache = {}


def _round_up(value, multiple):
    return ((value + multiple - 1) // multiple) * multiple


def resolve_backend(backend=None):
    """Resolve None/'auto' to a concrete backend: 'kernel' or 'scan'"""
    import torbi_tpu_torch

    backend = backend or torbi_tpu_torch.BACKEND
    if backend == 'auto':
        return 'kernel'
    if backend in ('kernel', 'scan'):
        return backend
    if backend in ('lse', 'timesharded'):
        raise NotImplementedError(
            f"backend='{backend}' is not ported yet (ROADMAP.md, queue A, "
            'item A10: the smoothed-max, associative and time-sharded '
            'modes)')
    raise ValueError(
        f"unknown backend {backend!r}; expected 'auto', 'kernel' or 'scan'")


def convert(observation, log_input, apply_epsilon):
    """The probability->log conversion and the reference's epsilon step
    ``log(exp(x) + tiny)``, as elementwise torch ops in that order. Works
    in place on the one copy it makes; returns the input when there is
    nothing to convert."""
    if not log_input:
        observation = torch.log(observation)
        if apply_epsilon:
            observation.exp_().add_(FP32_TINY).log_()
    elif apply_epsilon:
        observation = torch.exp(observation)
        observation.add_(FP32_TINY).log_()
    return observation


def _band_matrix(transition, band):
    return _identity_cached(
        _band_matrix_cache, transition,
        lambda: band_ops.build_band_matrix(transition, band[0], band[1]),
        extra_key=band)


def _batch1_chase(band, states):
    """The chase of a single banded sequence: 'fused' (K5), 'window' (K6)
    or None (K3), as the JAX dispatcher's _use_fused_chase and
    _use_window_chase choose. The window chase also needs a band without a
    floor: with a finite floor the path can leave the window."""
    import torbi_tpu_torch

    if (torbi_tpu_torch.BACKTRACE_BATCH1_FUSED
            and states <= FUSED1_MAX_STATES):
        return 'fused'
    if (not torbi_tpu_torch.BACKTRACE_BATCH1_FUSED
            and torbi_tpu_torch.BACKTRACE_BATCH1_WINDOW
            and band[2] is None
            and window_rows(band[1]) <= _round_up(states, 128) // 128):
        return 'window'
    return None


def kernel_route(transition, band, batch):
    """The forward kernel and the chase kernel that ``decode`` launches for
    a transition with this gated ``band`` (None: dense) once it neither
    decodes in closed form nor auto-chunks.

    Returns ((forward name, forward), (chase name, chase)), the names those
    of the wrappers' launch counters: ``forward(obs, batch_frames, initial,
    log_input=True, apply_epsilon=False)`` gives (post_seq, posterior)
    through K1's cluster design ('band_forward') or its per-CTA design
    ('band_forward_cta'), as ``band.forward_kernel`` picks by shape, K4
    ('band_spread') or K2 ('dense_forward'); the banded ones convert the
    observation as they load it, K2 takes it converted (other flags
    raise). ``chase(post_seq, posterior, batch_frames)`` gives the indices
    through K3 ('backtrace'), K5 ('backtrace_fused1') or K6
    ('backtrace_window'); K5 and K6 count their launches per phase (K5's
    'backtrace_pointers', K6's 'backtrace_window', both 'chase_pointers').
    """
    import torbi_tpu_torch

    states = int(transition.shape[0])
    if band is None:
        def dense_forward(obs, bf, initial, log_input=True,
                          apply_epsilon=False):
            if not log_input or apply_epsilon:
                raise ValueError(
                    'the dense forward kernel takes a converted observation '
                    '(dispatch.convert first)')
            return viterbi_forward_dense(obs, bf, transition, initial)

        forward = ('dense_forward', dense_forward)
    else:
        # K4, K5 and K6 read the same band matrix
        matrix = _band_matrix(transition, band)
        spread = (batch == 1 and band[1] > 0
                  and torbi_tpu_torch.BAND_BATCH1_SPREAD
                  and band_ops.spread_fits(states, band[1]))
        name, kernel = (
            ('band_spread', band_ops.viterbi_forward_band_spread) if spread
            else band_ops.forward_kernel(states, band[1]))
        forward = (name, lambda obs, bf, initial, log_input=True,
                   apply_epsilon=False: kernel(
                       obs, bf, initial, band, matrix, log_input,
                       apply_epsilon))
    chase = (_batch1_chase(band, states)
             if batch == 1 and band is not None else None)
    if chase == 'fused':
        return forward, ('backtrace_fused1', lambda post, posterior, bf: (
            backtrace_fused1(post, transition, posterior, bf, band, matrix)))
    if chase == 'window':
        return forward, ('backtrace_window', lambda post, posterior, bf: (
            backtrace_window(post, transition, posterior, bf, band, matrix)))
    return forward, ('backtrace', lambda post, posterior, bf: (
        backtrace_posteriors(post, transition, posterior, bf)))


def _decode_constant(observation, batch_frames, initial, floor):
    """Closed-form decode for a constant transition (every candidate is
    ``floor``), bitwise equal to the banded recursion.

    Forward: post[t][s] = fl(obs[t][s] + m_t) with the scalar per-row carry
    m_t = fl(g_{t-1} + floor), g_t = max_s post[t][s]; fp rounding is
    monotone, so max_s fl(obs[s] + c) = fl(max_s obs[s] + c) and g follows
    a scalar recurrence over per-frame observation maxima. Backtrace: every
    destination's backpointer is the same first argmax of
    fl(post[t-1] + floor), so no chase is needed. Every fp add happens in
    the order of the JAX package's closed form.
    """
    batch, frames, _ = observation.shape
    device = observation.device
    floor_t = torch.tensor(floor, dtype=torch.float32, device=device)
    bf = batch_frames

    post0 = observation[:, 0, :] + initial[None, :]     # (B, S)
    g = post0.amax(dim=1)                                # (B,)
    maxima = observation.amax(dim=2)                     # (B, T)
    ms = torch.empty(
        (batch, frames - 1), dtype=torch.float32, device=device)
    for t in range(1, frames):
        gm = g + floor_t                                 # m_t
        ms[:, t - 1] = gm
        # Freeze past each row's last valid frame
        g = torch.where(t < bf, maxima[:, t] + gm, g)

    # Backpointers: first argmax of fl(post + floor) per frame
    pred0 = (post0 + floor_t).argmax(dim=1)
    pred_rest = (
        (observation[:, 1:, :] + ms[:, :, None]) + floor_t).argmax(dim=2)
    pred = torch.cat([pred0[:, None], pred_rest], dim=1).to(torch.int32)

    # Seed: first argmax of the posterior at each row's last valid frame
    last = (bf.long() - 1).clamp(0, frames - 1)          # (B,)
    rows = torch.arange(batch, device=device)
    obs_last = observation[rows, last]                   # (B, S)
    m_last = torch.nn.functional.pad(ms, (1, 1))[rows, last][:, None]
    post_last = torch.where(
        (last == 0)[:, None], post0, obs_last + m_last)
    seed = post_last.argmax(dim=1).to(torch.int32)

    t = torch.arange(frames, device=device)[None, :]
    # Positions bf-1 .. T-1 hold the seed
    return torch.where(t >= bf[:, None] - 1, seed[:, None], pred)


def decode(observation, batch_frames, transition, initial, backend=None,
           finite_observation=False, log_input=True, apply_epsilon=False,
           device=None):
    """Decode log-space inputs.

    observation: (batch, frames, states) float32 log-probs (probabilities
        when ``log_input=False``), a tensor or array anywhere; a host
        observation is moved to ``device`` group by group (see the memory
        guard). Its state dimension may be pre-padded to the next multiple
        of 128 (the padding is ignored).
    batch_frames: (batch,) int32
    transition: (states, states) float32 log-probs (row = destination)
    initial: (states,) float32 log-probs
    apply_epsilon: apply the reference's exp/+tiny/log stabilization (its
        output is finite for finite or -inf inputs, so it implies
        ``finite_observation``)
    device: the decode device (None is cuda:0; 'cpu' runs the kernels'
        plain versions)

    Returns (batch, frames) int32 decoded state indices on ``device``.
    """
    import torbi_tpu_torch

    backend = resolve_backend(backend)
    device = resolve_device(device)
    observation = to_tensor(observation, torch.float32)
    if observation.ndim != 3:
        raise ValueError(
            'observation must be (batch, frames, states), got shape '
            f'{tuple(observation.shape)} (the packed 4-D layout of the JAX '
            'package exists only for its TPU kernel)')
    batch, frames, states_in = observation.shape
    transition = to_tensor(transition, torch.float32, device).contiguous()
    initial = to_tensor(initial, torch.float32, device).contiguous()
    batch_frames = to_tensor(batch_frames, torch.int32, device).contiguous()
    states = int(transition.shape[0])
    if tuple(transition.shape) != (states, states):
        raise ValueError(
            f'transition must be square, got {tuple(transition.shape)}')
    if tuple(initial.shape) != (states,):
        raise ValueError(
            f'initial has shape {tuple(initial.shape)}, expected ({states},)')
    if tuple(batch_frames.shape) != (batch,):
        raise ValueError(
            f'batch_frames has shape {tuple(batch_frames.shape)}, expected '
            f'({batch},)')
    if states_in not in (states, _round_up(states, 128)):
        raise ValueError(
            f'observation has {states_in} states but the transition has '
            f'{states} (pre-padded observations must pad to the next '
            f'128 multiple with -inf)')
    if batch == 0 or frames == 0:
        return torch.zeros((batch, frames), dtype=torch.int32, device=device)
    if apply_epsilon:
        finite_observation = True

    # Banded route: bit-exact when the transition structure and the
    # finiteness preconditions allow it (ops/band.py docstring). The
    # observation's finiteness is that of what the kernel sees, after the
    # log conversion.
    band = None
    if backend == 'kernel' and torbi_tpu_torch.USE_BAND_KERNEL:
        band = band_ops.gate_band(
            band_ops.detect_band(transition), initial,
            observation=None, finite_observation=True)
        if band is not None and not finite_observation:
            view = observation[..., :states]
            finite = torch.isfinite(view)
            if not log_input:
                finite &= view > 0
            if not bool(finite.all()):
                band = None
    constant = band is not None and band[1] == 0
    # The banded kernels convert the observation as they load it (the JAX
    # dispatcher's fold_obs); every other route converts first
    fold = band is not None and backend == 'kernel' and not constant

    # Batch-1 auto-chunking: a single long banded sequence decodes as
    # entropy-chunk rows (ops/autochunk.py); None falls through to the
    # serial decode
    if (batch == 1 and band is not None and band[1] > 0
            and backend == 'kernel'
            and frames >= int(torbi_tpu_torch.BATCH1_AUTO_CHUNK_MIN_FRAMES)
            and bool(torbi_tpu_torch.BATCH1_AUTO_CHUNK)):
        # One copy on the device serves the entropy pass, the chunk rows
        # and, when the route declines, the serial decode below
        observation = observation.to(device)
        chunked = autochunk.decode_chunked(
            observation, batch_frames, transition, initial, states=states,
            band=band, band_matrix=_band_matrix(transition, band),
            log_input=log_input, apply_epsilon=apply_epsilon, device=device)
        if chunked is not None:
            return chunked

    # Memory guard: a decode holds the observation, a converted copy of it
    # when the conversion runs outside the kernels (or the state padding is
    # cut off), and the posterior stream (none on the constant route), 4
    # bytes each per state. Oversized batches split into independent row
    # groups (batch rows are independent; the result is bitwise the same). A
    # host observation is sliced before any transfer, so the device only
    # holds the groups; a device-resident one stays whole and its groups
    # queue on the stream, each freed as the next is decoded.
    copies = 1 if states_in == states and (
        fold or (log_input and not apply_epsilon)) else 2
    row_bytes = frames * (
        states_in * copies + (0 if constant else states)) * 4
    budget = int(torbi_tpu_torch.DECODE_MEMORY_BUDGET)
    if batch > 1 and batch * row_bytes > budget:
        rows = max(1, budget // row_bytes)
        return torch.cat([
            decode(
                observation[start:start + rows],
                batch_frames[start:start + rows], transition, initial,
                backend=backend, finite_observation=finite_observation,
                log_input=log_input, apply_epsilon=apply_epsilon,
                device=device)
            for start in range(0, batch, rows)])

    obs = observation.to(device)
    if states_in != states:
        obs = obs[..., :states]
    if not fold:
        obs = convert(obs, log_input, apply_epsilon)
    obs = obs.contiguous()

    if backend == 'scan':
        return decode_scan(obs, batch_frames, transition, initial)
    if constant:
        return _decode_constant(obs, batch_frames, initial, band[2])
    (_, forward), (_, chase) = kernel_route(transition, band, batch)
    flags = (log_input, apply_epsilon) if fold else (True, False)
    post_seq, posterior = forward(obs, batch_frames, initial, *flags)
    return chase(post_seq, posterior, batch_frames)
