"""Backend dispatch for Viterbi decoding.

Counterpart of ``torbi_tpu/ops/dispatch.py::decode``, with its order of
decisions. One decode takes one of these routes:

- ``backend='scan'``: the plain PyTorch recursion with an int32 trellis
  (ops/scan.py);
- ``backend='lse'``: the approximate smoothed-max forward pass as a matrix
  product a frame, then the backtrace kernel (K3) over its posteriors
  (ops/lse.py);
- ``backend='timesharded'`` (one sequence), or the auto policy of the
  kernel backend where it pays: the exact frame-sharded decode over the
  ranks of the torch.distributed process group (parallel/timesharded.py,
  its max-plus products by K8);
- a constant transition (a width-0 band over a finite floor, such as the
  uniform default): a closed form of parallel torch passes around one
  kernel, K7, the scalar recurrence (ops/constant.py);
- a banded transition: the banded forward kernel, then a chase kernel;
- a transition no band holds whose exterior is -inf and whose positive
  pairs are few (``sparse.detect_sparse``): the in-list route, the sparse
  forward kernel (K9) over each destination's sources alone, then its
  chase (K10) (ops/sparse.py);
- any other transition: the dense forward kernel (K2), then the backtrace
  kernel (K3).

A banded transition at batch > 1 takes K1 (its cluster design, or its
wide-band design where no cluster layout fits: ``band.forward_kernel``),
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
forward kernels (K1, K4) and the sparse one (K9), which convert each value
as they load it, as in the JAX package (its ``fold_obs``): the banded,
auto-chunk and in-list routes make no converted copy of the observation.
The constant closed form, the dense route, ``'scan'``, ``'lse'`` and the
time-sharded route convert first
(``convert``: its span ``torbi.convert`` and its counter ``convert.values``),
as the JAX package does. ``decode.dense_reasons`` counts the decodes that
launch the dense kernel by why the banded kernels declined them.

CUDA kernels take runtime shapes, so the JAX package's frame and batch
buckets, state padding, packed mod-M input and batch-sharding
``shard_map`` mesh have no counterpart here; the time-sharded route's
shards are the ranks of a process group, where the JAX package takes its
local devices. A decode of one rank's share of a job split over the ranks
(``rank_share``: ``parallel.decode_sharded``, ``parallel.files``, the
sharded evaluation) weighs one shard, as a JAX host weighs its own
devices. On a CPU device the kernel routes run the kernels' plain
versions.
"""
import contextlib
import threading

import numpy as np
import torch

from . import autochunk
from . import band as band_ops
from . import constant as constant_ops
from . import sparse as sparse_ops
from .backtrace import (
    FUSED1_MAX_STATES, backtrace_fused1, backtrace_posteriors,
    backtrace_window, window_rows)
from .dense import viterbi_forward_dense
from .lse import decode_lse
from .scan import decode_scan
from ..utils import timing
from ..utils.cache import identity_cached as _identity_cached
from ..utils.convert import resolve_device, to_tensor

FP32_TINY = float(np.finfo(np.float32).tiny)

# The band matrix depends only on the transition, so it is built once per
# (live, unmodified) transition tensor
_band_matrix_cache = {}


def _round_up(value, multiple):
    return ((value + multiple - 1) // multiple) * multiple


class _Share(threading.local):
    """This thread's ``rank_share``: whether it decodes one rank's share of
    a split job, and the batch of the whole job (None for a file share)"""
    active = False
    batch = None


_share = _Share()


@contextlib.contextmanager
def rank_share(batch=None):
    """Decode, inside the ``with`` block, one rank's share of a job that the
    ranks of a process group split between them (parallel/sharded.py,
    parallel/files.py, the sharded evaluation).

    Each rank decodes other rows, so no decode inside may join a
    collective the other ranks do not: the time-sharded auto policy weighs
    one shard, as the JAX package's weighs a host's local devices, and
    ``backend='timesharded'`` raises. ``batch`` is the batch of the whole
    job when the share is a slice of one array (``decode_sharded``): the
    batch-1 auto-chunking then opens only for a job of one sequence, so a
    slice of one row decodes as the whole batch does."""
    saved = _share.active, _share.batch
    _share.active, _share.batch = True, batch
    try:
        yield
    finally:
        _share.active, _share.batch = saved


BACKENDS = ('kernel', 'scan', 'lse', 'timesharded')


def resolve_backend(backend=None):
    """Resolve None/'auto' to a concrete backend: 'kernel', 'scan', 'lse'
    or 'timesharded'"""
    import torbi_tpu_torch

    backend = backend or torbi_tpu_torch.BACKEND
    if backend == 'auto':
        return 'kernel'
    if backend in BACKENDS:
        return backend
    raise ValueError(
        f"unknown backend {backend!r}; expected 'auto' or one of "
        f'{BACKENDS}')


def timesharded_shard_count(frames, shards):
    """Largest shard count up to ``shards`` that divides the sequence
    length (the JAX dispatcher's _timesharded_mesh_size)"""
    for count in range(shards, 1, -1):
        if frames % count == 0:
            return count
    return 1


def timesharded_auto(backend, batch, frames, states, shards):
    """Whether the auto policy sends a decode to the time-sharded route:
    the kernel backend, ``TIME_SHARDED_AUTO``, one sequence of at least
    ``TIME_SHARDED_MIN_FRAMES`` frames, and more shards (ranks of the
    process group) than twice the states. On one card (one shard) it never
    does."""
    import torbi_tpu_torch

    return (backend == 'kernel'
            and bool(torbi_tpu_torch.TIME_SHARDED_AUTO)
            and batch == 1
            and frames >= int(torbi_tpu_torch.TIME_SHARDED_MIN_FRAMES)
            and shards > 2 * states)


def _decode_timesharded(observation, batch_frames, transition, initial,
                        log_input, apply_epsilon, device):
    """Route one batch row through the exact time-sharded decoder
    (parallel/timesharded.py) over the largest leading set of the default
    group's ranks whose count divides the valid frames; ranks outside it
    receive the path by broadcast. Frames past ``batch_frames[0]`` hold the
    last decoded state, the seed's broadcast."""
    import torch.distributed as dist

    from ..parallel import mesh
    from ..parallel.timesharded import decode_time_sharded

    states = int(transition.shape[0])
    frames = observation.shape[1]
    valid = int(batch_frames[0])
    obs = observation[0, :valid, :states].to(device)
    if not log_input or apply_epsilon:
        with timing.span('torbi.convert'):
            _convert_counters.values += obs.numel()
            obs = convert(obs, log_input, apply_epsilon)
    obs = obs.contiguous()
    size, group = mesh.shards()
    count = timesharded_shard_count(obs.shape[0], size)
    sub = mesh.leading_group(count, group)
    if sub == dist.GroupMember.NON_GROUP_MEMBER:
        decoded = torch.empty(obs.shape[0], dtype=torch.int32, device=device)
    else:
        decoded = decode_time_sharded(obs, transition, initial, group=sub)
    if count != size:
        dist.broadcast(decoded, src=dist.get_global_rank(group, 0),
                       group=group)
    if decoded.shape[0] < frames:
        decoded = torch.cat([decoded, decoded[-1:].expand(
            frames - decoded.shape[0])])
    return decoded[None]


def _shard_count():
    """The shard count the auto policy weighs: the size of the default
    process group, 1 without one"""
    from ..parallel import mesh

    return mesh.shards()[0]


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


# Elements of the observation that the routes' conversion passes converted
# (``decode`` and the time-sharded route; the banded kernels convert as
# they load, and count nothing). Counted on this function object, not
# through the module's name, which a wrapper (the tests' spies) may rebind;
# so is ``decode.dense_reasons``
convert.values = 0
_convert_counters = convert


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
    through K1's cluster design ('band_forward') or its wide-band design
    ('band_forward_wide'), as ``band.forward_kernel`` picks by shape, K4
    ('band_spread') or K2 ('dense_forward'); the banded ones convert the
    observation as they load it, K2 takes it converted (other flags
    raise). ``chase(post_seq, posterior, batch_frames)`` gives the indices
    through K3 ('backtrace'), K5 ('backtrace_fused1') or K6
    ('backtrace_window'); K5 and K6 count their launches per phase (K5's
    'backtrace_pointers', K6's 'backtrace_window', both 'chase_pointers').
    Each call runs inside the span ``torbi.forward.<name>`` or
    ``torbi.chase.<name>`` (``utils/timing.py``).
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
        chase = ('backtrace_fused1', lambda post, posterior, bf: (
            backtrace_fused1(post, transition, posterior, bf, band, matrix)))
    elif chase == 'window':
        chase = ('backtrace_window', lambda post, posterior, bf: (
            backtrace_window(post, transition, posterior, bf, band, matrix)))
    else:
        chase = ('backtrace', lambda post, posterior, bf: (
            backtrace_posteriors(post, transition, posterior, bf)))
    return _spanned('forward', *forward), _spanned('chase', *chase)


def sparse_route(lists):
    """The forward and the chase of the in-list route for a transition of
    these in-lists (``sparse.detect_sparse``), as ``kernel_route`` gives
    its own: ``forward(obs, batch_frames, initial, log_input=True,
    apply_epsilon=False)`` gives (pointers, posterior) through K9
    ('sparse_forward', converting the observation as it loads it), and
    ``chase(pointers, posterior, batch_frames)`` the indices through K10
    ('sparse_backtrace'), each inside its span"""
    def forward(obs, bf, initial, log_input=True, apply_epsilon=False):
        return sparse_ops.viterbi_forward_sparse(
            obs, bf, initial, lists, log_input, apply_epsilon)

    def chase(pointers, posterior, bf):
        return sparse_ops.backtrace_sparse(pointers, posterior, bf, lists)

    return (_spanned('forward', 'sparse_forward', forward),
            _spanned('chase', 'sparse_backtrace', chase))


def _spanned(role, name, call):
    """(name, ``call`` inside the span ``torbi.<role>.<name>``)"""
    return name, timing.spanned(f'torbi.{role}.{name}')(call)


@timing.spanned('torbi.decode')
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
    if backend == 'timesharded' and _share.active:
        # Raised on every rank, an empty share's too, before any collective
        raise ValueError(
            "backend='timesharded' splits one sequence over the ranks; a "
            "decode of one rank's share of a split job cannot take it")
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

    # Exact time-sharded route for one long sequence: forced by
    # backend='timesharded', or taken by the auto policy where sharding
    # the frames over the process group's ranks beats the serial kernels.
    # One rank's share of a split job weighs one shard: the other ranks
    # decode other rows and would never join its collectives
    if backend == 'timesharded' or timesharded_auto(
            backend, batch, frames, states,
            1 if _share.active else _shard_count()):
        if batch != 1:
            raise ValueError(
                "backend='timesharded' decodes one sequence (batch 1), "
                f'got batch {batch}')
        return _decode_timesharded(
            observation, batch_frames, transition, initial, log_input,
            apply_epsilon, device)

    # Banded route: bit-exact when the transition structure and the
    # finiteness preconditions allow it (ops/band.py docstring). The
    # observation's finiteness is that of what the kernel sees, after the
    # log conversion. ``reason`` says why a decode that launches K2 took
    # the dense route (``decode.dense_reasons``)
    band = None
    reason = 'backend'
    if backend == 'kernel' and torbi_tpu_torch.USE_BAND_KERNEL:
        detected = band_ops.detect_band(transition)
        band = band_ops.gate_band(
            detected, initial, observation=None, finite_observation=True)
        reason = 'width' if detected is None else 'floor'
        if band is not None and not finite_observation:
            view = observation[..., :states]
            finite = torch.isfinite(view)
            if not log_input:
                finite &= view > 0
            if not bool(finite.all()):
                band, reason = None, 'observation'
    constant = band is not None and band[1] == 0
    # In-list route: a transition no band holds, its exterior -inf and its
    # positive pairs few, decided from the transition alone; an observation
    # holding NaN or +inf stays on the dense route, as on the band gate
    lists = None
    if band is None and backend == 'kernel':
        lists = sparse_ops.detect_sparse(transition)
        if (lists is not None and not finite_observation
                and not sparse_ops.observation_holds(
                    observation[..., :states], log_input)):
            lists = None
    # The banded and sparse kernels convert the observation as they load
    # it (the JAX dispatcher's fold_obs); every other route converts first
    fold = (band is not None and backend == 'kernel'
            and not constant) or lists is not None

    # Batch-1 auto-chunking: a single long banded sequence decodes as
    # entropy-chunk rows (ops/autochunk.py); None falls through to the
    # serial decode. A slice of a larger batch (rank_share) is not one
    if (batch == 1 and _share.batch in (None, 1)
            and band is not None and band[1] > 0
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
    # cut off), 4 bytes each per state, and the posterior stream (4 bytes a
    # state; the in-list route's int16 pointers, 2; none on the constant
    # route). Oversized batches split into independent row
    # groups (batch rows are independent; the result is bitwise the same). A
    # host observation is sliced before any transfer, so the device only
    # holds the groups; a device-resident one stays whole and its groups
    # queue on the stream, each freed as the next is decoded.
    copies = 1 if states_in == states and (
        fold or (log_input and not apply_epsilon)) else 2
    stream = 0 if constant else (2 if lists is not None else 4) * states
    row_bytes = frames * (4 * states_in * copies + stream)
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

    obs = observation.to(device, non_blocking=True)
    if states_in != states:
        obs = obs[..., :states]
    if not fold and (not log_input or apply_epsilon):
        with timing.span('torbi.convert'):
            _convert_counters.values += obs.numel()
            obs = convert(obs, log_input, apply_epsilon)
    obs = obs.contiguous()

    if backend == 'scan':
        return decode_scan(obs, batch_frames, transition, initial)
    if backend == 'lse':
        return decode_lse(obs, batch_frames, transition, initial,
                          beta=float(torbi_tpu_torch.LSE_BETA))
    if constant:
        return constant_ops.decode_constant(
            obs, batch_frames, initial, band[2])
    if lists is not None:
        (_, forward), (_, chase) = sparse_route(lists)
    else:
        if band is None:
            _decode_counters.dense_reasons[reason] += 1
        (_, forward), (_, chase) = kernel_route(transition, band, batch)
    flags = (log_input, apply_epsilon) if fold else (True, False)
    post_seq, posterior = forward(obs, batch_frames, initial, *flags)
    return chase(post_seq, posterior, batch_frames)


# Decodes that launched the dense forward kernel (K2), by the reason the
# banded kernels declined the transition: 'width' (``detect_band`` finds no
# band within ``BAND_MAX_FRACTION`` of the states, and the in-list route
# declined it too), 'floor' (the band's
# exterior asks more of the initial distribution than it gives:
# ``gate_band``), 'observation' (an observation that is not finite, or
# not positive as probabilities) or 'backend' (``USE_BAND_KERNEL`` off)
decode.dense_reasons = {
    'width': 0, 'floor': 0, 'observation': 0, 'backend': 0}
_decode_counters = decode
