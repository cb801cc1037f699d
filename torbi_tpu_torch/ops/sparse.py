"""Sparse-transition Viterbi: the in-list route.

A transition whose exterior is -inf and whose positive pairs are a small
share of the S^2 (madmom's bar-pointer beat tracker: 8,934 of 31.55M at
5617 states) decodes over each destination's in-list alone, as madmom's
own Viterbi walks its CSR transition model. The dense route (K2, K3) would
visit every pair a frame. For each destination j, its sources i ascending
and their log values v:

    score[j] = max_i (posterior[i] + v)         over j's in-list only
    pointer[t, j] = the lowest i holding it (0 where score[j] is -inf)
    posterior'[j] = observation[t, j] + score[j]
                                        (frozen for t >= batch_frames)

Every candidate outside an in-list is -inf, so the values are the dense
recursion's bitwise, and the pointer is the backpointer K3 recovers from
the dense row. The forward kernel K9 (``viterbi_forward_sparse``,
csrc/sparse_forward.cu) writes the int16 pointers of every frame in place
of the posterior stream, each sequence on a cluster of CTAs that exchange
their slices of the posterior (``forward_plan`` picks the cluster size from
the batch and the card); the chase K10 (``backtrace_sparse``,
csrc/sparse_backtrace.cu) starts from the lowest-index argmax of the last
posterior and follows them back. K9 folds the observation's conversion
into its loads as K1 does (``log_input``, ``apply_epsilon``), so the route
makes no converted copy. On CPU tensors both run their plain versions.

The gate (``detect_sparse``) decides from the transition alone, from the
statistics band detection computes on its one host copy (its floor, the
pairs above it): an exterior of exactly -inf, at most ``MAX_SHARE`` of the
S^2 pairs positive, and at most ``MAX_STATES`` states. It then gathers the
in-lists from the transition where it lives (``in_lists``), once per live,
unmodified tensor.
"""
import collections
import ctypes

import torch

from . import band as band_ops
from . import dense
from ..csrc import build
from ..utils.cache import identity_cached as _identity_cached

NEG_INF = float('-inf')

# The gate's share of positive pairs. K9 visits a frame's in-lists on a
# cluster of CTAs a sequence, K2 every pair over the whole card. At 16 x
# 2048 x 5617 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's beats phase,
# PERF.md) K9 on one CTA a sequence took 10.4 ms against K2's 189.5 at
# madmom's 0.028% of the pairs, 102.8 at 0.12% of random ones, 197.6 at
# 0.33% and 288.0 at 0.97%; at batch 1 madmom's 20.8 against 229.9; pYIN's
# 16.1% at 512 x 861 x 1202: 213.8 against 88.7. So the route takes up to
# 0.2% of the pairs. On clusters K9 takes 4.4, 18.9, 43.0 and 86.5 ms at
# those shares, so the crossover lies past 0.97%; the share moves only
# with a measurement of its own
MAX_SHARE = 0.002
# K9 keeps two frames of the posterior in shared memory (8 bytes a state,
# within the H100's 227 KB opt-in), which also keeps the pointers' indices
# within int16
MAX_STATES = dense.SMEM_BYTES // 8
# K9's layout (csrc/sparse_forward.cu): a cluster of CLUSTER_SIZES CTAs a
# sequence, each a slice of the destinations; up to MAX_THREADS threads a
# CTA, each owning every threads-th destination of the slice; the slice's
# observation staged STAGES - 1 frames ahead in a ring of STAGES frames in
# shared memory where it fits beside the posterior; in-lists of more than
# LIGHT sources (``InLists.heavy``) dealt round-robin to the CTA's warps
MAX_THREADS = 1024
STAGES = 3
LIGHT = 8
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# A cluster spreads a sequence only while each CTA keeps at least this many
# destinations (madmom's slice at 16 CTAs): below it a frame's own work
# on one SM costs about what the exchange between CTAs does (at 97 states
# one CTA a sequence beats two; chip_smoke.py's SPARSE_SPREAD, PERF.md)
MIN_SLICE = 352
# K10's threads a sequence (the seed's argmax, the tail's fill, the
# in-lists' staging; one thread chases)
CHASE_THREADS = 256

# The in-lists of a transition: destination j's sources are
# sources[offsets[j]:offsets[j + 1]] (int16, ascending) with their log
# values; ``destinations`` repeats each j over its in-list (for the plain
# versions); ``pairs`` the positive pairs; ``heavy`` the destinations of
# more than LIGHT sources, ascending (int32, K9's warps take them);
# ``host_offsets`` the offsets on the host (K9's layouts)
InLists = collections.namedtuple(
    'InLists',
    'offsets sources values destinations pairs states heavy host_offsets')

_lists_cache = {}


def detect_sparse(transition):
    """The transition's in-lists (``InLists``) where the in-list route
    takes it, else None: an exterior of exactly -inf (no finite floor), at
    most MAX_SHARE x S^2 positive pairs, at most MAX_STATES states, and
    every pair finite. ``decode`` asks only where ``band.detect_band``
    found no band."""
    states = int(transition.shape[0])
    floor, _, _, pairs = band_ops.transition_stats(transition)
    if (floor != NEG_INF or not 0 < pairs <= MAX_SHARE * states * states
            or states > MAX_STATES):
        return None
    return in_lists(transition)


def in_lists(transition):
    """The in-lists of every pair above -inf, on the transition's device,
    built once per live, unmodified tensor (``utils/cache.py``); None
    where a pair is +inf or NaN. Row = destination, so ``nonzero``'s
    row-major order gives each destination's sources ascending"""
    def gather():
        matrix = torch.as_tensor(transition)
        states = int(matrix.shape[0])
        rows, cols = torch.nonzero(matrix > NEG_INF, as_tuple=True)
        values = matrix[rows, cols].contiguous()
        if not bool(torch.isfinite(values).all()):
            return None
        offsets = torch.zeros(states + 1, dtype=torch.int32,
                              device=matrix.device)
        degrees = torch.bincount(rows, minlength=states)
        offsets[1:] = degrees.cumsum(0)
        heavy = torch.nonzero(degrees > LIGHT).flatten().to(torch.int32)
        return InLists(offsets, cols.to(torch.int16).contiguous(), values,
                       rows, int(rows.numel()), states, heavy,
                       offsets.cpu())

    return _identity_cached(_lists_cache, transition, gather)


def observation_holds(observation, log_input):
    """Whether the observation holds only what the route decodes as the
    dense route does: no NaN and no +inf in log space (probabilities: none
    negative, NaN or +inf); -inf (a zero probability) is decoded alike"""
    if log_input:
        return not bool((torch.isnan(observation)
                         | torch.isposinf(observation)).any())
    return bool(((observation >= 0) & (observation < float('inf'))).all())


def forward_layout(states, pairs, cluster=1, smem=dense.SMEM_BYTES):
    """K9's launch at this shape (csrc/sparse_forward.cu, make_layout):
    ``cluster`` CTAs a sequence, each owning a slice of ``slice``
    destinations (the states at cluster 1, else their share rounded up to
    a multiple of 4); threads a CTA and destinations a thread (``per``);
    whether the slice's observation ring fits in shared memory beside the
    two posterior buffers (``staged``; else each value is loaded on its
    frame), whether the slice's in-lists fit there too (``resident``;
    else they are read from global memory); ``pairs``, the most in-list
    entries of any CTA's slice (every pair at cluster 1,
    ``slice_pairs``); its shared memory bytes, and whether the posterior
    fits at all (``fits``)"""
    share = -(-states // cluster)
    slice_ = states if cluster == 1 else -(-share // 4) * 4
    threads = min(MAX_THREADS, -(-slice_ // 32) * 32)
    posterior = 8 * (states if cluster == 1 else cluster * slice_)
    barriers = 0 if cluster == 1 else 16
    ring = 4 * STAGES * slice_
    lists = 6 * pairs + 4 * (slice_ + 1)

    def total(used):
        # The mbarriers 8-byte aligned after the rest
        return -(-used // 8) * 8 + barriers

    staged = total(posterior + ring) <= smem
    base = posterior + (ring if staged else 0)
    resident = total(base + lists) <= smem
    used = total(base + (lists if resident else 0))
    return {'threads': threads, 'per': -(-slice_ // threads),
            'staged': staged, 'resident': resident, 'smem_bytes': used,
            'cluster': cluster, 'slice': slice_, 'pairs': pairs,
            'fits': used <= smem}


def slice_pairs(lists, cluster):
    """The most in-list entries of any CTA's slice of destinations in a
    cluster of ``cluster`` (``forward_layout``'s ``pairs``)"""
    slice_ = forward_layout(lists.states, 0, cluster)['slice']
    bounds = lists.host_offsets[
        [min(k * slice_, lists.states) for k in range(cluster + 1)]]
    return int((bounds[1:] - bounds[:-1]).max())


def forward_plan(lists, batch, resident):
    """K9's layout for a batch: the largest cluster of CLUSTER_SIZES whose
    layout fits, whose slice holds at least MIN_SLICE destinations, and of
    which the card holds all ``batch`` clusters at once
    (``resident(layout)``: ``resident_clusters``), so that every sequence
    starts in the first wave; else one CTA a sequence. At madmom's 5617
    states the H100 holds 21, 15, 30 and 66 clusters of 16, 8, 4 and 2
    CTAs: 16 CTAs a track up to 21 tracks, 4 up to 30, 2 up to 66, one
    from 67"""
    for cluster in CLUSTER_SIZES[:0:-1]:
        layout = forward_layout(lists.states, slice_pairs(lists, cluster),
                                cluster)
        if (layout['fits'] and layout['slice'] >= MIN_SLICE
                and batch <= resident(layout)):
            return layout
    return forward_layout(lists.states, lists.pairs)


def warp_lists(lists, layout):
    """The heavy destinations (``InLists.heavy``) each warp of each CTA of
    a cluster reduces a frame under ``layout``, as K9 deals them:
    [[[destination, ...] for each warp] for each CTA]"""
    heavy = lists.heavy.cpu().tolist()
    slice_, warps = layout['slice'], layout['threads'] // 32
    plan = []
    for rank in range(layout['cluster']):
        own = [j for j in heavy if rank * slice_ <= j < (rank + 1) * slice_]
        plan.append([own[warp::warps] for warp in range(warps)])
    return plan


_resident_cache = {}


def resident_clusters(states, layout, device):
    """The clusters of K9 under ``layout`` at ``states`` states that the
    CUDA card ``device`` holds at once (cudaOccupancyMaxActiveClusters through
    csrc/sparse_forward.cu, sparse_forward_clusters), cached per card and
    layout; 0 where it holds none"""
    device = torch.device(device)
    key = (device.index, states, *sorted(layout.items()))
    if key not in _resident_cache:
        lib = _library('sparse_forward', 'sparse_forward_clusters')
        clusters = ctypes.c_int(0)
        with torch.cuda.device(device):
            code = lib.sparse_forward_clusters(
                states, layout['pairs'], layout['threads'],
                layout['cluster'], int(layout['staged']),
                int(layout['resident']), ctypes.byref(clusters))
        build.raise_on_error(lib, 'sparse_forward_clusters', code)
        _resident_cache[key] = clusters.value
    return _resident_cache[key]


def chase_layout(states, pairs, smem=dense.SMEM_BYTES):
    """K10's launch at this shape: its threads, whether the in-lists'
    offsets and sources stay in shared memory, and those bytes"""
    lists = 4 * (states + 1) + 2 * pairs
    resident = lists <= smem
    return {'threads': CHASE_THREADS, 'resident': resident,
            'smem_bytes': lists if resident else 0}


def sparse_forward_reference(observation, batch_frames, initial, lists,
                             log_input=True, apply_epsilon=False):
    """Plain PyTorch version of the sparse forward kernel (K9).

    observation: (batch, frames, states) float32 log-probabilities
        (probabilities when ``log_input=False``)
    batch_frames: (batch,) int32
    initial: (states,) float32
    lists: ``InLists`` of the transition

    The conversion runs first, as ``dispatch.convert``'s torch ops.

    Returns
        pointers: (batch, frames, states) int16; pointers[:, t, j] is the
            lowest source of j's best candidate at frame t (0 where every
            candidate is -inf), for 1 <= t < batch_frames; 0 elsewhere
        posterior: (batch, states) float32, the posterior after each row's
            last frame
    """
    from .dispatch import convert

    observation = convert(observation, log_input, apply_epsilon)
    batch, frames, states = observation.shape
    device = observation.device
    sources = lists.sources.to(device=device, dtype=torch.int64)
    values = lists.values.to(device)
    targets = lists.destinations.to(device)[None].expand(batch, -1)
    pointers = torch.zeros((batch, frames, states), dtype=torch.int16,
                           device=device)
    post = observation[:, 0] + initial[None]
    for t in range(1, frames):
        candidates = post[:, sources] + values[None]
        score = torch.full_like(post, NEG_INF).scatter_reduce(
            1, targets, candidates, 'amax')
        # The lowest source among each destination's maxima
        winners = torch.where(candidates == score.gather(1, targets),
                              sources[None], states)
        index = torch.full((batch, states), states, dtype=torch.int64,
                           device=device).scatter_reduce(
                               1, targets, winners, 'amin')
        index = torch.where(score == NEG_INF, 0, index)
        valid = (t < batch_frames)[:, None]
        post = torch.where(valid, observation[:, t] + score, post)
        pointers[:, t] = torch.where(valid, index, 0).to(torch.int16)
    return pointers, post


def viterbi_forward_sparse(observation, batch_frames, initial, lists,
                           log_input=True, apply_epsilon=False, layout=None):
    """Sparse forward pass: K9 (csrc/sparse_forward.cu) on CUDA tensors,
    its plain version on CPU tensors. Arguments and results as in
    ``sparse_forward_reference``; all tensors contiguous on one device.
    ``layout`` (one of ``forward_layout``'s) replaces the launch layout
    ``forward_plan`` picks. On the card the pointers of frame 0 and of the
    frames past a row's length are left unwritten (the chase never reads
    them). Counts its launches, by cluster size in ``size_launches``, and
    in ``pairs`` the pairs times the batch times the frames of each call,
    from the shapes."""
    device = observation.device
    batch, frames, states = observation.shape
    viterbi_forward_sparse.pairs += lists.pairs * batch * frames
    if device.type == 'cpu':
        return sparse_forward_reference(
            observation, batch_frames, initial, lists, log_input,
            apply_epsilon)
    build.check('observation', observation, (batch, frames, states),
                torch.float32, device)
    build.check('batch_frames', batch_frames, (batch,), torch.int32, device)
    build.check('initial', initial, (states,), torch.float32, device)
    _check_lists(lists, states, device)
    if states > MAX_STATES:
        raise ValueError(
            f'the sparse forward kernel holds at most {MAX_STATES} states, '
            f'got {states}')
    pointers = torch.empty((batch, frames, states), dtype=torch.int16,
                           device=device)
    posterior = torch.empty((batch, states), dtype=torch.float32,
                            device=device)
    if batch and frames:
        if layout is None:
            layout = forward_plan(lists, batch, lambda plan: (
                resident_clusters(states, plan, device)))
        elif layout['pairs'] < slice_pairs(lists, layout['cluster']):
            raise ValueError(
                f'a layout for {layout["pairs"]} in-list entries a CTA; '
                f'a slice holds {slice_pairs(lists, layout["cluster"])}')
        lib = _library('sparse_forward')
        with torch.cuda.device(device):
            code = lib.sparse_forward(
                build.pointer(observation), build.pointer(batch_frames),
                build.pointer(initial), build.pointer(lists.offsets),
                build.pointer(lists.sources), build.pointer(lists.values),
                build.pointer(lists.heavy), int(lists.heavy.numel()),
                build.pointer(pointers), build.pointer(posterior), batch,
                frames, states, layout['pairs'], int(log_input),
                int(apply_epsilon), layout['threads'], layout['cluster'],
                int(layout['staged']), int(layout['resident']),
                build.stream(device))
        build.raise_on_error(lib, 'sparse_forward', code)
        viterbi_forward_sparse.launches += 1
        viterbi_forward_sparse.size_launches[layout['cluster']] += 1
    return pointers, posterior


viterbi_forward_sparse.launches = 0
# The launches by CTAs a sequence (the layout's cluster), beside the total
viterbi_forward_sparse.size_launches = dict.fromkeys(CLUSTER_SIZES, 0)
viterbi_forward_sparse.pairs = 0


def backtrace_sparse_reference(pointers, posterior, batch_frames):
    """Plain PyTorch version of the sparse chase (K10).

    pointers: (batch, frames, states) int16 from the sparse forward pass
    posterior: (batch, states) float32, its last posterior
    batch_frames: (batch,) int32

    Returns (batch, frames) int32 indices: the lowest-index argmax of the
    posterior at frames - 1 and at every position at or past
    batch_frames - 1, then pointer by pointer back, as K3 chases."""
    batch, frames, _ = pointers.shape
    device = pointers.device
    index = posterior.argmax(dim=1)
    every = torch.arange(batch, device=device)
    indices = torch.empty((batch, frames), dtype=torch.int32, device=device)
    indices[:, frames - 1] = index.to(torch.int32)
    for t in range(frames - 1, 0, -1):
        pred = pointers[every, t, index].to(torch.int64)
        index = torch.where(t <= batch_frames - 1, pred, index)
        indices[:, t - 1] = index.to(torch.int32)
    return indices


def backtrace_sparse(pointers, posterior, batch_frames, lists):
    """Sparse chase: K10 (csrc/sparse_backtrace.cu) on CUDA tensors, its
    plain version on CPU tensors. Arguments and result as in
    ``backtrace_sparse_reference``, plus the transition's in-lists: where
    the last posterior's maximum is finite, every state of the path has a
    finite candidate, so a state with one source steps to it without
    reading its pointer, which K9 wrote equal to it. Counts its
    launches."""
    device = pointers.device
    if device.type == 'cpu':
        return backtrace_sparse_reference(pointers, posterior, batch_frames)
    batch, frames, states = pointers.shape
    build.check('pointers', pointers, (batch, frames, states), torch.int16,
                device)
    build.check('posterior', posterior, (batch, states), torch.float32,
                device)
    build.check('batch_frames', batch_frames, (batch,), torch.int32, device)
    _check_lists(lists, states, device)
    indices = torch.empty((batch, frames), dtype=torch.int32, device=device)
    if batch and frames:
        layout = chase_layout(states, lists.pairs)
        lib = _library('sparse_backtrace')
        with torch.cuda.device(device):
            code = lib.sparse_backtrace(
                build.pointer(pointers), build.pointer(posterior),
                build.pointer(batch_frames), build.pointer(lists.offsets),
                build.pointer(lists.sources), build.pointer(indices), batch,
                frames, states, lists.pairs, layout['threads'],
                int(layout['resident']), build.stream(device))
        build.raise_on_error(lib, 'sparse_backtrace', code)
        backtrace_sparse.launches += 1
    return indices


backtrace_sparse.launches = 0


def _check_lists(lists, states, device):
    if lists.states != states:
        raise ValueError(
            f'in-lists of {lists.states} states for {states} states')
    build.check('offsets', lists.offsets, (states + 1,), torch.int32, device)
    build.check('sources', lists.sources, (lists.pairs,), torch.int16,
                device)
    build.check('values', lists.values, (lists.pairs,), torch.float32,
                device)
    build.check('heavy', lists.heavy, (lists.heavy.numel(),), torch.int32,
                device)


_ARGUMENTS = {
    # obs, batch_frames, initial, offsets, sources, values, heavy;
    # heavy_count; pointers, posterior; batch, frames, states, pairs,
    # log_input, apply_epsilon, threads, cluster, staged, resident; the
    # stream
    'sparse_forward': [ctypes.c_void_p] * 7 + [ctypes.c_int]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
    # states, pairs, threads, cluster, staged, resident; the clusters out
    'sparse_forward_clusters': [ctypes.c_int] * 6 + [ctypes.c_void_p],
    # pointers, posterior, batch_frames, offsets, sources, out; batch,
    # frames, states, pairs, threads, resident; the stream
    'sparse_backtrace': [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}


def _library(name, entry=None):
    lib = build.library(name)
    entry = entry or name
    function = getattr(lib, entry)
    function.argtypes = _ARGUMENTS[entry]
    function.restype = ctypes.c_int
    return lib
