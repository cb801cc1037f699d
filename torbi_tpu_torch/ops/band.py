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
along the chosen path only.

Every forward here takes the observation as ``torbi_tpu``'s
``viterbi_forward_band`` does: ``log_input=False`` for probabilities,
``apply_epsilon=True`` for the reference's epsilon step ``log(exp(x) +
tiny)``. The kernels convert each value as they load it (the TPU kernels'
``obs_col``); the plain versions run ``dispatch.convert``'s torch ops
first, which the kernels equal bitwise.

K1 has two designs with the same values, chosen by shape
(``forward_kernel``): the cluster design ``viterbi_forward_band`` (the band
slice resident in shared memory across a cluster of 8 CTAs, each CTA a
window of the posterior; ``cluster_layout`` mirrors its layout and
``cluster_plan`` its launches) wherever its layout fits, else the wide-band
design ``viterbi_forward_band_wide`` (one persistent CTA per SM, each a
slice of destinations and the band slice over its source window, K2's plan;
``wide_plan`` picks it). One sequence on its own (batch 1) takes the K4
kernel, ``viterbi_forward_band_spread`` (its band in registers across a
cluster of 16 CTAs that exchange slices of the posterior through mbarriers;
``spread_layout`` mirrors its layout), with the same values.

Exactness preconditions (``gate_band`` enforces them; dispatch falls back to
the dense kernel otherwise): a pure -inf exterior needs an all-finite
initial distribution, a constant finite floor at least one finite initial
entry, and both a finite observation.
"""
import ctypes

import numpy as np
import torch

from . import dense
from ..csrc import build
from ..utils.cache import identity_cached as _identity_cached

NEG_INF = float('-inf')

# K4 (csrc/band_spread.cu, spread_layout): one cluster of SPREAD_CLUSTER =
# 16 CTAs, a non-portable size the H100 places. The spread lab's exchange
# probe costs less per frame at 16 than at 8, the portable size (NVIDIA H100
# 80GB HBM3, 700 W: 0.732 and 0.944 us/frame; K4 itself 1.121 and 1.388),
# and 16 holds every band 8 would (256 offsets wide against 192 at 1440
# states). 8 lanes share 4 destinations, each lane a run of band offsets
# held in a register tile of 8, 16, 24 or 32 offsets, for which
# SPREAD_TILES gives the most threads per CTA: at each,
# 4 x tile band registers plus SPREAD_REGISTER_OVERHEAD others fit the 65,536
# registers of an SM. K4 refuses a band its layout does not fit (wider than
# 8 x 32 = 256, too many threads, or shared memory past the card's 227 KB
# opt-in, SPREAD_SMEM_BYTES); dispatch sends such a single sequence to K1
SPREAD_CLUSTER = 16
SPREAD_LANES = 8
SPREAD_TILES = {8: 512, 16: 512, 24: 384, 32: 256}
SPREAD_REGISTER_OVERHEAD = 48
SPREAD_STAGES = 4
SPREAD_SMEM_BYTES = 227 * 1024

# K1's cluster design (csrc/band_forward.cu, Tile and cluster_layout):
# clusters of 8 CTAs; for each number of sequences per cluster, the thread
# tile (sequences per thread, destinations per thread, lanes sharing a
# destination) and the most threads per CTA. Its layout must fit the opt-in
# shared memory, CLUSTER_SMEM_BYTES
CLUSTER_CTAS = 8
CLUSTER_TILES = {
    1: (1, 1, 4, 1024),
    4: (4, 1, 1, 512),
    32: (4, 4, 1, 512),
}
CLUSTER_SMEM_BYTES = 227 * 1024
# The time of one wave of clusters of each size (as many as the card holds
# at once, resident_clusters), relative to a wave of clusters of 4:
# chip_smoke.py's K1 plan phase times a wave of each size at the pitch
# headline's frames, states and band (NVIDIA H100 80GB HBM3, 700 W: 1.619,
# 3.226 and 10.127 ms). cluster_plan weighs the launch of a batch's rest
# with it
CLUSTER_WAVE_COST = {1: 0.502, 4: 1.0, 32: 3.139}

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
                           band_matrix, log_input=True, apply_epsilon=False):
    """Plain PyTorch version of the banded forward kernel (K1).

    observation: (batch, frames, states) float32 log-probabilities
        (probabilities when ``log_input=False``)
    batch_frames: (batch,) int32
    initial: (states,) float32
    band: (lo, width, floor) from detect_band
    band_matrix: (width, states) float32 from build_band_matrix
    apply_epsilon: the reference's epsilon step on the observation

    The conversion runs first, as ``dispatch.convert``'s torch ops.

    Returns
        post_seq: (batch, frames, states) float32; post_seq[:, t] is the
            posterior after consuming frame t, frozen for t >= batch_frames
        posterior: (batch, states) float32 final posterior (post_seq[:, -1])
    """
    from .dispatch import convert

    observation = convert(observation, log_input, apply_epsilon)
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


def cluster_layout(states, width, sequences):
    """The layout of K1's cluster design (csrc/band_forward.cu,
    cluster_layout) with ``sequences`` per cluster of 8 CTAs: each CTA owns
    ``per_cta`` destinations, holds its band slice (skewed into
    ``width + R - 1`` rows) and double-buffered windows of ``per_cta +
    width - 1`` sources per sequence, the double-buffered (sequences, 8)
    tables of CTA maxima and a (warps, sequences) table of warp maxima.

    Returns a dict: per_cta, threads, smem_bytes, and fits (width >= 1, at
    most the tile's threads, at most CLUSTER_SMEM_BYTES)."""
    per_thread, dests, lanes, max_threads = CLUSTER_TILES[sequences]
    per_cta = -(-(-(-states // CLUSTER_CTAS)) // dests) * dests
    groups = per_cta // dests
    threads = -(-(groups * (sequences // per_thread) * lanes) // 32) * 32
    if lanes > 1:
        stride = -(-max(per_cta - 8, 0) // 32) * 32 + 8
    else:
        stride = -(-per_cta // 4) * 4
    window = per_cta + width - 1
    floats = ((width + dests - 1) * stride
              + -(-(2 * window * sequences) // 4) * 4
              + 2 * sequences * CLUSTER_CTAS + threads // 32 * sequences)
    return {
        'per_cta': per_cta, 'threads': threads, 'smem_bytes': 4 * floats,
        'fits': (width >= 1 and threads <= max_threads
                 and 4 * floats <= CLUSTER_SMEM_BYTES)}


def cluster_sizes(states, width):
    """The sequences per cluster whose layout fits this shape, ascending"""
    return [sequences for sequences in sorted(CLUSTER_TILES)
            if cluster_layout(states, width, sequences)['fits']]


def cluster_plan(batch, states, width, resident):
    """K1's cluster launches at this shape: ((start, count, sequences per
    cluster), ...) over the batch, or None when no cluster layout fits (the
    wide-band design runs). ``resident(sequences)`` is the clusters of that
    size the card holds at once (``resident_clusters``). Whole waves take
    the largest size that fits (the least time per sequence); the rest of
    the batch takes one launch at the size of least cost, its waves times
    CLUSTER_WAVE_COST, or joins the whole waves when that size is the
    largest. With 15 clusters held at once at 1440 states and the pitch
    band, batch 8 (the auto-chunk rows) is one launch of 8 clusters of 1
    sequence, batch 512 (the headline) 480 sequences in clusters of 32,
    then 32 in clusters of 4."""
    sizes = cluster_sizes(states, width)
    if not sizes:
        return None
    largest = sizes[-1]
    wave = resident(largest) * largest
    whole = batch // wave * wave
    rest = batch - whole

    def cost(sequences):
        clusters = -(-rest // sequences)
        return -(-clusters // resident(sequences)) * CLUSTER_WAVE_COST[
            sequences]

    size = min(sizes, key=cost) if rest else largest
    if size == largest:
        return ((0, batch, largest),)
    plan = ((0, whole, largest),) if whole else ()
    return plan + ((whole, rest, size),)


_resident_cache = {}


def resident_clusters(states, width, sequences, device):
    """The clusters of K1's cluster design, with ``sequences`` per cluster,
    that the CUDA card ``device`` holds at once at this shape
    (cudaOccupancyMaxActiveClusters through csrc/band_forward.cu,
    band_forward_clusters), cached per card and shape"""
    device = torch.device(device)
    key = (device.index, states, width, sequences)
    if key not in _resident_cache:
        lib = _library()
        clusters = ctypes.c_int(0)
        with torch.cuda.device(device):
            code = lib.band_forward_clusters(
                states, width, sequences, ctypes.byref(clusters))
        build.raise_on_error(lib, 'band_forward_clusters', code)
        if clusters.value < 1:
            raise RuntimeError(
                f'the card holds no cluster of {sequences} sequences at '
                f'{states} states and band width {width}')
        _resident_cache[key] = clusters.value
    return _resident_cache[key]


def forward_kernel(states, width):
    """K1's design at this shape: ('band_forward', viterbi_forward_band)
    where a cluster layout fits (``cluster_sizes``), else
    ('band_forward_wide', viterbi_forward_band_wide); the names are those
    of the wrappers' launch counters"""
    if cluster_sizes(states, width):
        return 'band_forward', viterbi_forward_band
    return 'band_forward_wide', viterbi_forward_band_wide


def _check_band_args(observation, batch_frames, initial, band, band_matrix):
    lo, width, floor = band
    if width == 0 and floor is None:
        raise ValueError(
            'band width 0 requires a finite floor (constant transition)')
    device = observation.device
    if device.type == 'cpu':
        return False
    batch, frames, states = observation.shape
    build.check('observation', observation, (batch, frames, states),
                torch.float32, device)
    build.check('batch_frames', batch_frames, (batch,), torch.int32, device)
    build.check('initial', initial, (states,), torch.float32, device)
    build.check('band_matrix', band_matrix, (width, states), torch.float32,
                device)
    return True


def viterbi_forward_band(observation, batch_frames, initial, band,
                         band_matrix, log_input=True, apply_epsilon=False):
    """Banded forward pass, K1's cluster design (csrc/band_forward.cu,
    band_forward) on CUDA tensors, its plain version on CPU tensors.
    Arguments and results as in ``band_forward_reference``; all tensors
    contiguous on one device. The launches follow ``cluster_plan``; on the
    card a shape no layout fits raises (``forward_kernel`` sends it to the
    wide-band design). Each launch counts once."""
    if not _check_band_args(
            observation, batch_frames, initial, band, band_matrix):
        return band_forward_reference(
            observation, batch_frames, initial, band, band_matrix,
            log_input, apply_epsilon)
    batch, _, states = observation.shape
    width = band[1]
    plan = cluster_plan(batch, states, width, lambda sequences: (
        resident_clusters(states, width, sequences, observation.device)))
    return _launch_clusters(
        observation, batch_frames, initial, band, band_matrix, plan,
        log_input, apply_epsilon)


viterbi_forward_band.launches = 0


def _forward_band_clusters(observation, batch_frames, initial, band,
                           band_matrix, sequences, log_input=True,
                           apply_epsilon=False):
    """``viterbi_forward_band`` in one launch with ``sequences`` per
    cluster, whatever the plan: each cluster size held against the plain
    version and timed on its own"""
    if sequences not in CLUSTER_TILES:
        raise ValueError(
            f'sequences per cluster must be one of {sorted(CLUSTER_TILES)}, '
            f'got {sequences}')
    if not _check_band_args(
            observation, batch_frames, initial, band, band_matrix):
        return band_forward_reference(
            observation, batch_frames, initial, band, band_matrix,
            log_input, apply_epsilon)
    plan = None
    if cluster_layout(observation.shape[2], band[1], sequences)['fits']:
        plan = ((0, observation.shape[0], sequences),)
    return _launch_clusters(
        observation, batch_frames, initial, band, band_matrix, plan,
        log_input, apply_epsilon)


def _launch_clusters(observation, batch_frames, initial, band, band_matrix,
                     plan, log_input, apply_epsilon):
    """K1's cluster design on checked CUDA tensors, one launch per entry
    (start, count, sequences per cluster) of ``plan``"""
    lo, width, floor = band
    batch, frames, states = observation.shape
    if plan is None:
        raise ValueError(
            f'no cluster layout of K1 fits {states} states and band width '
            f'{width}; band.forward_kernel sends this shape to '
            'band_forward_wide')
    device = observation.device
    post_seq = torch.empty_like(observation)
    if batch and frames:
        lib = _library()
        row = frames * states
        with torch.cuda.device(device):
            for start, count, size in plan:
                code = lib.band_forward(
                    build.pointer(observation, start * row),
                    build.pointer(batch_frames, start),
                    build.pointer(initial), build.pointer(band_matrix),
                    build.pointer(post_seq, start * row), count, frames,
                    states, lo, width, 0.0 if floor is None else floor,
                    int(floor is not None), int(log_input),
                    int(apply_epsilon), size, build.stream(device))
                build.raise_on_error(lib, 'band_forward', code)
                viterbi_forward_band.launches += 1
    return post_seq, post_seq[:, -1]


# The plan's fields in the order csrc/band_wide.cu takes them: K2's, then
# the window
WIDE_PLAN_FIELDS = dense.PLAN_FIELDS + ('window',)


def wide_plans(batch, states, width, resident, smem=dense.SMEM_BYTES):
    """Every launch plan of K1's wide-band design (csrc/band_wide.cu) that
    fits: K2's plans (``dense.dense_plans``) over each CTA's source window
    of ``window`` sources (``dense.band_window``: jc + width - 1, widened
    to 4 floats at both ends) in place of the whole row, its band slice
    resident in shared memory or streamed beside the posterior. Where the
    band lies (lo) moves the windows (``wide_windows``), not their size, so
    the plans do not depend on it"""
    return dense.dense_plans(batch, states, resident, smem, width=width)


def wide_plan(batch, states, width, resident, smem=dense.SMEM_BYTES):
    """The wide-band design's launch plan: of ``wide_plans``, the one of
    least ``cost`` (the fewest groups, then the resident slice, on ties),
    or None when no plan fits"""
    return min(wide_plans(batch, states, width, resident, smem),
               key=lambda plan: plan['cost'], default=None)


def wide_windows(plan, states, lo, width):
    """The source window of each destination group of a wide-band plan,
    as the kernel computes it: [(first source, sources), ...], the window
    [d jc + lo, d jc + jc + lo + width - 1) widened to 4 floats at both
    ends and cut to [0, states rounded up to 4); no sources for width 0"""
    windows = []
    for d in range(plan['dest_groups']):
        j0 = d * plan['jc']
        first = max(0, (j0 + lo) // 4 * 4)
        end = min(-(-states // 4) * 4,
                  -(-(j0 + plan['jc'] + lo + width - 1) // 4) * 4)
        windows.append((first, max(0, end - first) if width else 0))
    return windows


def viterbi_forward_band_wide(observation, batch_frames, initial, band,
                              band_matrix, log_input=True,
                              apply_epsilon=False, plan=None):
    """Banded forward pass, K1's wide-band design (csrc/band_wide.cu,
    band_forward_wide: one persistent CTA per SM) on CUDA tensors, its
    plain version on CPU tensors. Arguments and results as in
    ``band_forward_reference``. Takes any band, a width-0 one with a floor
    included. ``plan`` replaces the launch plan ``wide_plan`` picks for
    the card; a shape no plan fits raises."""
    if not _check_band_args(
            observation, batch_frames, initial, band, band_matrix):
        return band_forward_reference(
            observation, batch_frames, initial, band, band_matrix,
            log_input, apply_epsilon)
    lo, width, floor = band
    batch, frames, states = observation.shape
    device = observation.device
    post_seq = torch.empty_like(observation)
    if batch and frames:
        plan = plan or wide_plan(batch, states, width, dense._sms(device))
        if plan is None:
            raise ValueError(
                f'no launch plan of the wide-band forward kernel holds '
                f'{batch} x {states} states at band width {width}')
        # The group barriers' counters, then the keys of the row maxima
        # (3 frames x groups x bc), all zeros
        groups = plan['groups']
        scratch = torch.zeros(
            (groups + 3 * groups * plan['bc'],), dtype=torch.int32,
            device=device)
        slices = torch.empty(
            (1,) if plan['resident'] else (
                groups * plan['dest_groups'], plan['jc'], plan['window']),
            dtype=torch.float32, device=device)
        lib = _wide_library()
        with torch.cuda.device(device):
            code = lib.band_forward_wide(
                build.pointer(observation), build.pointer(batch_frames),
                build.pointer(initial), build.pointer(band_matrix),
                build.pointer(post_seq), build.pointer(scratch),
                build.pointer(scratch, groups), build.pointer(slices),
                batch, frames, states, lo, width,
                0.0 if floor is None else floor,
                int(floor is not None), int(log_input), int(apply_epsilon),
                *(int(plan[key]) for key in WIDE_PLAN_FIELDS),
                build.stream(device))
        build.raise_on_error(lib, 'band_forward_wide', code)
        viterbi_forward_band_wide.launches += 1
    return post_seq, post_seq[:, -1]


viterbi_forward_band_wide.launches = 0


def spread_layout(states, width, lo=0):
    """The layout of K4 (csrc/band_spread.cu, make_layout) over its cluster
    of SPREAD_CLUSTER CTAs: CTA r owns ``per_cta`` destinations (a multiple
    of 4); a thread owns 4 of them and a ``run`` of ceil(width / 8) band
    offsets, held in a register tile of ``dmax``
    offsets (the least of SPREAD_TILES that holds the run, None when none
    does); each CTA keeps two windows of ``slices`` whole slices from slice
    r + ``a`` on (``window`` floats each, enough for any lo), two outgoing
    slices, two tables of CTA maxima, two of warp maxima and a ring of
    SPREAD_STAGES observation rows.

    Returns a dict: per_cta, groups, threads, run, dmax, a, slices,
    offset (the window index of destination 0's source at offset 0),
    window, smem_bytes, and fits (a tile holds the run, the threads are
    within its limit, the shared memory within SPREAD_SMEM_BYTES)."""
    cluster = SPREAD_CLUSTER
    per_cta = -(-(-(-states // cluster)) // 4) * 4
    groups = per_cta // 4
    threads = -(-(groups * SPREAD_LANES) // 32) * 32
    run = -(-width // SPREAD_LANES)
    dmax = min((tile for tile in SPREAD_TILES if tile >= run), default=None)
    a = lo // per_cta
    slices = (per_cta + lo + width - 2) // per_cta - a + 1
    most = (2 * per_cta + width - 3) // per_cta + 1
    window = most * per_cta + SPREAD_LANES * (dmax or 0)
    floats = (4 + 2 * window + 2 * per_cta + -(-(2 * cluster) // 4) * 4
              + -(-(2 * (threads // 32)) // 4) * 4 + SPREAD_STAGES * threads)
    fits = (width >= 1 and dmax is not None
            and threads <= SPREAD_TILES[dmax]
            and 4 * floats <= SPREAD_SMEM_BYTES)
    return {
        'per_cta': per_cta, 'groups': groups, 'threads': threads, 'run': run,
        'dmax': dmax, 'a': a, 'slices': slices, 'offset': lo - a * per_cta,
        'window': window, 'smem_bytes': 4 * floats, 'fits': fits}


def spread_exchange(states, width, lo):
    """K4's exchange at this shape: ``receivers[q]``, the (rank, window
    slot) of every CTA whose window holds slice q, and ``expected[r]``, the
    bytes CTA r waits for per frame (its window's slices inside the cluster
    and one maximum from each CTA). Returns (receivers, expected)"""
    cluster = SPREAD_CLUSTER
    layout = spread_layout(states, width, lo)
    p, a, slices = layout['per_cta'], layout['a'], layout['slices']
    receivers = [
        [(r, q - r - a) for r in range(max(0, q - a - slices + 1),
                                       min(cluster - 1, q - a) + 1)]
        for q in range(cluster)]
    expected = [
        (len(range(max(0, r + a), min(cluster - 1, r + a + slices - 1) + 1))
         * p + cluster) * 4
        for r in range(cluster)]
    return receivers, expected


def spread_smem_bytes(states, width):
    """Shared memory per CTA of K4 at this shape (``spread_layout``)"""
    return spread_layout(states, width)['smem_bytes']


def spread_fits(states, width):
    """Whether K4 takes a band of this width at this many states"""
    return spread_layout(states, width)['fits']


def band_spread_reference(observation, batch_frames, initial, band,
                          band_matrix, log_input=True, apply_epsilon=False):
    """Plain PyTorch version of the batch-1 banded forward kernel (K4):
    ``band_forward_reference`` on the one sequence"""
    if observation.shape[0] != 1:
        raise ValueError(
            f'the batch-1 forward takes one sequence, got batch '
            f'{observation.shape[0]}')
    return band_forward_reference(
        observation, batch_frames, initial, band, band_matrix, log_input,
        apply_epsilon)


def viterbi_forward_band_spread(observation, batch_frames, initial, band,
                                band_matrix, log_input=True,
                                apply_epsilon=False):
    """Batch-1 banded forward pass: the K4 kernel (csrc/band_spread.cu),
    which spreads one sequence over a cluster of SPREAD_CLUSTER CTAs, on
    CUDA tensors; its plain version on CPU tensors.
    Arguments and results as in ``band_forward_reference`` with batch 1.
    On the card it raises when the band does not fit (``spread_layout``)."""
    lo, width, floor = band
    if width == 0 and floor is None:
        raise ValueError(
            'band width 0 requires a finite floor (constant transition)')
    device = observation.device
    if device.type == 'cpu':
        return band_spread_reference(
            observation, batch_frames, initial, band, band_matrix, log_input,
            apply_epsilon)
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
                int(log_input), int(apply_epsilon), build.stream(device))
        build.raise_on_error(lib, 'band_spread', code)
        viterbi_forward_band_spread.launches += 1
    return post_seq, post_seq[:, -1]


viterbi_forward_band_spread.launches = 0


def _library():
    lib = build.library('band_forward')
    # states..width, floor, has_floor, log_input, apply_epsilon
    shape = [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 3
    lib.band_forward.argtypes = [ctypes.c_void_p] * 5 + shape + [
        ctypes.c_int, ctypes.c_void_p]
    lib.band_forward_clusters.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.band_forward.restype = ctypes.c_int
    lib.band_forward_clusters.restype = ctypes.c_int
    return lib


def _wide_library():
    lib = build.library('band_wide')
    # batch, frames, states, lo, width, floor, has_floor, log_input,
    # apply_epsilon, the plan
    lib.band_forward_wide.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * (
            3 + len(WIDE_PLAN_FIELDS)) + [ctypes.c_void_p]
    lib.band_forward_wide.restype = ctypes.c_int
    return lib


def _spread_library():
    lib = build.library('band_spread')
    lib.band_spread.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.band_spread.restype = ctypes.c_int
    return lib
