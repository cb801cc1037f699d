"""Smoke run of torbi_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel bitwise against its plain PyTorch version on the card, decodes the
README toy, and drives the decode paths through the public entry point
``from_probabilities`` with the launch counters reset just before and read
just after each:

- the banded path (the headline): 512 sequences x 512 frames of peaked
  synthetic pitch posteriorgrams under the 1440-state pitch transition
  taken to log(p + tiny) -- the banded forward kernel (K1) in its cluster
  design, then the backtrace (K3). K1's cluster design ``band_forward`` is
  held bitwise and timed at the headline and on the auto-chunk rows, its
  wide-band design ``band_forward_wide`` (one persistent CTA per SM) on the
  auto-chunk rows beside it, and K1 (the cluster design at every cluster
  size, the wide-band design in both slice modes) and K3 on every shape
  of the edge list (``torbi_tpu_torch/utils/edges.py``, the list the CPU
  tests hold against torbi_tpu), K3 also past 8 x 1024 states. The banded
  forward kernels convert the observation as they load it (the log of a
  probability, the epsilon step): K1 in both designs and K4 are held
  bitwise against the plain route (the conversion's torch ops, then the
  same kernel) in log and probability space, with log(tiny) and
  0 < p < tiny entries, at the headline (the cluster design), on the
  auto-chunk rows, on a 401-wide band (the wide-band design) and over the
  edge list, and timed against the epsilon step plus the kernel; the
  headline also runs with ``log_probs=False``, and its traced call must
  hold no elementwise exp or log. K1's plans whose launches after the
  first are dependents (512 rows, also with sorted ragged lengths, and
  1024 rows) are held bitwise with their dependent-launch count, those of
  512 rows timed in turns against the same plan launched serially;
- the dense path: the README toy, a random dense 1440-state transition at
  8 x 64 (two short sequences) and a random dense 1280-state transition at
  512 x 512 (seed 0, two short sequences) -- the dense forward kernel (K2:
  one persistent CTA per SM, its transition slice in shared memory or
  streamed, the group barriers), then K3. K2 is held bitwise against its
  plain version at those shapes (at 512 x 512 all sequences, the plain
  version in sub-batches of 64) and at the edges of its launch plan (1, 3
  and 130 sequences at 96 and 2048 states, 3 x 24 x 97, 1 x 64 x 97 and
  8 x 64 x 1203, the last three on its padded sources; each also on the
  cheapest plan of either slice mode), with ``padded_launches`` 1 on the
  toy's 3 states and 0 at 1440 and 1280, timed beside its bounds
  (operations: the FP32 instructions per candidate of its SASS loop;
  shared memory), and its plan printed; the path at 512 x 512 x 1280 equals the
  plain scan route on the card, is timed by the host clock and traced
  once (idle share, top device ops);
- pYIN's HMM (``models/pyin.py``: 1202 states, no band, -inf transition
  and initial entries, probabilities in): K2 on its padded sources (the
  states are not a multiple of 4; ``padded_launches`` 1 a call) at the
  ``pyin-b512-sorted`` cell's longest batch, 512
  rows of up to 861 frames, bitwise its plain version, K3 on its output
  bitwise its plain version and the paths the benchmark's plain
  reference decode, the path through ``from_probabilities(...,
  log_probs=False)`` equal to them with its launches and the conversion's
  counters; K2's plan printed, and the conversion, K2 and K3 timed in
  turns;
- the in-list route (``ops/sparse.py``; ``--beats`` runs this phase
  alone, ``--beats quick`` its edges alone): K9 and K10 bitwise against
  their plain versions and the route's paths equal to K2 then K3's on
  random sparse HMMs with ties at the edge shapes (``SPARSE_EDGES``: one
  frame, one row, rows of one frame, ragged lengths, -inf initial
  entries, the four conversions, K9's observation ring and in-lists in
  shared memory or not, more clusters than the card holds at once) and on
  a frame of -inf, K9 there also at every cluster size its layout fits;
  madmom's beat tracker (``models/beats.py``, 5617 states) at the
  ``dbnbeat-b16-tracks`` cell's longest batch, 16 tracks of up to 42,006
  frames: K9 and K10 bitwise, the paths equal to K2 then K3's and to the
  benchmark's plain reference, the path through
  ``from_probabilities(..., log_probs=True)`` with one K9 (one launch of
  the planned cluster size, above 1) and one K10 launch, nothing else and
  no conversion pass; that call timed in turns with K9 on one CTA a track,
  at 16 tracks and on the longest track alone; K9 and K2 timed in turns
  there, K9 at every cluster size at the shapes of ``SPARSE_SPREAD``, and
  K9 against K2 at the shares the gate's threshold comes from
  (``SPARSE_SHARES``);
- the batch-1 kernels: K4 (its band tile in registers, the mbarrier
  exchange, one cluster of 16 CTAs) at 1 x 10,240 and 1 x 2048, in the
  three conversions, on every sequence of every band edge and at its
  widest band; K5's phase-1 table
  (backtrace_pointers) against its plain version, and K5's path (both
  phases) against the step-by-step chase at both shapes, on every
  sequence of the chase edges and on a pure -inf band, timed per phase,
  each phase with its own launch counter;
- the batch-1 paths, one pitch sequence of 10,240 frames (bench.py's batch-1
  shape): the default auto-chunk route (entropy-chunk rows through K1 and
  K3), the serial route with auto-chunking off (the batch-1 forward K4,
  then the fused chase K5), a 2048-frame sequence (K4, K5), the window
  chase (K6) on a pure -inf band, a band too wide for K4's register tile
  (K1's cluster design, K5), a band too wide for any cluster layout (width
  401: K1's wide-band design, K5), and the uniform transition's closed
  form (its recurrence K7, ``csrc/constant.cu``, once a call; also at
  512 x 512 with ragged lengths, held against the scan route; K7 itself
  held bitwise against its plain version at 1 x 10,240 and 512 x 512 and
  timed per call and per kernel, in a CUDA graph). K6 is
  K5's two phases without the floor pass: its phase-1 table and its path
  are held against their plain versions and its path against K5 at
  1 x 10,240, 1 x 2048 and on every sequence of the pure-band edges; the
  window route must launch both of its phases and never K5's phase 1
  (the floor pass). The
  auto-chunk route is timed on a new observation every call, from a host
  array, and on one buffer decoded again; each call plans afresh;
- the wide-band paths, bands no cluster layout holds (K1's wide-band
  design): (a) 1 x 256 x 1440 at width 401 over log(tiny) through
  ``from_probabilities`` (K1, then K5); (b) 512 x 512 x 1440 under the
  pitch transition of a 20 ms hop (width 347), the kernel alone, in both
  slice modes; (c) one pitch sequence of 10,240 frames under that
  transition through ``from_probabilities``, its default auto-chunk route
  (K1 on the rows, then K3); also 4096 states at width 175, and a band of
  half of 8200 states (the slice streamed). The kernel is held bitwise
  against its plain version at each, timed at (a) and (b) in turns
  against K2 on the same transition as a dense matrix (the same
  function), the paths against the plain scan route;
- the labs (``python -m torbi_tpu_torch.scripts.kernel_lab`` and
  ``... .chase_lab``): each lab kernel held bitwise against its plain
  version at small shapes (every forward body, the pipe groups 2-16
  included, at every accumulator count or tile with 1-8 sequences per CTA;
  at 1536 states the tensor-core mxushift at every accumulator count and
  hybrid:K at K 1, 8, 81, the mod-M mod12 and mod12k (both outputs) at
  every accumulator count and tile, mod12 also un-permuted against full;
  the spread kernel and the exchange probe spread_async with clusters of 8
  and 16, every chase variant in both
  thread shapes; pipeG at a run-time G: 3, 5, 24 and the groups with
  instances of their own), then timed at full width through the labs' entry
  points:
  the forward variants at 512 x 512 x 1440 (width 175) beside K1 and the
  H100 ideals, mxushift, hybrid, mod12 and mod12k at 512 x 512 x 1536
  beside full:4:4 at that shape, the spread variants at 1 x 10,240 beside
  K4 (spread_sync against spread_async: the cluster barrier's exchange
  against the mbarrier exchange), the chase variants over 10,240 steps
  beside K5 and K6. The output of
  every timed run is held bitwise against its plain version on the same
  inputs, at that full size;
- the committed reference paths (``utils/fixtures.py``,
  ``torbi_tpu_torch/assets/reference_paths.npz``): every case, decoded by
  torbi_tpu on the CPU when the file was written, decoded on the card
  through ``from_probabilities`` and held against it bitwise, the serial
  cases through K4 and K5, the wide-band cases through K1's wide-band
  design; the file cases through ``from_files_to_files``;
- the file path at full width (``file_path_phase``): 64 synthetic pitch
  files of 400-1600 frames x 1440 states (the benchmark's corpus generator,
  seed 3) through ``from_files_to_files`` (the native loader, which must
  fill every batch with no fallback, then K1 and K3), in one batch and in
  batches of 16, every output file bitwise the port's
  ``from_probabilities`` on that file alone; the loader's pinned buffers
  timed in turns against pageable ones through ``from_dataloader``; four
  ``.pt`` files through the Python loader; a 65,536-frame file decoded in
  chunks (``MIN_CHUNK_SIZE`` 512) against its chunks decoded one by one;
  ``from_file_to_file`` on a 10,240-frame file (the auto-chunk route:
  K1 and K3, not K4 or K5) against the plain scan route chunk by chunk;
  the CLI (``python -m torbi_tpu_torch``) in a subprocess on four files,
  without and with ``--config``;
- ``batch_frames`` past ``frames``: a 3 x 7 x 40 banded batch (K1, K3)
  and one 64-frame sequence (K4, K5) decode to the path of the clamped
  lengths;
- the evaluation harness at full width (``evaluation_phase``): two
  synthetic corpora of 1440-state pitch files (the eval script's
  generator and seeds), the reference pass on the CPU over a spawn pool,
  then ``evaluate.datasets`` in four configurations: the default (K1,
  K3) and ``config/nobatch.py`` (K4, K5) must score RPA@0 = 1.0 against
  the reference; with ``MIN_CHUNK_SIZE`` 64 (K1, K3) every output file
  must equal its chunks decoded one by one through the scan route;
  ``EVAL_BACKEND='lse'`` (K3) reports its RPA;
- the cross-route soak (``scripts/soak.py``): 240 seeded configurations
  through the kernels, each path bitwise the port's numpy oracle;
- the extra decode modes (``modes_phase``): the (max, +) product K8
  (``csrc/maxplus.cu``) bitwise against its plain version on its edge
  shapes, a 1440-state product and every launch of a time-sharded decode;
  the time-sharded route (``backend='timesharded'`` over a one-rank NCCL
  process group, K8) and the associative route (K8, then K3) at one
  sequence of 32,768 frames x 64 states, each bitwise the same route with
  the plain versions on the card and, at 4096 frames, the port's CPU
  result, timed beside the exact kernel route, with K8's share of each
  call beside the bound of its launches; ``backend='lse'`` at the
  headline (a matrix product a frame, then K3, bitwise its plain version
  on the lse posteriors), unchanged under TF32 matmul precision, its
  first rows the CPU's lse paths, its RPA against the exact path;
- the batch scale-out (``scaleout_phase``): two rank processes sharing
  the card in a gloo world (``python chip_smoke.py --scaleout-rank``, each
  making its inputs from the seeds and reading its own launch counters):
  the headline through ``parallel.decode_sharded`` (256 rows a rank, K1's
  cluster design then K3; also 509 rows), the dense 8 x 64 batch (K2, K3),
  ``parallel.files.from_files_to_files`` on the 64-file corpus and the
  evaluation harness on the 24-file ``synthdaps`` corpus, each bitwise (the
  evaluation: its RPA and frames) the single-process run, the files' shares
  the partition of ``shard_files_balanced``, the results written once; a
  world of one over NCCL; ``scripts/scaling.py --mode overhead`` with one
  and two ranks at 512 x 512 x 1440;
- the trace: one headline call under ``torch.profiler``, read by the
  benchmark's ``benchmark/trace.py``, with its top device ops and the
  device's idle share.

After the build it prints what ptxas reports of K7 and of each of K8's
tile designs, and fails if a design the plan picks, or K7, spills or
takes more than 128 registers a thread, or if the card holds fewer or
more CTAs an SM of a planned design than the plan models. Prints the
card's name and power limit, per-kernel times beside their bounds and
their plain versions' times, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
without the last line. Needs one CUDA card; imports nothing of JAX.
"""
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TINY = np.finfo(np.float32).tiny
BATCH, FRAMES, STATES = 512, 512, 1440
DENSE_BATCH, DENSE_FRAMES = 8, 64
# K2's throughput shape (README's dense shape), the edges of its launch
# plan (batch, frames, states; states off a multiple of 4 take the padded
# sources), ragged, and the sub-batch of its plain version there
DENSE_BIG_BATCH, DENSE_BIG_FRAMES, DENSE_BIG_STATES = 512, 512, 1280
DENSE_EDGES = ((1, 24, 96), (3, 24, 96), (130, 24, 96), (1, 24, 2048),
               (3, 24, 2048), (130, 24, 2048), (3, 24, 97), (1, 64, 97),
               (8, 64, 1203))
DENSE_SUB = 64
# The batch-1 shape of bench.py: one sequence of 10,240 frames, and a short
# one below the auto-chunk threshold
SINGLE_FRAMES, SHORT_FRAMES = 10240, 2048
# Half-width of the pure -inf band of the window phase (the pitch band's)
WINDOW_HALFWIDTH = 87
# A band over the pitch floor too wide for K4's register tile at 1440 states
# (width 261), and the frames of the phases that check that limit; a band
# too wide for any layout of K1's cluster design (width 401)
WIDE_HALFWIDTH, EDGE_FRAMES = 130, 256
BAND401_HALFWIDTH = 200
# The pitch transition at a 20 ms hop (160 samples at 8 kHz): a band of
# width 347, which no cluster layout of K1 holds at 1440 states; K1's
# wide-band design at 512 x 512 x 1440 (path b) and on one sequence of
# 10,240 frames (path c); and 4096 states at the pitch band's width
HOP_20MS = 160
WIDE_STATES, WIDE_STATES_HALFWIDTH = 4096, 87
# A band of half of 8200 states: the wide-band slice streams
STREAMED_STATES, STREAMED_HALFWIDTH, STREAMED_FRAMES = 8200, 2000, 6
# K3 past 8 x 1024 states: the chase without staging, on a dense transition
BIG_STATES = 8200
# The file path: bench.py's corpus generator at seed 3 (FILE_COUNT files of
# 400-1600 frames), also in batches of FILE_BATCH; one long file decoded in
# chunks at least FILE_CHUNK_MIN frames apart
FILE_COUNT, FILE_SEED, FILE_BATCH = 64, 3, 16
FILE_CHUNK_FRAMES, FILE_CHUNK_MIN = 65536, 512
# The evaluation harness: two synthetic corpora with the eval script's
# seeds, EVAL_FILES pitch files of 128-512 frames each
EVAL_SEEDS = {'synthdaps': 11, 'synthvctk': 7011}
EVAL_FILES = 24
# The cross-route soak through the kernels
SOAK_CASES, SOAK_SEED = 240, 20261017
# The batch scale-out: a gloo world of SCALEOUT_RANKS rank processes on
# the card, the headline split whole and at SCALEOUT_UNEVEN rows, the
# evaluation split on one of the smoke's corpora; seconds the ranks and the
# scaling script may take
SCALEOUT_RANKS, SCALEOUT_UNEVEN = 2, 509
SCALEOUT_DATASET = 'synthdaps'
SCALEOUT_TIMEOUT = 600
# pYIN's HMM (1202 states, dense): the rows of the pyin-b512-sorted
# cell's longest batch, its probabilities made from this seed
PYIN_ROWS, PYIN_SEED = 512, 2 ** 32 + 7
# madmom's DBN beat tracker (5617 states, 8,934 positive pairs): the rows
# of the dbnbeat-b16-tracks cell's longest batch, its activations drawn from
# this seed; the in-list route's edge shapes (batch, frames, states, the
# in-degree of a light destination, seed: odd state counts, one frame, one
# row; K9's observation ring in shared memory up to 11,622 states, its
# values loaded on the frame past it (11,700: the in-lists resident; 20,000:
# in global memory); 40 rows: more clusters of 8 and 16 CTAs than the card
# holds at once) and the random sparse HMMs
# the gate's threshold is timed at (batch, frames, states, and the in-degree
# of a random one, or madmom's or pYIN's transition, or madmom's with one
# source a state: no warp-reduced in-list)
BEATS_SEED = 2 ** 33 + 11
SPARSE_EDGES = ((1, 1, 97, 2, 1), (1, 64, 97, 2, 2), (3, 50, 1000, 3, 3),
                (5, 40, 5617, 2, 4), (7, 33, 2048, 1, 5), (2, 30, 9000, 3, 6),
                (2, 20, 11700, 0, 7), (2, 20, 20000, 4, 8),
                (40, 24, 5617, 2, 9))
SPARSE_SHARES = ((16, 2048, 5617, 'madmom'), (1, 4096, 5617, 'madmom'),
                 (16, 2048, 5617, 'chain'),
                 (16, 2048, 5617, 6), (16, 2048, 5617, 18),
                 (16, 2048, 5617, 56), (512, 861, 1202, 'pyin'))
# K9 timed at every cluster size (the layout forced) at these shapes
# (batch, frames, states, madmom's transition or the in-degree of a random
# one): the spread rule's MIN_SLICE
SPARSE_SPREAD = ((16, 2048, 5617, 'madmom'), (1, 4096, 5617, 'madmom'),
                 (1, 4096, 2816, 1), (16, 2048, 2816, 1),
                 (1, 4096, 1202, 1), (1, 4096, 97, 1))
# Rows of the uniform path at the headline's shape held against the scan
UNIFORM_SCAN_ROWS = 16
# The extra decode modes: the time-sharded and associative routes at one
# sequence of TIME_SHARDED_MIN_FRAMES frames x 64 states (also at
# MODES_CPU_FRAMES, against the CPU), K8's edge shapes, and the lse
# route's rows held against the CPU
MODES_FRAMES, MODES_STATES, MODES_CPU_FRAMES = 32768, 64, 4096
MAXPLUS_EDGES = (1, 5, 33, 64, 65, 127, 130)
MAXPLUS_LAYOUTS = ('batched', 'broadcast', 'strided', 'neg_inf', 'nan')
LSE_CPU_ROWS = 8

# The lab phases: the bitwise checks' frames (forward lab at 8 sequences,
# spread lab) and steps (chase lab), the timed iterations, and the forward
# variants timed at the headline shape
LAB_CHECK_FRAMES, LAB_CHECK_STEPS, LAB_ITERS = 64, 256, 3
LAB_FORWARD_SPECS = (
    'full:4:1', 'full:4:2', 'full:4:4', 'full:4:8', 'full:1:1', 'full:1:2',
    'full:1:4', 'full:1:8', 'rollmax', 'addmax', 'max', 'rowadd', 'pipe',
    'pipe2', 'pipe4', 'pipe16', 'pipe3', 'pipe5', 'pipe24', 'tilted:2',
    'tilted:4', 'tilted:8')
# pipeG for groups without an instance of their own (the run-time group)
RUN_TIME_PIPES = ('pipe3', 'pipe5', 'pipe24')
# The tensor-core and mod-M labs need the states a multiple of 128: the
# JAX lab's default 1536 (M = 12), the headline's batch, frames and width;
# full:4:4 timed beside them at that shape
LAB_MOD_STATES = 1536
HYBRID_KS = (1, 8, 81)
LAB_MOD_SPECS = (
    'full:4:4', 'mxushift:1', 'mxushift:2', 'mxushift:4', 'mxushift:8',
    *(f'hybrid:{k}' for k in HYBRID_KS), 'mod12', 'mod12:1:4', 'mod12:8:8',
    'mod12k', 'mod12k:1:4')

# The H100's memory rate and its FP32 instruction issue rate (an add and a
# max are one instruction each; two per candidate at 128 issue slots per SM
# and clock take as long as its max alone at the published 64 minima and
# maxima per SM and clock): utils/profile.py's model, with the card's SM
# count and clock read in main()
PEAK_BYTES_PER_S = 3.35e12
ISSUE_PER_S = None


def info(message):
    print(f'[smoke] {message}', flush=True)


def fail(message):
    info(f'FAILED: {message}')
    sys.exit(1)


def cuda_ms(torch, fn, iters, warmup=1):
    """Mean ms per call of ``fn`` on the card (CUDA events)"""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def cuda_once(torch, fn):
    """One call of ``fn``: its result and its ms (CUDA events)"""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    stop.record()
    stop.synchronize()
    return result, start.elapsed_time(stop)


def max_abs_err(torch, got, expected):
    if torch.equal(got, expected):
        return 0.0
    diff = (got.double() - expected.double()).abs()
    return float(torch.nan_to_num(diff, nan=float('inf')).max())


def k5_launched(counts):
    """Whether both phases of K5 launched in a run's launch counts"""
    return counts['backtrace_pointers'] >= 1 and counts['chase_pointers'] >= 1


def slice_mode_plans(plans):
    """The cheapest plan of each slice mode (resident, then streamed) of a
    launch planner's ``plans``, where one of that mode fits"""
    plans = list(plans)
    chosen = []
    for resident in (True, False):
        plan = min((plan for plan in plans if plan['resident'] == resident),
                   key=lambda plan: plan['cost'], default=None)
        if plan is not None:
            chosen.append(plan)
    return chosen


def require_equal(torch, name, got, expected):
    err = max_abs_err(torch, got, expected)
    if not torch.equal(got, expected):
        fail(f'{name}: kernel differs from its plain version '
             f'(max abs err {err}; tolerance: bitwise)')
    info(f'{name}: bitwise equal to its plain version (tolerance: bitwise)')
    return err


def bound_ms(bytes_moved, operations):
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op_ms = operations / ISSUE_PER_S * 1e3
    return (max(byte_ms, op_ms),
            'bytes' if byte_ms >= op_ms else 'operations')


def host_ms(torch, fn, calls=10):
    """Warm median, min and max ms of ``calls`` host-clock calls of ``fn``,
    each ending in a synchronize"""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times), min(times), max(times)


def in_range_pairs(states, lo, width):
    """In-range (source, destination) pairs of a band: the candidates one
    frame step needs"""
    j = np.arange(states)
    return int((np.minimum(states - lo - j, width)
                - np.maximum(-lo - j, 0)).clip(min=0).sum())


def clusters_of(plan):
    """Clusters launched by a band.cluster_plan"""
    return sum(-(-count // size) for _, count, size in plan)


def valid_steps(batch_frames, frames):
    """Frame steps t >= 1 with t < batch_frames, summed over the batch"""
    return int((batch_frames.clamp(max=frames) - 1).clamp(min=0).sum())


# The conversions the banded forward kernels fold into their loads, as
# (log_input, apply_epsilon), and the torch ops of the plain route that each
# must equal bitwise (dispatch.convert); (True, False) converts nothing
CONVERSIONS = {
    (True, True): 'torch.exp, add_(tiny), log_ (the epsilon step)',
    (False, True): 'torch.log, then exp_, add_(tiny), log_',
    (False, False): 'torch.log',
}


def with_tiny_entries(obs):
    """A copy of a log-space observation with every 7th value log(tiny):
    exp of it is subnormal, and in probability space (its exp) it is a
    0 < p < tiny entry"""
    out = obs.clone()
    out.view(-1)[::7] = float(np.log(np.float32(TINY)))
    return out


def hold_folded(torch, dispatch, label, fn, raw, rest):
    """``fn(obs, *rest, log_input, apply_epsilon)`` (a banded forward
    wrapper) with the conversion folded in, in log space on ``raw`` and in
    probability space on its exp, bitwise against the plain route: the
    conversion as torch ops, then ``fn`` on the converted observation.
    Returns the largest max abs err (0.0)"""
    err = 0.0
    for (log_input, apply_epsilon), ops in CONVERSIONS.items():
        obs = raw if log_input else torch.exp(raw)
        got = fn(obs, *rest, log_input=log_input,
                 apply_epsilon=apply_epsilon)[0]
        want = fn(dispatch.convert(obs, log_input, apply_epsilon)
                  .contiguous(), *rest)[0]
        torch.cuda.synchronize()
        mode = f'log_input={log_input}, apply_epsilon={apply_epsilon}'
        if not torch.equal(got, want):
            fail(f'{label} ({mode}): the folded conversion differs from '
                 f'the plain route in {int((got != want).sum())} values '
                 f'(max abs err {max_abs_err(torch, got, want)}; tolerance: '
                 f'bitwise): the kernel\'s logf/expf round otherwise than '
                 f'{ops}')
        err = max(err, max_abs_err(torch, got, want))
    return err


def ptxas_kernels(output):
    """{kernel: (registers, spill store bytes, spill load bytes)} from the
    -Xptxas -v report of one nvcc build"""
    kernels, current, spills = {}, None, (0, 0)
    for line in output.splitlines():
        match = re.search(r"Compiling entry function '(\S+)'", line)
        if match:
            current, spills = match.group(1), (0, 0)
        match = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                          line)
        if match:
            spills = (int(match.group(1)), int(match.group(2)))
        match = re.search(r'Used (\d+) registers', line)
        if match and current:
            kernels[current] = (int(match.group(1)), *spills)
    return kernels


def redesign_registers(build, associative):
    """K8's tile designs and K7 as ptxas reported them when they were
    built (the report kept beside each library), one info line each;
    fails if the report is missing, or if a design or K7 spills or takes
    more registers a thread than its launch bounds allow (128 for K7)"""
    for library in ('maxplus', 'constant'):
        kernels = ptxas_kernels(build.report(library) or '')
        if not kernels:
            fail(f'no ptxas report of {library}.cu beside its library')
        for kernel, (registers, stores, loads) in kernels.items():
            design = re.search(r'maxplus_kernelI((?:Li\d+E)+)E', kernel)
            if design:
                tile = tuple(int(x) for x in
                             re.findall(r'Li(\d+)E', design.group(1)))
                index = associative.MAXPLUS_TILES.index(tile)
                label = (f'K8 tile design {index} (TY, TX, RI, RJ, KD, '
                         f'STAGES, REGS) = {tile}')
                most = tile[-1]
            else:
                label, most = 'K7 constant_kernel', 128
            info(f'{label}: {registers} registers a thread, {stores} bytes '
                 f'spill stores, {loads} bytes spill loads (ptxas -v)')
            if registers > most or stores or loads:
                fail(f'{label} takes {registers} registers and spills '
                     f'{stores} bytes: at most {most} and none expected')


def sass_listing(build, library):
    """{function: [(address, opcode), ...]} of a built library's SASS
    (cuobjdump -sass), NOPs left out"""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    out = subprocess.run([tool, '-sass', str(build.target(library))],
                         capture_output=True, text=True, timeout=300)
    if out.returncode:
        fail(f'cuobjdump -sass failed on {library}: {out.stderr.strip()}')
    listing = {}
    function = None
    for line in out.stdout.splitlines():
        match = re.match(r'\s*Function : (\S+)', line)
        if match:
            function = match.group(1)
            listing[function] = []
            continue
        match = re.match(r'\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;', line)
        if function and match:
            words = match.group(2).split()
            op = words[1] if words[0].startswith('@') else words[0]
            if not op.startswith('NOP'):
                listing[function].append(
                    (int(match.group(1), 16), match.group(2)))
    return listing


def sass_opcodes(build, library):
    """{function: [opcode, ...]} of a built library's SASS, NOPs left out"""
    return {function: [
        text.split()[1] if text.startswith('@') else text.split()[0]
        for _, text in body]
        for function, body in sass_listing(build, library).items()}


# The SASS kinds an operations bound counts: FP32 adds, compares, minima
# and maxima, and selects
FP32_KINDS = ('FADD', 'FSETP', 'FSEL', 'SEL', 'FMNMX')


def sass_pointer_instructions(build, pattern='pointers_kernelILb1E'):
    """FP32 and select instructions per candidate of K5's phase 1
    (pointers_kernel with its floor term; without it, K6's), from its
    SASS: the adds, compares and selects from the kernel's first FADD to
    its last (the candidate loop: each candidate is one FADD; the combine
    with the floor candidate after the loop is left out), over its FADDs"""
    found = [ops for function, ops in sass_opcodes(
        build, 'backtrace_batch1').items() if pattern in function]
    if len(found) != 1:
        fail(f'cuobjdump: {len(found)} functions match {pattern}')
    kinds = [op.split('.')[0] for op in found[0]]
    adds = [n for n, kind in enumerate(kinds) if kind == 'FADD']
    if not adds:
        fail(f'cuobjdump: {pattern} holds no FADD')
    loop = kinds[adds[0]:adds[-1] + 1]
    return sum(kind in FP32_KINDS for kind in loop) / len(adds)


def sass_loop_instructions(build, library, pattern):
    """Instructions per candidate in the candidate loop of a kernel whose
    every candidate is one FADD, from its SASS: of the bodies of its
    backward branches, the one densest in FADDs (the innermost candidate
    loop). Returns (every instruction of it, loads, address arithmetic
    and the branch included, over its FADDs; its FP32 and select
    instructions over its FADDs, as sass_pointer_instructions counts)"""
    found = [body for function, body in sass_listing(build, library).items()
             if pattern in function]
    if len(found) != 1:
        fail(f'cuobjdump: {len(found)} functions match {pattern}')
    best = None
    for address, text in found[0]:
        target = re.search(r'\bBRA\b.*?(0x[0-9a-f]+)', text)
        if not target or int(target.group(1), 16) >= address:
            continue
        body = [op.split()[1] if op.startswith('@') else op.split()[0]
                for at, op in found[0]
                if int(target.group(1), 16) <= at <= address]
        kinds = [op.split('.')[0] for op in body]
        adds = kinds.count('FADD')
        if adds and (best is None or adds / len(body) > best[2] / best[0]):
            best = (len(body), sum(kind in FP32_KINDS for kind in kinds),
                    adds)
    if best is None:
        fail(f'cuobjdump: no loop with an FADD in {pattern}')
    return best[0] / best[2], best[1] / best[2]


def sass_conversion_counts(build):
    """SASS instructions (and MUFU instructions among them) per converted
    value, read with cuobjdump from the built K1 library: each instance of
    the cluster design with a conversion against the one without, over the
    values it converts in its code (frame 0 and the two inlined fetches, each
    NBT x R values: 3 with 1 sequence per cluster, 12 with 4, 48 with 32).
    Static counts: the compiler may schedule the instances differently
    around the conversion, so the three are estimates of one number.
    Returns {(log_input, apply_epsilon): {kernel: (all, mufu)}}"""
    counts = {function: [len(ops), sum(op.startswith('MUFU') for op in ops)]
              for function, ops in sass_opcodes(build, 'band_forward').items()}
    kernels = {f'K1 {nb} per cluster': (f'band_cluster_kernelILi{nb}ELi{{}}E',
                                        places)
               for nb, places in ((1, 3), (4, 12), (32, 48))}

    def find(pattern):
        found = [key for key in counts if pattern in key]
        if len(found) != 1:
            fail(f'cuobjdump: {len(found)} functions match {pattern}')
        return counts[found[0]]

    result = {}
    for (log_input, apply_epsilon) in CONVERSIONS:
        conv = (0 if log_input else 2) | (1 if apply_epsilon else 0)
        result[(log_input, apply_epsilon)] = {}
        for label, (pattern, places) in kernels.items():
            base, with_conv = find(pattern.format(0)), find(
                pattern.format(conv))
            result[(log_input, apply_epsilon)][label] = (
                (with_conv[0] - base[0]) / places,
                (with_conv[1] - base[1]) / places)
    return result


def dense_big_inputs(torch, device):
    """K2's throughput shape, made on the card from seed 0: log-uniform
    observations, a row-normalised random transition in log space, a
    uniform initial distribution; the last two sequences stop early"""
    generator = torch.Generator(device).manual_seed(0)
    trans = torch.rand((DENSE_BIG_STATES, DENSE_BIG_STATES),
                       generator=generator, device=device)
    trans = torch.log(trans / trans.sum(dim=1, keepdim=True) + TINY)
    obs = torch.log(torch.rand(
        (DENSE_BIG_BATCH, DENSE_BIG_FRAMES, DENSE_BIG_STATES),
        generator=generator, device=device) + TINY)
    initial = torch.full((DENSE_BIG_STATES,), -float(np.log(
        DENSE_BIG_STATES)), device=device)
    lengths = torch.tensor(
        [DENSE_BIG_FRAMES] * (DENSE_BIG_BATCH - 2)
        + [DENSE_BIG_FRAMES // 2, 7], dtype=torch.int32, device=device)
    return obs, lengths, trans, initial


def traced(torch, fn, trace_dir):
    """One call of ``fn`` under the benchmark's profiler, its Chrome trace
    written to trace_dir/trace.json: ``benchmark/trace.py``'s summary,
    with ``idle_share`` (1 - busy / span)"""
    from benchmark import trace

    trace_dir = Path(trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    with trace.profiled('cuda') as profile:
        fn()
        torch.cuda.synchronize()
    path = trace_dir / 'trace.json'
    profile.export_chrome_trace(str(path))
    summary = trace.summarize(trace.complete_events(path))
    if summary is None:
        fail(f'the trace at {path} holds no complete event')
    summary['idle_share'] = 1.0 - summary['busy_s'] / summary['span_s']
    return summary


def trace_rows(summary, top):
    """Info lines of the ``top`` longest device ops of a trace summary"""
    for name, (seconds, count) in list(
            summary['device_ops'].items())[:top]:
        info(f'  trace {seconds * 1e3:9.3f} ms x{count:<3} {name[:90]}')


def trace_dense(trace_dir):
    """Child process of the dense phase: one call of the dense path at the
    throughput shape under the profiler (a process traces the card once),
    after a warm-up call; writes the trace's summary to
    trace_dir/summary.json"""
    import torch

    sys.path.insert(0, str(ROOT))
    import torbi_tpu_torch

    device = torch.device('cuda', 0)
    obs, lengths, trans, initial = dense_big_inputs(torch, device)

    def call():
        return torbi_tpu_torch.from_probabilities(
            obs, batch_frames=lengths, transition=trans, initial=initial,
            log_probs=True, gpu=0)

    call()
    torch.cuda.synchronize()
    summary = traced(torch, call, trace_dir)
    (Path(trace_dir) / 'summary.json').write_text(json.dumps(summary))


def hold_fixtures(torch, fixtures, device, reset_counts, read_counts):
    """Decode every committed fixture case on the card through
    from_probabilities and hold its path against torbi_tpu's, bitwise; the
    serial cases must launch K4 and K5, the wide cases K1's wide-band
    design (the counters reset just before and read just after each).
    Returns the number of cases held"""
    committed = fixtures.load()
    names = [case.name for case in fixtures.CASES + fixtures.FILE_CASES]
    if sorted(committed) != sorted(names):
        fail(f'the fixture file holds {sorted(committed)}, the cases are '
             f'{sorted(names)}')
    for case in fixtures.CASES:
        inputs = fixtures.case_inputs(case)
        expected, digest = committed[case.name]
        if fixtures.inputs_hash(case, inputs) != digest:
            fail(f'fixture {case.name}: the inputs made here differ from '
                 'those the committed paths were decoded from')
        reset_counts()
        got = fixtures.decode(case, inputs, device.index)
        torch.cuda.synchronize()
        counts = read_counts()
        if case.name in fixtures.SERIAL and (
                counts['band_spread'] < 1 or not k5_launched(counts)):
            fail(f'fixture {case.name} did not take the serial route (K4, '
                 f'K5): launches {counts}')
        if case.name in fixtures.WIDE and (
                counts['band_forward_wide'] < 1 or counts['band_forward']
                or (case.name in fixtures.WIDE_SERIAL)
                != k5_launched(counts)):
            fail(f'fixture {case.name} did not take K1\'s wide-band design '
                 f'(and K5 for one sequence): launches {counts}')
        if got.device != device or not np.array_equal(
                got.cpu().numpy(), expected):
            differ = int((got.cpu().numpy() != expected).sum())
            fail(f'fixture {case.name}: the card\'s path differs from '
                 f'torbi_tpu\'s in {differ} of {expected.size} positions; '
                 + conversion_report(torch, inputs[0], case.log_probs,
                                     device))
    return len(fixtures.CASES)


def conversion_report(torch, observation, log_probs, device):
    """Which op of the conversion rounds differently on the card than on
    the CPU (the port's CPU route equals torbi_tpu's): each torch op of
    the plain route on both, step by step"""
    steps = [] if log_probs else [('torch.log', torch.log)]
    steps += [('torch.exp', torch.exp),
              ('add(tiny)', lambda x: x + float(TINY)),
              ('torch.log (epsilon step)', torch.log)]
    cpu = torch.from_numpy(np.asarray(observation, np.float32))
    card = cpu.to(device)
    for name, op in steps:
        cpu, card = op(cpu), op(card)
        differ = int((card.cpu() != cpu).sum())
        if differ:
            return (f'{name} rounds differently on the card in {differ} '
                    'values')
    return 'the conversion rounds the same on the card as on the CPU'


def file_path_phase(torch, device, card, reset_counts, read_counts):
    """The file path at full width on the card, through the entry points a
    user calls: from_files_to_files over FILE_COUNT pitch files (the
    native loader, K1, K3), in one batch and in batches of FILE_BATCH
    (several decodes overlapping the writes), .pt files through the Python
    loader, a FILE_CHUNK_FRAMES-frame file decoded in chunks, from_file_to_file
    on a SINGLE_FRAMES-frame file (the auto-chunk route), the CLI in a
    subprocess, and the file fixture cases against torbi_tpu's committed
    paths; each bitwise against the port's from_probabilities per file (or
    per chunk) on the card. The counters are reset just before and read
    just after each run. Returns the corpus run's launch counts.
    ``device`` is the card (or, to rehearse the phase's logic, the CPU)"""
    import torbi_tpu_torch
    from torbi_tpu_torch import core
    from torbi_tpu_torch.data import native
    from torbi_tpu_torch.models import pitch
    from torbi_tpu_torch.ops import autochunk, dispatch
    from torbi_tpu_torch.utils import fixtures, io, profile, timing

    gpu = device.index if device.type == 'cuda' else 'cpu'

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize()

    directory = ROOT / 'build' / 'smoke_files'
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    start = time.perf_counter()
    lengths = np.random.default_rng(FILE_SEED).integers(
        400, 1600, size=FILE_COUNT)
    inputs, outputs, trans_path = pitch.write_corpus(
        str(directory), lengths, STATES)
    trans_prob = np.load(trans_path)
    trans_log = torch.from_numpy(np.log(trans_prob + TINY)).to(device)
    info(f'files: {FILE_COUNT} files of {int(lengths.min())}-'
         f'{int(lengths.max())} frames x {STATES} ({int(lengths.sum())} '
         f'timesteps) written in {time.perf_counter() - start:.1f} s')

    def run(label, fn):
        """fn() under reset counters; returns (launches, native counts,
        wall s, 'torbi' s, fn's result)"""
        reset_counts()
        native.counts.update(filled=0, fallback=0)
        timing.reset()
        sync()
        begin = time.perf_counter()
        result = fn()
        sync()
        wall = time.perf_counter() - begin
        counts = read_counts()
        decode = timing.results().get('torbi', 0.0)
        info(f'{label}: wall {wall * 1e3:.3f} ms, decode (torbi) '
             f'{decode * 1e3:.3f} ms, launches {counts}, native batches '
             f'{dict(native.counts)}')
        if counts['band_forward'] < 1 or counts['backtrace'] < 1:
            fail(f'{label} did not launch K1 and K3')
        return counts, dict(native.counts), wall, decode, result

    def files_run(label, files, outs, batches):
        result = run(label, lambda: torbi_tpu_torch.from_files_to_files(
            files, outs, transition_file=trans_path, log_probs=True, gpu=gpu))
        if result[1] != {'filled': batches, 'fallback': 0}:
            fail(f'{label}: the native loader filled {result[1]}, expected '
                 f'{batches} batches and no fallback')
        return result

    def require_files(label, outs, expected,
                      what='from_probabilities on each file alone'):
        for out, want in zip(outs, expected):
            got = io.load(out)
            if got.dtype != np.int32 or not np.array_equal(got, want):
                fail(f'{label}: {Path(out).name} differs from {what}')
        info(f'{label}: {len(outs)} output files equal {what} '
             '(tolerance: bitwise)')

    # The corpus in one batch; every output against from_probabilities on
    # its file alone (one sequence: the serial batch-1 route, K4 and K5)
    counts, _, wall, decode, _ = files_run(
        f'files path ({FILE_COUNT} files, one batch)', inputs, outputs, 1)
    expected = [torbi_tpu_torch.from_probabilities(
        np.load(path)[None], transition=trans_log, log_probs=True,
        gpu=gpu)[0].cpu().numpy() for path in inputs]
    require_files('files path', outputs, expected)
    timesteps = int(lengths.sum())
    # The loader's assembly rate (host only), as the file path loads: into
    # pinned buffers for a decode on the card
    pin = device.type == 'cuda'
    for _ in range(2):
        begin = time.perf_counter()
        loaded = sum(obs.numel() * obs.element_size() for obs, _, _, _ in
                     torbi_tpu_torch.data.loader(inputs, pin_memory=pin))
        assembly_s = time.perf_counter() - begin
    corpus_counts = counts
    info(f'files path: {timesteps / wall:.0f} timesteps/s wall, '
         f'{timesteps / decode:.0f} decode; loader {loaded / 1e6:.0f} MB '
         f'in {assembly_s * 1e3:.1f} ms ({loaded / assembly_s / 1e9:.2f} '
         f'GB/s, host only); K1 launches {counts["band_forward"]}, K3 '
         f'{counts["backtrace"]}; on {card}')

    # Batches of FILE_BATCH: several decodes, each queued before the
    # previous batch's files are written
    saved = torbi_tpu_torch.BATCH_SIZE
    torbi_tpu_torch.BATCH_SIZE = FILE_BATCH
    try:
        batched = [path.replace('_out', '_b') for path in outputs]
        batches = -(-FILE_COUNT // FILE_BATCH)
        counts, _, _, _, _ = files_run(
            f'files path (batches of {FILE_BATCH})', inputs, batched,
            batches)
        if counts['band_forward'] < batches:
            fail(f'{batches} batches launched K1 {counts["band_forward"]} '
                 'times')
        require_files(f'files path (batches of {FILE_BATCH})', batched,
                      expected)

        # Pinned against pageable buffers, one batch and FILE_BATCH, in
        # turns (pinned, pageable, pageable, pinned), through
        # from_dataloader as from_files_to_files calls it
        mapping = {path: out for path, out in zip(inputs, batched)}
        turns = {}
        for batch_size in (512, FILE_BATCH):
            torbi_tpu_torch.BATCH_SIZE = batch_size
            for pinned in ((True, False, False, True) if pin else (False,)):
                _, _, wall, decode, _ = run(
                    f'from_dataloader, batches of {batch_size}, '
                    f'{"pinned" if pinned else "pageable"} buffers',
                    lambda: torbi_tpu_torch.from_dataloader(
                        torbi_tpu_torch.data.loader(
                            inputs, pin_memory=pinned),
                        mapping, transition=trans_log, log_probs=True,
                        gpu=gpu))
                turns.setdefault((batch_size, pinned), []).append(
                    (wall * 1e3, decode * 1e3))
        for (batch_size, pinned), runs in turns.items():
            info(f'files corpus, batches of {batch_size}, '
                 f'{"pinned" if pinned else "pageable"} buffers: wall ms '
                 f'{[round(r[0], 3) for r in runs]}, decode (torbi) ms '
                 f'{[round(r[1], 3) for r in runs]} (timesteps/s wall: '
                 f'{[round(timesteps / r[0] * 1e3) for r in runs]})')
    finally:
        torbi_tpu_torch.BATCH_SIZE = saved
    # The corpus in one batch, staged on the card: its decode alone
    observation, batch_frames, _, _ = next(iter(
        torbi_tpu_torch.data.loader(inputs)))
    obs_card = observation.to(device)
    frames_card = batch_frames.to(device)
    initial = core._default_initial(STATES, device)
    staged_s = profile.time_submissions(
        lambda: dispatch.decode(
            obs_card, frames_card, trans_log, initial,
            apply_epsilon=True, device=device),
        lambda r: r[0, 0], iters=3)
    del obs_card
    info(f'files batch staged on the card ({tuple(observation.shape)}, '
         f'{observation.numel() * 4 / 1e9:.2f} GB): decode alone '
         f'{staged_s * 1e3:.3f} ms')

    # .pt files take the Python loader
    pt_inputs = [path.replace('.npy', '.pt') for path in inputs[:4]]
    pt_outputs = [path.replace('.pt', '_pt.pt') for path in pt_inputs]
    for npy, pt in zip(inputs, pt_inputs):
        io.save(np.load(npy), pt)
    run('files path (.pt inputs, Python loader)',
        lambda: torbi_tpu_torch.from_files_to_files(
            pt_inputs, pt_outputs, transition_file=trans_path,
            log_probs=True, gpu=gpu))
    if native.counts['filled']:
        fail('.pt inputs went through the native loader')
    require_files('files path (.pt inputs)', pt_outputs, expected[:4])

    # One long file decoded in chunks: the chunk rows as one batch, against
    # each chunk decoded alone
    long_path = str(directory / 'long.npy')
    long_obs = pitch_file(long_path, FILE_CHUNK_FRAMES, seed=5)
    saved = torbi_tpu_torch.MIN_CHUNK_SIZE
    torbi_tpu_torch.MIN_CHUNK_SIZE = FILE_CHUNK_MIN
    try:
        chunks = torbi_tpu_torch.chunk(long_obs)
        run(f'chunked file (1 x {FILE_CHUNK_FRAMES}, MIN_CHUNK_SIZE '
            f'{FILE_CHUNK_MIN})',
            lambda: torbi_tpu_torch.from_files_to_files(
                [long_path], [long_path + '.out.npy'],
                transition_file=trans_path, log_probs=True, gpu=gpu))
    finally:
        torbi_tpu_torch.MIN_CHUNK_SIZE = saved
    joined = np.concatenate([torbi_tpu_torch.from_probabilities(
        chunk[None], transition=trans_log, log_probs=True,
        gpu=gpu)[0].cpu().numpy() for chunk in chunks])
    require_files(f'chunked file ({len(chunks)} chunks)',
                  [long_path + '.out.npy'], [joined],
                  'its chunks decoded one by one through from_probabilities')

    # from_file_to_file on one long file: the auto-chunk route (K1 and K3
    # on the chunk rows; K4 and K5 must not launch), against the plain scan
    # route decoded chunk by chunk on its plan. from_file takes log(p) of
    # the transition file: a pure -inf band
    single_path = str(directory / 'single.npy')
    single = pitch_file(single_path, SINGLE_FRAMES, seed=1)
    counts, _, _, _, _ = run(
        f'from_file_to_file (1 x {SINGLE_FRAMES})',
        lambda: torbi_tpu_torch.from_file_to_file(
            single_path, single_path + '.out.npy', trans_path,
            log_probs=True, gpu=gpu))
    if (counts['band_spread'] or counts['backtrace_pointers']
            or counts['chase_pointers']):
        fail('from_file_to_file took the serial route, not auto-chunking')
    single_card = torch.from_numpy(single[None]).to(device)
    with np.errstate(divide='ignore'):
        pure = torch.from_numpy(np.log(trans_prob)).to(device)
    starts, chunk_lengths = autochunk.plan_splits(
        autochunk.framewise_entropy(single_card, STATES, True).cpu().numpy(),
        SINGLE_FRAMES, torbi_tpu_torch.BATCH1_CHUNK_FRAMES)
    per_chunk = np.concatenate([torbi_tpu_torch.from_probabilities(
        single_card[:, start:start + length], transition=pure,
        log_probs=True, gpu=gpu, backend='scan')[0].cpu().numpy()
        for start, length in zip(starts.tolist(), chunk_lengths.tolist())])
    require_files(f'from_file_to_file ({len(starts)} auto-chunk rows)',
                  [single_path + '.out.npy'], [per_chunk],
                  'the plain scan route decoded chunk by chunk on its plan')

    # The CLI in a subprocess on 4 files, without and with --config
    config = directory / 'over.py'
    config.write_text('BATCH_SIZE = 2\n')
    for extra in ([], ['--config', str(config)]):
        cli_outputs = [path.replace('_out', '_cli') for path in outputs[:4]]
        begin = time.perf_counter()
        result = subprocess.run(
            [sys.executable, '-m', 'torbi_tpu_torch', '--input_files',
             *inputs[:4], '--output_files', *cli_outputs,
             '--transition_file', trans_path, '--log_probs', '--gpu',
             str(gpu), *extra],
            capture_output=True, text=True, timeout=300, cwd=ROOT)
        if result.returncode:
            fail(f'the CLI {extra} failed: {result.stderr[-3000:]}')
        require_files(f'CLI {" ".join(extra) or "(no --config)"} in '
                      f'{time.perf_counter() - begin:.1f} s', cli_outputs,
                      expected[:4])

    # The file fixture cases against torbi_tpu's committed paths
    committed = fixtures.load()
    for case in fixtures.FILE_CASES:
        inputs_case = fixtures.case_inputs(case)
        paths, digest = committed[case.name]
        if fixtures.file_inputs_hash(case, inputs_case) != digest:
            fail(f'fixture {case.name}: the inputs made here differ from '
                 'those the committed paths were decoded from')
        got = run(f'fixture {case.name}', lambda: fixtures.decode_files(
            torbi_tpu_torch, case, inputs_case, gpu=gpu))[4]
        if not np.array_equal(got, paths):
            fail(f'fixture {case.name}: the card\'s paths differ from '
                 f'torbi_tpu\'s in {int((got != paths).sum())} of '
                 f'{paths.size} positions')
    info(f'file fixtures: {len(fixtures.FILE_CASES)} cases equal '
         'torbi_tpu\'s committed paths (tolerance: bitwise)')
    shutil.rmtree(directory, ignore_errors=True)
    return corpus_counts


def constant_phase(torch, device, single, headline, init, clock_hz):
    """K7, the constant route's recurrence, against its plain version on the
    card, bitwise: on one pitch sequence of SINGLE_FRAMES frames (whole,
    and cut short by its length) and on the headline's BATCH x FRAMES with
    ragged lengths, some past the stream; the frame maxima and first
    maxima as the closed form computes them from the converted
    observation. Timed (CUDA events) at each shape beside its bound and
    the chain of frames at the card's SM clock ``clock_hz``: per call
    through the wrapper (the host's work included where it is the longer)
    and per kernel (20 calls captured in a CUDA graph, replayed 5 times:
    ``scripts/modes_timing.py::graph_ms``). Returns the kernels-line entry
    (its launches added by the caller)."""
    from torbi_tpu_torch.ops import constant, dispatch
    from torbi_tpu_torch.scripts.modes_timing import graph_ms

    floor = float(torch.tensor(math.log(1. / STATES), dtype=torch.float32))
    rng = np.random.default_rng(11)
    ragged = rng.integers(1, FRAMES + 1, size=BATCH).astype(np.int32)
    ragged[:4] = [FRAMES, 1, 2, FRAMES + 9]
    cases = (
        ('1 x 10,240', single, [SINGLE_FRAMES]),
        ('1 x 10,240 cut at 7000', single, [7000]),
        (f'{BATCH} x {FRAMES} ragged', headline, ragged))
    timings = {}
    entry = None
    for label, observation, lengths in cases:
        obs = dispatch.convert(observation, True, True).contiguous()
        args = (obs.amax(dim=2).contiguous(),
                (obs[:, 0, :] + init[None, :]).amax(dim=1).contiguous(),
                torch.tensor(lengths, dtype=torch.int32, device=device),
                floor)
        del obs
        got = constant.recurrence(*args)
        expected, plain_ms = cuda_once(
            torch, lambda: constant.recurrence_reference(*args))
        err = require_equal(torch, f'K7 constant_recurrence at {label}',
                            got, expected)
        ms = cuda_ms(torch, lambda: constant.recurrence(*args), iters=10)
        kernel_ms = graph_ms(lambda: constant.recurrence(*args))
        batch, frames = args[0].shape
        plan = constant.recurrence_plan(
            batch, frames,
            torch.cuda.get_device_properties(device).multi_processor_count)
        # The maxima, the first maxima and the lengths in, the carry out;
        # two adds a frame and sequence
        moved = (batch * frames + 3 * batch + batch * (frames - 1)) * 4
        bound = bound_ms(moved, 2 * batch * (frames - 1))
        # The chain: two dependent fp32 adds a frame at 4 clocks each
        chain_ms = (frames - 1) * 8 / clock_hz * 1e3
        timings[label] = dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                              bound=bound, chain_ms=chain_ms)
        info(f'K7 at {label}: {kernel_ms:.4f} ms a kernel (CUDA graph of 20 '
             f'calls, 5 replays), {ms:.4f} ms a call through the wrapper '
             f'(CUDA events, mean of 10), bound {bound[0]:.5f} ({bound[1]}), '
             f'the chain of {frames - 1} frames at 8 clocks each '
             f'{chain_ms:.4f} ms; plain {plain_ms:.1f} ms; plan '
             f'{plan["sequences"]} sequences a CTA on {plan["blocks"]} CTAs, '
             f'tiles of {plan["tile"]} frames')
        if entry is None:
            entry = dict(
                name='constant_recurrence', route='cuda',
                source='torbi_tpu_torch/csrc/constant.cu',
                replaces='torbi_tpu/ops/dispatch.py:385', path='uniform',
                max_abs_err=err, ms=ms, kernel_ms=kernel_ms,
                plain_ms=plain_ms, bound=bound, library_ms=None,
                chain_bound_ms=chain_ms)
        entry['max_abs_err'] = max(entry['max_abs_err'], err)
    entry['shapes'] = {
        label: {key: (value[0] if key == 'bound' else value)
                for key, value in timing.items()}
        for label, timing in timings.items()}
    return entry


def c4_phase(torch, reset_counts, read_counts):
    """``batch_frames`` past ``frames`` on the card: a 3 x 7 x 40 banded
    batch with lengths [9, 7, 3] through K1 and K3, and one 64-frame
    sequence with length 80 through K4 and K5; each path equals the path
    of the clamped lengths (the same route) and the plain scan route's
    there. The counters are reset just before and read just after each."""
    import torbi_tpu_torch

    rng = np.random.default_rng(4)
    states = 40
    trans = np.full((states, states), np.log(TINY), np.float32)
    rows = np.arange(states)
    for offset in range(-3, 4):
        keep = (rows + offset >= 0) & (rows + offset < states)
        trans[rows[keep], rows[keep] + offset] = np.log(
            rng.uniform(0.05, 1, keep.sum())).astype(np.float32)
    for label, shape, lengths, kernels in (
            ('3 x 7, lengths [9, 7, 3]', (3, 7), [9, 7, 3],
             ('band_forward', 'backtrace')),
            ('1 x 64, length 80', (1, 64), [80],
             ('band_spread', 'backtrace_pointers', 'chase_pointers'))):
        obs = np.log(rng.dirichlet(np.ones(states), size=shape)
                     .astype(np.float32) + TINY)

        def decode(lengths, **kwargs):
            return torbi_tpu_torch.from_probabilities(
                obs, batch_frames=np.array(lengths, np.int32),
                transition=trans, log_probs=True, gpu=0, **kwargs)

        reset_counts()
        got = decode(lengths)
        torch.cuda.synchronize()
        counts = read_counts()
        missing = [name for name in kernels if counts[name] < 1]
        if missing:
            fail(f'batch_frames past frames ({label}) did not launch '
                 f'{missing}: launches {counts}')
        clamped = np.minimum(lengths, shape[1])
        if not torch.equal(got, decode(clamped)):
            fail(f'batch_frames past frames ({label}) differs from the path '
                 'of the clamped lengths')
        if not torch.equal(got, decode(clamped, backend='scan')):
            fail(f'batch_frames past frames ({label}) differs from the plain '
                 'scan route at the clamped lengths')
        info(f'batch_frames past frames, {label}: equals the path of the '
             f'clamped lengths and the scan route there (launches '
             f'{ {name: counts[name] for name in kernels} })')


def evaluation_phase(torch, device, card, reset_counts, read_counts):
    """The evaluation harness at full width, unmodified: two synthetic
    corpora of EVAL_FILES 1440-state pitch files each (the eval script's
    generator and seeds), the reference pass on the CPU over a spawn pool,
    then four configurations through ``evaluate.datasets``: the default
    (batches of BATCH_SIZE: K1 and K3), ``config/nobatch.py`` (one file a
    call: K4 and K5), MIN_CHUNK_SIZE 64 (chunk rows: K1 and K3) and
    ``EVAL_BACKEND='lse'`` (the smoothed-max route: K3; its RPA reported).
    The default and nobatch must score RPA@0 = 1.0 against the reference;
    each chunked output file must equal its chunks decoded one by one
    through the plain scan route. The package's constants are restored
    afterwards. Returns {config: (results, launch counts)}. ``device`` is
    the card (or, to rehearse the phase's logic, the CPU)."""
    import os

    import torbi_tpu_torch
    from torbi_tpu_torch.config import configure
    from torbi_tpu_torch.scripts import eval_synth
    from torbi_tpu_torch.utils import io

    gpu = device.index if device.type == 'cuda' else 'cpu'
    names = ('CONFIG', 'CACHE_DIR', 'EVAL_DIR', 'PARTITION_DIR',
             'PITCH_TRANSITION_MATRIX', 'DATASETS', 'EVALUATION_SAMPLES',
             'BATCH_SIZE', 'MIN_CHUNK_SIZE', 'EVAL_BACKEND', 'MODULE')
    missing = object()
    saved = {name: getattr(torbi_tpu_torch, name, missing) for name in names}

    def restore():
        for name, value in saved.items():
            if value is not missing:
                setattr(torbi_tpu_torch, name, value)
            elif hasattr(torbi_tpu_torch, name):
                delattr(torbi_tpu_torch, name)

    workdir = ROOT / 'build' / 'smoke_eval'
    shutil.rmtree(workdir, ignore_errors=True)
    datasets = list(EVAL_SEEDS)
    start = time.perf_counter()
    frames = 0
    for dataset, seed in EVAL_SEEDS.items():
        _, lengths = eval_synth.build_corpus(
            workdir, dataset, EVAL_FILES, 128, 512, seed)
        frames += sum(lengths)
    info(f'evaluation corpora {datasets}: {len(datasets) * EVAL_FILES} '
         f'files, {frames} frames x {STATES} states, made in '
         f'{time.perf_counter() - start:.1f} s')
    results = {}
    try:
        eval_synth.configure(workdir, 'synth-smoke', datasets, EVAL_FILES)
        threads = min(8, os.cpu_count() or 1)
        start = time.perf_counter()
        eval_synth.reference_pass(datasets, threads)
        info(f'evaluation reference pass: {frames} frames on {threads} '
             f'spawn workers in {time.perf_counter() - start:.1f} s')
        runs = (
            ('default', None, {}, ('band_forward', 'backtrace')),
            ('nobatch', ROOT / 'torbi_tpu_torch' / 'config' / 'nobatch.py',
             {}, ('band_spread', 'backtrace_pointers', 'chase_pointers')),
            ('chunk64', None, {'MIN_CHUNK_SIZE': 64},
             ('band_forward', 'backtrace')),
            ('lse', None, {'EVAL_BACKEND': 'lse'}, ('backtrace',)))
        for label, config_file, overrides, kernels in runs:
            restore()
            if config_file is not None:
                configure([config_file])
            eval_synth.configure(
                workdir, torbi_tpu_torch.CONFIG if config_file
                else f'synth-smoke-{label}', datasets, EVAL_FILES)
            for name, value in overrides.items():
                setattr(torbi_tpu_torch, name, value)
            reset_counts()
            start = time.perf_counter()
            result = torbi_tpu_torch.evaluate.datasets(
                datasets, gpu=gpu, num_threads=threads)
            wall = time.perf_counter() - start
            counts = read_counts()
            results[label] = (result, counts)
            for dataset in datasets:
                entry = result[dataset]
                info(f'evaluation {label}, {dataset}: RPA@0/1/2 '
                     + '/'.join(f'{entry["rpa"][k]:.6f}'
                                for k in ('0', '1', '2'))
                     + f', {entry["frames"]} frames, RTF '
                     f'{entry["rtf"]["torbi"]:.1f}, '
                     f'{entry["timesteps_per_second"]["torbi"]:.0f} '
                     f'timesteps/s (torbi), on {card}')
            info(f'evaluation {label}: {wall:.1f} s wall, launches {counts}')
            if device.type == 'cuda':
                absent = [name for name in kernels if counts[name] < 1]
                if absent:
                    fail(f'the evaluation ({label}) did not launch '
                         f'{absent}: launches {counts}')
            if label == 'lse':
                # Approximate by design: its RPA is reported, not limited
                continue
            if label != 'chunk64':
                low = {dataset: result[dataset]['rpa']['0']
                       for dataset in datasets
                       if result[dataset]['rpa']['0'] != 1.0}
                if low:
                    fail(f'the evaluation ({label}) scored RPA@0 below 1.0 '
                         f'against the reference decoder: {low}')
                continue
            # Each chunked output file: its chunks one by one, scan route
            transition = np.log(
                io.load(torbi_tpu_torch.PITCH_TRANSITION_MATRIX) + TINY)
            checked = 0
            for dataset in datasets:
                for stem in json.loads((
                        workdir / 'partitions' / f'{dataset}.json')
                        .read_text()):
                    obs = io.load(workdir / 'cache' / dataset / f'{stem}.pt')
                    expected = torch.cat([
                        torbi_tpu_torch.from_probabilities(
                            piece[None], transition=transition,
                            log_probs=True, gpu=gpu, backend='scan')[0]
                        for piece in torbi_tpu_torch.chunk(obs)]).cpu()
                    got = torch.from_numpy(io.load(
                        workdir / 'eval' / dataset / torbi_tpu_torch.CONFIG
                        / f'{stem}.pt'))
                    if not torch.equal(got, expected):
                        fail(f'the chunked evaluation output {dataset}/'
                             f'{stem} differs from its chunks decoded one '
                             'by one through the scan route')
                    checked += 1
            info(f'evaluation chunk64: {checked} output files equal their '
                 'chunks decoded one by one through the scan route')
    finally:
        restore()
    return results


def soak_phase(torch, device, reset_counts, read_counts):
    """The cross-route soak (``scripts/soak.py``) through the kernels:
    SOAK_CASES seeded configurations, each path bitwise the port's numpy
    oracle. Returns the launches per kernel over the run."""
    from torbi_tpu_torch.scripts import soak

    reset_counts()
    start = time.perf_counter()
    result = soak.run(SOAK_CASES, SOAK_SEED, device, verbose=False)
    torch.cuda.synchronize()
    counts = read_counts()
    info(f'soak: {result["cases"]} cases (kinds {result["kinds"]}) in '
         f'{time.perf_counter() - start:.1f} s, launches {counts}, '
         f'{len(result["failures"])} mismatches against the oracle '
         '(tolerance: bitwise)')
    for settings in result['failures']:
        info(f'soak mismatch: {settings}')
    if result['failures']:
        fail(f'the soak found {len(result["failures"])} mismatches')
    return counts


def same_bits(torch, got, expected):
    """Whether two float tensors hold equal values, NaN where the other
    holds NaN (the payloads of NaN aside; -0 equals +0)"""
    nan = got.isnan()
    return (got.shape == expected.shape
            and torch.equal(nan, expected.isnan())
            and torch.equal(got.masked_fill(nan, 0.),
                            expected.masked_fill(nan, 0.)))


def maxplus_operands(torch, states, layout, device, seed):
    """(a, b) of a (max, +) product at ``states``: 'batched' (3, S, S) by
    (3, S, S); 'broadcast' by one (S, S) (batch stride 0); 'strided' every
    other matrix of a stack, as the scan takes them; 'neg_inf' with -inf
    rows of a, -inf columns of b and the time-sharded code's identity;
    'nan' with +inf entries of a meeting -inf of b, and a NaN"""
    generator = torch.Generator(device='cpu').manual_seed(seed + states)
    a = torch.randn((3, states, states), generator=generator) * 10
    b = torch.randn((3, states, states), generator=generator) * 10
    if layout == 'broadcast':
        b = b[1:2]
    elif layout == 'strided':
        stack = torch.randn((7, states, states), generator=generator) * 10
        return stack.to(device)[0:-1:2], stack.to(device)[1::2]
    elif layout == 'neg_inf':
        a[0, 0, :] = -np.inf
        a[1, :, states // 2] = -np.inf
        b[0, :, 0] = -np.inf
        b[2] = -np.inf
        b[2].fill_diagonal_(0.)
    elif layout == 'nan':
        a[0, :, 0] = np.inf
        b[0, 0, :] = -np.inf
        a[1, 0, 0] = np.nan
    return a.to(device), b.to(device)


def modes_phase(torch, device, card, headline, exact_path, reset_counts,
                read_counts):
    """The extra decode modes on the card, the counters reset just before
    and read just after each path:

    - K8 (``csrc/maxplus.cu``) bitwise against its plain version on the
      edge shapes (MAXPLUS_EDGES states in every layout of
      ``maxplus_operands``, rectangular operands broadcast both ways, a
      batch past the grid's 65,535, a 1440-state product), and on every
      launch of one time-sharded decode at 1 x MODES_FRAMES x MODES_STATES;
    - the time-sharded route (``backend='timesharded'`` through
      ``from_probabilities``, over a one-rank NCCL process group) and the
      associative route (``viterbi_decode_scan``: K8, then K3) at that
      shape: each bitwise the same route with the plain versions on the
      card, timed beside the exact kernel route (K2, K3) at that shape,
      and at 1 x MODES_CPU_FRAMES bitwise the port's CPU result;
    - ``backend='lse'`` at the headline (512 x 512 x 1440 pitch): K3
      bitwise ``backtrace_reference`` on its posteriors, the same paths
      under ``torch.set_float32_matmul_precision('high')``, its first
      LSE_CPU_ROWS rows the port's CPU paths, its RPA against the exact
      path, and its time split into the products, the other torch ops and
      K3.

    ``headline`` is (observation, transition, initial, batch_frames) of the
    headline on the card and ``exact_path`` its exact path. Returns (K8's
    kernels-line entry, the time-sharded path's counts, the lse path's
    counts)."""
    import torch.distributed as dist

    import torbi_tpu_torch
    from torbi_tpu_torch.ops import associative, backtrace, dispatch, lse
    from torbi_tpu_torch.scripts.modes_timing import (
        free_port, product_work, share)

    # K8 on the edge shapes
    checked = 0
    for states in MAXPLUS_EDGES:
        for layout in MAXPLUS_LAYOUTS:
            a, b = maxplus_operands(torch, states, layout, device, 80)
            if not same_bits(torch, associative.maxplus_matmul(a, b),
                             associative.maxplus_matmul_reference(a, b)):
                fail(f'K8 maxplus_matmul differs from its plain version at '
                     f'{states} states, {layout} (tolerance: bitwise)')
            checked += 1
    generator = torch.Generator(device='cpu').manual_seed(81)
    for a_shape, b_shape in (((2, 1, 7, 11), (3, 11, 5)),
                             ((70000, 2, 3), (70000, 3, 2)),
                             ((1440, 1440), (1440, 1440))):
        a = (torch.randn(a_shape, generator=generator) * 10).to(device)
        b = (torch.randn(b_shape, generator=generator) * 10).to(device)
        got = associative.maxplus_matmul(a, b)
        expected, plain_ms = cuda_once(
            torch, lambda: associative.maxplus_matmul_reference(a, b))
        if not same_bits(torch, got, expected):
            fail(f'K8 maxplus_matmul differs from its plain version at '
                 f'{a_shape} by {b_shape} (tolerance: bitwise)')
        checked += 1
        if a_shape == (1440, 1440):
            big_a, big_b, plain_1440 = a, b, plain_ms
    del a, b, got, expected
    ms_1440 = cuda_ms(
        torch, lambda: associative.maxplus_matmul(big_a, big_b), iters=5)
    bound_1440 = bound_ms(*product_work(big_a, big_b))
    plan_1440 = associative.maxplus_plan(
        1, 1440, 1440, 1440, 0, 1440, 0, 1440,
        sms=torch.cuda.get_device_properties(device).multi_processor_count)
    info(f'K8 maxplus_matmul: {checked} edge shapes bitwise equal to its '
         f'plain version (tolerance: bitwise; NaN where it holds NaN); 1440 '
         f'x 1440 x 1440: {ms_1440:.4f} ms (CUDA events, mean of 5), bound '
         f'{bound_1440[0]:.4f} ({bound_1440[1]}), plain {plain_1440:.1f} ms; '
         f'{plan_1440["items"]} tiles of {plan_1440["rows"]} x '
         f'{plan_1440["cols"]} on {plan_1440["grid"]} CTAs')
    del big_a, big_b

    # One sequence at the small-state regime of the associative modes
    rng = np.random.default_rng(31)
    frames, states = MODES_FRAMES, MODES_STATES
    obs_host = np.log(rng.dirichlet(
        np.full(states, 0.3), size=frames).astype(np.float32) + TINY)
    trans_host = np.log(rng.dirichlet(
        np.ones(states), size=states).astype(np.float32) + TINY)
    init_host = np.log(np.full(states, 1.0 / states, np.float32) + TINY)
    obs = torch.from_numpy(obs_host).to(device)
    trans = torch.from_numpy(trans_host).to(device)
    init = torch.from_numpy(init_host).to(device)
    shape = f'1 x {frames} x {states}'

    def decode(observation, **kwargs):
        return torbi_tpu_torch.from_probabilities(
            observation[None], transition=trans, initial=init,
            log_probs=True, gpu=0, **kwargs)[0]

    # The routes with the plain versions: every K8 launch also held
    # against its plain version, whose result goes on
    real_maxplus = associative.maxplus_matmul
    real_backtrace = associative.backtrace_posteriors
    held = {'launches': 0}

    def held_maxplus(a, b):
        got = real_maxplus(a, b)
        expected = associative.maxplus_matmul_reference(a, b)
        if not same_bits(torch, got, expected):
            fail(f'K8 maxplus_matmul differs from its plain version on a '
                 f'launch of the time-sharded route at {shape}, operands '
                 f'{tuple(a.shape)} by {tuple(b.shape)} (tolerance: bitwise)')
        # An empty product launches nothing
        held['launches'] += bool(got.numel())
        return expected

    # While a wrapper stands in for K8, the kernel's own count goes to the
    # wrapper (it counts through its module's name): comparison and timing
    # launches do not count
    held_maxplus.launches = 0

    def plain_route(fn):
        associative.maxplus_matmul = held_maxplus
        associative.backtrace_posteriors = backtrace.backtrace_reference
        try:
            return fn()
        finally:
            associative.maxplus_matmul = real_maxplus
            associative.backtrace_posteriors = real_backtrace

    # K8's own time at the scan's first level (every other step matrix)
    steps = trans[None] + dispatch.convert(obs, True, True)[1:, :, None]
    first_a, first_b = steps[1::2], steps[0:-1:2]
    level_ms = cuda_ms(
        torch, lambda: associative.maxplus_matmul(first_a, first_b), iters=5)
    _, level_plain_ms = cuda_once(
        torch, lambda: associative.maxplus_matmul_reference(first_a, first_b))
    pairs = first_a.shape[0]
    level_bound = bound_ms(*product_work(first_a, first_b))
    del steps, first_a, first_b

    port = free_port()
    dist.init_process_group(
        'nccl', init_method=f'tcp://127.0.0.1:{port}', world_size=1, rank=0)
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats(device)
        ts_path = decode(obs, backend='timesharded')
        torch.cuda.synchronize()
        ts_counts = read_counts()
        ts_peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        others = {name: count for name, count in ts_counts.items()
                  if count and name != 'maxplus_matmul'}
        if ts_counts['maxplus_matmul'] < 1 or others:
            fail(f'the time-sharded path at {shape} launched {ts_counts}: '
                 'K8 and nothing else expected')
        ts_plain = plain_route(lambda: decode(obs, backend='timesharded'))
        if held['launches'] != ts_counts['maxplus_matmul']:
            fail(f'the time-sharded route held {held["launches"]} K8 '
                 'launches against the plain version, of '
                 f'{ts_counts["maxplus_matmul"]}')
        if not torch.equal(ts_path, ts_plain):
            fail(f'the time-sharded path at {shape} differs from the same '
                 'route with the plain versions on the card')
        ts_ms = host_ms(torch, lambda: decode(obs, backend='timesharded'),
                        calls=3)
        # K8's share of one call: CUDA events around each launch, beside
        # the bound of those launches
        ts_share = share(lambda: decode(obs, backend='timesharded'))
        ts_k8_ms, ts_k8_launches = ts_share['k8_ms'], ts_share['k8_launches']
        ts_k8_bound = bound_ms(ts_share['bytes'], ts_share['operations'])
        ts_short = decode(obs[:MODES_CPU_FRAMES], backend='timesharded')
    finally:
        dist.destroy_process_group()
    info(f'time-sharded path at {shape} (from_probabilities, one-rank NCCL '
         f'group): launches {ts_counts}; bitwise the same route with the '
         f'plain versions on the card, its {held["launches"]} K8 launches '
         f'each bitwise their plain version; {ts_ms[0]:.3f} ms/call warm '
         f'median of 3 (min {ts_ms[1]:.3f}, max {ts_ms[2]:.3f}), K8 '
         f'{ts_k8_ms:.3f} ms of it in {ts_k8_launches} launches (CUDA '
         f'events), their bound {ts_k8_bound[0]:.3f} ({ts_k8_bound[1]}), '
         f'peak device memory {ts_peak_gb:.2f} GB, on {card}')

    # The associative route: the scan, then K3
    def scan_route(observation):
        converted = dispatch.convert(observation, True, True).contiguous()
        return associative.viterbi_decode_scan(converted, trans, init)

    reset_counts()
    scan_path = scan_route(obs)
    torch.cuda.synchronize()
    scan_counts = read_counts()
    if (scan_counts['maxplus_matmul'] < 1 or scan_counts['backtrace'] != 1
            or sum(scan_counts.values()) != scan_counts['maxplus_matmul'] + 1):
        fail(f'the associative route at {shape} launched {scan_counts}: K8 '
             'and K3 expected')
    if not torch.equal(scan_path, plain_route(lambda: scan_route(obs))):
        fail(f'the associative route at {shape} differs from the same route '
             'with the plain versions on the card')
    scan_ms = host_ms(torch, lambda: scan_route(obs), calls=3)
    scan_share = share(lambda: scan_route(obs))
    scan_k8_ms = scan_share['k8_ms']
    scan_k8_launches = scan_share['k8_launches']
    scan_k8_bound = bound_ms(scan_share['bytes'], scan_share['operations'])
    scan_short = scan_route(obs[:MODES_CPU_FRAMES])

    # The exact kernel route at the same shape (K2, K3)
    reset_counts()
    exact = decode(obs)
    torch.cuda.synchronize()
    exact_counts = read_counts()
    exact_ms = host_ms(torch, lambda: decode(obs), calls=3)
    info(f'associative route at {shape} (viterbi_decode_scan): launches '
         f'{scan_counts}; bitwise the same route with the plain versions on '
         f'the card; {scan_ms[0]:.3f} ms/call warm median of 3, K8 '
         f'{scan_k8_ms:.3f} ms of it in {scan_k8_launches} launches (CUDA '
         f'events), their bound {scan_k8_bound[0]:.3f} ({scan_k8_bound[1]}); '
         f'the exact kernel route (launches {exact_counts}) '
         f'{exact_ms[0]:.3f} ms/call; '
         f'frames where the time-sharded path differs from the exact one: '
         f'{int((ts_path != exact).sum())}, the associative path: '
         f'{int((scan_path != exact).sum())} (of {frames})')

    # At 1 x MODES_CPU_FRAMES against the port's CPU result
    short_host = obs_host[:MODES_CPU_FRAMES]
    start = time.perf_counter()
    ts_cpu = torbi_tpu_torch.from_probabilities(
        short_host[None], transition=trans_host, initial=init_host,
        log_probs=True, gpu='cpu', backend='timesharded')[0]
    converted = dispatch.convert(
        torch.from_numpy(short_host), True, True).contiguous()
    scan_cpu = associative.viterbi_decode_scan(
        converted, torch.from_numpy(trans_host), torch.from_numpy(init_host))
    cpu_s = time.perf_counter() - start
    if not torch.equal(ts_short.cpu(), ts_cpu):
        fail(f'the time-sharded path at 1 x {MODES_CPU_FRAMES} x {states} '
             'differs from the port\'s CPU result')
    if not torch.equal(scan_short.cpu(), scan_cpu):
        fail(f'the associative path at 1 x {MODES_CPU_FRAMES} x {states} '
             'differs from the port\'s CPU result')
    info(f'time-sharded and associative paths at 1 x {MODES_CPU_FRAMES} x '
         f'{states}: bitwise the port\'s CPU results ({cpu_s:.1f} s on the '
         'CPU)')
    del obs, ts_path, scan_path, exact

    # backend='lse' at the headline
    h_obs, h_trans, h_init, h_bf = headline
    beta = float(torbi_tpu_torch.LSE_BETA)

    def lse_call(observation=h_obs, **kwargs):
        return torbi_tpu_torch.from_probabilities(
            observation, transition=h_trans, initial=h_init, log_probs=True,
            backend='lse', **{'gpu': 0, **kwargs})

    reset_counts()
    lse_path = lse_call()
    torch.cuda.synchronize()
    lse_counts = read_counts()
    if lse_counts['backtrace'] != 1 or sum(lse_counts.values()) != 1:
        fail(f'the lse path launched {lse_counts}: K3 once expected')
    lse_ms = host_ms(torch, lse_call, calls=3)
    converted = dispatch.convert(h_obs, True, True).contiguous()
    (posts, posterior), forward_ms = cuda_once(
        torch, lambda: lse.forward_lse(converted, h_bf, h_trans, h_init, beta))
    k3 = backtrace.backtrace_posteriors(posts, h_trans, posterior, h_bf)
    k3_plain, k3_plain_ms = cuda_once(
        torch, lambda: backtrace.backtrace_reference(
            posts, h_trans, posterior, h_bf))
    if not torch.equal(k3, k3_plain):
        fail('K3 on the lse posteriors differs from its plain version '
             '(tolerance: bitwise)')
    if not torch.equal(k3, lse_path):
        fail('the lse path differs from K3 on its own forward pass')
    k3_ms = cuda_ms(torch, lambda: backtrace.backtrace_posteriors(
        posts, h_trans, posterior, h_bf), iters=5)
    del posts, posterior, converted
    u = torch.rand((BATCH, STATES), device=device)
    exp_t = torch.rand((STATES, STATES), device=device).T
    with lse._highest_precision():
        products_ms = cuda_ms(torch, lambda: [
            torch.matmul(u, exp_t) for _ in range(FRAMES - 1)], iters=1)
    del u, exp_t
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('high')
    try:
        high = lse_call()
    finally:
        torch.set_float32_matmul_precision(saved)
    if not torch.equal(high, lse_path):
        fail("the lse path changes under set_float32_matmul_precision('high')")
    rows = lse_call(h_obs[:LSE_CPU_ROWS])
    rows_cpu = lse_call(h_obs[:LSE_CPU_ROWS].cpu(), gpu='cpu')
    if not torch.equal(rows.cpu(), rows_cpu):
        fail(f'the lse paths of rows 0-{LSE_CPU_ROWS - 1} differ from the '
             f'port\'s CPU lse paths in {int((rows.cpu() != rows_cpu).sum())} '
             'positions')
    err = (lse_path.long() - exact_path.long()).abs()
    rpa = [float((err <= bins).double().mean()) for bins in (0, 1, 2)]
    # 511 products of (512 x 1440) (1440 x 1440) at 2 FLOP a term
    flops = 2 * BATCH * STATES * STATES * (FRAMES - 1)
    info(f'lse path at {BATCH} x {FRAMES} x {STATES} (beta {beta}): '
         f'launches {lse_counts}; {lse_ms[0]:.3f} ms/call warm median of 3 '
         f'(min {lse_ms[1]:.3f}, max {lse_ms[2]:.3f}), on {card}; forward '
         f'{forward_ms:.3f} ms (CUDA events), of it the {FRAMES - 1} '
         f'products {products_ms:.3f} ({flops / products_ms / 1e9:.1f} '
         f'TFLOP/s), the other torch ops {forward_ms - products_ms:.3f}; K3 '
         f'{k3_ms:.3f} (plain {k3_plain_ms:.1f}), bitwise its plain version '
         f'on the lse posteriors; unchanged under precision \'high\'; rows '
         f'0-{LSE_CPU_ROWS - 1} equal the CPU lse paths; RPA@0/1/2 against '
         f'the exact path ' + '/'.join(f'{value:.6f}' for value in rpa))

    entry = dict(
        name='maxplus_matmul', route='cuda',
        source='torbi_tpu_torch/csrc/maxplus.cu',
        replaces='torbi_tpu/ops/associative.py:25', path='timesharded',
        max_abs_err=0.0, ms=level_ms, plain_ms=level_plain_ms,
        bound=level_bound, library_ms=None,
        library='none: no PyTorch call computes (max, +); the broadcast '
                'form materialises S^3',
        shape=f'{pairs} x {states} x {states} x {states} (the scan\'s first '
              f'level at {shape})',
        ms_1440=ms_1440, bound_ms_1440=bound_1440[0], plain_ms_1440=plain_1440,
        route_k8_ms=ts_k8_ms, route_k8_bound_ms=ts_k8_bound[0],
        route_ms=ts_ms[0], scan_route_ms=scan_ms[0],
        scan_route_k8_ms=scan_k8_ms, scan_route_k8_bound_ms=scan_k8_bound[0],
        exact_route_ms=exact_ms[0], held_launches=held['launches'],
        lse_ms=lse_ms[0], lse_forward_ms=forward_ms,
        lse_products_ms=products_ms, lse_k3_ms=k3_ms, lse_rpa=rpa)
    info(f'K8 at the scan\'s first level ({entry["shape"]}): {level_ms:.4f} '
         f'ms (CUDA events, mean of 5), bound {level_bound[0]:.4f} '
         f'({level_bound[1]}), plain {level_plain_ms:.1f} ms')
    return entry, ts_counts, lse_counts


def decode_counters():
    """The launch counters of the decode kernels (the wrappers themselves)"""
    from torbi_tpu_torch.ops import (
        associative, backtrace, band, constant, dense, sparse)

    return {
        'band_forward': band.viterbi_forward_band,
        'band_forward_wide': band.viterbi_forward_band_wide,
        'band_spread': band.viterbi_forward_band_spread,
        'dense_forward': dense.viterbi_forward_dense,
        'backtrace': backtrace.backtrace_posteriors,
        'backtrace_pointers': backtrace.backtrace_pointers,
        'chase_pointers': backtrace.chase_pointers,
        'backtrace_window': backtrace.backtrace_window,
        'constant_recurrence': constant.recurrence,
        'maxplus_matmul': associative.maxplus_matmul,
        'sparse_forward': sparse.viterbi_forward_sparse,
        'sparse_backtrace': sparse.backtrace_sparse,
    }


def mps_running():
    """Whether a CUDA MPS control or server process runs on this machine
    (ranks under MPS share the SMs; without it they time-slice the card)"""
    for comm in Path('/proc').glob('*/comm'):
        try:
            if comm.read_text().startswith('nvidia-cuda-mps'):
                return True
        except OSError:
            continue
    return False


def scaleout_rank(rank, world, port, workdir):
    """One rank of ``scaleout_phase``'s gloo world, a process of its own on
    the device that ``workdir/spec.json`` names: the headline split (whole
    and uneven) and the dense split through ``decode_sharded``, the file
    split and the evaluation split, each with this rank's launch counters
    and calls of the plain versions set to 0 just before and read just
    after. It makes its inputs from the seeds and writes its gathered
    paths (``.npy``) and a JSON summary into ``workdir``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    import torbi_tpu_torch
    from torbi_tpu_torch.data import native
    from torbi_tpu_torch.evaluate import core
    from torbi_tpu_torch.models import pitch
    from torbi_tpu_torch.ops import backtrace, band, dense, dispatch
    from torbi_tpu_torch.parallel import decode_sharded, files
    from torbi_tpu_torch.parallel.sharded import slice_rows
    from torbi_tpu_torch.scripts import eval_synth

    workdir = Path(workdir)
    spec = json.loads((workdir / 'spec.json').read_text())
    device = torch.device(spec['device'])
    cuda = device.type == 'cuda'
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group(
        'gloo', init_method=f'tcp://127.0.0.1:{port}', world_size=world,
        rank=rank)

    def say(message):
        print(f'[smoke rank {rank}] {message}', flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    counters = decode_counters()
    # The plain versions the wrappers of K1, K2 and K3 fall back to on CPU
    # tensors, counted where they are looked up
    plain_calls = {}
    for module, name in ((band, 'band_forward_reference'),
                         (dense, 'dense_forward_reference'),
                         (backtrace, 'backtrace_reference')):
        def counted(*args, _real=getattr(module, name), _name=name,
                    **kwargs):
            plain_calls[_name] += 1
            return _real(*args, **kwargs)

        plain_calls[name] = 0
        setattr(module, name, counted)

    def run(label, fn):
        for counter in counters.values():
            counter.launches = 0
        plain_calls.update(dict.fromkeys(plain_calls, 0))
        sync()
        out = fn()
        sync()
        launches = {name: counter.launches
                    for name, counter in counters.items()}
        say(f'{label}: launches {launches}, plain versions {plain_calls}')
        return out, {'launches': launches, 'plain': dict(plain_calls)}

    try:
        summary = {'rank': rank}
        batch, frames, states = spec['headline']
        start, stop = slice_rows(batch, world, rank)
        # What the main path hands the kernels: the epsilon step applied
        obs = dispatch.convert(torch.from_numpy(
            pitch.synthetic_posteriorgrams(batch, frames, states)).to(device),
            True, True).contiguous()
        trans = torch.from_numpy(np.log(
            pitch.transition_matrix() + TINY).astype(np.float32)).to(device)
        init = torch.from_numpy(np.log(
            np.full(states, 1.0 / states, np.float32) + TINY)).to(device)
        bf = torch.full((batch,), frames, dtype=torch.int32, device=device)

        def headline(rows=batch):
            return decode_sharded(obs[:rows], bf[:rows], trans, init,
                                  finite_observation=True, device=device)

        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        path, summary['headline'] = run(
            f'headline split, rows {start}-{stop} of {batch}', headline)
        np.save(workdir / f'headline_rank{rank}.npy', path.cpu().numpy())
        times = []
        for _ in range(5):
            dist.barrier()
            sync()
            begin = time.perf_counter()
            headline()
            sync()
            times.append((time.perf_counter() - begin) * 1e3)
        summary['headline']['ms'] = statistics.median(times)
        if cuda:
            width = band.detect_band(trans)[1]
            resident = {
                size: band.resident_clusters(states, width, size, device)
                for size in band.cluster_sizes(states, width)}
            summary['headline'].update(
                plan=band.cluster_plan(stop - start, states, width,
                                       resident.get),
                peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
        uneven = spec['uneven']
        path, summary['uneven'] = run(
            f'headline split, {uneven} rows (uneven)',
            lambda: headline(uneven))
        np.save(workdir / f'uneven_rank{rank}.npy', path.cpu().numpy())
        del obs, path

        # The dense batch of the main process, from its seed
        rng = np.random.default_rng(1)
        dense_batch, dense_frames = spec['dense']
        dense_obs = dispatch.convert(torch.from_numpy(np.log(
            rng.dirichlet(np.ones(states), size=(dense_batch, dense_frames))
            .astype(np.float32) + TINY).astype(np.float32)).to(device),
            True, True).contiguous()
        dense_trans = torch.from_numpy(np.log(
            rng.dirichlet(np.ones(states), size=states).astype(np.float32)
            + TINY).astype(np.float32)).to(device)
        dense_bf = torch.tensor(
            [dense_frames] * (dense_batch - 2) + [dense_frames // 2, 1],
            dtype=torch.int32, device=device)
        path, summary['dense'] = run(
            f'dense split, {dense_batch} x {dense_frames} x {states}',
            lambda: decode_sharded(dense_obs, dense_bf, dense_trans, init,
                                   finite_observation=True, device=device))
        np.save(workdir / f'dense_rank{rank}.npy', path.cpu().numpy())

        native.counts.update(filled=0, fallback=0)
        _, summary['files'] = run(
            f'file split, {len(spec["files"])} files',
            lambda: files.from_files_to_files(
                spec['files'], spec['files_split'],
                transition_file=spec['files_transition'], log_probs=True,
                gpu=spec['gpu']))
        summary['files'].update(
            share=files.shard_files_balanced(
                spec['files'], spec['files_split'])[0],
            native=dict(native.counts))

        eval_synth.configure(Path(spec['eval_workdir']), spec['eval_config'],
                             [spec['eval_dataset']], spec['eval_files'])
        writes = []
        real_write = core._write

        def write(results):
            writes.append(1)
            real_write(results)

        core._write = write
        results, summary['evaluation'] = run(
            f'evaluation split, {spec["eval_dataset"]}',
            lambda: torbi_tpu_torch.evaluate.datasets(
                [spec['eval_dataset']], gpu=spec['gpu'], num_threads=1))
        summary['evaluation'].update(results=results, writes=len(writes))
        (workdir / f'rank{rank}.json').write_text(json.dumps(summary))
    finally:
        dist.destroy_process_group()


def scaleout_phase(torch, device, card, headline, exact_path, dense_path,
                   eval_single, reset_counts, read_counts):
    """The batch scale-out on one card (``parallel``): a gloo world of
    SCALEOUT_RANKS rank processes sharing ``device`` (NCCL takes no two
    ranks of one device), each a ``python chip_smoke.py --scaleout-rank``
    that makes its inputs from the seeds (``scaleout_rank``):

    1. the headline through ``decode_sharded`` (256 rows a rank: K1's
       cluster design, then K3) and SCALEOUT_UNEVEN rows (uneven), each
       rank's gathered path bitwise ``exact_path``, this process's
       headline path (its first rows), each rank launching K1 and K3 and no
       plain version;
    2. the dense batch of ``dense_path`` (K2 and K3 in each rank, K2's
       cooperative launch under two contexts), bitwise;
    3. ``parallel.files.from_files_to_files`` on file_path_phase's corpus
       (regenerated): the shares disjoint, covering the corpus, equal to
       ``shard_files_balanced``'s partition, every output bitwise this
       process's ``from_files_to_files``, each rank's native loader filling
       every batch with no fallback;
    4. the evaluation harness over both ranks on evaluation_phase's
       SCALEOUT_DATASET corpus: the aggregated RPA and frames equal
       ``eval_single``'s, the results file written once, by rank 0.

    Then a world of one over NCCL in this process (the gather on the
    card), bitwise ``exact_path``, and ``scripts.scaling --mode overhead``
    with one and two ranks at BATCH x FRAMES x STATES pitch. Returns each
    rank's launches of K1, K2 and K3 per part. ``device`` is the card (or,
    to rehearse the phase's logic, the CPU, with gloo for the world of
    one)."""
    import torch.distributed as dist

    import torbi_tpu_torch
    from torbi_tpu_torch.models import pitch
    from torbi_tpu_torch.ops import dispatch
    from torbi_tpu_torch.parallel import decode_sharded, files
    from torbi_tpu_torch.scripts.modes_timing import free_port, run_ranks

    cuda = device.type == 'cuda'
    gpu = None if cuda else 'cpu'

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        # The ranks share the card with this process's cached blocks
        torch.cuda.empty_cache()
    workdir = ROOT / 'build' / 'smoke_scaleout'
    shutil.rmtree(workdir, ignore_errors=True)
    (workdir / 'files').mkdir(parents=True)
    lengths = np.random.default_rng(FILE_SEED).integers(
        400, 1600, size=FILE_COUNT)
    inputs, outputs, trans_path = pitch.write_corpus(
        str(workdir / 'files'), lengths, STATES)
    split = [path.replace('_out', '_split') for path in outputs]
    torbi_tpu_torch.from_files_to_files(
        inputs, outputs, transition_file=trans_path, log_probs=True,
        gpu=device)
    eval_config = 'synth-smoke-scaleout'
    eval_dir = ROOT / 'build' / 'smoke_eval' / 'eval'
    (eval_dir / f'{eval_config}.json').unlink(missing_ok=True)
    obs, trans, init, bf = headline
    spec = {
        'device': str(device), 'gpu': gpu,
        'headline': [int(obs.shape[0]), int(obs.shape[1]), STATES],
        'uneven': SCALEOUT_UNEVEN, 'dense': [DENSE_BATCH, DENSE_FRAMES],
        'files': inputs, 'files_split': split, 'files_transition': trans_path,
        'eval_workdir': str(ROOT / 'build' / 'smoke_eval'),
        'eval_config': eval_config, 'eval_dataset': SCALEOUT_DATASET,
        'eval_files': EVAL_FILES}
    (workdir / 'spec.json').write_text(json.dumps(spec))
    info(f'scale-out: MPS {"on" if mps_running() else "off"}; '
         f'{SCALEOUT_RANKS} rank processes on {device} in a gloo world')

    begin = time.perf_counter()
    try:
        texts = run_ranks(
            lambda rank, port: [
                sys.executable, str(Path(__file__).resolve()),
                '--scaleout-rank', str(rank), str(SCALEOUT_RANKS), str(port),
                str(workdir)],
            SCALEOUT_RANKS, SCALEOUT_TIMEOUT,
            env=dict(GLOO_SOCKET_IFNAME='lo'), cwd=ROOT)
    except RuntimeError as error:
        fail(f'scale-out ranks failed: {error}')
    for text in texts:
        for line in text.splitlines():
            if line.startswith('[smoke rank'):
                print(line, flush=True)
    ranks = [json.loads((workdir / f'rank{rank}.json').read_text())
             for rank in range(SCALEOUT_RANKS)]
    info(f'scale-out: the {SCALEOUT_RANKS} ranks ran in '
         f'{time.perf_counter() - begin:.1f} s')

    def require_kernels(part, names, absent=()):
        for rank, summary in enumerate(ranks):
            launches = summary[part]['launches']
            plain = summary[part]['plain']
            if cuda and (any(launches[name] < 1 for name in names)
                         or any(launches[name] for name in absent)
                         or any(plain.values())):
                fail(f'scale-out {part}, rank {rank}: launches {launches}, '
                     f'plain versions {plain}; expected {names} launched, '
                     f'{list(absent)} not, and no plain version')

    def require_path(part, expected):
        for rank in range(SCALEOUT_RANKS):
            got = np.load(workdir / f'{part}_rank{rank}.npy')
            if got.dtype != np.int32 or not np.array_equal(got, expected):
                fail(f'scale-out {part}, rank {rank}: the gathered path '
                     'differs from the single-process path (tolerance: '
                     'bitwise)')

    exact = exact_path.cpu().numpy()
    require_path('headline', exact)
    require_path('uneven', exact[:SCALEOUT_UNEVEN])
    require_kernels('headline', ('band_forward', 'backtrace'),
                    ('band_forward_wide', 'dense_forward'))
    require_kernels('uneven', ('band_forward', 'backtrace'),
                    ('band_forward_wide', 'dense_forward'))
    for summary in ranks:
        part = summary['headline']
        info(f'scale-out headline, rank {summary["rank"]}: K1 plan '
             f'{part.get("plan")}, {part["ms"]:.3f} ms/call (decode_sharded,'
             f' host clock, warm median of 5, both ranks on one card), peak '
             f'device memory {part.get("peak_gb", 0.0):.2f} GB, on {card}')
    info(f'scale-out headline: every rank\'s gathered path bitwise the '
         f'single-process path, whole and at {SCALEOUT_UNEVEN} rows; K1 '
         '(cluster design) and K3 in each rank, no plain version')
    require_path('dense', dense_path.cpu().numpy())
    require_kernels('dense', ('dense_forward', 'backtrace'),
                    ('band_forward',))
    info('scale-out dense: bitwise the single-process path; K2 and K3 in '
         'each rank')

    shares = [summary['files']['share'] for summary in ranks]
    if sorted(sum(shares, [])) != sorted(inputs):
        fail('scale-out files: the shares are not a partition of the corpus')
    for rank, share in enumerate(shares):
        if share != files.shard_files_balanced(
                inputs, split, rank, SCALEOUT_RANKS)[0]:
            fail(f'scale-out files, rank {rank}: its share is not '
                 'shard_files_balanced\'s')
        native = ranks[rank]['files']['native']
        if native['fallback'] or native['filled'] < 1:
            fail(f'scale-out files, rank {rank}: the native loader filled '
                 f'{native}')
    for out, single in zip(split, outputs):
        got, want = np.load(out), np.load(single)
        if got.dtype != np.int32 or not np.array_equal(got, want):
            fail(f'scale-out files: {Path(out).name} differs from the '
                 'single-process output')
    require_kernels('files', ('band_forward', 'backtrace'))
    info(f'scale-out files: shares of {[len(s) for s in shares]} files, '
         f'disjoint, the whole corpus, shard_files_balanced\'s partition; '
         f'{len(split)} outputs bitwise the single-process ones; native '
         f'batches {[summary["files"]["native"] for summary in ranks]}')

    want = eval_single[SCALEOUT_DATASET]
    for rank, summary in enumerate(ranks):
        got = summary['evaluation']['results'][SCALEOUT_DATASET]
        if got['rpa'] != want['rpa'] or got['frames'] != want['frames']:
            fail(f'scale-out evaluation, rank {rank}: RPA {got["rpa"]} over '
                 f'{got["frames"]} frames, single process {want["rpa"]} over '
                 f'{want["frames"]}')
    writes = [summary['evaluation']['writes'] for summary in ranks]
    written = json.loads((eval_dir / f'{eval_config}.json').read_text())
    if writes != [1] + [0] * (SCALEOUT_RANKS - 1) or (
            written != ranks[0]['evaluation']['results']):
        fail(f'scale-out evaluation: results written {writes} times by '
             'rank, or the file differs from the results')
    require_kernels('evaluation', ('band_forward', 'backtrace'))
    rtf = ranks[0]['evaluation']['results'][SCALEOUT_DATASET]['rtf']
    info(f'scale-out evaluation ({SCALEOUT_DATASET}, {EVAL_FILES} files): '
         f'RPA and {want["frames"]} frames equal the single-process run\'s; '
         f'written once, by rank 0; RTF by context (the slowest rank) '
         f'{rtf}')

    # A world of one over NCCL: the gather on the card
    obs_k = dispatch.convert(obs, True, True).contiguous()
    dist.init_process_group(
        'nccl' if cuda else 'gloo',
        init_method=f'tcp://127.0.0.1:{free_port()}', world_size=1, rank=0)
    try:
        def one():
            return decode_sharded(obs_k, bf, trans, init,
                                  finite_observation=True, device=device)

        reset_counts()
        path = one()
        sync()
        counts = read_counts()
        one_ms = host_ms(torch, one, calls=5) if cuda else None
    finally:
        dist.destroy_process_group()
    del obs_k
    if not torch.equal(path, exact_path):
        fail('scale-out world of one: the path differs from the '
             'single-process path')
    if cuda and (counts['band_forward'] < 1 or counts['backtrace'] < 1):
        fail(f'scale-out world of one launched {counts}')
    info(f'scale-out world of one ({dist.Backend.NCCL if cuda else "gloo"}):'
         f' bitwise the single-process path, launches {counts}'
         + (f', {one_ms[0]:.3f} ms/call warm median of 5' if cuda else ''))

    # The scaling script, overhead mode, one and two ranks on the card
    begin = time.perf_counter()
    scaling = subprocess.run(
        [sys.executable, '-m', 'torbi_tpu_torch.scripts.scaling', '--mode',
         'overhead', '--ranks', f'1,{SCALEOUT_RANKS}', '--rows-per-device',
         str(int(obs.shape[0]) // SCALEOUT_RANKS), '--frames',
         str(int(obs.shape[1])), '--states', str(STATES), '--iters', '3',
         '--output', str(workdir / 'scaling.json')]
        + ([] if cuda else ['--gpu', 'cpu']),
        capture_output=True, text=True, timeout=SCALEOUT_TIMEOUT, cwd=ROOT)
    if scaling.returncode:
        fail(f'scripts.scaling failed: {scaling.stdout[-2000:]}'
             f'{scaling.stderr[-3000:]}')
    artifact = json.loads(scaling.stdout.strip().splitlines()[-1])
    single, row = artifact['scales'][0], artifact['scales'][-1]
    info(f'scaling --mode overhead at {row["batch"]} x {artifact["frames"]} '
         f'x {artifact["states"]} pitch ({time.perf_counter() - begin:.1f} '
         f's): one process {single["seconds_per_call"] * 1e3:.3f} ms/call '
         f'({single["rows_per_device_seconds"] * 1e3:.3f} for one rank\'s '
         f'{artifact["rows_per_device"]} rows alone), '
         f'{row["ranks"]} ranks ({row["backend"]}, one card) '
         f'{row["seconds_per_call"] * 1e3:.3f} ms/call (ranks '
         f'{row["ms"]} ms; their slices alone {row["decode_ms"]}, the gather '
         f'alone {row["gather_ms"]}), work_overhead '
         f'{row["work_overhead"]:.4f}, projected_efficiency '
         f'{row["projected_efficiency"]:.4f}; on {artifact["card"] or card}; '
         f'{artifact["note"]}')
    return {name: {part: [summary[part]['launches'][name]
                          for summary in ranks]
                   for part in ('headline', 'uneven', 'dense', 'files',
                                'evaluation')}
            for name in ('band_forward', 'dense_forward', 'backtrace')}


def pyin_phase(torch, device, card, reset_counts, read_counts):
    """pYIN's HMM (``models/pyin.py``, 1202 states, no band) on the dense
    route at the ``pyin-b512-sorted`` cell's longest batch: 512 rows of
    its last sorted lengths (up to 861 frames) of the cell's generated
    probabilities (``benchmark/pyin.py``, seed PYIN_SEED). K2 on its
    padded sources (the states are not a multiple of 4: the padded
    transition and the exchange, one ``padded_launches`` a call) held
    bitwise against
    ``dense_forward_reference`` (in sub-batches), K3 on its output against
    ``backtrace_reference`` and the paths against the benchmark's plain
    reference decode; the path through ``from_probabilities(...,
    log_probs=False)`` equal to them, with its launches and the
    conversion's counters. Prints K2's plan and times the conversion, K2
    and K3 in turns. Returns a dict of the timings"""
    from benchmark import inputs, pyin as pyin_inputs
    from benchmark.reference import viterbi as reference_viterbi
    from torbi_tpu_torch.models import pyin
    from torbi_tpu_torch.ops import backtrace, dense, dispatch

    import torbi_tpu_torch

    traffic = json.loads(
        (ROOT / 'benchmark' / 'traffic' / 'pyin-sorted-pool4096.json')
        .read_text())
    lengths = inputs.lengths(
        traffic['pool'], **traffic['lengths'])[-PYIN_ROWS:]
    states = pyin.STATES
    probs = pyin_inputs.observations(
        lengths, pyin.PITCH_BINS, traffic,
        inputs.device_generator(PYIN_SEED, device), device)
    bf = torch.tensor(lengths, dtype=torch.int32, device=device)
    trans_p = torch.from_numpy(pyin.transition_matrix()).to(device)
    init_p = torch.from_numpy(pyin.initial()).to(device)
    trans, init = torch.log(trans_p), torch.log(init_p)
    obs_k = dispatch.convert(probs, False, True).contiguous()
    frames = max(lengths)
    info(f'pyin: {PYIN_ROWS} rows of {min(lengths)}-{frames} frames x '
         f'{states} states ({sum(lengths)} real frames), '
         f'{int((trans_p > 0).sum())} positive pairs')

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = dense.dense_plan(PYIN_ROWS, states, sms)
    info(f'pyin: K2 plan at {PYIN_ROWS} x {states}: {plan}')
    if plan is None:
        fail(f'pyin: no K2 plan at {states} states')
    k2_wrapper = dense.viterbi_forward_dense
    padded = k2_wrapper.padded_launches
    post_seq, posterior = dense.viterbi_forward_dense(obs_k, bf, trans, init)
    torch.cuda.synchronize()
    if k2_wrapper.padded_launches - padded != 1:
        fail(f'pyin: K2 staged through the padded exchange '
             f'{k2_wrapper.padded_launches - padded} times, expected once')
    for start in range(0, PYIN_ROWS, DENSE_SUB):
        rows = slice(start, start + DENSE_SUB)
        want, _ = dense.dense_forward_reference(
            obs_k[rows], bf[rows], trans, init)
        require_equal(torch, f'pyin K2 rows {start}-{start + DENSE_SUB - 1}',
                      post_seq[rows], want)
        del want
    indices = backtrace.backtrace_posteriors(post_seq, trans, posterior, bf)
    require_equal(torch, 'pyin K3', indices, backtrace.backtrace_reference(
        post_seq, trans, posterior, bf))
    paths = reference_viterbi.decode_blocks(
        [obs_k[row] for row in range(PYIN_ROWS)], lengths, trans, init)
    for row, path in enumerate(paths):
        if not torch.equal(indices[row, :lengths[row]].long(), path):
            fail(f'pyin: row {row} of K3 differs from the plain reference '
                 'decode')
    info(f'pyin: K3 paths equal the plain reference decode on all '
         f'{PYIN_ROWS} rows')

    values = dispatch.convert.values
    reasons = dict(dispatch.decode.dense_reasons)
    reset_counts()
    padded = k2_wrapper.padded_launches

    def call():
        return torbi_tpu_torch.from_probabilities(
            probs, bf, trans_p, init_p, log_probs=False, gpu=device)

    decoded = call()
    torch.cuda.synchronize()
    counts = read_counts()
    padded_launches = k2_wrapper.padded_launches - padded
    if not torch.equal(decoded, indices):
        fail('pyin: from_probabilities differs from K2 then K3')
    if padded_launches != 1:
        fail(f'pyin: from_probabilities staged K2 through the padded '
             f'exchange {padded_launches} times, expected once')
    if (counts['dense_forward'], counts['backtrace']) != (1, 1) or any(
            count for name, count in counts.items()
            if name not in ('dense_forward', 'backtrace')):
        fail(f'pyin: from_probabilities launched {counts}')
    converted = dispatch.convert.values - values
    after = dict(dispatch.decode.dense_reasons)
    if converted != probs.numel() or after != dict(
            reasons, width=reasons['width'] + 1):
        fail(f'pyin: convert.values +{converted} (expected '
             f'{probs.numel()}), dense_reasons {reasons} -> {after}')
    info(f'pyin: from_probabilities(..., log_probs=False) equals K2 then '
         f'K3, launches {counts}, padded_launches +{padded_launches}, '
         f'convert.values +{converted}, dense_reasons width +1')

    # The conversion, K2 and K3 in turns, then the whole call
    def k2():
        return dense.viterbi_forward_dense(obs_k, bf, trans, init)

    def k3():
        return backtrace.backtrace_posteriors(post_seq, trans, posterior, bf)

    def conversion():
        return dispatch.convert(probs, False, True)

    times = {'convert': [], 'dense_forward': [], 'backtrace': []}
    for name, fn in (('convert', conversion), ('dense_forward', k2),
                     ('backtrace', k3), ('backtrace', k3),
                     ('dense_forward', k2), ('convert', conversion)):
        times[name].append(cuda_ms(torch, fn, iters=3))
    call_ms = host_ms(torch, call, calls=5)
    operations = 2 * (sum(lengths) - PYIN_ROWS) * (
        int((trans_p > 0).sum()) + states)
    k2_bound, _ = bound_ms(4 * probs.numel() * 2, operations)
    conv_bound, _ = bound_ms(4 * probs.numel() * 2, 0)
    info(f'pyin: ms in turns (conversion, K2, K3, K3, K2, conversion) on '
         f'{card}: conversion {times["convert"]}, K2 '
         f'{times["dense_forward"]}, K3 {times["backtrace"]}; the call '
         f'(host clock, warm median of 5) {call_ms[0]:.3f} (min '
         f'{call_ms[1]:.3f}, max {call_ms[2]:.3f}); the algorithm\'s '
         f'bound {k2_bound:.3f} ms (its positive pairs and the floor at 2 '
         f'FP32 instructions each), one read and write of the observation '
         f'{conv_bound:.3f} ms')
    del post_seq, posterior, obs_k, probs
    torch.cuda.empty_cache()
    return {'convert_ms': times['convert'],
            'dense_forward_ms': times['dense_forward'],
            'backtrace_ms': times['backtrace'], 'call_ms': call_ms[0],
            'plan': plan, 'padded_launches': padded_launches}


def sparse_hmm(torch, batch, frames, states, degree, seed, device):
    """A random sparse HMM with ties, on ``device``: each destination a few
    sources (0 to 2 degree; one in 20 a long list of 9-40, which K9's
    warps reduce), values and the observation drawn from a few levels so
    that candidates tie, a -inf exterior, -inf entries in the initial
    distribution, ragged lengths (the first row whole). Returns
    (observation, batch_frames, transition, initial), log space"""
    rng = np.random.default_rng(seed)
    trans = np.full((states, states), -np.inf, np.float32)
    for j in range(states):
        count = (int(rng.integers(9, 41)) if rng.random() < 0.05
                 else int(rng.integers(0, 2 * degree + 1)))
        chosen = rng.choice(states, min(count, states), replace=False)
        trans[j, chosen] = np.log(rng.choice([0.25, 0.5, 1.0], len(chosen)))
    obs = np.log(rng.choice([0.1, 0.2, 0.4], (batch, frames, states)))
    with np.errstate(divide='ignore'):
        init = np.log(rng.choice([0.0, 0.5, 1.0], states))
    init[0] = 0.0
    lengths = rng.integers(0, frames + 1, batch)
    lengths[0] = frames
    return (torch.from_numpy(obs.astype(np.float32)).to(device),
            torch.from_numpy(lengths.astype(np.int32)).to(device),
            torch.from_numpy(trans).to(device),
            torch.from_numpy(init.astype(np.float32)).to(device))


def require_pointers(torch, name, got, expected, batch_frames,
                     quiet=False):
    """K9's pointers against its plain version's on the rows the chase
    reads (1 <= t < batch_frames; the kernel leaves the others unwritten)"""
    frames = got.shape[1]
    for row, length in enumerate(batch_frames.tolist()):
        top = min(length, frames)
        if top > 1 and not torch.equal(got[row, 1:top],
                                       expected[row, 1:top]):
            fail(f'{name}: K9\'s pointers of row {row} differ from its '
                 'plain version (tolerance: bitwise)')
    if not quiet:
        info(f'{name}: K9\'s pointers bitwise equal to its plain version '
             'on every frame the chase reads')


def cluster_layouts(sparse, lists):
    """K9's layout at every cluster size whose layout fits these in-lists"""
    layouts = [sparse.forward_layout(lists.states,
                                     sparse.slice_pairs(lists, cluster),
                                     cluster)
               for cluster in sparse.CLUSTER_SIZES]
    return [layout for layout in layouts if layout['fits']]


def require_clusters(torch, sparse, label, obs, bf, init, lists, conversion,
                     want):
    """K9 at every cluster size that fits, bitwise its plain version's
    ``want`` (pointers, posterior); returns the sizes held"""
    sizes = []
    for layout in cluster_layouts(sparse, lists):
        pointers, posterior = sparse.viterbi_forward_sparse(
            obs, bf, init, lists, *conversion, layout=layout)
        name = f'{label} at {layout["cluster"]} CTAs a sequence'
        require_pointers(torch, name, pointers, want[0], bf, quiet=True)
        if not torch.equal(posterior, want[1]):
            fail(f'{name}: K9\'s posterior differs from its plain version '
                 '(tolerance: bitwise)')
        sizes.append(layout['cluster'])
    return sizes


def sparse_route_paths(torch, obs, bf, trans, init, conversion):
    """(K9 then K10's paths, K2 then K3's paths, K9's outputs) of one
    log-space input, K9 folding ``conversion`` (log_input,
    apply_epsilon), K2 on the converted copy"""
    from torbi_tpu_torch.ops import backtrace, dense, dispatch, sparse

    lists = sparse.in_lists(trans)
    pointers, posterior = sparse.viterbi_forward_sparse(
        obs, bf, init, lists, *conversion)
    paths = sparse.backtrace_sparse(pointers, posterior, bf, lists)
    converted = dispatch.convert(obs, *conversion).contiguous()
    post_seq, last = dense.viterbi_forward_dense(converted, bf, trans, init)
    dense_paths = backtrace.backtrace_posteriors(post_seq, trans, last, bf)
    return paths, dense_paths, (pointers, posterior, converted, post_seq)


def beats_phase(torch, device, card, reset_counts, read_counts,
                quick=False):
    """The in-list route (``ops/sparse.py``): K9 and K10 bitwise against
    their plain versions, and the route's paths equal to K2 then K3's, on
    the edge shapes (random sparse HMMs with ties, -inf initial entries,
    ragged lengths, in the four conversions at the first shapes); then,
    unless ``quick``, madmom's beat tracker (``models/beats.py``) at the
    dbnbeat-b16-tracks cell's longest batch, 16 tracks of up to 42,006
    frames of the cell's generated densities: K9 and K10 bitwise, the paths
    equal to K2 then K3's and to the benchmark's plain reference (madmom's
    sparse Viterbi), the path through ``from_probabilities(...,
    log_probs=True)`` with one K9 and one K10 launch, no K2, no conversion
    pass; K9 and K2 timed in turns there, and K9 against K2 at the gate's
    threshold (``SPARSE_SHARES``: 1% of 5617^2 pairs; pYIN's 16.1% at 1202
    states, 512 rows). Returns a dict of the timings"""
    from benchmark import beats as beats_inputs, inputs
    from benchmark.reference import beats as reference
    from torbi_tpu_torch.models import beats, pyin
    from torbi_tpu_torch.ops import backtrace, dense, dispatch, sparse

    import torbi_tpu_torch

    result = {}

    def resident(states):
        return lambda layout: sparse.resident_clusters(states, layout, device)

    for index, (batch, frames, states, degree, seed) in enumerate(
            SPARSE_EDGES):
        obs, bf, trans, init = sparse_hmm(
            torch, batch, frames, states, degree, seed, device)
        if batch > 1:
            bf[-1] = 1  # a row of one frame
        lists = sparse.in_lists(trans)
        layout = sparse.forward_plan(lists, batch, resident(states))
        conversions = ((True, False), (True, True), (False, False),
                       (False, True)) if index < 3 else ((True, True),)
        for conversion in conversions:
            raw = obs if conversion[0] else torch.exp(obs)
            label = (f'sparse edge {batch} x {frames} x {states} '
                     f'({lists.pairs} pairs, {layout}), conversion '
                     f'{conversion}')
            paths, dense_paths, (pointers, posterior, converted, _) = (
                sparse_route_paths(torch, raw, bf, trans, init, conversion))
            want_pointers, want_posterior = sparse.sparse_forward_reference(
                raw, bf, init, lists, *conversion)
            require_pointers(torch, label, pointers, want_pointers, bf)
            require_equal(torch, f'{label} K9 posterior', posterior,
                          want_posterior)
            require_equal(torch, f'{label} K10', paths,
                          sparse.backtrace_sparse_reference(
                              pointers, posterior, bf))
            if not torch.equal(paths, dense_paths):
                fail(f'{label}: the in-list route\'s paths differ from K2 '
                     'then K3\'s')
            sizes = require_clusters(
                torch, sparse, label, raw, bf, init, lists, conversion,
                (want_pointers, want_posterior))
            info(f'{label}: the paths equal K2 then K3\'s; K9 bitwise at '
                 f'{sizes} CTAs a sequence')
            del pointers, posterior, converted
    # A frame of -inf everywhere: every later posterior is -inf, the seed
    # 0, and K10 reads every pointer
    obs, bf, trans, init = sparse_hmm(torch, 3, 40, 1000, 3, 8, device)
    obs[:, 20] = float('-inf')
    paths, dense_paths, (pointers, posterior, _, _) = sparse_route_paths(
        torch, obs, bf, trans, init, (True, False))
    require_equal(torch, 'sparse -inf frame K10', paths,
                  sparse.backtrace_sparse_reference(pointers, posterior, bf))
    if not torch.equal(paths, dense_paths):
        fail('sparse -inf frame: the paths differ from K2 then K3\'s')
    lists = sparse.in_lists(trans)
    sizes = require_clusters(
        torch, sparse, 'sparse -inf frame', obs, bf, init, lists,
        (True, False), sparse.sparse_forward_reference(obs, bf, init, lists))
    info('sparse -inf frame: K10 follows the pointers and equals K2 then '
         f'K3; K9 bitwise at {sizes} CTAs a sequence')
    if quick:
        return result

    # madmom's beat tracker at the cell's longest batch
    traffic = json.loads(
        (ROOT / 'benchmark' / 'traffic' / 'dbnbeat-sorted-pool48.json')
        .read_text())
    config = json.loads(
        (ROOT / 'benchmark' / 'configs' / 'dbnbeat5617-default.json')
        .read_text())
    lengths = inputs.lengths(traffic['pool'], **traffic['lengths'])[
        -config['BATCH_SIZE']:]
    host = inputs.host_generator(BEATS_SEED)
    tracks = beats_inputs.activations(
        lengths, traffic['activations'], beats.FPS, host)
    obs = beats_inputs.log_densities(tracks, config['dbn'], device)
    bf = torch.tensor(lengths, dtype=torch.int32, device=device)
    trans = torch.from_numpy(beats.transition_matrix()).to(device)
    init = torch.from_numpy(beats.initial()).to(device)
    lists = sparse.detect_sparse(trans)
    if lists is None or lists.pairs != 8934:
        fail(f'beats: the gate declined madmom\'s transition ({lists})')
    if sparse.detect_sparse(torch.log(torch.from_numpy(
            pyin.transition_matrix()).to(device))) is not None:
        fail('beats: the gate took pYIN\'s transition')
    layout = sparse.forward_plan(lists, len(lengths),
                                 resident(beats.STATES))
    held = {each['cluster']: sparse.resident_clusters(
        beats.STATES, each, device) for each in cluster_layouts(sparse, lists)}
    heavy = [max(len(warp) for cta in sparse.warp_lists(lists, each)
                 for warp in cta) for each in cluster_layouts(sparse, lists)]
    info(f'beats: {len(lengths)} tracks of {min(lengths)}-{max(lengths)} '
         f'frames x {beats.STATES} states ({sum(lengths)} real frames), '
         f'{lists.pairs} pairs; K9 layout {layout}; clusters the card holds '
         f'at once by size {held}; heavy in-lists a warp at most {heavy}; '
         f'K10 layout {sparse.chase_layout(beats.STATES, lists.pairs)}')
    result.update(plan=layout, resident_clusters=held)

    (pointers, posterior), k9_ms = cuda_once(
        torch, lambda: sparse.viterbi_forward_sparse(
            obs, bf, init, lists, True, True))
    paths, k10_ms = cuda_once(torch, lambda: sparse.backtrace_sparse(
        pointers, posterior, bf, lists))
    info(f'beats: K9 {k9_ms:.3f} ms, K10 {k10_ms:.3f} ms (first calls)')
    want_pointers, want_posterior = sparse.sparse_forward_reference(
        obs, bf, init, lists, True, True)
    require_pointers(torch, 'beats K9', pointers, want_pointers, bf)
    require_equal(torch, 'beats K9 posterior', posterior, want_posterior)
    del want_pointers, want_posterior
    require_equal(torch, 'beats K10', paths,
                  sparse.backtrace_sparse_reference(pointers, posterior, bf))
    rows = reference.decode(reference.stabilised(obs), lengths,
                            reference.hmm(config['dbn'], device)[0], init)
    for row, length in enumerate(lengths):
        if not torch.equal(paths[row, :length].long(), rows[row, :length]):
            fail(f'beats: row {row} differs from the plain reference '
                 '(madmom\'s sparse Viterbi)')
    del rows
    info('beats: the paths equal the benchmark\'s plain reference on all '
         f'{len(lengths)} tracks')

    values = dispatch.convert.values
    reasons = dict(dispatch.decode.dense_reasons)
    reset_counts()

    def call():
        return torbi_tpu_torch.from_probabilities(
            obs, bf, trans, init, log_probs=True, gpu=device)

    cuda = device.type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    sizes = dict(sparse.viterbi_forward_sparse.size_launches)
    decoded = call()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    counts = read_counts()
    sizes = {size: count - sizes[size] for size, count in
             sparse.viterbi_forward_sparse.size_launches.items()
             if count != sizes[size]}
    if not torch.equal(decoded, paths):
        fail('beats: from_probabilities differs from K9 then K10')
    # The plain versions on the CPU count no launch
    if cuda and ((counts['sparse_forward'], counts['sparse_backtrace'])
                 != (1, 1) or any(
                     count for name, count in counts.items()
                     if name not in ('sparse_forward', 'sparse_backtrace'))
                 or sizes != {layout['cluster']: 1}
                 or layout['cluster'] == 1):
        fail(f'beats: from_probabilities launched {counts}, by cluster size '
             f'{sizes} (planned {layout["cluster"]} CTAs a track, above 1)')
    if (dispatch.convert.values != values
            or dict(dispatch.decode.dense_reasons) != reasons):
        fail('beats: from_probabilities ran a conversion pass or counted a '
             'dense decode')
    info(f'beats: from_probabilities(..., log_probs=True) equals K9 then '
         f'K10, launches {counts}, K9 by cluster size {sizes}, no '
         f'conversion pass; peak memory {peak} bytes')
    result['size_launches'] = sizes
    del pointers, posterior, decoded

    # The call as the cell makes it, K9 on one CTA a track (the old
    # layout) and as planned, in turns, at 16 tracks and on the longest
    plan = sparse.forward_plan
    longest = int(np.argmax(lengths))

    def one_cta(lists, batch, resident):
        return sparse.forward_layout(lists.states, lists.pairs)

    for rows, (part, part_bf) in (
            (len(lengths), (obs, bf)),
            (1, (obs[longest:longest + 1], bf[longest:longest + 1]))):
        turns = {'one_cta': [], 'planned': []}
        for name in ('one_cta', 'planned', 'planned', 'one_cta'):
            sparse.forward_plan = one_cta if name == 'one_cta' else plan
            try:
                turns[name].append(host_ms(
                    torch, lambda: torbi_tpu_torch.from_probabilities(
                        part, part_bf, trans, init, log_probs=True,
                        gpu=device), calls=2)[0])
            finally:
                sparse.forward_plan = plan
        chosen = plan(lists, rows, resident(beats.STATES))['cluster']
        info(f'beats: from_probabilities at {rows} x {max(lengths)} x '
             f'{beats.STATES}, ms in turns (one CTA, planned, planned, one '
             f'CTA) on {card}: one CTA a track {turns["one_cta"]}, '
             f'{chosen} CTAs a track {turns["planned"]}')
        result[f'call_{rows}_ms'] = dict(turns, cluster=chosen)

    # K2 then K3 on the same batch
    converted = dispatch.convert(obs, True, True).contiguous()
    del obs
    torch.cuda.empty_cache()
    (post_seq, last), k2_ms = cuda_once(
        torch, lambda: dense.viterbi_forward_dense(
            converted, bf, trans, init))
    dense_paths, k3_ms = cuda_once(
        torch, lambda: backtrace.backtrace_posteriors(
            post_seq, trans, last, bf))
    if not torch.equal(dense_paths, paths):
        fail('beats: the in-list route\'s paths differ from K2 then K3\'s')
    info(f'beats: the paths equal K2 then K3\'s (K2 {k2_ms:.3f} ms, K3 '
         f'{k3_ms:.3f} ms)')
    del post_seq, last

    def k9():
        return sparse.viterbi_forward_sparse(converted, bf, init, lists)

    def k2():
        return dense.viterbi_forward_dense(converted, bf, trans, init)

    times = {'sparse_forward': [], 'dense_forward': []}
    for name, fn in (('sparse_forward', k9), ('dense_forward', k2),
                     ('dense_forward', k2), ('sparse_forward', k9)):
        times[name].append(cuda_ms(torch, fn, iters=1, warmup=0))
    pointers, posterior = k9()
    k10 = cuda_ms(torch, lambda: sparse.backtrace_sparse(
        pointers, posterior, bf, lists), iters=3)
    del pointers, posterior
    call_ms = host_ms(torch, lambda: torbi_tpu_torch.from_probabilities(
        converted, bf, trans, init, log_probs=True, gpu=device), calls=3)
    real = sum(lengths)
    least, _ = bound_ms(4 * (real * beats.STATES + lists.pairs),
                        2 * (real - len(lengths)) * lists.pairs)
    # K9 at every cluster size, at the cell's batch and on its longest
    # track
    want = k9()
    for rows, (part, part_bf) in (
            (len(lengths), (converted, bf)),
            (1, (converted[longest:longest + 1], bf[longest:longest + 1]))):
        spread = {}
        for each in cluster_layouts(sparse, lists):
            got = sparse.viterbi_forward_sparse(part, part_bf, init, lists,
                                                layout=each)
            expected = want[1] if rows > 1 else want[1][longest:longest + 1]
            if not torch.equal(got[1], expected):
                fail(f'beats: K9 at {each["cluster"]} CTAs a track differs')
            del got
            spread[each['cluster']] = cuda_ms(
                torch, lambda: sparse.viterbi_forward_sparse(
                    part, part_bf, init, lists, layout=each), iters=2)
        per_frame = {size: round(ms / max(lengths) * 1e3, 3)
                     for size, ms in spread.items()}
        info(f'beats: K9 at {rows} x {max(lengths)} x {beats.STATES} by CTAs '
             f'a track, ms: {spread}; us a serial frame: {per_frame}')
        result[f'clusters_{rows}_ms'] = spread
    del want
    info(f'beats: ms in turns (K9, K2, K2, K9) on {card}: K9 '
         f'{times["sparse_forward"]}, K2 {times["dense_forward"]}; K10 '
         f'{k10:.3f}; the call (host clock, warm median of 3) '
         f'{call_ms[0]:.3f}; K9\'s bound {least:.3f} ms (the observation '
         f'read once); {max(lengths)} serial frames: '
         f'{min(times["sparse_forward"]) / max(lengths) * 1e3:.3f} us a '
         'frame')
    del converted
    torch.cuda.empty_cache()
    result.update(sparse_forward_ms=times['sparse_forward'],
                  dense_forward_ms=times['dense_forward'],
                  sparse_backtrace_ms=k10, call_ms=call_ms[0],
                  peak_bytes=peak)

    # K9 against K2 at denser transitions: the gate's threshold
    for batch, frames, states, degree in SPARSE_SHARES:
        if degree == 'pyin':
            dense_trans = torch.log(torch.from_numpy(
                pyin.transition_matrix()).to(device))
        elif degree == 'madmom':
            dense_trans = trans
        elif degree == 'chain':
            # madmom's, each first state keeping its lowest source alone
            dense_trans = trans.clone()
            keep = torch.isfinite(dense_trans).int().argmax(dim=1)
            dense_trans.fill_(float('-inf'))
            rows = torch.arange(states, device=device)
            dense_trans[rows, keep] = trans[rows, keep]
        else:
            dense_trans = sparse_hmm(torch, 1, 1, states, degree, 9,
                                     device)[2]
        share_lists = sparse.in_lists(dense_trans)
        share_obs = torch.log(torch.rand(
            (batch, frames, states), device=device,
            generator=torch.Generator(device=device).manual_seed(5)))
        share_bf = torch.full((batch,), frames, dtype=torch.int32,
                              device=device)
        share_init = torch.zeros(states, device=device)
        turns = {'sparse_forward': [], 'dense_forward': []}
        for name in ('sparse_forward', 'dense_forward', 'dense_forward',
                     'sparse_forward'):
            turns[name].append(cuda_ms(torch, (
                (lambda: sparse.viterbi_forward_sparse(
                    share_obs, share_bf, share_init, share_lists))
                if name == 'sparse_forward' else
                (lambda: dense.viterbi_forward_dense(
                    share_obs, share_bf, dense_trans, share_init))),
                iters=1))
        share = share_lists.pairs / states ** 2
        chosen = sparse.forward_plan(share_lists, batch, resident(states))
        info(f'sparse gate: {batch} x {frames} x {states} at '
             f'{share_lists.pairs} pairs ({100 * share:.3f}% of S^2, '
             f'K9 layout {chosen}): K9 {turns["sparse_forward"]} ms, K2 '
             f'{turns["dense_forward"]} ms in turns')
        result[f'share_{batch}x{frames}x{states}_{share_lists.pairs}'] = (
            dict(share=share, cluster=chosen['cluster'], **turns))
        del share_obs, dense_trans, share_lists
        torch.cuda.empty_cache()

    # K9 at every cluster size: where spreading a sequence pays
    for batch, frames, states, degree in SPARSE_SPREAD:
        spread_trans = (trans if degree == 'madmom' else sparse_hmm(
            torch, 1, 1, states, degree, 9, device)[2])
        spread_lists = sparse.in_lists(spread_trans)
        spread_obs = torch.log(torch.rand(
            (batch, frames, states), device=device,
            generator=torch.Generator(device=device).manual_seed(6)))
        spread_bf = torch.full((batch,), frames, dtype=torch.int32,
                               device=device)
        spread_init = torch.zeros(states, device=device)
        spread = {}
        for each in cluster_layouts(sparse, spread_lists):
            spread[each['cluster']] = cuda_ms(
                torch, lambda: sparse.viterbi_forward_sparse(
                    spread_obs, spread_bf, spread_init, spread_lists,
                    layout=each), iters=2)
        chosen = sparse.forward_plan(spread_lists, batch, resident(states))
        info(f'sparse spread: {batch} x {frames} x {states} ({degree}, '
             f'{spread_lists.pairs} pairs), K9 ms by CTAs a sequence '
             f'{spread}; planned {chosen["cluster"]}')
        result[f'spread_{batch}x{frames}x{states}_{degree}'] = dict(
            ms=spread, planned=chosen['cluster'])
        del spread_obs, spread_lists
        torch.cuda.empty_cache()
    return result


def beats_main(quick):
    """``python3 chip_smoke.py --beats [quick]``: the in-list route's
    phase alone, its kernels and K2, K3 built first"""
    import torch

    if not torch.cuda.is_available():
        fail('the in-list phase needs a CUDA card')
    sys.path.insert(0, str(ROOT))
    from torbi_tpu_torch.csrc import build

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    from torbi_tpu_torch.utils import profile

    global ISSUE_PER_S
    sms, clock_hz = profile.device_rates()
    ISSUE_PER_S = profile.FP32_LANES_PER_SM * sms * clock_hz
    start = time.perf_counter()
    names = ('sparse_forward', 'sparse_backtrace', 'dense_forward',
             'backtrace')
    build.build(names)
    info(f'built {", ".join(names)} in {time.perf_counter() - start:.1f} s')
    for name in names[:2]:
        for line in (build.report(name) or '').splitlines():
            if 'registers' in line or 'spill' in line:
                info(f'{name}: {line.strip()}')
    counters = decode_counters()

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counters.items()}

    result = beats_phase(torch, device, card, reset_counts, read_counts,
                         quick=quick)
    print(json.dumps({'sparse': result, 'ok': True}), flush=True)


def pitch_file(path, frames, seed):
    """One log-space pitch posteriorgram file of ``frames`` x STATES, written
    in slices; returns the array"""
    from torbi_tpu_torch.models import pitch

    obs = np.concatenate([
        pitch.synthetic_posteriorgrams(
            1, min(1 << 14, frames - start), STATES, seed=seed + start)[0]
        for start in range(0, frames, 1 << 14)])
    np.save(path, obs)
    return obs


def main():
    try:
        import torch
    except ImportError:
        fail('PyTorch is not installed')
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke run needs a '
             'CUDA card')
    if not (ROOT / 'torbi_tpu_torch' / '__init__.py').is_file():
        fail(f'torbi_tpu_torch is not beside {Path(__file__).name}')
    sys.path.insert(0, str(ROOT))

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    if smi.returncode or not smi.stdout.strip():
        fail(f'nvidia-smi failed: {smi.stderr.strip()}')
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    info(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
         f'CUDA {torch.version.cuda}')

    import torbi_tpu_torch
    from torbi_tpu_torch.csrc import build
    from torbi_tpu_torch.models import pitch
    from torbi_tpu_torch.ops import (
        associative, backtrace, band, constant, dense, dispatch)
    from torbi_tpu_torch.scripts import chase_lab, kernel_lab
    from torbi_tpu_torch.utils import edges, fixtures, profile

    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    global ISSUE_PER_S
    sms, clock_hz = profile.device_rates()
    ISSUE_PER_S = profile.FP32_LANES_PER_SM * sms * clock_hz
    smem_words_per_s = profile.SMEM_WORDS_PER_SM_CLOCK * sms * clock_hz
    info(f'{sms} SMs at {clock_hz / 1e9:.3f} GHz: {ISSUE_PER_S:.4g} FP32 '
         f'instructions/s, {smem_words_per_s:.4g} shared-memory words/s')

    # 1. Build every kernel (one nvcc per source, in parallel), and beside
    # them the file path's native loader (host code, g++)
    start = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        loader_build = pool.submit(build.host_library, 'loader')
        build.build()
        if loader_build.result() is None:
            fail('the native loader (csrc/loader.cpp) did not build with g++')
    info(f'built {", ".join(build.SOURCES)} and the native loader in '
         f'{time.perf_counter() - start:.1f} s')
    for name in build.SOURCES:
        output = build.report(name)
        if output is None:
            fail(f'no ptxas report of {name}.cu beside its library')
        for line in output.splitlines():
            if 'registers' in line or 'spill' in line:
                info(f'{name}: {line.strip()}')
    redesign_registers(build, associative)
    # The CTAs an SM holds of each K8 design, as the card reports them,
    # against the plan's model
    for tile in range(len(associative.MAXPLUS_TILES)):
        for resident in (None, 'a', 'b'):
            # A resident operand of a 64-deep product: all its slabs
            slabs = -(-64 // associative.MAXPLUS_TILES[tile][4])
            layout = associative.maxplus_layout(tile, resident, slabs)
            blocks, smem = associative.maxplus_occupancy(
                tile, resident, slabs)
            if (blocks, smem) != (layout['ctas_per_sm'],
                                  layout['smem_bytes']):
                fail(f'K8 tile design {tile} (resident {resident}): the card '
                     f'holds {blocks} CTAs of {smem} bytes an SM, the plan '
                     f'models {layout["ctas_per_sm"]} of '
                     f'{layout["smem_bytes"]}')
    info('K8: the card holds as many CTAs an SM of each design as its plan '
         'models (cudaOccupancyMaxActiveBlocksPerMultiprocessor)')
    # The instructions the folded conversion adds per value, from the SASS
    sass = sass_conversion_counts(build)
    for (log_input, apply_epsilon), per_kernel in sass.items():
        info(f'SASS per converted value (log_input={log_input}, '
             f'apply_epsilon={apply_epsilon}): ' + ', '.join(
                 f'{kernel} {total:g} instructions, {mufu:g} MUFU'
                 for kernel, (total, mufu) in per_kernel.items()))
    # The headline's conversion (log space, the epsilon step) per value, as
    # the headline's kernel (32 per cluster) compiles it
    conv_per_value = sass[(True, True)]['K1 32 per cluster'][0]

    # Inputs of the banded path, made from a seed
    start = time.perf_counter()
    obs_host = pitch.synthetic_posteriorgrams(BATCH, FRAMES, STATES)
    trans_host = np.log(pitch.transition_matrix() + TINY).astype(np.float32)
    init_host = np.log(
        np.full(STATES, 1.0 / STATES, dtype=np.float32) + TINY)
    obs = torch.from_numpy(obs_host).to(device)
    trans = torch.from_numpy(trans_host).to(device)
    init = torch.from_numpy(init_host).to(device)
    bf = torch.full((BATCH,), FRAMES, dtype=torch.int32, device=device)
    info(f'inputs made in {time.perf_counter() - start:.1f} s')

    band_tuple = band.detect_band(trans)
    info(f'band (lo, width, floor) = {band_tuple}')
    if band_tuple is None or band_tuple[1] != 175:
        fail(f'unexpected band {band_tuple} for the pitch transition')
    lo, width, _ = band_tuple
    band_matrix = band.build_band_matrix(trans, lo, width)
    # What the main path hands the kernels: the epsilon step applied once
    obs_k = dispatch.convert(obs, True, True).contiguous()
    convert_ms = cuda_ms(
        torch, lambda: dispatch.convert(obs, True, True), iters=5)
    # The same step on a probability observation (log, then the epsilon
    # step: four passes); its bound, one read and one write of the
    # observation
    obs_prob = torch.exp(obs)
    convert_prob_ms = cuda_ms(
        torch, lambda: dispatch.convert(obs_prob, False, True), iters=5)
    del obs_prob
    convert_bound_ms = 2 * obs.numel() * 4 / PEAK_BYTES_PER_S * 1e3
    info(f'epsilon step (plain torch elementwise, headline shape): '
         f'{convert_ms:.3f} ms; log and epsilon step on probabilities '
         f'{convert_prob_ms:.3f} ms; bound (one read and one write) '
         f'{convert_bound_ms:.3f} ms')

    kernels = {}

    # 2. Each kernel against its plain version on the card
    # K1 at the headline shape: the cluster design (band_forward, as
    # band.cluster_plan launches it) against the plain version, then timed
    k1_args = (obs_k, bf, init, band_tuple, band_matrix)
    resident = {size: band.resident_clusters(STATES, width, size, device)
                for size in band.cluster_sizes(STATES, width)}
    k1_plan = band.cluster_plan(BATCH, STATES, width, resident.get)
    info(f'K1 cluster plan at {BATCH} x {STATES}, width {width}: (start, '
         f'count, sequences per cluster) {k1_plan}; clusters of 8 held at '
         f'once per sequences per cluster {resident}')
    post_k, posterior_k = band.viterbi_forward_band(*k1_args)
    (post_r, _), k1_plain_ms = cuda_once(
        torch, lambda: band.band_forward_reference(*k1_args))
    torch.cuda.synchronize()
    err = require_equal(torch, 'K1 band_forward (cluster design)', post_k,
                        post_r)
    del post_r
    k1_ms = cuda_ms(torch, lambda: band.viterbi_forward_band(*k1_args),
                    iters=5)
    steps = valid_steps(bf, FRAMES)
    in_range = in_range_pairs(STATES, lo, width)
    k1_bytes = (2 * BATCH * FRAMES * STATES + width * STATES + STATES) * 4
    # Per step: an add and a max per candidate; per state the floor max,
    # the posterior max and the observation add
    k1_ops = steps * (2 * in_range + 3 * STATES)
    kernels['band_forward'] = dict(
        name='band_forward', route='cuda',
        source='torbi_tpu_torch/csrc/band_forward.cu',
        replaces='torbi_tpu/ops/band.py:512', path='banded',
        max_abs_err=err, ms=k1_ms, plain_ms=k1_plain_ms,
        bound=bound_ms(k1_bytes, k1_ops), library_ms=None,
        smem_bound_ms=steps * in_range / smem_words_per_s * 1e3)
    # The wide-band design's line takes its time, bound and plain time
    # from path (a), the band no cluster layout holds (phase 6); its
    # throughput shape (b) and auto-chunk path (c) stand beside them
    kernels['band_forward_wide'] = dict(
        name='band_forward_wide', route='cuda',
        source='torbi_tpu_torch/csrc/band_wide.cu',
        replaces='torbi_tpu/ops/band.py:512', path='wide-band',
        max_abs_err=0.0)
    info(f'K1 at the headline (cluster design): {k1_ms:.3f} ms; plain '
         f'{k1_plain_ms:.1f} ms')

    # K1 as the main path calls it, the conversion folded in: each design
    # (the cluster design as the plan launches it and at every cluster
    # size) bitwise against the plain route (the conversion's torch ops,
    # then the same kernel), in log space and in probability space; the
    # headline's generator makes log(tiny) entries, whose exp is subnormal
    # (and 0 < p < tiny in probability space). Each cluster size on the
    # converted observation is first held against post_k, the plain
    # version's output, so the plain route of the folded check is too
    log_tiny = float(np.log(np.float32(TINY)))
    if not bool((obs == log_tiny).any()):
        fail('the headline observation holds no log(tiny) entry')
    fold_rest = (bf, init, band_tuple, band_matrix)
    kernels['band_forward']['max_abs_err'] = max(
        kernels['band_forward']['max_abs_err'], hold_folded(
            torch, dispatch, 'K1 band_forward folded at the headline',
            band.viterbi_forward_band, obs, fold_rest))
    for size in band.CLUSTER_TILES:
        kernels['band_forward']['max_abs_err'] = max(
            kernels['band_forward']['max_abs_err'], require_equal(
                torch, f'K1 band_forward at the headline, {size} per '
                'cluster', band._forward_band_clusters(
                    *k1_args, size)[0], post_k), hold_folded(
                torch, dispatch, f'K1 band_forward folded at the headline, '
                f'{size} per cluster', band._forward_band_clusters, obs,
                fold_rest + (size,)))
    info('K1 folded (cluster sizes '
         f'{"/".join(map(str, band.CLUSTER_TILES))}) bitwise equal to the '
         'plain route at the headline, log and probability space')

    # Folded K1 against the epsilon step's torch ops plus K1, in turns
    def k1_folded():
        return band.viterbi_forward_band(obs, *fold_rest, True, True)

    def k1_after_epsilon():
        return band.viterbi_forward_band(
            dispatch.convert(obs, True, True).contiguous(), *fold_rest)

    fold_turns = [cuda_ms(torch, fn, iters=5) for fn in (
        k1_folded, k1_after_epsilon, k1_after_epsilon, k1_folded)]
    k1_fold_ms = (fold_turns[0] + fold_turns[3]) / 2
    # The converted values: frame 0 and every valid frame, each once
    converted_values = (BATCH + steps) * STATES
    kernels['band_forward'].update(
        epsilon_step_ms=convert_ms, log_epsilon_step_ms=convert_prob_ms,
        epsilon_step_bound_ms=convert_bound_ms,
        ms=k1_fold_ms, unfolded_ms=k1_ms,
        epsilon_plus_kernel_ms=(fold_turns[1] + fold_turns[2]) / 2,
        conversion_instructions_per_value=conv_per_value,
        bound=bound_ms(k1_bytes, k1_ops + converted_values * conv_per_value))
    info(f'K1 folded against the epsilon step + K1 at the headline, in turns '
         f'(ms): folded {fold_turns[0]:.3f}, epsilon + K1 '
         f'{fold_turns[1]:.3f}, epsilon + K1 {fold_turns[2]:.3f}, folded '
         f'{fold_turns[3]:.3f} '
         f'(K1 alone on a converted observation {k1_ms:.3f}); bound with '
         f'{conv_per_value:g} conversion instructions per value '
         f'{kernels["band_forward"]["bound"][0]:.3f} '
         f'({kernels["band_forward"]["bound"][1]})')
    # Band bytes read from L2 per call, reckoned from the launch layout
    # (not measured): the cluster design loads each CTA's slice (the whole
    # band per cluster) once per launch
    info('K1 band bytes from L2 per headline call, estimated from the '
         'launch layout, not measured: cluster '
         f'{clusters_of(k1_plan) * width * STATES * 4:.4g}')

    # K1's launch plan on the card: one whole wave (the clusters the card
    # holds at once) at each cluster size, whose ratios
    # band.CLUSTER_WAVE_COST holds; the plan's rest (the last 32
    # sequences) at each size; the headline in one launch of 16 clusters
    # of 32 (two waves); a four-card rank's 128 rows under two plans
    wave_ms = {}
    for size, clusters in resident.items():
        wave = clusters * size
        wave_ms[size] = cuda_ms(torch, lambda: band._forward_band_clusters(
            obs_k[:wave], bf[:wave], init, band_tuple, band_matrix, size),
            iters=3)
    rest = k1_plan[-1][0]
    rest_args = (obs_k[rest:], bf[rest:], init, band_tuple, band_matrix)
    rest_ms = {size: cuda_ms(torch, lambda: band._forward_band_clusters(
        *rest_args, size), iters=3) for size in resident}
    one_launch_ms = cuda_ms(torch, lambda: band._forward_band_clusters(
        *k1_args, 32), iters=3)
    kernels['band_forward'].update(
        resident_clusters=resident, wave_ms=wave_ms, rest_ms=rest_ms,
        one_launch_ms=one_launch_ms)
    info('K1 one wave per sequences per cluster (ms): ' + ', '.join(
        f'{size}: {ms:.3f} (relative to 4: {ms / wave_ms[4]:.3f}, '
        f'band.CLUSTER_WAVE_COST {band.CLUSTER_WAVE_COST[size]})'
        for size, ms in wave_ms.items()))
    info(f'K1 the last {BATCH - rest} sequences per sequences per cluster '
         '(ms): ' + ', '.join(
             f'{size}: {ms:.3f}' for size, ms in rest_ms.items())
         + f' (the plan takes {k1_plan[-1][2]}); one launch of '
         f'{-(-BATCH // 32)} clusters of 32: {one_launch_ms:.3f} ms')
    # The plans that clusters of 8 and 16 changed: each batch under the
    # plan without them (clusters of 4, through _launch_clusters) and as
    # the wrapper plans it, in turns (old, new, new, old), both outputs
    # bitwise against the plain version's; the per-size launch counts show
    # which tiles the wrapper ran. A four-card rank's share of the headline
    # (128 rows) and the 64-row rest of 1024 rows at the pitch band, the
    # headline and 128 rows at width 259 (whole waves of 8 there) and the
    # headline at width 215 (whole waves of 16)
    size_launches = band.viterbi_forward_band.size_launches
    k1_wrapper = band.viterbi_forward_band
    plan_turns = {}

    def hold_plans(label, args, expected):
        rows, plan_width = len(args[0]), args[3][1]
        old_plan = ((0, rows, 4),)
        new_plan = band.cluster_plan(rows, STATES, plan_width, lambda size: (
            band.resident_clusters(STATES, plan_width, size, device)))
        size_launches.update(dict.fromkeys(size_launches, 0))
        k1_wrapper.dependent_launches = 0
        err = 0.0
        for name, got in (
                ('clusters of 4', band._launch_clusters(
                    *args, old_plan, True, False)[0]),
                ('the wrapper', band.viterbi_forward_band(*args)[0])):
            err = max(err, require_equal(
                torch, f'K1 {label} ({name})', got, expected))
        wanted = dict.fromkeys(size_launches, 0)
        wanted[4] += 1
        for _, _, size in new_plan:
            wanted[size] += 1
        if size_launches != wanted:
            fail(f'K1 {label}: launches per sequences per cluster '
                 f'{size_launches}, expected {wanted} (plan {new_plan})')
        # Every launch of the wrapper's plan after its first is a dependent
        if k1_wrapper.dependent_launches != len(new_plan) - 1:
            fail(f'K1 {label}: {k1_wrapper.dependent_launches} dependent '
                 f'launches, expected {len(new_plan) - 1} (plan {new_plan})')
        wanted[4] -= 1
        turns = [cuda_ms(torch, fn, iters=5) for fn in (
            lambda: band._launch_clusters(*args, old_plan, True, False),
            lambda: band.viterbi_forward_band(*args))]
        turns += [cuda_ms(torch, fn, iters=5) for fn in (
            lambda: band.viterbi_forward_band(*args),
            lambda: band._launch_clusters(*args, old_plan, True, False))]
        plan_turns[label] = dict(
            old=old_plan, new=new_plan, ms=turns, wrapper_launches=wanted)
        info(f'K1 {label}, in turns (ms): plan {old_plan} {turns[0]:.3f}, '
             f'plan {new_plan} {turns[1]:.3f}, {turns[2]:.3f}, plan '
             f'{old_plan} {turns[3]:.3f}; new/old '
             f'{(turns[1] + turns[2]) / (turns[0] + turns[3]):.3f}; the '
             f'wrapper\'s launches per sequences per cluster {wanted}')
        return err

    share = BATCH // 4
    err = max(
        hold_plans(f'{share} rows at width {width}', (
            obs_k[:share], bf[:share], init, band_tuple, band_matrix),
            post_k[:share]),
        hold_plans(f'64 rows at width {width}', (
            obs_k[:64], bf[:64], init, band_tuple, band_matrix),
            post_k[:64]))
    for halfwidth in (129, 107):
        plan_trans = torch.from_numpy(
            fixtures.triangular_log(STATES, halfwidth, TINY)).to(device)
        plan_band = band.detect_band(plan_trans)
        plan_args = (obs_k, bf, init, plan_band, band.build_band_matrix(
            plan_trans, *plan_band[:2]))
        plan_post = band.band_forward_reference(*plan_args)[0]
        err = max(err, hold_plans(
            f'headline at width {plan_band[1]}', plan_args, plan_post))
        if halfwidth == 129:
            err = max(err, hold_plans(
                f'{share} rows at width {plan_band[1]}',
                tuple(arg[:share] for arg in plan_args[:2]) + plan_args[2:],
                plan_post[:share]))
        del plan_trans, plan_args, plan_post
    kernels['band_forward']['max_abs_err'] = max(
        kernels['band_forward']['max_abs_err'], err)
    kernels['band_forward'].update(plan_turns=plan_turns)

    # A plan's launches after its first are dependents: their clusters
    # start in the SMs the earlier launch's clusters free as they retire.
    # Held bitwise at the headline (480 rows in clusters of 32, then 32 in
    # clusters of 4), at 1024 rows (960, then 64 in clusters of 8; the
    # headline's rows twice) and on the headline's observation with sorted
    # ragged lengths (as the batches of a sorted corpus arrive: the first
    # clusters of the wave end first), each with one dependent launch. The
    # plans of 512 rows timed in turns against the same plan launched
    # serially: one launch per entry, each a whole launch of its own
    sorted_bf = torch.linspace(
        FRAMES * 0.4, FRAMES, BATCH, device=device).round().to(torch.int32)
    sorted_args = (obs_k, sorted_bf, init, band_tuple, band_matrix)
    dependent_turns = {}

    def hold_dependent(label, args, expected, timed):
        rows = len(args[0])
        plan = band.cluster_plan(rows, STATES, width, lambda size: (
            band.resident_clusters(STATES, width, size, device)))
        if len(plan) < 2:
            fail(f'K1 {label}: plan {plan} has no launch after its first')
        k1_wrapper.dependent_launches = 0
        err = require_equal(torch, f'K1 {label} (plan {plan}, dependent)',
                            band.viterbi_forward_band(*args)[0], expected)
        if k1_wrapper.dependent_launches != len(plan) - 1:
            fail(f'K1 {label}: {k1_wrapper.dependent_launches} dependent '
                 f'launches, expected {len(plan) - 1}')

        def serial():
            return [band._forward_band_clusters(
                args[0][start:start + count], args[1][start:start + count],
                *args[2:], size)[0] for start, count, size in plan]

        err = max(err, require_equal(
            torch, f'K1 {label} (plan {plan}, serial)', torch.cat(serial()),
            expected))
        if not timed:
            return err
        turns = [cuda_ms(torch, fn, iters=5) for fn in (
            serial, lambda: band.viterbi_forward_band(*args))]
        turns += [cuda_ms(torch, fn, iters=5) for fn in (
            lambda: band.viterbi_forward_band(*args), serial)]
        dependent_turns[label] = dict(plan=plan, ms=turns)
        info(f'K1 {label}, plan {plan} in turns (ms): serial {turns[0]:.3f}, '
             f'dependent {turns[1]:.3f}, {turns[2]:.3f}, serial '
             f'{turns[3]:.3f}; dependent/serial '
             f'{(turns[1] + turns[2]) / (turns[0] + turns[3]):.4f}')
        return err

    err = max(
        hold_dependent(f'{BATCH} rows', k1_args, post_k, True),
        hold_dependent(f'{BATCH} rows, sorted lengths', sorted_args,
                       band.band_forward_reference(*sorted_args)[0], True),
        hold_dependent(
            f'{2 * BATCH} rows', (torch.cat([obs_k, obs_k]),
                                  torch.cat([bf, bf])) + k1_args[2:],
            torch.cat([post_k, post_k]), False))
    kernels['band_forward']['max_abs_err'] = max(
        kernels['band_forward']['max_abs_err'], err)
    kernels['band_forward'].update(dependent_turns=dependent_turns)

    # K3: backtrace on K1's output
    idx_k = backtrace.backtrace_posteriors(post_k, trans, posterior_k, bf)
    idx_r = backtrace.backtrace_reference(post_k, trans, posterior_k, bf)
    torch.cuda.synchronize()
    err = require_equal(torch, 'K3 backtrace (banded stream)', idx_k, idx_r)
    k3_ms = cuda_ms(torch, lambda: backtrace.backtrace_posteriors(
        post_k, trans, posterior_k, bf), iters=5)
    k3_plain_ms = cuda_ms(torch, lambda: backtrace.backtrace_reference(
        post_k, trans, posterior_k, bf), iters=1, warmup=0)
    # Stream rows the chase reads, the final posterior, the transition
    # once, the indices out
    k3_bytes = (steps * STATES + BATCH * STATES + STATES * STATES
                + BATCH * FRAMES) * 4
    k3_ops = (steps + BATCH) * 2 * STATES
    kernels['backtrace'] = dict(
        name='backtrace', route='cuda',
        source='torbi_tpu_torch/csrc/backtrace.cu',
        replaces='torbi_tpu/ops/backtrace.py:293', path='banded',
        max_abs_err=err, ms=k3_ms, plain_ms=k3_plain_ms,
        bound=bound_ms(k3_bytes, k3_ops), library_ms=None)
    info(f'K3 backtrace: {k3_ms:.3f} ms, plain {k3_plain_ms:.1f} ms')
    del post_k, posterior_k

    # K2: the dense forward at the latency shape (8 x 64 x 1440, two short
    # sequences), on the toy, at the edges of its launch plan and at the
    # throughput shape (512 x 512 x 1280, the last two sequences short),
    # each held bitwise against its plain version, the throughput shape
    # whole, the plain version in sub-batches; K3 on its output
    rng = np.random.default_rng(1)
    dense_obs_host = np.log(
        rng.dirichlet(np.ones(STATES), size=(DENSE_BATCH, DENSE_FRAMES))
        .astype(np.float32) + TINY).astype(np.float32)
    dense_trans_host = np.log(
        rng.dirichlet(np.ones(STATES), size=STATES).astype(np.float32)
        + TINY).astype(np.float32)
    dense_obs = torch.from_numpy(dense_obs_host).to(device)
    dense_trans = torch.from_numpy(dense_trans_host).to(device)
    dense_bf = torch.tensor(
        [DENSE_FRAMES] * (DENSE_BATCH - 2) + [DENSE_FRAMES // 2, 1],
        dtype=torch.int32, device=device)
    if band.detect_band(dense_trans) is not None:
        fail('the random dense transition was detected as banded')
    dense_obs_k = dispatch.convert(dense_obs, True, True).contiguous()

    def dense_reference(args):
        """The plain K2 in sub-batches, to bound its memory"""
        return torch.cat([dense.dense_forward_reference(
            args[0][start:start + DENSE_SUB], args[1][start:start + DENSE_SUB],
            *args[2:])[0] for start in range(0, args[0].shape[0], DENSE_SUB)])

    def plan_text(plan):
        # K2 stages in 16-byte copies always; K1's wide-band design also
        # in loads where the states are off a multiple of 4
        copies = ('16-byte copies' if plan.get('vec', True) else 'loads')
        return (f'{plan["groups"]} groups x {plan["dest_groups"]} CTAs, '
                f'{plan["bc"]} sequences (passes of {plan["bp"]}) x '
                f'{plan["jc"]} destinations a CTA, {plan["threads"]} '
                f'threads, split {plan["split"]}, chunks of {plan["chunk"]} '
                f'sources ({copies}), '
                f'slice {"resident" if plan["resident"] else "streamed"}'
                + (f' over a window of {plan["window"]} sources'
                   if 'window' in plan else '')
                + f', {plan["smem_bytes"]} shared bytes')

    dense_args = (dense_obs_k, dense_bf, dense_trans, init)
    dpost_k, dposterior_k = dense.viterbi_forward_dense(*dense_args)
    dpost_r, _ = dense.dense_forward_reference(*dense_args)
    torch.cuda.synchronize()
    err = require_equal(torch, 'K2 dense_forward at '
                        f'{DENSE_BATCH} x {DENSE_FRAMES} x {STATES}',
                        dpost_k, dpost_r)
    info(f'K2 plan at {DENSE_BATCH} x {STATES}: '
         + plan_text(dense.dense_plan(DENSE_BATCH, STATES, sms)))
    toy_obs = torch.log(torch.tensor([[
        [0.25, 0.5, 0.25],
        [0.25, 0.25, 0.5],
        [0.33, 0.33, 0.33]]], device=device))
    toy_trans = torch.log(torch.tensor([
        [0.5, 0.25, 0.25],
        [0.33, 0.34, 0.33],
        [0.25, 0.25, 0.5]], device=device))
    toy_init = torch.log(torch.tensor([0.4, 0.35, 0.25], device=device))
    toy_bf = torch.tensor([3], dtype=torch.int32, device=device)
    tpost_k, tposterior_k = dense.viterbi_forward_dense(
        toy_obs, toy_bf, toy_trans, toy_init)
    tpost_r, _ = dense.dense_forward_reference(
        toy_obs, toy_bf, toy_trans, toy_init)
    err = max(err, require_equal(
        torch, 'K2 dense_forward (toy)', tpost_k, tpost_r))
    # The plan's edges: one, three and 130 sequences at 96 and 2048 states
    # (at 130 x 2048 the plan streams the transition slice), and 97 and
    # 1203 states (rows off 16 bytes: the padded transition and the
    # exchange, one padded launch each), ragged, with one-frame sequences;
    # random log-probabilities made on the card
    edge_gen = torch.Generator(device).manual_seed(3)
    k2_wrapper = dense.viterbi_forward_dense
    for batch_e, frames_e, states_e in DENSE_EDGES:
        lengths = torch.randint(1, frames_e + 1, (batch_e,),
                                generator=edge_gen, device=device)
        lengths[0] = frames_e
        lengths[-1] = 1
        e_args = (torch.log(torch.rand(
            (batch_e, frames_e, states_e), generator=edge_gen,
            device=device) + TINY), lengths.to(torch.int32),
            torch.log(torch.rand((states_e, states_e), generator=edge_gen,
                                 device=device) + TINY),
            torch.log(torch.rand((states_e,), generator=edge_gen,
                                 device=device) + TINY))
        want = dense_reference(e_args)
        plan = dense.dense_plan(batch_e, states_e, sms)
        padded = k2_wrapper.padded_launches
        err = max(err, require_equal(
            torch, f'K2 dense_forward at {batch_e} x {frames_e} x '
            f'{states_e} ({plan_text(plan)})',
            dense.viterbi_forward_dense(*e_args)[0], want))
        # Both slice modes wherever a plan holds them (the cheapest plan of
        # each): the kernel's two instances (resident or streamed slice)
        for plan in slice_mode_plans(
                dense.dense_plans(batch_e, states_e, sms)):
            err = max(err, require_equal(
                torch, f'K2 dense_forward at {batch_e} x '
                f'{frames_e} x {states_e} ({plan_text(plan)})',
                dense.viterbi_forward_dense(*e_args, plan=plan)[0], want))
        launched = k2_wrapper.padded_launches - padded
        if launched != (1 + len(slice_mode_plans(dense.dense_plans(
                batch_e, states_e, sms)))) * (states_e % 4 != 0):
            fail(f'K2 at {batch_e} x {frames_e} x {states_e}: {launched} '
                 'launches staged through the padded exchange')
        info(f'K2 at {batch_e} x {frames_e} x {states_e}: padded_launches '
             f'+{launched}')
    # The throughput shape, made on the card from seed 0
    big_obs, big_bf, big_trans, big_init = dense_big_inputs(torch, device)
    if band.detect_band(big_trans) is not None:
        fail('the random dense transition at the throughput shape was '
             'detected as banded')
    big_args = (big_obs, big_bf, big_trans, big_init)
    big_plan = dense.dense_plan(DENSE_BIG_BATCH, DENSE_BIG_STATES, sms)
    big_want, big_plain_ms = cuda_once(torch,
                                       lambda: dense_reference(big_args))
    err = max(err, require_equal(
        torch, f'K2 dense_forward at {DENSE_BIG_BATCH} x {DENSE_BIG_FRAMES} '
        f'x {DENSE_BIG_STATES}, all {DENSE_BIG_BATCH} sequences',
        dense.viterbi_forward_dense(*big_args)[0], big_want))
    del big_want
    info(f'K2 plan at {DENSE_BIG_BATCH} x {DENSE_BIG_STATES}: '
         + plan_text(big_plan))
    k2_ms = cuda_ms(torch, lambda: dense.viterbi_forward_dense(*dense_args),
                    iters=5)
    k2_big_ms = cuda_ms(
        torch, lambda: dense.viterbi_forward_dense(*big_args), iters=5)
    k2_plain_ms = cuda_ms(
        torch, lambda: dense.dense_forward_reference(*dense_args), iters=1,
        warmup=0)
    # Bounds: the candidates these inputs need (valid steps x states^2) at
    # the FP32 instructions per candidate of the kernel's loop (SASS, the
    # instance the throughput plan takes: its add and its max), plus the
    # observation add per output; every instruction of the loop, loads
    # and address arithmetic included, is kept beside them as the design's
    # figure; the smem bound at half a shared-memory word per candidate (a
    # thread's 4 x 4 tile loads 16 + 16 words per 4 sources, 64
    # candidates); the bytes: observation in, stream out, the transition
    # once
    k2_loop, k2_per_candidate = sass_loop_instructions(
        build, 'dense_forward',
        f'dense_forward_kernelILb{int(big_plan["resident"])}EE')
    smem_words = 2 * dense.TILE / dense.TILE ** 2

    def dense_bounds(batch, frames, states, lengths):
        steps_d = valid_steps(lengths, frames)
        candidates = steps_d * states * states
        bound = bound_ms(
            (2 * batch * frames * states + states * states + states) * 4,
            candidates * k2_per_candidate + steps_d * states)
        return (bound, candidates,
                candidates * smem_words / smem_words_per_s * 1e3)

    k2_bound, k2_cand, k2_smem = dense_bounds(
        DENSE_BATCH, DENSE_FRAMES, STATES, dense_bf)
    big_bound, big_cand, big_smem = dense_bounds(
        DENSE_BIG_BATCH, DENSE_BIG_FRAMES, DENSE_BIG_STATES, big_bf)
    big_rate = big_cand / (k2_big_ms * 1e-3) / (sms * clock_hz)
    kernels['dense_forward'] = dict(
        name='dense_forward', route='cuda',
        source='torbi_tpu_torch/csrc/dense_forward.cu',
        replaces='torbi_tpu/ops/pallas.py:48', path='dense',
        max_abs_err=err, ms=k2_ms, plain_ms=k2_plain_ms, bound=k2_bound,
        library_ms=None, smem_bound_ms=k2_smem,
        sass_fp32_per_candidate=k2_per_candidate,
        sass_instructions_per_candidate=k2_loop,
        shape=f'{DENSE_BATCH} x {DENSE_FRAMES} x {STATES}',
        throughput_shape=f'{DENSE_BIG_BATCH} x {DENSE_BIG_FRAMES} x '
                         f'{DENSE_BIG_STATES}',
        throughput_ms=k2_big_ms, throughput_plain_ms=big_plain_ms,
        throughput_bound_ms=big_bound[0], throughput_bound_by=big_bound[1],
        throughput_smem_bound_ms=big_smem,
        throughput_candidates_per_sm_clock=big_rate,
        plan=dense.dense_plan(DENSE_BATCH, STATES, sms),
        throughput_plan=dense.dense_plan(
            DENSE_BIG_BATCH, DENSE_BIG_STATES, sms))
    info(f'K2 dense_forward at {DENSE_BATCH} x {DENSE_FRAMES} x {STATES}: '
         f'{k2_ms:.4f} ms, bound {k2_bound[0]:.4f} ({k2_bound[1]}; smem '
         f'{k2_smem:.4f}), plain {k2_plain_ms:.1f} ms; at '
         f'{DENSE_BIG_BATCH} x {DENSE_BIG_FRAMES} x {DENSE_BIG_STATES}: '
         f'{k2_big_ms:.3f} ms, bound {big_bound[0]:.3f} ({big_bound[1]}; '
         f'smem {big_smem:.3f}), plain (in sub-batches of {DENSE_SUB}) '
         f'{big_plain_ms:.1f} ms; {k2_per_candidate:.3f} FP32 SASS '
         f'instructions per candidate ({k2_loop:.3f} in all), '
         f'{big_rate:.2f} candidates per SM and clock '
         '(CUDA events)')
    for label, post, posterior, tr, frames_of in (
            ('dense stream', dpost_k, dposterior_k, dense_trans, dense_bf),
            ('toy stream', tpost_k, tposterior_k, toy_trans, toy_bf)):
        got = backtrace.backtrace_posteriors(post, tr, posterior, frames_of)
        want = backtrace.backtrace_reference(post, tr, posterior, frames_of)
        kernels['backtrace']['max_abs_err'] = max(
            kernels['backtrace']['max_abs_err'],
            require_equal(torch, f'K3 backtrace ({label})', got, want))
    del dpost_k, dpost_r

    # The edge list (utils/edges.py, held against torbi_tpu on the CPU by
    # tests/test_torch_edges.py): K1's cluster design at every cluster
    # size, its wide-band design (the cheapest plan of each slice mode)
    # and K3 on each band edge, K3 on each chase edge, and K3 past 8 x
    # 1024 states (the chase without staging)
    fold_spread_err = 0.0
    for edge in edges.BAND_EDGES:
        e_obs, e_bf, e_trans, e_init = (
            torch.from_numpy(a).to(device)
            for a in edges.band_edge_inputs(edge))
        e_band = band.detect_band(e_trans)
        e_args = (e_obs, e_bf, e_init, e_band, band.build_band_matrix(
            e_trans, e_band[0], e_band[1]))
        e_post, e_posterior = band.band_forward_reference(*e_args)
        for size in band.CLUSTER_TILES:
            got, _ = band._forward_band_clusters(*e_args, size)
            kernels['band_forward']['max_abs_err'] = max(
                kernels['band_forward']['max_abs_err'], require_equal(
                    torch, f'K1 band_forward {edge.name}, {size} per '
                    'cluster', got, e_post))
        for plan in slice_mode_plans(band.wide_plans(
                edge.batch, edge.states, edge.width, sms)):
            kernels['band_forward_wide']['max_abs_err'] = max(
                kernels['band_forward_wide']['max_abs_err'], require_equal(
                    torch, f'K1 band_forward_wide {edge.name} '
                    f'({plan_text(plan)})', band.viterbi_forward_band_wide(
                        *e_args, plan=plan)[0], e_post))
        kernels['backtrace']['max_abs_err'] = max(
            kernels['backtrace']['max_abs_err'], require_equal(
                torch, f'K3 backtrace {edge.name}',
                backtrace.backtrace_posteriors(
                    e_post, e_trans, e_posterior, e_bf),
                backtrace.backtrace_reference(
                    e_post, e_trans, e_posterior, e_bf)))
        # The folded conversion on the edge, with log(tiny) entries: K1 at
        # every cluster size and wide, K4 on each sequence (lanes
        # past the states, sequences past the batch and frames past
        # batch_frames load nothing)
        t_obs, t_rest = with_tiny_entries(e_obs), e_args[1:]
        for size in band.CLUSTER_TILES:
            kernels['band_forward']['max_abs_err'] = max(
                kernels['band_forward']['max_abs_err'], hold_folded(
                    torch, dispatch, f'K1 band_forward folded {edge.name}, '
                    f'{size} per cluster', band._forward_band_clusters,
                    t_obs, t_rest + (size,)))
        kernels['band_forward_wide']['max_abs_err'] = max(
            kernels['band_forward_wide']['max_abs_err'], hold_folded(
                torch, dispatch, f'K1 band_forward_wide folded {edge.name}',
                band.viterbi_forward_band_wide, t_obs, t_rest))
        # K4 on every sequence of the edge, one at a time: against its
        # plain version, and folded in every conversion
        for seq in range(e_obs.shape[0]):
            one = (e_obs[seq:seq + 1].contiguous(),
                   e_bf[seq:seq + 1].contiguous()) + e_args[2:]
            fold_spread_err = max(fold_spread_err, max_abs_err(
                torch, band.viterbi_forward_band_spread(*one)[0],
                band.band_spread_reference(*one)[0]))
            if fold_spread_err:
                fail(f'K4 band_spread {edge.name}, sequence {seq}: differs '
                     f'from its plain version (max abs err '
                     f'{fold_spread_err}; tolerance: bitwise)')
            fold_spread_err = max(fold_spread_err, hold_folded(
                torch, dispatch, f'K4 band_spread folded {edge.name}, '
                f'sequence {seq}', band.viterbi_forward_band_spread,
                t_obs[seq:seq + 1].contiguous(), one[1:]))
    big = torch.Generator(device).manual_seed(2)
    chase_cases = [
        (edge.name, *(torch.from_numpy(a).to(device)
                      for a in edges.chase_edge_inputs(edge)))
        for edge in edges.CHASE_EDGES]
    chase_cases.append((
        f'{BIG_STATES} states',
        torch.randn((3, 6, BIG_STATES), generator=big, device=device),
        torch.randn((BIG_STATES, BIG_STATES), generator=big, device=device),
        torch.tensor([6, 1, 4], dtype=torch.int32, device=device)))
    for name, c_post, c_trans, c_bf in chase_cases:
        kernels['backtrace']['max_abs_err'] = max(
            kernels['backtrace']['max_abs_err'], require_equal(
                torch, f'K3 backtrace {name}', backtrace.backtrace_posteriors(
                    c_post, c_trans, c_post[:, -1], c_bf),
                backtrace.backtrace_reference(
                    c_post, c_trans, c_post[:, -1], c_bf)))
    # K5 on every chase edge, one sequence at a time (a dense transition:
    # its phase 1 over every offset)
    for name, c_post, c_trans, c_bf in chase_cases[:-1]:
        for seq in range(c_post.shape[0]):
            one = c_post[seq:seq + 1].contiguous()
            bf_one = c_bf[seq:seq + 1].contiguous()
            got = backtrace.backtrace_fused1(one, c_trans, one[:, -1], bf_one)
            want = backtrace.backtrace_fused1_reference(
                one, c_trans, one[:, -1], bf_one)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f'K5 backtrace_fused1 {name}, sequence {seq}: differs '
                     f'from its plain version in '
                     f'{int((got != want).sum())} positions (tolerance: '
                     'exact)')
    del chase_cases, c_trans
    info(f'edge list: {len(edges.BAND_EDGES)} band edges (K1 at '
         f'{len(band.CLUSTER_TILES)} cluster sizes and wide in both slice '
         'modes, K3; K4 on '
         f'each sequence; K1 and K4 folded in {len(CONVERSIONS)} '
         f'conversions) and {len(edges.CHASE_EDGES) + 1} chase edges bitwise '
         '(K3; K5 on each sequence of the first '
         f'{len(edges.CHASE_EDGES)})')

    counters = decode_counters()

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counters.items()}

    # 3 + dense path: the README toy and the dense decode through the
    # public entry point, counters reset just before and read just after
    toy_probs = (
        np.array([[[0.25, 0.5, 0.25], [0.25, 0.25, 0.5],
                   [0.33, 0.33, 0.33]]], dtype=np.float32),
        np.array([[0.5, 0.25, 0.25], [0.33, 0.34, 0.33],
                  [0.25, 0.25, 0.5]], dtype=np.float32),
        np.array([0.4, 0.35, 0.25], dtype=np.float32))
    reset_counts()
    k2_wrapper = dense.viterbi_forward_dense
    padded = k2_wrapper.padded_launches
    toy = torbi_tpu_torch.from_probabilities(
        toy_probs[0], transition=toy_probs[1], initial=toy_probs[2],
        gpu=0)
    padded_toy = k2_wrapper.padded_launches - padded
    dense_out = torbi_tpu_torch.from_probabilities(
        dense_obs, batch_frames=dense_bf, transition=dense_trans,
        initial=init, log_probs=True, gpu=0)

    def dense_big(**kwargs):
        return torbi_tpu_torch.from_probabilities(
            big_obs, batch_frames=big_bf, transition=big_trans,
            initial=big_init, log_probs=True, gpu=0, **kwargs)

    dense_big_out = dense_big()
    torch.cuda.synchronize()
    dense_counts = read_counts()
    # The toy's 3 states take the padded sources; 1440 and 1280 states
    # read the transition and the stream in place
    padded_dense = k2_wrapper.padded_launches - padded - padded_toy
    info(f'dense path launches: {dense_counts}; padded_launches: the toy '
         f'+{padded_toy}, {DENSE_BATCH} x {DENSE_FRAMES} x {STATES} and '
         f'{DENSE_BIG_BATCH} x {DENSE_BIG_FRAMES} x {DENSE_BIG_STATES} '
         f'+{padded_dense}')
    if (padded_toy, padded_dense) != (1, 0):
        fail(f'padded_launches: the toy +{padded_toy} (expected 1), the '
             f'1440 and 1280 shapes +{padded_dense} (expected 0)')
    kernels['dense_forward']['padded_launches'] = {
        'toy': padded_toy, f'{STATES} and {DENSE_BIG_STATES}': padded_dense}
    if toy.device != device or toy.dtype != torch.int32:
        fail(f'toy result is {toy.dtype} on {toy.device}')
    if toy.tolist() != [[1, 2, 2]]:
        fail(f'README toy decoded to {toy.tolist()}, expected [[1, 2, 2]]')
    info('README toy decodes to [[1, 2, 2]] on the card')
    if dense_counts['dense_forward'] < 1 or dense_counts['backtrace'] < 1:
        fail('the dense path did not launch the dense forward and '
             'backtrace kernels')
    dense_scan = torbi_tpu_torch.from_probabilities(
        dense_obs, batch_frames=dense_bf, transition=dense_trans,
        initial=init, log_probs=True, gpu=0, backend='scan')
    dense_cpu = torbi_tpu_torch.from_probabilities(
        dense_obs_host, batch_frames=dense_bf.cpu(),
        transition=dense_trans_host, initial=init_host, log_probs=True,
        gpu='cpu')
    if not torch.equal(dense_out, dense_scan):
        fail('dense path differs from the plain scan route on the card')
    if not torch.equal(dense_out.cpu(), dense_cpu):
        fail('dense path differs from the plain route on the CPU')
    info('dense path equals the plain scan route on the card and the '
         'plain route on the CPU')
    if dense_counts['dense_forward'] < 3:
        fail('the dense path at the throughput shape did not launch K2')
    if not torch.equal(dense_big_out, dense_big(backend='scan')):
        fail(f'dense path at {DENSE_BIG_BATCH} x {DENSE_BIG_FRAMES} x '
             f'{DENSE_BIG_STATES} differs from the plain scan route on the '
             'card')
    dense_big_ms = host_ms(torch, dense_big)
    # Traced in a child process: this process traces the headline later
    trace_dir = ROOT / 'build' / 'smoke_trace_dense'
    shutil.rmtree(trace_dir, ignore_errors=True)
    child = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), '--trace-dense',
         str(trace_dir)], capture_output=True, text=True, timeout=600)
    if child.returncode:
        fail(f'the traced dense call failed: {child.stderr[-2000:]}')
    dense_trace = json.loads((trace_dir / 'summary.json').read_text())
    if not dense_trace['device_events']:
        fail('the profiler trace of the dense path holds no device event')
    kernels['dense_forward'].update(
        path_ms=dense_big_ms[0], path_idle_share=dense_trace['idle_share'])
    info(f'dense path at {DENSE_BIG_BATCH} x {DENSE_BIG_FRAMES} x '
         f'{DENSE_BIG_STATES} (from_probabilities): equals the plain scan '
         f'route on the card; {dense_big_ms[0]:.3f} ms/call warm median of '
         f'10 (min {dense_big_ms[1]:.3f}, max {dense_big_ms[2]:.3f}), '
         f'{DENSE_BIG_BATCH * DENSE_BIG_FRAMES / dense_big_ms[0] * 1e3:.0f} '
         f'timesteps/s, on {card}; traced call: device busy '
         f'{dense_trace["busy_s"] * 1e3:.3f} of '
         f'{dense_trace["span_s"] * 1e3:.3f} ms, idle share '
         f'{dense_trace["idle_share"]:.4f}')
    trace_rows(dense_trace, 6)
    del dense_big_out, big_obs, big_args

    # pYIN's HMM on the dense route at the cell's longest batch
    kernels['dense_forward']['pyin'] = pyin_phase(
        torch, device, card, reset_counts, read_counts)

    # madmom's beat tracker on the in-list route at the cell's longest
    # batch, the route's edges, and the gate's threshold
    sparse_times = beats_phase(torch, device, card, reset_counts,
                               read_counts)

    # 4. The banded path (the headline) through from_probabilities
    def headline():
        return torbi_tpu_torch.from_probabilities(
            obs, transition=trans, initial=init, log_probs=True, gpu=0)

    reset_counts()
    band.viterbi_forward_band.dependent_launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    result = headline()
    torch.cuda.synchronize()
    band_counts = read_counts()
    if band.viterbi_forward_band.dependent_launches != 1:
        fail('the banded path launched K1\'s rest as a dependent '
             f'{band.viterbi_forward_band.dependent_launches} times, '
             'expected once')
    kernels['band_forward']['dependent_launches'] = (
        band.viterbi_forward_band.dependent_launches)
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    info(f'banded path launches: {band_counts}')
    if band_counts['band_forward'] < 1 or band_counts['backtrace'] < 1:
        fail('the banded path did not launch the banded forward and '
             'backtrace kernels')
    if band_counts['band_forward_wide']:
        fail('the banded path launched K1\'s wide-band design')
    if tuple(result.shape) != (BATCH, FRAMES) or result.dtype != torch.int32:
        fail(f'headline result is {result.dtype} {tuple(result.shape)}')
    if int(result.min()) < 0 or int(result.max()) >= STATES:
        fail('headline result holds indices out of range')
    plain = torbi_tpu_torch.from_probabilities(
        obs, transition=trans, initial=init, log_probs=True, gpu=0,
        backend='scan')
    if not torch.equal(result, plain):
        fail(f'headline differs from the plain scan route on the card in '
             f'{int((result != plain).sum())} positions')
    del plain
    cpu = torbi_tpu_torch.from_probabilities(
        obs_host[:8], transition=trans_host, initial=init_host,
        log_probs=True, gpu='cpu')
    if not torch.equal(result[:8].cpu(), cpu):
        fail('headline rows 0-7 differ from the plain route on the CPU')
    info('headline equals the plain scan route on the card, and the plain '
         'route on the CPU for rows 0-7')

    times = []
    headline()
    for _ in range(10):
        start = time.perf_counter()
        headline()
        times.append(time.perf_counter() - start)
    median_s = statistics.median(times)
    info(f'headline: {median_s * 1e3:.3f} ms/call warm median of 10 '
         f'(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), '
         f'{BATCH * FRAMES / median_s:.0f} timesteps/s, peak device memory '
         f'{peak_gb:.2f} GB, on {card}')
    # The headline in probability space, as a user with probabilities calls
    # it: from_probabilities(log_probs=False) takes the log of the
    # observation (folded into K1 with the epsilon step), of the transition
    # (a pure -inf band) and of the initial distribution
    prob_obs = torch.exp(obs)
    prob_trans = torch.from_numpy(pitch.transition_matrix()).to(device)

    def headline_prob():
        return torbi_tpu_torch.from_probabilities(
            prob_obs, transition=prob_trans, gpu=0)

    reset_counts()
    prob_result = headline_prob()
    torch.cuda.synchronize()
    prob_counts = read_counts()
    info(f'banded path in probability space launches: {prob_counts}')
    if prob_counts['band_forward'] < 1 or prob_counts['band_forward_wide']:
        fail('the probability-space headline did not take K1\'s cluster '
             'design')
    if not torch.equal(prob_result, torbi_tpu_torch.from_probabilities(
            prob_obs, transition=prob_trans, gpu=0, backend='scan')):
        fail('the probability-space headline differs from the plain scan '
             'route on the card')
    prob_ms = host_ms(torch, headline_prob)
    del prob_obs, prob_result
    info(f'headline, log_probs=False (probabilities, pitch transition as '
         f'probabilities): {prob_ms[0]:.3f} ms/call warm median of 10 (min '
         f'{prob_ms[1]:.3f}, max {prob_ms[2]:.3f}), '
         f'{BATCH * FRAMES / prob_ms[0] * 1e3:.0f} timesteps/s; equals the '
         f'plain scan route on the card; log_probs=True '
         f'{median_s * 1e3:.3f} ms/call')
    info(f'headline per-kernel ms (CUDA events): band_forward '
         f'{kernels["band_forward"]["ms"]:.3f} (plain '
         f'{kernels["band_forward"]["plain_ms"]:.1f}), backtrace '
         f'{kernels["backtrace"]["ms"]:.3f} (plain '
         f'{kernels["backtrace"]["plain_ms"]:.1f}); the epsilon step is '
         f'folded into band_forward (as torch ops alone {convert_ms:.3f})')

    # 5. The batch-1 kernels against their plain versions, at the batch-1
    # shape: one pitch sequence of 10,240 frames (bench.py's generator,
    # seed 1)
    single_host = pitch.synthetic_posteriorgrams(
        1, SINGLE_FRAMES, STATES, seed=1)
    single = torch.from_numpy(single_host).to(device)
    single_k = dispatch.convert(single, True, True).contiguous()
    bf1 = torch.tensor([SINGLE_FRAMES], dtype=torch.int32, device=device)
    steps1 = valid_steps(bf1, SINGLE_FRAMES)

    # K4: the batch-1 banded forward at both serial shapes (1 x 10,240 and
    # 1 x 2048) against its plain version, and K1 on the same sequence for
    # comparison
    post1, posterior1 = band.viterbi_forward_band_spread(
        single_k, bf1, init, band_tuple, band_matrix)
    post1_r, _ = band.band_spread_reference(
        single_k, bf1, init, band_tuple, band_matrix)
    torch.cuda.synchronize()
    err = require_equal(torch, f'K4 band_spread at 1 x {SINGLE_FRAMES}',
                        post1, post1_r)
    del post1_r
    short_k = single_k[:, :SHORT_FRAMES].contiguous()
    bf_short = torch.tensor([SHORT_FRAMES], dtype=torch.int32, device=device)
    post_s, posterior_s = band.viterbi_forward_band_spread(
        short_k, bf_short, init, band_tuple, band_matrix)
    err = max(err, require_equal(
        torch, f'K4 band_spread at 1 x {SHORT_FRAMES}', post_s,
        band.band_spread_reference(
            short_k, bf_short, init, band_tuple, band_matrix)[0]))
    k4_ms = cuda_ms(torch, lambda: band.viterbi_forward_band_spread(
        single_k, bf1, init, band_tuple, band_matrix), iters=3)
    k4_plain_ms = cuda_ms(torch, lambda: band.band_spread_reference(
        single_k, bf1, init, band_tuple, band_matrix), iters=1, warmup=0)
    k1_single_ms = cuda_ms(torch, lambda: band.viterbi_forward_band(
        single_k, bf1, init, band_tuple, band_matrix), iters=1)
    k4_bytes = (2 * SINGLE_FRAMES * STATES + width * STATES + STATES) * 4
    k4_ops = steps1 * (2 * in_range + 3 * STATES)
    k4_layout = band.spread_layout(STATES, width, lo)
    kernels['band_spread'] = dict(
        name='band_spread', route='cuda',
        source='torbi_tpu_torch/csrc/band_spread.cu',
        replaces='torbi_tpu/ops/band.py:843', path='batch1-serial',
        max_abs_err=err, ms=k4_ms, plain_ms=k4_plain_ms,
        bound=bound_ms(k4_bytes, k4_ops), library_ms=None,
        smem_bound_ms=steps1 * in_range / smem_words_per_s * 1e3,
        cluster=band.SPREAD_CLUSTER, chain_frames=steps1,
        tile=f'{k4_layout["threads"]} threads, 4 destinations x '
             f'{k4_layout["dmax"]} offsets a thread')
    info(f'K4 band_spread: {k4_ms:.3f} ms ({k4_ms * 1e3 / steps1:.3f} '
         f'us/frame), plain {k4_plain_ms:.1f} ms; K1 (cluster design) on '
         'the same sequence '
         f'{k1_single_ms:.3f} ms ({k1_single_ms * 1e3 / steps1:.3f} '
         f'us/frame)')
    # K4 as the serial route calls it, the conversion folded in, bitwise
    # against the plain route on the raw sequence (log(tiny) entries
    # included); then timed against the epsilon step plus K4, in turns
    fold1_rest = (bf1, init, band_tuple, band_matrix)
    kernels['band_spread']['max_abs_err'] = max(
        err, fold_spread_err, hold_folded(
            torch, dispatch, 'K4 band_spread folded at 1 x '
            f'{SINGLE_FRAMES}', band.viterbi_forward_band_spread, single,
            fold1_rest))

    def k4_folded():
        return band.viterbi_forward_band_spread(
            single, *fold1_rest, True, True)

    def k4_after_epsilon():
        return band.viterbi_forward_band_spread(
            dispatch.convert(single, True, True).contiguous(), *fold1_rest)

    k4_turns = [cuda_ms(torch, fn, iters=3) for fn in (
        k4_folded, k4_after_epsilon, k4_after_epsilon, k4_folded)]
    k4_all_ops = k4_ops + (1 + steps1) * STATES * conv_per_value
    kernels['band_spread'].update(
        ms=(k4_turns[0] + k4_turns[3]) / 2, unfolded_ms=k4_ms,
        epsilon_plus_kernel_ms=(k4_turns[1] + k4_turns[2]) / 2,
        bound=bound_ms(k4_bytes, k4_all_ops),
        cluster_bound_ms=k4_all_ops / (
            profile.FP32_LANES_PER_SM * band.SPREAD_CLUSTER * clock_hz) * 1e3)
    kernels['band_spread']['max_abs_err'] = max(
        kernels['band_spread']['max_abs_err'], hold_folded(
            torch, dispatch, f'K4 band_spread folded at 1 x {SHORT_FRAMES}',
            band.viterbi_forward_band_spread,
            single[:, :SHORT_FRAMES].contiguous(),
            (bf_short, init, band_tuple, band_matrix)))
    info(f'K4 folded against the epsilon step + K4, in turns (ms): folded '
         f'{k4_turns[0]:.3f}, epsilon + K4 {k4_turns[1]:.3f}, epsilon + K4 '
         f'{k4_turns[2]:.3f}, folded {k4_turns[3]:.3f} (K4 alone on a '
         f'converted sequence {k4_ms:.3f})')

    # K4's widest band: the widest band that band.spread_fits
    # admits at 1440 states runs bitwise against the plain version; one
    # offset wider the kernel refuses, so dispatch and kernel agree
    wide_host = fixtures.triangular_log(STATES, WIDE_HALFWIDTH, TINY)
    wide = torch.from_numpy(wide_host).to(device)
    wide_band = band.detect_band(wide)
    if band.spread_fits(STATES, wide_band[1]):
        fail(f'the band {wide_band} fits K4; expected it too wide')
    edge = max(w for w in range(1, wide_band[1])
               if band.spread_fits(STATES, w))
    edge_lo = -(edge // 2)
    edge_obs = single_k[:, :EDGE_FRAMES].contiguous()
    bf_edge = torch.tensor([EDGE_FRAMES], dtype=torch.int32, device=device)
    edge_args = (edge_obs, bf_edge, init, (edge_lo, edge, wide_band[2]),
                 band.build_band_matrix(wide, edge_lo, edge))
    edge_post, _ = band.viterbi_forward_band_spread(*edge_args)
    edge_post_r, _ = band.band_spread_reference(*edge_args)
    torch.cuda.synchronize()
    err = max(err, require_equal(
        torch, f'K4 band_spread (width {edge}, its widest at {STATES} states)',
        edge_post, edge_post_r))
    kernels['band_spread']['max_abs_err'] = max(
        kernels['band_spread']['max_abs_err'], err)
    del edge_post, edge_post_r
    try:
        band.viterbi_forward_band_spread(
            edge_obs, bf_edge, init, (edge_lo, edge + 1, wide_band[2]),
            band.build_band_matrix(wide, edge_lo, edge + 1))
        torch.cuda.synchronize()
    except RuntimeError as error:
        info(f'K4 refuses width {edge + 1}: {error}')
    else:
        fail(f'K4 launched a band of width {edge + 1}, which '
             f'band.spread_fits refuses')

    # K5: phase 1's table and phase 2's path on that table against their
    # plain versions, then the path of both phases against the step-by-step
    # chase (backtrace_fused1_reference) on both serial shapes; timed per
    # phase and as one call; K3 for comparison
    table = backtrace.backtrace_pointers(post1, band_tuple, band_matrix, bf1)
    table_r, table_plain_ms = cuda_once(
        torch, lambda: backtrace.backtrace_pointers_reference(
            post1, band_tuple, band_matrix, bf1))
    table_err = require_equal(
        torch, f'K5 phase 1 (backtrace_pointers) table at 1 x '
        f'{SINGLE_FRAMES}', table, table_r)
    del table_r
    block = backtrace.chase_block(STATES)
    chased_r, chase_plain_ms = cuda_once(
        torch, lambda: backtrace.chase_pointers_reference(
            table, posterior1, bf1, block))
    chase_err = require_equal(
        torch, f'K5 phase 2 (chase_pointers) path at 1 x {SINGLE_FRAMES} '
        f'in blocks of {block}', backtrace.chase_pointers(
            table, posterior1, bf1), chased_r)
    del chased_r
    idx1 = backtrace.backtrace_fused1(
        post1, trans, posterior1, bf1, band_tuple, band_matrix)
    idx1_r = backtrace.backtrace_fused1_reference(
        post1, trans, posterior1, bf1)
    torch.cuda.synchronize()
    err = require_equal(torch, f'K5 backtrace_fused1 at 1 x {SINGLE_FRAMES}',
                        idx1, idx1_r)
    err = max(err, require_equal(
        torch, f'K5 backtrace_fused1 at 1 x {SHORT_FRAMES}',
        backtrace.backtrace_fused1(post_s, trans, posterior_s, bf_short,
                                   band_tuple, band_matrix),
        backtrace.backtrace_fused1_reference(
            post_s, trans, posterior_s, bf_short)))
    del post_s, posterior_s
    k5_ms = cuda_ms(torch, lambda: backtrace.backtrace_fused1(
        post1, trans, posterior1, bf1, band_tuple, band_matrix), iters=5)
    k5_phase_ms = (
        cuda_ms(torch, lambda: backtrace.backtrace_pointers(
            post1, band_tuple, band_matrix, bf1), iters=5),
        cuda_ms(torch, lambda: backtrace.chase_pointers(
            table, posterior1, bf1), iters=5))
    del table
    k5_plain_ms = cuda_ms(torch, lambda: backtrace.backtrace_fused1_reference(
        post1, trans, posterior1, bf1), iters=1, warmup=0)
    k3_single_ms = cuda_ms(torch, lambda: backtrace.backtrace_posteriors(
        post1, trans, posterior1, bf1), iters=1)
    # The bounds of the parallel design. Phase 1: the in-band candidates at
    # the instructions per candidate of its compiled loop (SASS) and the
    # floor's row argmax (an add, a compare, a select per value); the
    # stream rows it reads, the band matrix, the int16 table it writes.
    # Phase 2: one lookup per state and step; the table it reads, the
    # posterior, the path it writes
    per_candidate = sass_pointer_instructions(build, 'pointers_kernelILb1E')
    k5_ops = steps1 * (in_range * per_candidate + 3 * STATES)
    k5_bytes = (steps1 * STATES + width * STATES) * 4 + SINGLE_FRAMES * (
        STATES * 2)
    chase_ops = steps1 * STATES
    chase_bytes = SINGLE_FRAMES * STATES * 2 + (STATES + SINGLE_FRAMES) * 4
    k5_common = dict(
        route='cuda', source='torbi_tpu_torch/csrc/backtrace_batch1.cu',
        replaces='torbi_tpu/ops/backtrace.py:652', path='batch1-serial',
        library_ms=None)
    kernels['backtrace_pointers'] = dict(
        k5_common, name='backtrace_pointers', max_abs_err=table_err,
        ms=k5_phase_ms[0], plain_ms=table_plain_ms,
        bound=bound_ms(k5_bytes, k5_ops),
        sass_instructions_per_candidate=per_candidate,
        fused1_ms=k5_ms, fused1_reference_ms=k5_plain_ms,
        fused1_max_abs_err=err, chain_steps_removed=steps1)
    kernels['chase_pointers'] = dict(
        k5_common, name='chase_pointers', max_abs_err=max(chase_err, err),
        ms=k5_phase_ms[1], plain_ms=chase_plain_ms,
        bound=bound_ms(chase_bytes, chase_ops), block_frames=block)
    info(f'K5 backtrace_fused1: {k5_ms:.3f} ms (phase 1 '
         f'{k5_phase_ms[0]:.3f}, phase 2 {k5_phase_ms[1]:.3f}; '
         f'{per_candidate:.3f} SASS instructions per phase-1 candidate), '
         f'plain {k5_plain_ms:.1f} ms (phase 1 alone {table_plain_ms:.1f}, '
         f'phase 2 alone {chase_plain_ms:.1f}); '
         f'K3 on the same stream {k3_single_ms:.3f} ms '
         f'({k3_single_ms * 1e3 / steps1:.3f} us/step)')
    del post1, posterior1

    # K6: the window chase on a pure -inf band (the triangular transition
    # of tests/test_autochunk.py at the pitch band's half-width), K5's two
    # phases without the floor pass: its phase-1 table against its plain
    # version, its path against its plain version (the full chase) and K5
    # at 1 x 10,240 and 1 x 2048 and on the pure-band edges, one sequence
    # at a time; timed per phase
    pure = torch.from_numpy(
        fixtures.triangular_log(STATES, WINDOW_HALFWIDTH, 0.0)).to(device)
    pure_band = band.detect_band(pure)
    if pure_band is None or pure_band[2] is not None:
        fail(f'unexpected band {pure_band} for the pure -inf band')
    pure_matrix = band.build_band_matrix(pure, pure_band[0], pure_band[1])
    wpost, wposterior = band.viterbi_forward_band_spread(
        single_k, bf1, init, pure_band, pure_matrix)
    table6 = backtrace.window_pointers(wpost, pure_band, pure_matrix, bf1)
    table6_r, table6_plain_ms = cuda_once(
        torch, lambda: backtrace.backtrace_pointers_reference(
            wpost, pure_band, pure_matrix, bf1))
    err = require_equal(
        torch, f'K6 phase 1 (window_pointers) table at 1 x {SINGLE_FRAMES}',
        table6, table6_r)
    del table6_r
    window_cases = [(f'1 x {SINGLE_FRAMES}', wpost, wposterior, bf1, pure,
                     pure_band, pure_matrix)]
    short_post = wpost[:, :SHORT_FRAMES].contiguous()
    window_cases.append((f'1 x {SHORT_FRAMES}', short_post,
                         short_post[:, -1], bf_short, pure, pure_band,
                         pure_matrix))
    for edge in edges.BAND_EDGES:
        if edge.floor:
            continue
        e_obs, e_bf, e_trans, e_init = (
            torch.from_numpy(x).to(device)
            for x in edges.band_edge_inputs(edge))
        e_band = band.detect_band(e_trans)
        e_matrix = band.build_band_matrix(e_trans, e_band[0], e_band[1])
        e_post, _ = band.band_forward_reference(
            e_obs, e_bf, e_init, e_band, e_matrix)
        for seq in range(e_obs.shape[0]):
            one = e_post[seq:seq + 1].contiguous()
            window_cases.append((
                f'{edge.name}, sequence {seq}', one, one[:, -1],
                e_bf[seq:seq + 1].contiguous(), e_trans, e_band, e_matrix))
    for label, w_post, w_posterior, w_bf, w_trans, w_band, w_matrix in (
            window_cases):
        got = backtrace.backtrace_window(
            w_post, w_trans, w_posterior, w_bf, w_band, w_matrix)
        for what, want in (
                ('its plain version', backtrace.backtrace_window_reference(
                    w_post, w_trans, w_posterior, w_bf, w_band)),
                ('K5', backtrace.backtrace_fused1(
                    w_post, w_trans, w_posterior, w_bf, w_band, w_matrix))):
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f'K6 backtrace_window {label}: differs from {what} in '
                     f'{int((got != want).sum())} positions (tolerance: '
                     'exact)')
        got = backtrace.window_pointers(w_post, w_band, w_matrix, w_bf)
        want = backtrace.backtrace_pointers_reference(
            w_post, w_band, w_matrix, w_bf)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f'K6 phase 1 table {label}: differs from its plain version '
                 f'in {int((got != want).sum())} entries (tolerance: exact)')
    info(f'K6 backtrace_window: table and path equal to their plain '
         f'versions and the path to K5 on {len(window_cases)} pure-band '
         'sequences (1 x 10,240, 1 x 2048, every sequence of the pure band '
         'edges; tolerance: exact)')
    idx6 = backtrace.backtrace_window(
        wpost, pure, wposterior, bf1, pure_band, pure_matrix)
    k6_ms = cuda_ms(torch, lambda: backtrace.backtrace_window(
        wpost, pure, wposterior, bf1, pure_band, pure_matrix), iters=5)
    k6_phase_ms = (
        cuda_ms(torch, lambda: backtrace.window_pointers(
            wpost, pure_band, pure_matrix, bf1), iters=5),
        cuda_ms(torch, lambda: backtrace.chase_pointers(
            table6, wposterior, bf1), iters=5))
    k6_plain_ms = cuda_ms(
        torch, lambda: backtrace.backtrace_window_reference(
            wpost, pure, wposterior, bf1, pure_band), iters=1, warmup=0)
    # The bound of the function: the chase along this path reads the
    # window of each step (its stream row and transition row) and writes
    # the path, a chain of steps1 dependent steps that no throughput bound
    # sees. Beside it, the design's own figure: phase 1's in-band
    # candidates at the FP32 SASS instructions per candidate of its loop
    # (no floor term) and phase 2's lookup per state and step; the stream
    # rows and band matrix read, the table written and read again, the
    # path written
    lo_w, width_w = pure_band[0], pure_band[1]
    per_candidate6 = sass_pointer_instructions(build, 'pointers_kernelILb0E')
    k6_ops = steps1 * (in_range_pairs(STATES, lo_w, width_w) * per_candidate6
                       + STATES)
    k6_bytes = ((steps1 * STATES + width_w * STATES) * 4
                + 2 * SINGLE_FRAMES * STATES * 2
                + (STATES + SINGLE_FRAMES) * 4)
    path_states = idx6[0, 1:].long()
    window = int((torch.clamp(path_states + lo_w + width_w, max=STATES)
                  - torch.clamp(path_states + lo_w, min=0)).sum())
    chase_bound = bound_ms((2 * window + STATES + SINGLE_FRAMES) * 4,
                           2 * window + 2 * STATES)
    design_bound = bound_ms(k6_bytes, k6_ops)
    kernels['backtrace_window'] = dict(
        name='backtrace_window', route='cuda',
        source='torbi_tpu_torch/csrc/backtrace_batch1.cu',
        replaces='torbi_tpu/ops/backtrace.py:458', path='batch1-window',
        max_abs_err=err, ms=k6_ms, plain_ms=k6_plain_ms,
        bound=chase_bound, library_ms=None, chain_steps=steps1,
        phase1_ms=k6_phase_ms[0], phase2_ms=k6_phase_ms[1],
        phase1_plain_ms=table6_plain_ms,
        sass_fp32_per_candidate=per_candidate6,
        design_bound_ms=design_bound[0], design_bound_by=design_bound[1])
    info(f'K6 backtrace_window: {k6_ms:.4f} ms (phase 1 '
         f'{k6_phase_ms[0]:.4f}, phase 2 {k6_phase_ms[1]:.4f}; '
         f'{per_candidate6:.3f} FP32 SASS instructions per phase-1 '
         f'candidate), bound {chase_bound[0]:.5f} ({chase_bound[1]}; the '
         f'chase along the path, a chain of {steps1} steps), the two '
         f'phases\' own work {design_bound[0]:.4f} ({design_bound[1]}); '
         f'plain {k6_plain_ms:.1f} ms (phase 1 alone {table6_plain_ms:.1f})')
    del wpost, wposterior, table6, window_cases

    # 6. The batch-1 paths through from_probabilities, counters reset just
    # before and read just after each
    from torbi_tpu_torch.ops import autochunk

    def run_path(label, fn, frames=SINGLE_FRAMES):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        info(f'{label} launches: {counts}')
        if tuple(out.shape) != (1, frames) or out.dtype != torch.int32:
            fail(f'{label} result is {out.dtype} {tuple(out.shape)}')
        if int(out.min()) < 0 or int(out.max()) >= STATES:
            fail(f'{label} result holds indices out of range')
        return out, counts

    def single_call(obs_in=single, trans_in=trans, **kwargs):
        return torbi_tpu_torch.from_probabilities(
            obs_in, transition=trans_in, initial=init, log_probs=True,
            gpu=0, **kwargs)

    def require_same(label, got, expected, what):
        if not torch.equal(got, expected):
            fail(f'{label} differs from {what} in '
                 f'{int((got != expected).sum())} positions')
        info(f'{label} equals {what}')

    single_paths = {}

    # The default route: entropy-chunk rows through K1 and K3
    route = autochunk.decode_chunked
    plan_bytes = route.plan_bytes
    band.viterbi_forward_band.dependent_launches = 0
    chunked, chunk_counts = run_path('batch-1 auto-chunk path', single_call)
    plan_bytes = route.plan_bytes - plan_bytes
    if band.viterbi_forward_band.dependent_launches:
        fail('the auto-chunk path launched K1 as a dependent')
    if chunk_counts['band_forward'] < 1 or chunk_counts['backtrace'] < 1:
        fail('the auto-chunk path did not launch K1 and K3')
    if (chunk_counts['band_spread'] or chunk_counts['backtrace_pointers']
            or chunk_counts['chase_pointers']):
        fail('the auto-chunk path launched a batch-1 kernel')
    if chunk_counts['band_forward_wide']:
        fail('the auto-chunk path launched K1\'s wide-band design')
    entropy = autochunk.framewise_entropy(single, STATES, True).cpu().numpy()
    plan = autochunk.plan_splits(
        entropy, SINGLE_FRAMES, torbi_tpu_torch.BATCH1_CHUNK_FRAMES)
    if plan is None:
        fail('no auto-chunk plan for the peaked pitch sequence')
    starts, lengths = plan
    info(f'auto-chunk plan: {len(starts)} rows, longest chunk '
         f'{int(lengths.max())} frames, {plan_bytes} plan bytes to the card '
         f'(decode_chunked.plan_bytes), starts {starts.tolist()}')
    if plan_bytes != 8 * len(starts):
        fail(f'the auto-chunk call copied {plan_bytes} plan bytes to the '
             f'card, not its starts and lengths ({8 * len(starts)})')
    per_chunk = torch.cat([
        single_call(single[:, start:start + length], backend='scan')
        for start, length in zip(starts.tolist(), lengths.tolist())], dim=1)
    require_same('auto-chunk path', chunked, per_chunk,
                 'the plain scan route decoded chunk by chunk on its plan')
    # The batch-1 latency: a new observation every call, as a user's file
    # is; then a host array every call (the copy to the card included);
    # then one buffer and batch_frames tensor decoded again. Every call
    # pays the entropy pass, its host round trip, the plan and its copy to
    # the card
    def timed_route(label, fn, want_bytes):
        """host_ms of an auto-chunk call, and the plan bytes it copied to
        the card a call (decode_chunked.plan_bytes) over host_ms's 11 calls,
        after one more"""
        fn()
        before = route.plan_bytes
        single_paths[label] = host_ms(torch, fn, calls=10)
        per_call = (route.plan_bytes - before) / 11
        info(f'batch-1 {label}: {per_call:.0f} plan bytes to the card a call')
        if per_call != want_bytes:
            fail(f'batch-1 {label} copied {per_call} plan bytes to the card '
                 f'a call, expected {want_bytes}')

    fresh = iter([single.clone() for _ in range(12)])
    timed_route('auto-chunk, new tensor each call',
                lambda: single_call(next(fresh)), 8 * len(starts))
    del fresh
    timed_route('auto-chunk, host array each call',
                lambda: single_call(single_host), 8 * len(starts))
    timed_route('auto-chunk, same buffer again',
                lambda: single_call(batch_frames=bf1), 8 * len(starts))
    entropy_ms = cuda_ms(torch, lambda: autochunk.framewise_entropy(
        single, STATES, True), iters=5)
    start = time.perf_counter()
    autochunk.plan_splits(
        autochunk.framewise_entropy(single, STATES, True).cpu().numpy(),
        SINGLE_FRAMES, torbi_tpu_torch.BATCH1_CHUNK_FRAMES)
    plan_ms = (time.perf_counter() - start) * 1e3
    info(f'auto-chunk plan: entropy pass {entropy_ms:.3f} ms (CUDA events), '
         f'entropy to the host and plan {plan_ms:.3f} ms (host clock)')
    # Where the route's time goes: K1 and K3 on its chunk rows, timed alone
    longest = int(lengths.max())
    gather = torch.from_numpy(np.minimum(
        starts[:, None] + np.arange(longest)[None, :],
        SINGLE_FRAMES - 1)).to(device)
    rows = dispatch.convert(single[0][gather], True, True).contiguous()
    row_frames = torch.from_numpy(lengths).to(device)
    rows_args = (rows, row_frames, init, band_tuple, band_matrix)
    n_rows = len(starts)
    (rows_post, rows_posterior), rows_plain_ms = cuda_once(
        torch, lambda: band.band_forward_reference(*rows_args))
    for kernel, fn in (('band_forward', band.viterbi_forward_band),
                       ('band_forward_wide', band.viterbi_forward_band_wide)):
        kernels[kernel]['max_abs_err'] = max(
            kernels[kernel]['max_abs_err'], require_equal(
                torch, f'K1 {kernel} on the auto-chunk rows',
                fn(*rows_args)[0], rows_post))
    rows_idx, rows_k3_plain_ms = cuda_once(
        torch, lambda: backtrace.backtrace_reference(
            rows_post, trans, rows_posterior, row_frames))
    kernels['backtrace']['max_abs_err'] = max(
        kernels['backtrace']['max_abs_err'], require_equal(
            torch, 'K3 backtrace on the auto-chunk rows',
            backtrace.backtrace_posteriors(
                rows_post, trans, rows_posterior, row_frames), rows_idx))
    rows_turns = [cuda_ms(torch, lambda: fn(*rows_args), iters=3) for fn in (
        band.viterbi_forward_band, band.viterbi_forward_band_wide,
        band.viterbi_forward_band_wide, band.viterbi_forward_band)]
    rows_k1_ms = (rows_turns[0] + rows_turns[3]) / 2
    # The rows as the route hands them to K1: gathered raw, converted in
    # the kernel. Folded K1 (the plan, every cluster size, wide) bitwise
    # against the plain route, then timed against the epsilon step plus K1
    raw_rows = single[0][gather]
    raw_rest = rows_args[1:]
    kernels['band_forward']['max_abs_err'] = max(
        kernels['band_forward']['max_abs_err'], hold_folded(
            torch, dispatch, 'K1 band_forward folded on the auto-chunk rows',
            band.viterbi_forward_band, raw_rows, raw_rest))
    for size in band.CLUSTER_TILES:
        kernels['band_forward']['max_abs_err'] = max(
            kernels['band_forward']['max_abs_err'], hold_folded(
                torch, dispatch, 'K1 band_forward folded on the auto-chunk '
                f'rows, {size} per cluster', band._forward_band_clusters,
                raw_rows, raw_rest + (size,)))
    kernels['band_forward_wide']['max_abs_err'] = max(
        kernels['band_forward_wide']['max_abs_err'], hold_folded(
            torch, dispatch, 'K1 band_forward_wide folded on the auto-chunk '
            'rows', band.viterbi_forward_band_wide, raw_rows, raw_rest))
    rows_fold_turns = [cuda_ms(torch, fn, iters=3) for fn in (
        lambda: band.viterbi_forward_band(raw_rows, *raw_rest, True, True),
        lambda: band.viterbi_forward_band(
            dispatch.convert(raw_rows, True, True).contiguous(), *raw_rest),
        lambda: band.viterbi_forward_band(
            dispatch.convert(raw_rows, True, True).contiguous(), *raw_rest),
        lambda: band.viterbi_forward_band(raw_rows, *raw_rest, True, True))]
    info('K1 folded against the epsilon step + K1 on the auto-chunk rows, '
         'in turns (ms): ' + ', '.join(f'{ms:.3f}' for ms in rows_fold_turns)
         + f' (folded, epsilon + K1, epsilon + K1, folded; K1 alone on '
         f'converted rows {rows_k1_ms:.3f})')
    rows_k3_ms = cuda_ms(torch, lambda: backtrace.backtrace_posteriors(
        rows_post, trans, rows_posterior, row_frames), iters=5)
    rows_steps = valid_steps(row_frames, longest)
    rows_k1_bound = bound_ms(
        (2 * n_rows * longest * STATES + width * STATES + STATES) * 4,
        rows_steps * (2 * in_range + 3 * STATES)
        + (n_rows + rows_steps) * STATES * conv_per_value)
    rows_k3_bound = bound_ms(
        (rows_steps * STATES + n_rows * STATES + STATES * STATES
         + n_rows * longest) * 4, (rows_steps + n_rows) * 2 * STATES)
    rows_plan = band.cluster_plan(n_rows, STATES, width, resident.get)
    kernels['band_forward'].update(
        rows_ms=(rows_fold_turns[0] + rows_fold_turns[3]) / 2,
        rows_unfolded_ms=rows_k1_ms,
        rows_epsilon_plus_kernel_ms=(rows_fold_turns[1]
                                     + rows_fold_turns[2]) / 2,
        rows_plain_ms=rows_plain_ms,
        rows_bound_ms=rows_k1_bound[0], rows_bound_by=rows_k1_bound[1],
        rows_smem_bound_ms=rows_steps * in_range / smem_words_per_s * 1e3,
        rows_launches=chunk_counts['band_forward'])
    # A finding, not a route: the wide-band design on the pitch band's
    # rows beside the cluster design that serves them
    kernels['band_forward_wide'].update(
        pitch_rows_ms=(rows_turns[1] + rows_turns[2]) / 2,
        pitch_rows_cluster_ms=rows_k1_ms)
    info('K1 band bytes from L2 on the auto-chunk rows, estimated from the '
         'launch layout as at the headline, not measured: cluster '
         f'{clusters_of(rows_plan) * width * STATES * 4:.4g}')
    kernels['backtrace'].update(
        rows_ms=rows_k3_ms, rows_plain_ms=rows_k3_plain_ms,
        rows_bound_ms=rows_k3_bound[0], rows_bound_by=rows_k3_bound[1],
        rows_launches=chunk_counts['backtrace'])
    info(f'auto-chunk rows ({n_rows} x {longest} x {STATES}, cluster plan '
         f'{rows_plan}): K1 in turns (ms) cluster {rows_turns[0]:.3f}, '
         f'wide {rows_turns[1]:.3f}, wide {rows_turns[2]:.3f}, cluster '
         f'{rows_turns[3]:.3f} ({rows_k1_ms * 1e3 / (longest - 1):.3f} '
         f'us/frame), plain {rows_plain_ms:.1f}, bound '
         f'{rows_k1_bound[0]:.4f} ({rows_k1_bound[1]}); K3 {rows_k3_ms:.3f} '
         f'ms ({rows_k3_ms * 1e3 / (longest - 1):.3f} us/step), plain '
         f'{rows_k3_plain_ms:.1f}, bound {rows_k3_bound[0]:.4f} '
         f'({rows_k3_bound[1]}) (CUDA events)')
    del rows, rows_args, rows_post, rows_posterior, rows_idx, raw_rows

    # The serial routes, auto-chunking off: K4 then K5; then the window
    # chase on the pure band
    knobs = ('BATCH1_AUTO_CHUNK', 'BACKTRACE_BATCH1_FUSED',
             'BACKTRACE_BATCH1_WINDOW')
    saved = {name: getattr(torbi_tpu_torch, name) for name in knobs}
    try:
        torbi_tpu_torch.BATCH1_AUTO_CHUNK = False
        serial, serial_counts = run_path('batch-1 serial path', single_call)
        if (serial_counts['band_spread'] < 1
                or not k5_launched(serial_counts)):
            fail('the serial batch-1 path did not launch K4 and K5')
        require_same('serial batch-1 path', serial,
                     single_call(backend='scan'),
                     'the plain scan route on the card')
        info(f'auto-chunk and serial paths differ in '
             f'{int((chunked != serial).sum())} of {SINGLE_FRAMES} frames')
        single_paths['serial K4+K5'] = host_ms(torch, single_call)

        torbi_tpu_torch.BACKTRACE_BATCH1_FUSED = False
        torbi_tpu_torch.BACKTRACE_BATCH1_WINDOW = True
        windowed, window_counts = run_path(
            'batch-1 window path', lambda: single_call(trans_in=pure))
        if (window_counts['backtrace_window'] < 1
                or window_counts['chase_pointers'] < 1
                or window_counts['band_spread'] < 1):
            fail('the window path did not launch K4 and both phases of K6')
        if window_counts['backtrace_pointers']:
            fail('the window path launched K5\'s phase 1, which holds the '
                 'floor pass')
        require_same('window path', windowed,
                     single_call(trans_in=pure, backend='scan'),
                     'the plain scan route on the card')
        single_paths['serial K4+K6 (pure band)'] = host_ms(
            torch, lambda: single_call(trans_in=pure))
    finally:
        for name, value in saved.items():
            setattr(torbi_tpu_torch, name, value)

    # A band too wide for K4 takes K1's cluster design, then K5
    wide_out, wide_counts = run_path(
        'batch-1 band past K4 path',
        lambda: single_call(single[:, :EDGE_FRAMES], trans_in=wide),
        EDGE_FRAMES)
    if (wide_counts['band_forward'] < 1 or wide_counts['band_spread']
            or wide_counts['band_forward_wide']
            or not k5_launched(wide_counts)):
        fail('the band past K4 did not take K1\'s cluster design and K5')
    require_same('band past K4 path', wide_out,
                 single_call(single[:, :EDGE_FRAMES], trans_in=wide,
                             backend='scan'),
                 'the plain scan route on the card')

    # The wide-band paths: bands that no cluster layout of K1 holds take
    # its wide-band design (one persistent CTA per SM)
    def wide_against_dense(raw, args, transition, iters):
        """The wide-band design with the epsilon step folded in, and K2 on
        the same transition as a dense matrix (the same function; the
        observation converted first), timed in turns (wide, K2, K2, wide);
        then the wide-band design on the converted observation. Returns
        (wide ms, K2 ms, unfolded wide ms, the turns)"""
        converted = dispatch.convert(raw, True, True).contiguous()

        def wide_call():
            return band.viterbi_forward_band_wide(raw, *args[1:], True, True)

        def dense_call():
            return dense.viterbi_forward_dense(
                converted, args[1], transition, args[2])

        turns = [cuda_ms(torch, fn, iters=iters) for fn in (
            wide_call, dense_call, dense_call, wide_call)]
        unfolded = cuda_ms(torch, lambda: band.viterbi_forward_band_wide(
            converted, *args[1:]), iters=iters)
        return (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, \
            unfolded, turns

    def wide_bound(batch, frames, states, lengths, wide_band):
        """The wide-band function's bound on these inputs: the observation
        in and the stream out, the band once; an add and a max per
        in-range candidate, per state the floor max, the posterior max and
        the observation add, and the folded conversion per value"""
        steps_w = valid_steps(lengths, frames)
        pairs = in_range_pairs(states, wide_band[0], wide_band[1])
        return bound_ms(
            (2 * batch * frames * states + wide_band[1] * states + states)
            * 4, steps_w * (2 * pairs + 3 * states)
            + (batch + steps_w) * states * conv_per_value)

    wide_entry = kernels['band_forward_wide']
    wide_sass, wide_sass_fp32 = sass_loop_instructions(
        build, 'band_wide', 'band_wide_kernelILb1ELb1E')
    wide_entry.update(sass_fp32_per_candidate=wide_sass_fp32,
                      sass_instructions_per_candidate=wide_sass)

    # (a) A band of width 401 over log(tiny) on one sequence of 256
    # frames: the kernel against its plain version and K2's dense matrix,
    # folded in every conversion, timed; then the path through
    # from_probabilities (K1, then K5)
    band401_trans = torch.from_numpy(
        fixtures.triangular_log(STATES, BAND401_HALFWIDTH, TINY)).to(device)
    band401 = band.detect_band(band401_trans)
    if band.forward_kernel(STATES, band401[1])[0] != 'band_forward_wide':
        fail(f'the band {band401} fits a cluster layout; expected it too '
             'wide')
    a_raw = single[:, :EDGE_FRAMES].contiguous()
    a_args = (edge_obs, bf_edge, init, band401, band.build_band_matrix(
        band401_trans, band401[0], band401[1]))
    (a_post_r, _), a_plain_ms = cuda_once(
        torch, lambda: band.band_forward_reference(*a_args))
    a_plan = band.wide_plan(1, STATES, band401[1], sms)
    wide_entry['max_abs_err'] = max(
        wide_entry['max_abs_err'], require_equal(
            torch, f'K1 band_forward_wide (a) 1 x {EDGE_FRAMES} x {STATES}, '
            f'width {band401[1]} ({plan_text(a_plan)})',
            band.viterbi_forward_band_wide(*a_args)[0], a_post_r),
        require_equal(
            torch, f'K2 dense_forward on the width-{band401[1]} transition '
            'as a dense matrix (a), against the wide-band plain version',
            dense.viterbi_forward_dense(
                edge_obs, bf_edge, band401_trans, init)[0], a_post_r))
    del a_post_r
    wide_entry['max_abs_err'] = max(
        wide_entry['max_abs_err'], hold_folded(
            torch, dispatch, f'K1 band_forward_wide folded (a), width '
            f'{band401[1]}', band.viterbi_forward_band_wide,
            with_tiny_entries(a_raw), a_args[1:]))
    a_ms, a_dense_ms, a_unfolded_ms, a_turns = wide_against_dense(
        a_raw, a_args, band401_trans, iters=5)
    a_steps = valid_steps(bf_edge, EDGE_FRAMES)
    a_bound = wide_bound(1, EDGE_FRAMES, STATES, bf_edge, band401)
    wide_entry.update(
        ms=a_ms, unfolded_ms=a_unfolded_ms, plain_ms=a_plain_ms,
        bound=a_bound, library_ms=None, dense_k2_ms=a_dense_ms,
        shape=f'1 x {EDGE_FRAMES} x {STATES}, width {band401[1]}',
        plan=a_plan)
    info(f'K1 band_forward_wide (a) at width {band401[1]} (1 x '
         f'{EDGE_FRAMES}): folded {a_ms:.3f} ms ({a_ms * 1e3 / a_steps:.3f} '
         f'us/frame; in turns against K2 on the dense matrix: '
         + ', '.join(f'{ms:.3f}' for ms in a_turns)
         + f': wide, K2, K2, wide; on a converted sequence '
         f'{a_unfolded_ms:.3f}), plain {a_plain_ms:.1f} ms, bound '
         f'{a_bound[0]:.4f} ({a_bound[1]}); {wide_sass_fp32:.3f} FP32 SASS '
         f'instructions per candidate ({wide_sass:.3f} in all)')
    a_out, a_counts = run_path(
        'wide-band path (a)',
        lambda: single_call(a_raw, trans_in=band401_trans), EDGE_FRAMES)
    if (a_counts['band_forward_wide'] < 1 or a_counts['band_forward']
            or a_counts['band_spread'] or not k5_launched(a_counts)):
        fail('wide-band path (a) did not take K1\'s wide-band design and '
             'K5')
    require_same('wide-band path (a)', a_out,
                 single_call(a_raw, trans_in=band401_trans, backend='scan'),
                 'the plain scan route on the card')
    a_call_ms = host_ms(
        torch, lambda: single_call(a_raw, trans_in=band401_trans))
    wide_entry['path_call_ms'] = a_call_ms[0]
    info(f'wide-band path (a), 1 x {EDGE_FRAMES} x {STATES}, width '
         f'{band401[1]}: {a_call_ms[0]:.3f} ms/call warm median of 10 (min '
         f'{a_call_ms[1]:.3f}, max {a_call_ms[2]:.3f})')

    # (b) The pitch transition of a 20 ms hop (width 347) at the
    # headline's 512 x 512 x 1440: the kernel in both slice modes against
    # its plain version, K2's dense matrix against it too; timed in turns
    # against K2
    hop_trans = torch.from_numpy(np.log(
        pitch.transition_matrix(hopsize=HOP_20MS) + TINY)).to(device)
    hop_band = band.detect_band(hop_trans)
    if (hop_band is None or hop_band[1] != 347
            or band.forward_kernel(STATES, hop_band[1])[0]
            != 'band_forward_wide'):
        fail(f'the pitch band of a 20 ms hop is {hop_band}; expected width '
             '347 on the wide-band design')
    b_args = (obs_k, bf, init, hop_band, band.build_band_matrix(
        hop_trans, hop_band[0], hop_band[1]))
    (b_post_r, _), b_plain_ms = cuda_once(
        torch, lambda: band.band_forward_reference(*b_args))
    b_plan = band.wide_plan(BATCH, STATES, hop_band[1], sms)
    for plan in slice_mode_plans(
            band.wide_plans(BATCH, STATES, hop_band[1], sms)):
        wide_entry['max_abs_err'] = max(
            wide_entry['max_abs_err'], require_equal(
                torch, f'K1 band_forward_wide (b) {BATCH} x {FRAMES} x '
                f'{STATES}, width {hop_band[1]} ({plan_text(plan)})',
                band.viterbi_forward_band_wide(*b_args, plan=plan)[0],
                b_post_r))
    wide_entry['max_abs_err'] = max(
        wide_entry['max_abs_err'], require_equal(
            torch, f'K2 dense_forward on the width-{hop_band[1]} transition '
            'as a dense matrix (b), against the wide-band plain version',
            dense.viterbi_forward_dense(obs_k, bf, hop_trans, init)[0],
            b_post_r))
    del b_post_r
    # The timed call: the raw observation with the conversion folded in,
    # on the plan that is timed (at 132 SMs fewer than four lanes an
    # output: the kernel's straight-run conversion branch)
    wide_entry['max_abs_err'] = max(
        wide_entry['max_abs_err'], hold_folded(
            torch, dispatch, f'K1 band_forward_wide folded (b), width '
            f'{hop_band[1]} ({plan_text(b_plan)})',
            band.viterbi_forward_band_wide, obs, b_args[1:]))
    b_ms, b_dense_ms, b_unfolded_ms, b_turns = wide_against_dense(
        obs, b_args, hop_trans, iters=3)
    b_bound = wide_bound(BATCH, FRAMES, STATES, bf, hop_band)
    wide_entry.update(
        throughput_shape=f'{BATCH} x {FRAMES} x {STATES}, width '
                         f'{hop_band[1]}',
        throughput_ms=b_ms, throughput_unfolded_ms=b_unfolded_ms,
        throughput_dense_k2_ms=b_dense_ms, throughput_plain_ms=b_plain_ms,
        throughput_bound_ms=b_bound[0], throughput_bound_by=b_bound[1],
        throughput_plan=b_plan)
    info(f'K1 band_forward_wide (b) {BATCH} x {FRAMES} x {STATES}, width '
         f'{hop_band[1]}: folded {b_ms:.3f} ms (in turns against K2 on the '
         'dense matrix: ' + ', '.join(f'{ms:.3f}' for ms in b_turns)
         + f'; on a converted observation {b_unfolded_ms:.3f}), plain '
         f'{b_plain_ms:.1f} ms, bound {b_bound[0]:.3f} ({b_bound[1]}); plan '
         + plan_text(b_plan))

    # 4096 states at the pitch band's width (no cluster layout holds any
    # width there) and a band of half of 8200 states (no resident slice
    # fits: the slice streams), against the plain version
    gen_w = torch.Generator(device).manual_seed(4)
    for states_w, halfwidth_w, lengths_w in (
            (WIDE_STATES, WIDE_STATES_HALFWIDTH, (32, 21)),
            (STREAMED_STATES, STREAMED_HALFWIDTH, (STREAMED_FRAMES,))):
        trans_w = torch.from_numpy(
            fixtures.triangular_log(states_w, halfwidth_w, TINY)).to(device)
        band_w = band.detect_band(trans_w)
        lengths_t = torch.tensor(lengths_w, dtype=torch.int32, device=device)
        w_args = (torch.log(torch.rand(
            (len(lengths_w), max(lengths_w), states_w), generator=gen_w,
            device=device) + TINY), lengths_t, torch.full(
            (states_w,), -float(np.log(states_w)), device=device), band_w,
            band.build_band_matrix(trans_w, band_w[0], band_w[1]))
        want_w = band.band_forward_reference(*w_args)[0]
        for plan in slice_mode_plans(band.wide_plans(
                len(lengths_w), states_w, band_w[1], sms)):
            wide_entry['max_abs_err'] = max(
                wide_entry['max_abs_err'], require_equal(
                    torch, f'K1 band_forward_wide {len(lengths_w)} x '
                    f'{max(lengths_w)} x {states_w}, width {band_w[1]} '
                    f'({plan_text(plan)})', band.viterbi_forward_band_wide(
                        *w_args, plan=plan)[0], want_w))
        del want_w, w_args, trans_w

    # (c) One pitch sequence of 10,240 frames under the 20 ms band through
    # from_probabilities: the default auto-chunk route, its rows through
    # the wide-band design, then K3; held against the plain scan route
    # chunk by chunk on the same plan (the plan reads the observation
    # only); the rows' forward timed alone
    c_out, c_counts = run_path(
        'wide-band path (c)', lambda: single_call(trans_in=hop_trans))
    if (c_counts['band_forward_wide'] < 1 or c_counts['backtrace'] < 1
            or c_counts['band_forward'] or c_counts['band_spread']
            or c_counts['backtrace_pointers'] or c_counts['chase_pointers']):
        fail('wide-band path (c) did not take the auto-chunk route through '
             'K1\'s wide-band design and K3')
    require_same('wide-band path (c)', c_out, torch.cat([
        single_call(single[:, start:start + length], trans_in=hop_trans,
                    backend='scan')
        for start, length in zip(starts.tolist(), lengths.tolist())], dim=1),
        'the plain scan route decoded chunk by chunk on its plan')
    fresh = iter([single.clone() for _ in range(11)])
    c_call_ms = host_ms(
        torch, lambda: single_call(next(fresh), trans_in=hop_trans))
    del fresh
    single_paths['wide band (c), auto-chunk, new tensor each call'] = \
        c_call_ms
    c_rows_args = (single[0][gather], row_frames, init, hop_band,
                   b_args[4])
    c_rows_ms = cuda_ms(torch, lambda: band.viterbi_forward_band_wide(
        *c_rows_args, True, True), iters=3)
    c_rows_plan = band.wide_plan(n_rows, STATES, hop_band[1], sms)
    c_rows_bound = wide_bound(n_rows, longest, STATES, row_frames, hop_band)
    wide_entry.update(
        auto_chunk_shape=f'1 x {SINGLE_FRAMES} x {STATES}, width '
                         f'{hop_band[1]}',
        auto_chunk_call_ms=c_call_ms[0], auto_chunk_rows_ms=c_rows_ms,
        auto_chunk_rows_bound_ms=c_rows_bound[0],
        auto_chunk_rows_bound_by=c_rows_bound[1],
        auto_chunk_rows_plan=c_rows_plan,
        auto_chunk_launches=c_counts['band_forward_wide'])
    info(f'wide-band path (c): {c_call_ms[0]:.3f} ms/call warm median of 10 '
         f'(min {c_call_ms[1]:.3f}, max {c_call_ms[2]:.3f}; a new tensor '
         f'each call); the rows ({n_rows} x {longest}) through '
         f'band_forward_wide {c_rows_ms:.3f} ms ('
         f'{c_rows_ms * 1e3 / (longest - 1):.3f} us/frame; bound '
         f'{c_rows_bound[0]:.4f} ({c_rows_bound[1]}) and a chain of '
         f'{longest - 1} frames; plan {plan_text(c_rows_plan)})')

    # A sequence below the auto-chunk threshold takes K4 and K5 by default
    short = single[:, :SHORT_FRAMES].contiguous()
    short_out, short_counts = run_path(
        'batch-1 short path', lambda: single_call(short), SHORT_FRAMES)
    if (short_counts['band_spread'] < 1
            or not k5_launched(short_counts)):
        fail('the 2048-frame path did not launch K4 and K5')
    require_same('short path', short_out, single_call(short, backend='scan'),
                 'the plain scan route on the card')
    short_ms = host_ms(torch, lambda: single_call(short))

    # The uniform transition: the constant closed form, its recurrence K7
    # (one launch a call) and torch reductions; K7 itself held bitwise at
    # 1 x 10,240 and at the headline's shape with ragged lengths
    def uniform_call(**kwargs):
        return torbi_tpu_torch.from_probabilities(
            single, log_probs=True, gpu=0, **kwargs)

    uniform, uniform_counts = run_path('batch-1 uniform path', uniform_call)
    others = {name: count for name, count in uniform_counts.items()
              if count and name != 'constant_recurrence'}
    if uniform_counts['constant_recurrence'] != 1 or others:
        fail(f'the uniform path launched {uniform_counts}: K7 once, nothing '
             'else expected')
    require_same('uniform path', uniform, uniform_call(backend='scan'),
                 'the plain scan route on the card')
    single_paths['uniform closed form'] = host_ms(torch, uniform_call)
    kernels['constant_recurrence'] = constant_phase(
        torch, device, single, obs, init, clock_hz)
    kernels['constant_recurrence']['path_ms'] = single_paths[
        'uniform closed form'][0]
    # The uniform route at the headline's shape, ragged lengths (some past
    # the stream); its first UNIFORM_SCAN_ROWS rows against the scan route
    ragged = torch.from_numpy(np.random.default_rng(12).integers(
        1, FRAMES + 3, size=BATCH).astype(np.int32)).to(device)
    reset_counts()
    uniform_big = torbi_tpu_torch.from_probabilities(
        obs, batch_frames=ragged, log_probs=True, gpu=0)
    torch.cuda.synchronize()
    big_counts = read_counts()
    if big_counts['constant_recurrence'] != 1:
        fail(f'the uniform path at {BATCH} x {FRAMES} launched {big_counts}')
    require_same(
        f'uniform path at {BATCH} x {FRAMES} (ragged), first '
        f'{UNIFORM_SCAN_ROWS} rows', uniform_big[:UNIFORM_SCAN_ROWS],
        torbi_tpu_torch.from_probabilities(
            obs[:UNIFORM_SCAN_ROWS],
            batch_frames=ragged[:UNIFORM_SCAN_ROWS].clamp(max=FRAMES),
            log_probs=True, gpu=0, backend='scan'),
        'the plain scan route at the clamped lengths on the card')
    uniform_big_ms = host_ms(torch, lambda: torbi_tpu_torch.from_probabilities(
        obs, batch_frames=ragged, log_probs=True, gpu=0))
    kernels['constant_recurrence']['headline_path_ms'] = uniform_big_ms[0]
    info(f'uniform path at {BATCH} x {FRAMES} x {STATES}: '
         f'{uniform_big_ms[0]:.3f} ms/call warm median of 10 (min '
         f'{uniform_big_ms[1]:.3f}, max {uniform_big_ms[2]:.3f}), on {card}')
    del uniform_big

    # batch_frames past frames through K1 + K3 and K4 + K5
    c4_phase(torch, reset_counts, read_counts)

    for label, (median_ms, low, high) in single_paths.items():
        info(f'batch-1 {label}: {median_ms:.3f} ms/call warm median of 10 '
             f'(min {low:.3f}, max {high:.3f}), '
             f'{SINGLE_FRAMES / median_ms * 1e3:.0f} timesteps/s, '
             f'1 x {SINGLE_FRAMES} x {STATES}, on {card}')
    info(f'batch-1 short (1 x {SHORT_FRAMES}) K4+K5: {short_ms[0]:.3f} '
         f'ms/call warm median of 10, '
         f'{SHORT_FRAMES / short_ms[0] * 1e3:.0f} timesteps/s')

    # 6b. What the card decodes against torbi_tpu: every committed fixture
    # case (utils/fixtures.py) through from_probabilities, bitwise
    held = hold_fixtures(torch, fixtures, device, reset_counts, read_counts)
    info(f'fixtures: {held} cases decoded on the card equal torbi_tpu\'s '
         f'committed paths (tolerance: bitwise); {", ".join(fixtures.SERIAL)} '
         f'through K4 and K5, {", ".join(fixtures.WIDE)} through K1\'s '
         'wide-band design')

    # 6c. The file path: from_files_to_files, from_file_to_file and the CLI
    # at full width, counters reset just before and read just after each
    files = file_path_phase(torch, device, card, reset_counts, read_counts)

    # 6d. The evaluation harness at full width on two synthetic corpora, in
    # three configurations, counters reset just before and read just after
    # each
    evaluation = evaluation_phase(
        torch, device, card, reset_counts, read_counts)

    # 6e. The cross-route soak through the kernels
    soak_counts = soak_phase(torch, device, reset_counts, read_counts)

    # 6f. The extra decode modes: K8 on its edges, the time-sharded and
    # associative routes at 1 x 32,768 x 64, backend='lse' at the headline
    kernels['maxplus_matmul'], ts_counts, lse_counts = modes_phase(
        torch, device, card, (obs, trans, init, bf), result, reset_counts,
        read_counts)

    # 6g. The batch scale-out: two rank processes sharing the card in a gloo
    # world (the headline, uneven, dense, file and evaluation splits), a
    # world of one over NCCL, the scaling script's overhead mode
    scaleout = scaleout_phase(
        torch, device, card, (obs, trans, init, bf), result, dense_out,
        evaluation['default'][0], reset_counts, read_counts)

    # 7. The lab kernels against their plain versions, bitwise, at small
    # shapes: every forward body at every accumulator count (or tile) with
    # 1, 2, 4 and 8 sequences per CTA at 8 x 64 x 1440 (width 175), the
    # spread lab with clusters of 8 and 16 at 1 x 256 x 1440, every chase
    # variant in both thread shapes over 256 steps x 1440
    lab_obs, lab_band = kernel_lab.lab_inputs(
        8, LAB_CHECK_FRAMES, STATES, width, device)
    for name in ('full', 'rollmax', 'addmax', 'max', 'vregroll', 'rowadd',
                 'pipe', 'pipe2', 'pipe4', 'pipe16', 'tilted', 'introt',
                 'subroll'):
        want = kernel_lab.forward_reference(name, lab_obs, lab_band, width)
        params = (kernel_lab.TILES if name in kernel_lab.TILED
                  else kernel_lab.N_ACCS)
        for param in params:
            for nb in kernel_lab.BATCH_TILES:
                got = kernel_lab.lab_forward(
                    name, lab_obs, lab_band, width, param, nb)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f'lab_forward {name}:{param}:{nb} differs from its '
                         f'plain version (max abs err '
                         f'{max_abs_err(torch, got, want)}; tolerance: '
                         'bitwise)')
        info(f'lab_forward {name}: bitwise equal to its plain version at '
             f'{"R" if name in kernel_lab.TILED else "n_acc"} '
             f'{"/".join(map(str, params))} x 1/2/4/8 sequences per CTA')
    # pipeG at a group given at run time: G = 3, 5, 24, and the groups that
    # have instances of their own through the same body, against full's
    # plain version
    want = kernel_lab.forward_reference('full', lab_obs, lab_band, width)
    for name in RUN_TIME_PIPES + ('pipe2', 'pipe4', 'pipe', 'pipe16'):
        for n_acc in kernel_lab.N_ACCS:
            for nb in kernel_lab.BATCH_TILES:
                got = kernel_lab.lab_pipe(name, lab_obs, lab_band, width,
                                          n_acc, nb, run_time_group=True)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f'lab_pipe {name}:{n_acc}:{nb} (run-time group) '
                         f'differs from its plain version (max abs err '
                         f'{max_abs_err(torch, got, want)}; tolerance: '
                         'bitwise)')
    info('lab_pipe run-time group (pipe3, pipe5, pipe24, and G = 2, 4, 8, '
         '16): bitwise equal to its plain version at n_acc 1/2/4/8 x 1/2/4/8 '
         'sequences per CTA')
    # The tensor-core and mod-M labs at 8 x 64 x 1536: mxushift at every
    # n_acc, hybrid:K, mod12 (also un-permuted against full) and mod12k's
    # two outputs at every n_acc and sequences per CTA
    mod_obs, mod_band = kernel_lab.lab_inputs(
        8, LAB_CHECK_FRAMES, LAB_MOD_STATES, width, device)
    want = kernel_lab.forward_reference('full', mod_obs, mod_band, width)
    for n_acc in kernel_lab.N_ACCS:
        require_equal(torch, f'lab_mxu mxushift:{n_acc} at {LAB_MOD_STATES} '
                      'states', kernel_lab.lab_mxu(
                          mod_obs, mod_band, width, n_acc), want)
    for k in HYBRID_KS:
        require_equal(torch, f'lab_mxu hybrid:{k} at {LAB_MOD_STATES} states',
                      kernel_lab.lab_mxu(mod_obs, mod_band, width, mxu_k=k),
                      want)
    keys, stitched = kernel_lab.mod12_stitched(mod_band, width)
    obs_mod = kernel_lab.mod12_obs(mod_obs, LAB_MOD_STATES)
    want_mod, want_natural = kernel_lab.mod12k_reference(
        mod_obs, stitched, keys)
    if not torch.equal(kernel_lab.mod12_reference(obs_mod, stitched, keys),
                       want_mod) or not torch.equal(want_natural, want):
        fail('the plain mod12 and mod12k differ from full (tolerance: '
             'bitwise)')
    for n_acc in kernel_lab.N_ACCS:
        for nb in kernel_lab.BATCH_TILES:
            got = kernel_lab.lab_mod12(obs_mod, stitched, keys, n_acc, nb)
            got_k = kernel_lab.lab_mod12k(mod_obs, stitched, keys, n_acc, nb)
            torch.cuda.synchronize()
            for label, out, expected in (
                    ('mod12', got, want_mod),
                    ('mod12 un-permuted vs full', kernel_lab.unmod12_posterior(
                        got, 8, LAB_MOD_STATES), want),
                    ('mod12k mod-M output', got_k[0], want_mod),
                    ('mod12k natural output', got_k[1], want)):
                if not torch.equal(out, expected):
                    fail(f'lab_mod {label} at {n_acc}:{nb} differs from its '
                         f'plain version (max abs err '
                         f'{max_abs_err(torch, out, expected)}; tolerance: '
                         'bitwise)')
    info(f'lab_mod mod12 (also un-permuted against full) and mod12k (both '
         f'outputs): bitwise equal to their plain versions at n_acc 1/2/4/8 '
         f'x 1/2/4/8 sequences per CTA, {len(keys)} stitched pairs at '
         f'{LAB_MOD_STATES} states')
    del mod_obs, obs_mod, want_mod, want_natural
    spread_obs, spread_band = kernel_lab.lab_inputs(
        1, LAB_CHECK_STEPS, STATES, width, device)
    spread_seq = spread_obs[0].contiguous()
    for sync_only in (False, True):
        want = kernel_lab.spread_reference(
            spread_seq, spread_band, width, sync_only)
        for cluster in kernel_lab.CLUSTERS:
            label = (f'lab_spread ({"spread_sync" if sync_only else "spread"}'
                     f', cluster {cluster})')
            require_equal(torch, label, kernel_lab.lab_spread(
                spread_seq, spread_band, width, cluster, sync_only), want)
            if sync_only:
                require_equal(
                    torch, f'lab_spread (spread_async, cluster {cluster})',
                    kernel_lab.lab_spread(spread_seq, spread_band, width,
                                          cluster, True, 'async'), want)
    chase_trans, chase_post = chase_lab.lab_inputs(
        LAB_CHECK_STEPS, STATES, device)
    for variant in chase_lab.VARIANTS:
        want = chase_lab.chase_reference(variant, chase_trans, chase_post)
        shapes = (chase_lab.THREAD_SHAPES if variant in chase_lab.ROW_VARIANTS
                  else (chase_lab.threads_of(variant),))
        for threads in shapes:
            got = int(chase_lab.lab_chase(
                variant, chase_trans, chase_post, threads))
            if got != want:
                fail(f'lab_chase {variant} ({threads} threads) ended at '
                     f'{got}, its plain version at {want} (tolerance: '
                     'exact)')
        info(f'lab_chase {variant}: final index {want} equal to its plain '
             f'version ({"/".join(map(str, shapes))} threads)')
    del lab_obs, spread_obs, chase_post

    # 8. The labs at full width through their entry points, the launch
    # counters reset just before and read just after each
    lab_counters = {
        'lab_forward': kernel_lab.lab_forward,
        'lab_pipe': kernel_lab.lab_pipe,
        'lab_mxushift': kernel_lab.lab_mxu,
        'lab_mod12': kernel_lab.lab_mod12,
        'lab_mod12k': kernel_lab.lab_mod12k,
        'lab_spread': kernel_lab.lab_spread,
        'lab_chase': chase_lab.lab_chase}
    lab_counts = {}

    def lab_run(name, module, argv, kernels=None):
        for fn in lab_counters.values():
            fn.launches = 0
        result = module.main(argv)
        torch.cuda.synchronize()
        lab_counts[name] = {key: fn.launches
                            for key, fn in lab_counters.items()}
        info(f'{name} lab launches: {lab_counts[name]}')
        for kernel in kernels or (name,):
            if lab_counts[name][kernel] < 1:
                fail(f'the {name} lab did not launch {kernel}')
        return result

    shape = ['--states', str(STATES), '--width', str(width),
             '--iters', str(LAB_ITERS)]
    forward_lab = lab_run('lab_forward', kernel_lab, [
        '--variants', ','.join(LAB_FORWARD_SPECS), '--batch', str(BATCH),
        '--frames', str(FRAMES), *shape], ('lab_forward', 'lab_pipe'))
    # Every timed output against its plain version on the same inputs, at
    # the timed size: the plain version runs once per function (full for
    # its aliases), its first call timed
    lab_obs, lab_band = forward_lab['inputs']
    wanted, lab_plain, lab_err = {}, {}, {}
    for spec, got in forward_lab['outputs'].items():
        name = kernel_lab.parse_spec(spec)[0]
        function = kernel_lab.function_of(name)
        if function not in wanted:
            wanted[function], lab_plain[function] = cuda_once(
                torch, lambda: kernel_lab.forward_reference(
                    function, lab_obs, lab_band, width))
        if not torch.equal(got, wanted[function]):
            fail(f'lab_forward {spec} at {BATCH} x {FRAMES} x {STATES} '
                 f'differs from its plain version (max abs err '
                 f'{max_abs_err(torch, got, wanted[function])}; tolerance: '
                 'bitwise)')
        kernel = 'lab_pipe' if kernel_lab.pipe_group(name) else 'lab_forward'
        lab_err[kernel] = max(lab_err.get(kernel, 0.0),
                              max_abs_err(torch, got, wanted[function]))
    info(f'lab_forward: every timed spec bitwise equal to its plain version '
         f'at {BATCH} x {FRAMES} x {STATES}, width {width} (plain ms: '
         + ', '.join(f'{key} {value:.1f}' for key, value in lab_plain.items())
         + ')')
    # The groups with instances of their own, through the run-time body:
    # their times beside the fixed instances' (the spec's defaults, n_acc 4
    # and 4 sequences per CTA), outputs held bitwise
    run_time_ms = {}
    for name in ('pipe2', 'pipe4', 'pipe', 'pipe16'):
        got = kernel_lab.lab_pipe(name, lab_obs, lab_band, width,
                                  run_time_group=True)
        if not torch.equal(got, wanted['full']):
            fail(f'lab_pipe {name} (run-time group) at {BATCH} x {FRAMES} x '
                 f'{STATES} differs from its plain version (tolerance: '
                 'bitwise)')
        del got
        run_time_ms[name] = cuda_ms(torch, lambda: kernel_lab.lab_pipe(
            name, lab_obs, lab_band, width, run_time_group=True),
            iters=LAB_ITERS)
    info('lab_pipe at the headline shape, fixed instance against the '
         'run-time group (ms): ' + ', '.join(
             f'{name} {forward_lab["results"][name]["ms"]:.3f} / '
             f'{ms:.3f}' for name, ms in run_time_ms.items())
         + '; run-time only: ' + ', '.join(
             f'{name} {forward_lab["results"][name]["ms"]:.3f}'
             for name in RUN_TIME_PIPES))
    del wanted, lab_obs, lab_band, forward_lab['inputs'], \
        forward_lab['outputs']
    ideals = forward_lab['ideals']
    k1_ms = kernels['band_forward']['ms']
    info(f'forward lab at {BATCH} x {FRAMES} x {STATES}, width {width} '
         f'({ideals["candidates"]:.4g} circular candidates): ideals issue '
         f'{ideals["issue_ideal_ms"]:.3f} ms, shared memory '
         f'{ideals["smem_ideal_ms"]:.3f} ms, HBM '
         f'{ideals["hbm_ideal_ms"]:.3f} ms; K1 {k1_ms:.3f} ms on its '
         f'{steps * in_range:.4g} clipped candidates')
    for spec, row in forward_lab['results'].items():
        info(f'lab_forward {spec}: {row["ms"]:.3f} ms ({row["ms"] / k1_ms:.3f}'
             f' x K1), {row["candidates_per_sm_clock"]:.3f} candidates per '
             f'SM and clock, {ideals["issue_ideal_ms"] / row["ms"]:.3f} of '
             f'the issue ideal, {ideals["smem_ideal_ms"] / row["ms"]:.3f} of '
             f'the shared-memory ideal, on {card}')

    # The tensor-core and mod-M labs at 512 x 512 x 1536 through the same
    # entry point, beside full:4:4 at that shape; every timed output against
    # its plain version, mod12's also un-permuted against full's
    mod_lab = lab_run('lab_mxu_mod', kernel_lab, [
        '--variants', ','.join(LAB_MOD_SPECS), '--batch', str(BATCH),
        '--frames', str(FRAMES), '--states', str(LAB_MOD_STATES), '--width',
        str(width), '--iters', str(LAB_ITERS)],
        ('lab_forward', 'lab_mxushift', 'lab_mod12', 'lab_mod12k'))
    mod_obs, mod_band = mod_lab['inputs']
    want, lab_plain['full@1536'] = cuda_once(
        torch, lambda: kernel_lab.forward_reference(
            'full', mod_obs, mod_band, width))
    keys, stitched = kernel_lab.mod12_stitched(mod_band, width)
    obs_mod = kernel_lab.mod12_obs(mod_obs, LAB_MOD_STATES)
    want_mod, lab_plain['mod12'] = cuda_once(
        torch, lambda: kernel_lab.mod12_reference(obs_mod, stitched, keys))
    del obs_mod
    (want_mod_k, want_natural), lab_plain['mod12k'] = cuda_once(
        torch, lambda: kernel_lab.mod12k_reference(mod_obs, stitched, keys))
    if not (torch.equal(want_mod_k, want_mod)
            and torch.equal(want_natural, want)):
        fail('the plain mod12 and mod12k differ from full at '
             f'{LAB_MOD_STATES} states (tolerance: bitwise)')
    for spec, got in mod_lab['outputs'].items():
        name = kernel_lab.parse_spec(spec)[0]
        if name == 'mod12':
            pairs = [('lab_mod12', got, want_mod),
                     ('lab_mod12', kernel_lab.unmod12_posterior(
                         got, BATCH, LAB_MOD_STATES), want)]
        elif name == 'mod12k':
            pairs = [('lab_mod12k', got[0], want_mod),
                     ('lab_mod12k', got[1], want)]
        else:
            pairs = [('lab_mxushift' if name in kernel_lab.MXU
                      else 'lab_forward', got, want)]
        for kernel, out, expected in pairs:
            err = max_abs_err(torch, out, expected)
            lab_err[kernel] = max(lab_err.get(kernel, 0.0), err)
            if not torch.equal(out, expected):
                fail(f'{kernel} {spec} at {BATCH} x {FRAMES} x '
                     f'{LAB_MOD_STATES} differs from its plain version (max '
                     f'abs err {err}; tolerance: bitwise)')
    info(f'lab_mxu and lab_mod: every timed spec bitwise equal to its plain '
         f'version at {BATCH} x {FRAMES} x {LAB_MOD_STATES}, width {width}, '
         f'mod12 also un-permuted against full, mod12k in both outputs '
         f'(plain ms: full {lab_plain["full@1536"]:.1f}, mod12 '
         f'{lab_plain["mod12"]:.1f}, mod12k {lab_plain["mod12k"]:.1f})')
    del want, want_mod, want_mod_k, want_natural, mod_obs, mod_band, \
        mod_lab['inputs'], mod_lab['outputs']
    full1536_ms = mod_lab['results']['full:4:4']['ms']
    for spec, row in mod_lab['results'].items():
        extra = ''
        if 'mma_instructions' in row:
            extra = (f'; {row["mma_instructions"]} mma.sync.m16n8k16 '
                     f'({row["mma_peak_ms"]:.3f} ms at the 989 TFLOP/s bf16 '
                     f'peak), candidates on the tensor cores '
                     f'{row["tensor_core_candidates"]}, by shared-memory '
                     f'load {row["shared_load_candidates"]}')
        elif 'stitched_pairs' in row:
            extra = f'; {row["stitched_pairs"]} stitched pairs'
        info(f'lab {spec} at {BATCH} x {FRAMES} x {LAB_MOD_STATES}: '
             f'{row["ms"]:.3f} ms ({row["ms"] / full1536_ms:.3f} x full:4:4 '
             f'at that shape), {row["candidates_per_sm_clock"]:.3f} '
             f'candidates per SM and clock{extra}, on {card}')

    spread_lab = lab_run('lab_spread', kernel_lab, [
        '--variants', 'spread,spread:16,spread_sync,spread_sync:16,'
        'spread_async,spread_async:16',
        '--batch', '1', '--frames', str(SINGLE_FRAMES), *shape])
    spread_seq, spread_band = spread_lab['inputs']
    spread_seq = spread_seq[0]
    wanted = {}
    for sync_only in (False, True):
        wanted[sync_only], ms = cuda_once(
            torch, lambda: kernel_lab.spread_reference(
                spread_seq, spread_band, width, sync_only))
        if not sync_only:
            lab_plain['spread'] = ms
    for spec, got in spread_lab['outputs'].items():
        want = wanted[spec.split(':')[0] != 'spread']
        lab_err['lab_spread'] = max(lab_err.get('lab_spread', 0.0),
                                    max_abs_err(torch, got, want))
        if not torch.equal(got, want):
            fail(f'lab_spread {spec} at 1 x {SINGLE_FRAMES} x {STATES} '
                 f'differs from its plain version (max abs err '
                 f'{lab_err["lab_spread"]}; tolerance: bitwise)')
    info(f'lab_spread: every timed spec bitwise equal to its plain version '
         f'at 1 x {SINGLE_FRAMES} x {STATES} (plain {lab_plain["spread"]:.1f}'
         ' ms)')
    del wanted, spread_seq, spread_band, spread_lab['inputs']
    for spec, row in spread_lab['results'].items():
        info(f'lab_spread {spec}: {row["ms"]:.3f} ms, '
             f'{row["ms_per_frame"] * 1e3:.3f} us/frame (K4 '
             f'{k4_ms * 1e3 / steps1:.3f} us/frame), on {card}')
    exchange = {spec: row['ms_per_frame'] * 1e3 for spec, row in
                spread_lab['results'].items() if spec != 'spread'
                and spec != 'spread:16'}
    info('exchange probe, us/frame: ' + ', '.join(
        f'{spec} {value:.3f}' for spec, value in exchange.items())
         + ' (spread_sync: remote stores and a cluster barrier; '
         'spread_async: the mbarrier exchange K4 runs)')

    chase_lab_run = lab_run('lab_chase', chase_lab, [
        '--variants', ','.join(chase_lab.VARIANTS), '--frames',
        str(SINGLE_FRAMES), '--states', str(STATES), '--iters',
        str(LAB_ITERS), '--threads', '32,192'])
    chase_results = chase_lab_run['results']
    chase_trans, chase_post = chase_lab_run['inputs']
    wanted = {}
    for variant in chase_lab.VARIANTS:
        wanted[variant], ms = cuda_once(
            torch, lambda: chase_lab.chase_reference(
                variant, chase_trans, chase_post))
        if variant == 'tree12':
            lab_plain['tree12'] = ms
    for label, row in chase_results.items():
        want = wanted[label.split('@')[0]]
        lab_err['lab_chase'] = max(lab_err.get('lab_chase', 0.0),
                                   float(abs(row['index'] - want)))
        if row['index'] != want:
            fail(f'lab_chase {label} over {SINGLE_FRAMES} steps ended at '
                 f'{row["index"]}, its plain version at {want} (tolerance: '
                 'exact)')
    info(f'lab_chase: every timed variant ends at its plain version\'s '
         f'index over {SINGLE_FRAMES} steps x {STATES} (plain tree12 '
         f'{lab_plain["tree12"]:.1f} ms)')
    del chase_trans, chase_post, chase_lab_run['inputs']
    for label, row in chase_results.items():
        info(f'lab_chase {label}: {row["ns_per_step"]:.1f} ns/step (K5 '
             f'{k5_ms * 1e6 / steps1:.1f}, K6 {k6_ms * 1e6 / steps1:.1f} '
             f'ns/step), on {card}')
    wpad = -(-width // 8) * 8
    candidates = BATCH * (FRAMES - 1) * STATES * width
    kernels['lab_forward'] = dict(
        name='lab_forward', route='cuda',
        source='torbi_tpu_torch/csrc/lab_forward.cu',
        replaces='scripts/kernel_lab.py:205', path='lab_forward',
        max_abs_err=lab_err['lab_forward'],
        ms=forward_lab['results']['full:4:4']['ms'],
        plain_ms=lab_plain['full'],
        bound=bound_ms(
            (BATCH * FRAMES * STATES + wpad * STATES + BATCH * STATES) * 4,
            2 * candidates + BATCH * (FRAMES - 1) * STATES),
        library_ms=None, smem_bound_ms=candidates / smem_words_per_s * 1e3)
    kernels['lab_pipe'] = dict(
        kernels['lab_forward'], name='lab_pipe',
        source='torbi_tpu_torch/csrc/lab_pipe.cu',
        max_abs_err=lab_err['lab_pipe'],
        ms=forward_lab['results']['pipe']['ms'],
        run_time_group_ms={**run_time_ms, **{
            name: forward_lab['results'][name]['ms']
            for name in RUN_TIME_PIPES}})
    # The mxu and mod-M labs at 1536 states: full's function, its bounds
    mod_steps = BATCH * (FRAMES - 1) * LAB_MOD_STATES
    mod_candidates = mod_steps * width
    mod_in = BATCH * FRAMES * LAB_MOD_STATES
    mod_out = BATCH * LAB_MOD_STATES
    stitched_words = stitched.numel()
    mod_results = mod_lab['results']
    for name, source, line, spec, in_words, out_words, plain in (
            ('lab_mxushift', 'lab_mxu', 319, 'mxushift:4',
             mod_in + wpad * LAB_MOD_STATES, mod_out, 'full@1536'),
            ('lab_mod12', 'lab_mod', 578, 'mod12', mod_in + stitched_words,
             mod_out, 'mod12'),
            ('lab_mod12k', 'lab_mod', 671, 'mod12k', mod_in + stitched_words,
             2 * mod_out, 'mod12k')):
        kernels[name] = dict(
            name=name, route='cuda',
            source=f'torbi_tpu_torch/csrc/{source}.cu',
            replaces=f'scripts/kernel_lab.py:{line}', path='lab_mxu_mod',
            max_abs_err=lab_err[name], ms=mod_results[spec]['ms'],
            plain_ms=lab_plain[plain],
            bound=bound_ms((in_words + out_words) * 4,
                           2 * mod_candidates + mod_steps),
            library_ms=None,
            smem_bound_ms=mod_candidates / smem_words_per_s * 1e3)
    kernels['lab_mxushift'].update(
        mma_instructions=mod_results['mxushift:4']['mma_instructions'],
        mma_peak_ms=mod_results['mxushift:4']['mma_peak_ms'])
    kernels['lab_mod12']['stitched_pairs'] = len(keys)
    kernels['lab_mod12k']['stitched_pairs'] = len(keys)
    spread_candidates = (SINGLE_FRAMES - 1) * STATES * width
    kernels['lab_spread'] = dict(
        name='lab_spread', route='cuda',
        source='torbi_tpu_torch/csrc/lab_spread.cu',
        replaces='scripts/kernel_lab.py:872', path='lab_spread',
        max_abs_err=lab_err['lab_spread'],
        ms=spread_lab['results']['spread']['ms'],
        plain_ms=lab_plain['spread'],
        bound=bound_ms(
            (SINGLE_FRAMES * STATES + wpad * STATES + STATES) * 4,
            2 * spread_candidates + (SINGLE_FRAMES - 1) * STATES),
        library_ms=None,
        smem_bound_ms=spread_candidates / smem_words_per_s * 1e3,
        exchange_us_per_frame=exchange)
    kernels['lab_chase'] = dict(
        name='lab_chase', route='cuda',
        source='torbi_tpu_torch/csrc/lab_chase.cu',
        replaces='scripts/chase_lab.py:169', path='lab_chase',
        max_abs_err=lab_err['lab_chase'],
        ms=chase_results['tree12@192']['ms_per_call'],
        plain_ms=lab_plain['tree12'],
        bound=bound_ms(SINGLE_FRAMES * 2 * STATES * 4 + 4,
                       SINGLE_FRAMES * 2 * STATES),
        library_ms=None)
    info('lab kernels line entries: lab_forward full:4:4, lab_pipe pipe '
         '(G = 8; both at 1440 states), lab_mxushift mxushift:4, lab_mod12 '
         'mod12:4:4, lab_mod12k mod12k:4:4 (at 1536 states, bounds of '
         'full\'s function there), lab_spread spread (cluster 8), lab_chase '
         'tree12 (192 threads), each beside its plain version at the same '
         'size')

    # 9. One headline call traced, read by the benchmark's trace.py
    trace_dir = ROOT / 'build' / 'smoke_trace'
    shutil.rmtree(trace_dir, ignore_errors=True)
    headline_trace = traced(torch, headline, trace_dir)
    ops = headline_trace['device_ops']
    if not headline_trace['device_events']:
        fail('the profiler trace of the headline holds no device event')
    elementwise = [name for name in ops
                   if re.search(r'\b(exp|log)_kernel', name)]
    if elementwise:
        fail('the traced headline call ran elementwise exp/log device ops: '
             f'{elementwise}')
    info(f'profile headline trace: {len(ops)} device ops, no '
         'elementwise exp or log (the conversion runs inside K1)')
    info(f'profile headline trace: device busy '
         f'{headline_trace["busy_s"] * 1e3:.3f} of '
         f'{headline_trace["span_s"] * 1e3:.3f} ms traced, idle share '
         f'{headline_trace["idle_share"]:.4f}')
    trace_rows(headline_trace, 8)

    # 10. The kernels line, then the device line last; K1 and K3 also carry
    # their launches on the file path's corpus run
    for name in ('band_forward', 'backtrace'):
        kernels[name]['files_launches'] = files[name]
    for name in ('band_forward', 'backtrace'):
        kernels[name]['evaluation_launches'] = evaluation['default'][1][name]
    for name in ('band_spread', 'backtrace_pointers', 'chase_pointers'):
        kernels[name]['evaluation_launches'] = evaluation['nobatch'][1][name]
    for name in counters:
        if name in kernels:
            kernels[name]['soak_launches'] = soak_counts[name]
        else:
            # The in-list route's kernels report in the sparse line
            sparse_times[f'{name}_soak_launches'] = soak_counts[name]
    for name, parts in scaleout.items():
        kernels[name]['scaleout_launches'] = parts
    path_counts = {
        'banded': band_counts, 'dense': dense_counts,
        'batch1-serial': serial_counts, 'batch1-window': window_counts,
        'wide-band': a_counts, 'uniform': uniform_counts,
        'timesharded': ts_counts, **lab_counts}
    lines = []
    for name in ('band_forward', 'band_forward_wide', 'band_spread',
                 'dense_forward', 'backtrace', 'backtrace_pointers',
                 'chase_pointers', 'backtrace_window', 'constant_recurrence',
                 'maxplus_matmul', 'lab_forward',
                 'lab_pipe', 'lab_mxushift', 'lab_mod12', 'lab_mod12k',
                 'lab_spread', 'lab_chase'):
        entry = dict(kernels[name])
        bound, bound_by = entry.pop('bound')
        counts = path_counts[entry['path']]
        line = dict(
            name=entry['name'], route=entry['route'],
            source=entry['source'], replaces=entry['replaces'],
            launches=counts[name], max_abs_err=entry['max_abs_err'],
            ms=entry['ms'], plain_ms=entry['plain_ms'], bound_ms=bound,
            bound_by=bound_by, library_ms=entry['library_ms'],
            path=entry['path'])
        if name == 'backtrace':
            # K3 also chases the lse route's posteriors
            line['launches'] += lse_counts[name]
            line['lse_launches'] = lse_counts[name]
        for extra, value in entry.items():
            if extra not in line and extra != 'name':
                line[extra] = value
        lines.append(line)
    print(json.dumps({'kernels': lines}), flush=True)
    print(json.dumps({'sparse': sparse_times}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu',
        'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    try:
        if sys.argv[1:2] == ['--trace-dense']:
            trace_dense(sys.argv[2])
        elif sys.argv[1:2] == ['--beats']:
            beats_main(quick=sys.argv[2:3] == ['quick'])
        elif sys.argv[1:2] == ['--scaleout-rank']:
            scaleout_rank(int(sys.argv[2]), int(sys.argv[3]),
                          int(sys.argv[4]), sys.argv[5])
        else:
            main()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        info('FAILED: unexpected error')
        sys.exit(1)
