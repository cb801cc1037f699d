"""Forward-kernel lab on the card: variants of the banded forward
recursion's inner loop, and the batch-1 spread kernel.

Counterpart of the repo's ``scripts/kernel_lab.py``. Each variant is a
hand-written CUDA kernel (``csrc/lab_forward.cu``, ``csrc/lab_pipe.cu``,
``csrc/lab_mxu.cu``, ``csrc/lab_mod.cu``, ``csrc/lab_spread.cu``) that
computes, per sequence, the final posterior of the lab's floorless circular
recursion over an observation (batch, frames, states) and a band
(width_padded, states) of which rows d < width are read
(lo = -(width // 2), S states):

    post = obs[:, 0]
    post'[j] = obs[:, t, j] + max_d cand(d, j),  d < width, t >= 1

with, in natural state order, the candidate of each variant:

    full, loopk, rowadd, pipe, pipe2,   post[(j + lo + d) mod S] + band[d, j]
      pipe4, pipe8, pipe16, ushare,
      ushare2, tilted, mxushift,
      hybrid, mod12, mod12k
    rollmax                             post[(j + lo + d) mod S]
    addmax                              post[j] + band[d, j]
    max                                 post[j]
    vregroll                            post[(j - 128 d) mod S] + band[d, j]
    introt                              post[128 a + (l - r_d) mod L_a]
                                        (j = 128 a + l, L_a the length of
                                        128-state block a,
                                        r_d = ((-lo) mod S - d) mod 128)
    subroll                             post[(j - 128 (d mod ceil(S / 128)))
                                        mod S] + band[d, j]
    spread                              full, on sequence 0 (one sequence
                                        over a cluster of CTAs, K4's design)
    spread_sync                         max, on sequence 0, in spread's
                                        layout (the barrier skeleton)
    spread_async                        max, on sequence 0, with K4's
                                        mbarrier exchange (the probe)

The aliases compute the same function with another body: ``rowadd`` reads
the band from shared memory, ``pipeG`` issues G source loads ahead (any G
>= 1, ``pipe`` is 8: G = 2, 4, 8, 16 have instances of their own, any other
G takes the body whose G is an argument), ``tilted``/``ushare``/``ushare2``
tile R destinations per thread with their sources in registers
(csrc/lab_forward.cuh says what each measures). ``mxushift`` shifts on the
tensor cores (mma against one-hot fragments, the posterior split into three
bf16 parts, ``split_bf16x3``) and ``hybrid:K`` only the offsets of K
lane-residue classes (``mxu_residues``), the rest by shared-memory loads.
``mod12`` runs in the mod-M layout (M = S / 128, state M l + r at row r,
lane l) with a stitched band (``build_mod12_plan``) on an observation
already in that layout (``mod12_obs``), and returns the mod-M posterior
(``unmod12_posterior`` takes it back); ``mod12k`` reads the natural
observation, does the relayout in the kernel and returns both posteriors.
The last four need S a multiple of 128, as in the JAX lab. For S a multiple
of 128 each function is the JAX lab's.

A variant spec is ``name[:n_acc[:batch_tile]]``: n_acc accumulators per
destination (1, 2, 4, 8; default 4), and batch_tile sequences per CTA (1,
2, 4, 8; default 4, K1's at the headline). For the tiled variants
(tilted, ushare, ushare2, introt, subroll) the second field is R, the
destinations per thread (2, 4, 8; default 4). For spread and spread_sync it
(and spread_async) is the cluster size (8, or 16 where the card allows
it; default 8). For
hybrid it is K, the residue classes on the tensor cores (default 4, the
JAX lab's n_acc default); mxushift and hybrid hold 16 sequences per CTA,
the mma's rows (batch_tile 16 only).

Timing: ``time_submissions`` (queued launches, one scalar fetch). Each
variant prints ``ms``, ``G_candidates_per_s`` and
``candidates_per_sm_clock`` (candidates per SM and clock at the card's SM
count and clock: the TPU lab's ``ns_per_vreg_op`` has no counterpart), then
a summary with the H100 ideals of ``utils/profile.speed_of_light``.
mxushift and hybrid also print their mma count and its time at the bf16
tensor-core peak, mod12 and mod12k their stitched pairs.

Usage:
    python -m torbi_tpu_torch.scripts.kernel_lab \\
        --variants full,rollmax,addmax,max,tilted,spread \\
        [--batch 512] [--frames 512] [--states 1440] [--width 175] \\
        [--iters 8] [--check] [--check-spread] [--check-mod12] \\
        [--device cuda]

(``--states 1536`` for mxushift, hybrid, mod12, mod12k and --check-mod12.)
It runs on the card (``--device``, default ``cuda``) and raises without
one; on CPU tensors every variant runs its plain version
(``forward_reference``, ``spread_reference``, ``mod12_reference``,
``mod12k_reference``), which is what the CPU tests hold against the JAX
lab.
"""
import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from ..csrc import build

# Body codes of csrc/lab_forward.cuh (the pipe bodies build from
# csrc/lab_pipe.cu, the others from csrc/lab_forward.cu)
BODIES = {
    'full': 0, 'loopk': 0, 'rollmax': 1, 'addmax': 2, 'max': 3,
    'vregroll': 4, 'rowadd': 5, 'pipe': 6, 'pipe8': 6, 'tilted': 7,
    'ushare': 7, 'ushare2': 7, 'introt': 8, 'subroll': 9, 'pipe2': 10,
    'pipe4': 11, 'pipe16': 12}
# The pipe variants with an instance of their own; any other pipeG takes
# the run-time group of csrc/lab_pipe.cu (lab_pipe_group)
PIPES = ('pipe', 'pipe2', 'pipe4', 'pipe8', 'pipe16')
MXU = ('mxushift', 'hybrid')
MOD = ('mod12', 'mod12k')
# Variants that compute another variant's function with another body
FUNCTIONS = {
    name: 'full' for name in (
        'loopk', 'rowadd', 'tilted', 'ushare', 'ushare2', 'spread')
    + PIPES + MXU}
FUNCTIONS['spread_sync'] = 'max'
FUNCTIONS['spread_async'] = 'max'
TILED = ('tilted', 'ushare', 'ushare2', 'introt', 'subroll')
SPREAD = ('spread', 'spread_sync', 'spread_async')
N_ACCS = (1, 2, 4, 8)
TILES = (2, 4, 8)
BATCH_TILES = (1, 2, 4, 8)
CLUSTERS = (8, 16)
# Sequences per CTA of mxushift and hybrid: the rows of one mma
MXU_BATCH_TILE = 16
DEFAULT_N_ACC = 4
DEFAULT_TILE = 4
DEFAULT_BATCH_TILE = 4
DEFAULT_CLUSTER = 8
DEFAULT_MXU_K = 4
# bf16 tensor-core peak of the H100 SXM (NVIDIA's data sheet, dense), and
# the flops of one mma.sync.m16n8k16
H100_BF16_FLOPS = 989e12
MMA_FLOPS = 2 * 16 * 8 * 16
NEG_INF = float('-inf')


def pipe_group(name):
    """G of a ``pipeG`` variant name (``pipe`` is 8), else None. Any digits
    parse, as in the JAX lab (``int(variant[4:] or 8)``); G < 1 raises
    ``ValueError``, as the JAX lab's ``range(0, width, 0)`` does"""
    if name == 'pipe':
        return 8
    if not (name.startswith('pipe') and name[4:].isdigit()):
        return None
    group = int(name[4:])
    if group < 1:
        raise ValueError(f'{name}: the pipe group must be 1 or more')
    return group


def function_of(name):
    """The variant whose function ``name`` computes (itself for most)"""
    return 'full' if pipe_group(name) else FUNCTIONS.get(name, name)


def parse_spec(spec):
    """``name[:n_acc[:batch_tile]]`` -> (name, n_acc or R or cluster or K,
    batch_tile); raises ``ValueError`` for anything this lab does not take
    (``pipeG`` for any G >= 1, as the JAX lab)"""
    parts = spec.split(':')
    name = parts[0]
    if (name not in BODIES and name not in SPREAD + MXU + MOD
            and pipe_group(name) is None):
        names = sorted(BODIES) + list(SPREAD + MXU + MOD)
        raise ValueError(
            f'unknown variant {name!r}; expected pipeG (G >= 1) or one of '
            f'{names}')
    if name in SPREAD:
        default, allowed = DEFAULT_CLUSTER, CLUSTERS
    elif name in TILED:
        default, allowed = DEFAULT_TILE, TILES
    elif name == 'hybrid':
        default, allowed = DEFAULT_MXU_K, None
    else:
        default, allowed = DEFAULT_N_ACC, N_ACCS
    param = int(parts[1]) if len(parts) > 1 and parts[1] else default
    tiles, default_tile = ((MXU_BATCH_TILE,), MXU_BATCH_TILE) if name in MXU \
        else (BATCH_TILES, DEFAULT_BATCH_TILE)
    batch_tile = (int(parts[2]) if len(parts) > 2 and parts[2]
                  else default_tile)
    if allowed is None and param < 0:
        raise ValueError(f'{spec}: K must be 0 or more')
    if allowed is not None and param not in allowed:
        raise ValueError(f'{spec}: the second field must be one of {allowed}')
    if batch_tile not in tiles:
        raise ValueError(f'{spec}: batch_tile must be one of {tiles}')
    return name, param, batch_tile


def require_mod128(states, variant):
    """Raise unless ``states`` is a multiple of 128, as ``variant`` needs"""
    if states % 128:
        raise ValueError(
            f'{variant} needs the states to be a multiple of 128 (the JAX '
            f'lab cannot run it either), got {states}; try --states 1536')


def source_index(variant, states, width, device='cpu'):
    """(states, width) int64 source state of each candidate of ``variant``,
    and whether the candidate adds the band value"""
    function = function_of(variant)
    lo = -(width // 2)
    j = torch.arange(states, device=device)[:, None]
    d = torch.arange(width, device=device)[None, :]
    if function in ('full', 'rollmax'):
        src = (j + lo + d) % states
    elif function in ('addmax', 'max'):
        src = j.expand(states, width)
    elif function == 'vregroll':
        src = (j - 128 * d) % states
    elif function == 'introt':
        block = j // 128 * 128
        length = torch.clamp(states - block, max=128)
        rotation = ((-lo) % states - d) % 128
        src = block + (j - block - rotation) % length
    elif function == 'subroll':
        blocks = -(-states // 128)
        src = (j - 128 * (d % blocks)) % states
    else:
        raise ValueError(f'unknown variant {variant!r}')
    return src, function not in ('rollmax', 'max', 'introt')


def forward_reference(variant, observation, band, width):
    """Plain PyTorch version of every forward lab variant (its function
    depends on the name only, not on n_acc, R or batch_tile).

    observation: (batch, frames, states) float32
    band: (>= width, states) float32; rows d < width are read
    Returns the (batch, states) float32 final posterior.
    """
    name = variant.split(':')[0]
    if name in MOD:
        raise ValueError(
            f'{name} runs in the mod-M layout: see {name}_reference')
    _, frames, states = observation.shape
    src, adds_band = source_index(name, states, width, observation.device)
    band_t = band[:width].t()
    post = observation[:, 0]
    for t in range(1, frames):
        candidates = post[:, src]
        if adds_band:
            candidates = candidates + band_t
        post = observation[:, t] + candidates.amax(dim=2)
    return post.contiguous()


def _check_inputs(observation, band, width):
    device = observation.device
    batch, frames, states = observation.shape
    build.check('observation', observation, (batch, frames, states),
                torch.float32, device)
    if not 1 <= width <= min(states, band.shape[0]):
        raise ValueError(
            f'width {width} must lie in [1, min(states, band rows)]')
    build.check('band', band, (band.shape[0], states), torch.float32, device)


def lab_forward(variant, observation, band, width, n_acc=None,
                batch_tile=DEFAULT_BATCH_TILE):
    """A forward lab variant: its kernel (csrc/lab_forward.cu, or
    csrc/lab_pipe.cu through ``lab_pipe`` for the pipe variants) on CUDA
    tensors, ``forward_reference`` on CPU tensors. ``n_acc`` is R for the
    tiled variants (default 4 either way). Returns (batch, states)."""
    name, param, batch_tile = parse_spec(
        f'{variant}:{"" if n_acc is None else n_acc}:{batch_tile}')
    if name in SPREAD + MXU + MOD:
        runner = ('lab_spread' if name in SPREAD
                  else 'lab_mxu' if name in MXU else f'lab_{name}')
        raise ValueError(f'{name} runs through {runner}')
    if pipe_group(name):
        return lab_pipe(name, observation, band, width, param, batch_tile)
    if observation.device.type == 'cpu':
        return forward_reference(name, observation, band, width)
    out = _launch_forward('lab_forward', name, param, batch_tile,
                          observation, band, width)
    lab_forward.launches += 1
    return out


lab_forward.launches = 0


def lab_pipe(variant, observation, band, width, n_acc=None,
             batch_tile=DEFAULT_BATCH_TILE, run_time_group=False):
    """The pipe variants (``pipeG``, any G >= 1; ``pipe`` is 8): their
    kernel (csrc/lab_pipe.cu) on CUDA tensors, ``forward_reference`` on CPU
    tensors. G = 2, 4, 8, 16 take their own instances unless
    ``run_time_group``; any other G takes ``lab_pipe_group``, the body whose
    G is an argument (clamped in the kernel to the width and to 32). Returns
    (batch, states)."""
    name, param, batch_tile = parse_spec(
        f'{variant}:{"" if n_acc is None else n_acc}:{batch_tile}')
    group = pipe_group(name)
    if group is None:
        raise ValueError(f'{name} is not a pipe variant')
    if observation.device.type == 'cpu':
        return forward_reference(name, observation, band, width)
    if name in PIPES and not run_time_group:
        out = _launch_forward('lab_pipe', name, param, batch_tile,
                              observation, band, width)
    else:
        _check_inputs(observation, band, width)
        batch, frames, states = observation.shape
        out = torch.empty((batch, states), dtype=torch.float32,
                          device=observation.device)
        lib = _library('lab_pipe')
        with torch.cuda.device(observation.device):
            code = lib.lab_pipe_group(
                build.pointer(observation), build.pointer(band),
                build.pointer(out), group, param, batch_tile, batch, frames,
                states, width, build.stream(observation.device))
        build.raise_on_error(lib, f'lab_pipe_group ({name})', code)
    lab_pipe.launches += 1
    return out


lab_pipe.launches = 0


def _launch_forward(library, name, param, batch_tile, observation, band,
                    width):
    """One launch of a body of csrc/lab_forward.cuh through ``library``'s
    C entry point (lab_forward or lab_pipe)"""
    _check_inputs(observation, band, width)
    batch, frames, states = observation.shape
    out = torch.empty((batch, states), dtype=torch.float32,
                      device=observation.device)
    tiled = name in TILED
    lib = _library(library)
    with torch.cuda.device(observation.device):
        code = getattr(lib, library)(
            build.pointer(observation), build.pointer(band),
            build.pointer(out), BODIES[name], 1 if tiled else param,
            param if tiled else 1, batch_tile, batch, frames, states, width,
            build.stream(observation.device))
    build.raise_on_error(lib, f'{library} ({name})', code)
    return out


def spread_reference(observation, band, width, sync_only=False):
    """Plain PyTorch version of the spread lab: ``full`` (``max`` with
    ``sync_only``) on one (frames, states) sequence; returns (states,)"""
    return forward_reference(
        'spread_sync' if sync_only else 'spread', observation[None], band,
        width)[0]


def lab_spread(observation, band, width, cluster=DEFAULT_CLUSTER,
               sync_only=False, exchange='barrier'):
    """The spread lab: its kernel (csrc/lab_spread.cu, one cluster of
    ``cluster`` CTAs) on CUDA tensors, ``spread_reference`` on CPU tensors.
    observation: (frames, states) float32, one sequence. ``exchange`` is
    'barrier' (remote stores and a cluster barrier per frame) or 'async'
    (K4's mbarrier exchange, the probe ``spread_async``: ``sync_only``'s
    function only). Raises when the card refuses the cluster. Returns the
    (states,) final posterior."""
    if cluster not in CLUSTERS:
        raise ValueError(f'cluster must be one of {CLUSTERS}')
    if exchange not in ('barrier', 'async'):
        raise ValueError(
            f"exchange must be 'barrier' or 'async', got {exchange!r}")
    if exchange == 'async' and not sync_only:
        raise ValueError('the async exchange probe computes sync_only\'s '
                         'function only')
    if observation.device.type == 'cpu':
        return spread_reference(observation, band, width, sync_only)
    frames, states = observation.shape
    _check_inputs(observation[None], band, width)
    out = torch.empty((states,), dtype=torch.float32,
                      device=observation.device)
    lib = _library('lab_spread')
    with torch.cuda.device(observation.device):
        if exchange == 'async':
            code = lib.lab_spread_async(
                build.pointer(observation), build.pointer(out), frames,
                states, width, cluster, build.stream(observation.device))
        else:
            code = lib.lab_spread(
                build.pointer(observation), build.pointer(band),
                build.pointer(out), frames, states, width, cluster,
                int(sync_only), build.stream(observation.device))
    probe = {'async': ', async exchange', 'barrier': ''}[exchange]
    probe += ', sync only' if sync_only else ''
    build.raise_on_error(lib, f'lab_spread (cluster {cluster}{probe})', code)
    lab_spread.launches += 1
    return out


lab_spread.launches = 0


###############################################################################
# mxushift and hybrid:K: the shifts on the tensor cores
###############################################################################


def split_bf16x3(x):
    """The three bf16 parts of float32 ``x`` that csrc/lab_mxu.cu feeds the
    tensor cores, as float32: hi = bf16(x), mid = bf16(x - hi), lo =
    bf16(x - hi - mid), each rounded to nearest even. For finite x (not
    subnormal) ``(hi + mid) + lo == x`` in float32, bitwise."""
    hi = x.to(torch.bfloat16).float()
    rest = x - hi
    mid = rest.to(torch.bfloat16).float()
    lo = (rest - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def mxu_residues(states, width, k=None):
    """The JAX lab's partition of the offsets (scripts/kernel_lab.py:247-259).

    Offset d rolls the posterior by s = ((-lo) mod S - d) mod S; offsets are
    grouped by their lane residue u = s mod 128, in order of first
    appearance. Returns (classes, mxu): classes a list of (u, [(d, s),
    ...]), and mxu the set of residues shifted on the tensor cores: every
    class for ``k`` None (``mxushift``), else the first ``k``
    single-candidate classes (``hybrid:k``)."""
    shift0 = (width // 2) % states
    classes = {}
    for d in range(width):
        s = (shift0 - d) % states
        classes.setdefault(s % 128, []).append((d, s))
    classes = list(classes.items())
    if k is None:
        return classes, {u for u, _ in classes}
    singles = [u for u, group in classes if len(group) == 1]
    return classes, set(singles[:k])


def mxu_offsets(states, width, k=None):
    """(width,) bool: offset d shifts on the tensor cores"""
    classes, mxu = mxu_residues(states, width, k)
    flags = np.zeros(width, dtype=bool)
    for u, group in classes:
        if u in mxu:
            flags[[d for d, _ in group]] = True
    return flags


def mxu_mma_count(batch, frames, states, width, k=None):
    """The mma.sync.m16n8k16 instructions csrc/lab_mxu.cu issues for one
    call: per 16 sequences (one cluster of CTAs) and frame t >= 1, per
    8-destination tile
    j0 and offset d on the tensor cores, 3 (one per bf16 part), or 6 when
    the sources (j0 + lo + d + n) mod S straddle two 16-state blocks
    ((j0 + lo + d) mod 16 > 8)"""
    flags = mxu_offsets(states, width, k)
    lo = -(width // 2)
    j0 = np.arange(0, states, 8)[:, None]
    d = np.nonzero(flags)[0][None, :]
    per_frame = int(np.where((j0 + lo + d) % 16 > 8, 6, 3).sum())
    groups = -(-batch // MXU_BATCH_TILE)
    return groups * max(frames - 1, 0) * per_frame


def lab_mxu(observation, band, width, n_acc=DEFAULT_N_ACC, mxu_k=None):
    """``mxushift`` (``mxu_k`` None) or ``hybrid:mxu_k``: the kernel of
    csrc/lab_mxu.cu on CUDA tensors, ``full``'s plain version on CPU
    tensors. observation: (batch, frames, states) float32 with states a
    multiple of 128 and finite values; band: (>= width, states). Returns
    the (batch, states) final posterior."""
    batch, frames, states = observation.shape
    require_mod128(states, 'mxushift' if mxu_k is None else 'hybrid')
    if n_acc not in N_ACCS:
        raise ValueError(f'n_acc must be one of {N_ACCS}')
    if mxu_k is not None and mxu_k < 0:
        raise ValueError('mxu_k must be 0 or more')
    if observation.device.type == 'cpu':
        return forward_reference('full', observation, band, width)
    _check_inputs(observation, band, width)
    out = torch.empty((batch, states), dtype=torch.float32,
                      device=observation.device)
    flags = None
    if mxu_k is not None:
        flags = _device_table(
            ('mxu', states, width, mxu_k), observation.device,
            lambda: mxu_offsets(states, width, mxu_k).astype(np.uint8))
    lib = _library('lab_mxu')
    with torch.cuda.device(observation.device):
        code = lib.lab_mxu(
            build.pointer(observation), build.pointer(band),
            None if flags is None else build.pointer(flags),
            build.pointer(out), n_acc, batch, frames, states, width,
            build.stream(observation.device))
    label = 'mxushift' if mxu_k is None else f'hybrid:{mxu_k}'
    build.raise_on_error(lib, f'lab_mxu ({label})', code)
    lab_mxu.launches += 1
    return out


lab_mxu.launches = 0

# Small constant tables on the card (the hybrid flags, the mod-M keys),
# made once per content and device: a copy from the host at every call
# would wait for the card and so stall the queued launches the lab times
_tables = {}


def _device_table(key, device, make):
    if (key, device) not in _tables:
        _tables[key, device] = torch.from_numpy(
            np.ascontiguousarray(make())).to(device)
    return _tables[key, device]


###############################################################################
# mod12 and mod12k: the mod-M layout with a stitched band
###############################################################################


def build_mod12_plan(states, width, band_host):
    """Stitched-band plan of the mod-M layout (scripts/kernel_lab.py:474).

    With M = states / 128, state s lives at row s mod M, lane s div M.
    Offset d reads, for output j, the source (j + sigma) mod S with
    sigma = -s(d) mod S; at output row r that is the row rename beta =
    -sigma mod M and the lane rotate alpha = -((r + sigma) div M) mod 128.
    Returns {(alpha, beta): (M, 128) float32}: the band weight of the one
    offset whose candidate lands at each cell through that key, -inf
    elsewhere (the JAX plan repeats each row over the TPU's 8 sublanes;
    this one does not). Asserts that every (key, row) stripe has one owner,
    so the max over all keys is bitwise ``full``'s."""
    require_mod128(states, 'the mod-M layout')
    band_host = np.asarray(band_host, dtype=np.float32)
    M = states // 128
    shift0 = (width // 2) % states
    pairs, owner = {}, {}
    lanes = np.arange(128) * M
    for d in range(width):
        sigma = -((shift0 - d) % states) % states
        beta = (-sigma) % M
        for r_out in range(M):
            key = ((-((r_out + sigma) // M)) % 128, beta)
            mat = pairs.setdefault(key, np.full((M, 128), NEG_INF, np.float32))
            assert owner.setdefault((key, r_out), d) == d, 'stitch collision'
            mat[r_out] = band_host[d, lanes + r_out]
    return pairs


def mod12_stitched(band, width):
    """The sorted keys [(alpha, beta), ...] of ``build_mod12_plan`` and the
    stitched band (P, M, 128) float32 on ``band``'s device"""
    plan = build_mod12_plan(band.shape[1], width, band.cpu().numpy())
    keys = sorted(plan)
    return keys, torch.from_numpy(np.stack([plan[key] for key in keys])).to(
        band.device)


def mod12_obs(obs, states):
    """(batch, frames, states) -> (batch / 8, M * 8, frames, 128), the JAX
    lab's mod-M observation: state s of sequence 8 g + b at row
    (s mod M) * 8 + b, lane s div M of group g"""
    M = states // 128
    batch, frames, _ = obs.shape
    arr = obs.reshape(batch // 8, 8, frames, 128, M).permute(0, 4, 1, 2, 3)
    return arr.reshape(batch // 8, M * 8, frames, 128).contiguous()


def unmod12_posterior(post, batch, states):
    """(batch / 8 * M * 8, 128) mod-M posterior -> (batch, states)"""
    M = states // 128
    arr = post.reshape(batch // 8, M, 8, 128).permute(0, 2, 3, 1)
    return arr.reshape(batch, states).contiguous()


def mod12_reference(obs_mod, stitched, keys):
    """Plain PyTorch version of ``mod12``: the stitched recursion on the
    mod-M layout with rolls, adds and maxima, each key's lane rotate shared
    by its row renames.

    obs_mod: (batch / 8, M * 8, frames, 128) float32 (``mod12_obs``)
    stitched: (P, M, 128) float32, keys: the P (alpha, beta) of its rows
    Returns the (batch / 8 * M * 8, 128) final posterior.
    """
    groups, rows, frames, lanes = obs_mod.shape
    M = stitched.shape[1]
    obs = obs_mod.reshape(groups, M, 8, frames, lanes)
    band = stitched[:, :, None, :]  # broadcast over the 8 sequences
    post = obs[:, :, :, 0]
    for t in range(1, frames):
        rotated = {alpha: torch.roll(post, alpha, dims=3)
                   for alpha in sorted({alpha for alpha, _ in keys})}
        best = None
        for i, (alpha, beta) in enumerate(keys):
            v = torch.roll(rotated[alpha], beta, dims=1) + band[i]
            best = v if best is None else torch.maximum(best, v)
        post = obs[:, :, :, t] + best
    return post.reshape(groups * rows, lanes).contiguous()


def mod12k_reference(observation, stitched, keys):
    """Plain PyTorch version of ``mod12k``: natural (batch, frames, states)
    in; (mod-M posterior (batch / 8 * M * 8, 128), natural (batch,
    states)) out"""
    batch, _, states = observation.shape
    post = mod12_reference(mod12_obs(observation, states), stitched, keys)
    return post, unmod12_posterior(post, batch, states)


def _mod_check(states, batch, stitched, keys):
    require_mod128(states, 'mod12')
    if batch % 8:
        raise ValueError(f'the mod-M layout needs batch a multiple of 8, '
                         f'got {batch}')
    if tuple(stitched.shape) != (len(keys), states // 128, 128):
        raise ValueError(
            f'stitched has shape {tuple(stitched.shape)}, expected '
            f'{(len(keys), states // 128, 128)}')


def _mod_launch(observation, stitched, keys, n_acc, batch_tile, natural,
                batch, frames, states, obs_shape):
    device = observation.device
    build.check('observation', observation, obs_shape, torch.float32, device)
    build.check('stitched', stitched, tuple(stitched.shape), torch.float32,
                device)
    if n_acc not in N_ACCS or batch_tile not in BATCH_TILES:
        raise ValueError(f'n_acc must be one of {N_ACCS} and batch_tile one '
                         f'of {BATCH_TILES}')
    keys = tuple(keys)
    if list(keys) != sorted(keys):
        raise ValueError('the keys must be sorted by (alpha, beta)')
    alphas = sorted({alpha for alpha, _ in keys})
    tables = [
        _device_table(('mod', keys, part), device, lambda make=make: make)
        for part, make in (
            ('alphas', np.array(alphas, np.int32)),
            ('starts', np.searchsorted(
                [alpha for alpha, _ in keys], alphas + [129]).astype(
                    np.int32)),
            ('betas', np.array([beta for _, beta in keys], np.int32)))]
    out = torch.empty((batch // 8 * (states // 128) * 8, 128),
                      dtype=torch.float32, device=device)
    nat = (torch.empty((batch, states), dtype=torch.float32, device=device)
           if natural else None)
    lib = _library('lab_mod')
    with torch.cuda.device(device):
        code = lib.lab_mod(
            build.pointer(observation), build.pointer(stitched),
            *map(build.pointer, tables), build.pointer(out),
            None if nat is None else build.pointer(nat), len(alphas),
            len(keys), n_acc, batch_tile, batch, frames, states,
            build.stream(device))
    build.raise_on_error(
        lib, f'lab_mod ({"mod12k" if natural else "mod12"})', code)
    return out, nat


def lab_mod12(obs_mod, stitched, keys, n_acc=DEFAULT_N_ACC,
              batch_tile=DEFAULT_BATCH_TILE):
    """``mod12``: the kernel of csrc/lab_mod.cu on CUDA tensors,
    ``mod12_reference`` on CPU tensors (arguments as there). Returns the
    (batch / 8 * M * 8, 128) mod-M final posterior."""
    groups, rows, frames, lanes = obs_mod.shape
    if rows % 8 or lanes != 128:
        raise ValueError(f'obs_mod has shape {tuple(obs_mod.shape)}, '
                         'expected (batch / 8, M * 8, frames, 128)')
    batch, states = groups * 8, rows // 8 * 128
    _mod_check(states, batch, stitched, keys)
    if obs_mod.device.type == 'cpu':
        return mod12_reference(obs_mod, stitched, keys)
    out, _ = _mod_launch(obs_mod, stitched, keys, n_acc, batch_tile, False,
                         batch, frames, states, tuple(obs_mod.shape))
    lab_mod12.launches += 1
    return out


lab_mod12.launches = 0


def lab_mod12k(observation, stitched, keys, n_acc=DEFAULT_N_ACC,
               batch_tile=DEFAULT_BATCH_TILE):
    """``mod12k``: the kernel of csrc/lab_mod.cu reading the natural
    (batch, frames, states) observation on CUDA tensors,
    ``mod12k_reference`` on CPU tensors. Returns (mod-M posterior, natural
    (batch, states) posterior)."""
    batch, frames, states = observation.shape
    _mod_check(states, batch, stitched, keys)
    if observation.device.type == 'cpu':
        return mod12k_reference(observation, stitched, keys)
    out = _mod_launch(observation, stitched, keys, n_acc, batch_tile, True,
                      batch, frames, states, (batch, frames, states))
    lab_mod12k.launches += 1
    return out


lab_mod12k.launches = 0


# ctypes argument types of each library's C entry point (pointers and the
# stream as c_void_p, so that ctypes does not cut them to 32 bits)
_ARGTYPES = {
    'lab_forward': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    'lab_spread': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    'lab_mxu': [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    'lab_mod': [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
}
_ARGTYPES['lab_pipe'] = _ARGTYPES['lab_forward']


def _library(name):
    lib = build.library(name)
    entry = getattr(lib, name)
    entry.argtypes = _ARGTYPES[name]
    entry.restype = ctypes.c_int
    if name == 'lab_pipe':
        lib.lab_pipe_group.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.lab_pipe_group.restype = ctypes.c_int
    if name == 'lab_spread':
        lib.lab_spread_async.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.lab_spread_async.restype = ctypes.c_int
    return lib


def lab_inputs(batch, frames, states, width, device):
    """The JAX lab's inputs, from seed 0: a standard-normal observation
    (batch, frames, states) and band (width rounded up to 8, states)"""
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((batch, frames, states)).astype(np.float32)
    band = rng.standard_normal(
        (-(-width // 8) * 8, states)).astype(np.float32)
    return (torch.from_numpy(obs).to(device),
            torch.from_numpy(band).to(device))


def run_spec(spec, observation, band, width, iters):
    """Time one variant spec; returns its result row and the output of its
    last timed call"""
    from ..utils import profile

    name, param, batch_tile = parse_spec(spec)
    batch, frames, states = observation.shape
    last, extra = {}, {}
    fetch = lambda result: result[0, 0]  # noqa: E731
    if name in MXU:
        mxu_k = param if name == 'hybrid' else None
        n_acc = DEFAULT_N_ACC if name == 'hybrid' else param

        def call():
            last['output'] = lab_mxu(observation, band, width, n_acc, mxu_k)
            return last['output']

        mmas = mxu_mma_count(batch, frames, states, width, mxu_k)
        on_mxu = int(mxu_offsets(states, width, mxu_k).sum())
        steps = batch * max(frames - 1, 0) * states
        extra = {
            'mma_instructions': mmas,
            'mma_peak_ms': mmas * MMA_FLOPS / H100_BF16_FLOPS * 1e3,
            'tensor_core_candidates': steps * on_mxu,
            'shared_load_candidates': steps * (width - on_mxu)}
    elif name in MOD:
        keys, stitched = mod12_stitched(band, width)
        extra = {'stitched_pairs': len(keys)}
        if name == 'mod12':
            obs_mod = mod12_obs(observation, states)

            def call():
                last['output'] = lab_mod12(obs_mod, stitched, keys, param,
                                           batch_tile)
                return last['output']
        else:
            def call():
                last['output'] = lab_mod12k(observation, stitched, keys,
                                            param, batch_tile)
                return last['output']

            fetch = lambda result: result[1][0, 0]  # noqa: E731
    elif name in SPREAD:
        sequence = observation[0]
        batch = 1

        def call():
            last['output'] = lab_spread(
                sequence, band, width, param, name != 'spread',
                'async' if name == 'spread_async' else 'barrier')
            return last['output']

        fetch = lambda result: result[0]  # noqa: E731
    else:
        def call():
            last['output'] = lab_forward(name, observation, band, width,
                                         param, batch_tile)
            return last['output']
    seconds = profile.time_submissions(call, fetch, iters)
    sms, clock_hz = profile.device_rates()
    candidates = batch * max(frames - 1, 0) * width * states
    return {
        'variant': spec,
        'ms': seconds * 1e3,
        'ms_per_frame': seconds * 1e3 / max(frames - 1, 1),
        'G_candidates_per_s': candidates / seconds / 1e9,
        'candidates_per_sm_clock': candidates / (seconds * sms * clock_hz),
        **extra,
    }, last['output']


def check_tilted(args, device):
    """Hold ``tilted`` bitwise against ``full`` on the given shape"""
    obs, band = lab_inputs(
        args.batch, args.frames, args.states, args.width, device)
    ref = lab_forward('full', obs, band, args.width)
    got = lab_forward('tilted', obs, band, args.width)
    match = bool(torch.equal(ref, got))
    print(json.dumps({'tilted_bitwise_match': match}), flush=True)
    return match


def check_spread(args, device):
    """Hold ``spread`` bitwise against row 0 of ``full`` (an 8-sequence
    batch), as the JAX lab's --check-spread does"""
    obs, band = lab_inputs(8, args.frames, args.states, args.width, device)
    band[args.width:] = float('-inf')
    ref = lab_forward('full', obs, band, args.width)[0]
    got = lab_spread(obs[0].contiguous(), band, args.width)
    match = bool(torch.equal(ref, got))
    print(json.dumps({'spread_bitwise_match': match}), flush=True)
    return match


def check_mod12(args, device):
    """Hold ``mod12`` (un-permuted) and ``mod12k`` (its natural output)
    bitwise against ``full`` on the given shape, as the JAX lab's
    --check-mod12 does, and print its two JSON lines"""
    obs, band = lab_inputs(
        args.batch, args.frames, args.states, args.width, device)
    ref = lab_forward('full', obs, band, args.width)
    keys, stitched = mod12_stitched(band, args.width)
    got = unmod12_posterior(
        lab_mod12(mod12_obs(obs, args.states), stitched, keys), args.batch,
        args.states)
    match = bool(torch.equal(ref, got))
    print(json.dumps({'mod12_bitwise_match': match,
                      'stitched_pairs': len(keys)}), flush=True)
    match_k = bool(torch.equal(ref, lab_mod12k(obs, stitched, keys)[1]))
    print(json.dumps({'mod12k_bitwise_match': match_k}), flush=True)
    return match and match_k


def main(argv=None):
    """Run the lab; returns the 'results' ({spec: result row}), the
    'outputs' of each spec's last timed call ((batch, states) posteriors,
    (states,) for the spread variants, the (batch / 8 * M * 8, 128) mod-M
    posterior for mod12, both posteriors for mod12k), the 'inputs'
    (observation, band) and the 'ideals' of the forward variants' shape"""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--variants', default='full,rollmax,addmax,max')
    parser.add_argument('--batch', type=int, default=512)
    parser.add_argument('--frames', type=int, default=512)
    parser.add_argument('--states', type=int, default=1440)
    parser.add_argument('--width', type=int, default=175)
    parser.add_argument('--iters', type=int, default=8)
    parser.add_argument('--device', default='cuda')
    parser.add_argument(
        '--check', action='store_true',
        help='hold tilted bitwise against full on this shape and exit')
    parser.add_argument(
        '--check-spread', action='store_true',
        help='hold spread bitwise against row 0 of full and exit')
    parser.add_argument(
        '--check-mod12', action='store_true',
        help='hold mod12 and mod12k bitwise against full on this shape '
        '(states a multiple of 128) and exit')
    args = parser.parse_args(argv)
    specs = args.variants.split(',')
    for spec in specs:
        name = parse_spec(spec)[0]
        if name in MXU + MOD and not (args.check or args.check_spread
                                      or args.check_mod12):
            require_mod128(args.states, name)
    if args.check_mod12:
        require_mod128(args.states, 'mod12')

    from ..utils import profile
    from ..utils.convert import resolve_device

    device = resolve_device(args.device)
    if args.check:
        sys.exit(0 if check_tilted(args, device) else 1)
    if args.check_spread:
        sys.exit(0 if check_spread(args, device) else 1)
    if args.check_mod12:
        sys.exit(0 if check_mod12(args, device) else 1)

    obs, band = lab_inputs(
        args.batch, args.frames, args.states, args.width, device)
    results, outputs = {}, {}
    for spec in specs:
        row, outputs[spec] = run_spec(spec, obs, band, args.width,
                                      args.iters)
        results[spec] = row
        print(json.dumps(row), flush=True)
    ideals = profile.speed_of_light(
        args.batch, args.frames, args.states, (-(args.width // 2), args.width),
        None, circular=True)
    summary = {
        'summary': {spec: row['ms'] for spec, row in sorted(
            results.items(), key=lambda item: item[1]['ms'])},
        'ideals_ms': {key: ideals[key] for key in (
            'issue_ideal_ms', 'smem_ideal_ms', 'hbm_ideal_ms')},
        'device': (torch.cuda.get_device_name(device)
                   if device.type == 'cuda' else 'cpu')}
    print(json.dumps(summary), flush=True)
    return {'results': results, 'outputs': outputs, 'inputs': (obs, band),
            'ideals': ideals}


if __name__ == '__main__':
    main()
