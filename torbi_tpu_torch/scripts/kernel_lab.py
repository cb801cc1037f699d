"""Forward-kernel lab on the card: variants of the banded forward
recursion's inner loop, and the batch-1 spread kernel.

Counterpart of the repo's ``scripts/kernel_lab.py``. Each variant is a
hand-written CUDA kernel (``csrc/lab_forward.cu``, ``csrc/lab_spread.cu``)
that computes, per sequence, the final posterior of the lab's floorless
circular recursion over an observation (batch, frames, states) and a band
(width_padded, states) of which rows d < width are read
(lo = -(width // 2), S states):

    post = obs[:, 0]
    post'[j] = obs[:, t, j] + max_d cand(d, j),  d < width, t >= 1

with, in natural state order, the candidate of each variant:

    full, loopk, rowadd, pipe, pipe8,   post[(j + lo + d) mod S] + band[d, j]
      ushare, ushare2, tilted
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

The aliases compute the same function with another body: ``rowadd`` reads
the band from shared memory, ``pipe`` issues 8 source loads ahead, and
``tilted``/``ushare``/``ushare2`` tile R destinations per thread with
their sources in registers (csrc/lab_forward.cu says what each measures).
For S a multiple of 128 each function is the JAX lab's; the JAX lab's
``mxushift``, ``hybrid``, ``mod12`` and ``mod12k`` are not ported yet
(ROADMAP.md A12) and raise ``NotImplementedError``.

A variant spec is ``name[:n_acc[:batch_tile]]``: n_acc accumulators per
destination (1, 2, 4, 8; default 4), and batch_tile sequences per CTA (1,
2, 4, 8; default 4, K1's at the headline). For the tiled variants
(tilted, ushare, ushare2, introt, subroll) the second field is R, the
destinations per thread (2, 4, 8; default 4). For spread and spread_sync it
is the cluster size (8, or 16 where the card allows it; default 8).

Timing: ``time_submissions`` (queued launches, one scalar fetch). Each
variant prints ``ms``, ``G_candidates_per_s`` and
``candidates_per_sm_clock`` (candidates per SM and clock at the card's SM
count and clock: the TPU lab's ``ns_per_vreg_op`` has no counterpart), then
a summary with the H100 ideals of ``utils/profile.speed_of_light``.

Usage:
    python -m torbi_tpu_torch.scripts.kernel_lab \\
        --variants full,rollmax,addmax,max,tilted,spread \\
        [--batch 512] [--frames 512] [--states 1440] [--width 175] \\
        [--iters 8] [--check] [--check-spread] [--device cuda]

It runs on the card (``--device``, default ``cuda``) and raises without
one; on CPU tensors every variant runs its plain version
(``forward_reference``, ``spread_reference``), which is what the CPU tests
hold against the JAX lab.
"""
import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from ..csrc import build

# Body codes of csrc/lab_forward.cu
BODIES = {
    'full': 0, 'loopk': 0, 'rollmax': 1, 'addmax': 2, 'max': 3,
    'vregroll': 4, 'rowadd': 5, 'pipe': 6, 'pipe8': 6, 'tilted': 7,
    'ushare': 7, 'ushare2': 7, 'introt': 8, 'subroll': 9}
# Variants that compute another variant's function with another body
FUNCTIONS = {
    name: 'full' for name in (
        'loopk', 'rowadd', 'pipe', 'pipe8', 'tilted', 'ushare', 'ushare2',
        'spread')}
FUNCTIONS['spread_sync'] = 'max'
TILED = ('tilted', 'ushare', 'ushare2', 'introt', 'subroll')
SPREAD = ('spread', 'spread_sync')
UNPORTED = ('mxushift', 'hybrid', 'mod12', 'mod12k')
N_ACCS = (1, 2, 4, 8)
TILES = (2, 4, 8)
BATCH_TILES = (1, 2, 4, 8)
CLUSTERS = (8, 16)
DEFAULT_N_ACC = 4
DEFAULT_TILE = 4
DEFAULT_BATCH_TILE = 4
DEFAULT_CLUSTER = 8


def _unported(name):
    return NotImplementedError(
        f"the JAX lab's {name!r} is not ported yet (ROADMAP.md A12 queues "
        'mxushift/hybrid, mod12 and mod12k)')


def parse_spec(spec):
    """``name[:n_acc[:batch_tile]]`` -> (name, n_acc or R or cluster,
    batch_tile); raises ``NotImplementedError`` for the unported names and
    ``ValueError`` for anything else this lab does not take"""
    parts = spec.split(':')
    name = parts[0]
    if name in UNPORTED:
        raise _unported(name)
    if name not in BODIES and name not in SPREAD:
        raise ValueError(
            f'unknown variant {name!r} (pipe takes groups of 8 only); '
            f'expected one of {sorted(BODIES) + list(SPREAD)}')
    if name in SPREAD:
        default, allowed = DEFAULT_CLUSTER, CLUSTERS
    elif name in TILED:
        default, allowed = DEFAULT_TILE, TILES
    else:
        default, allowed = DEFAULT_N_ACC, N_ACCS
    param = int(parts[1]) if len(parts) > 1 and parts[1] else default
    batch_tile = (int(parts[2]) if len(parts) > 2 and parts[2]
                  else DEFAULT_BATCH_TILE)
    if param not in allowed:
        raise ValueError(f'{spec}: the second field must be one of {allowed}')
    if batch_tile not in BATCH_TILES:
        raise ValueError(
            f'{spec}: batch_tile must be one of {BATCH_TILES}')
    return name, param, batch_tile


def source_index(variant, states, width, device='cpu'):
    """(states, width) int64 source state of each candidate of ``variant``,
    and whether the candidate adds the band value"""
    function = FUNCTIONS.get(variant, variant)
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
    if name in UNPORTED:
        raise _unported(name)
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
    """A forward lab variant: its kernel (csrc/lab_forward.cu) on CUDA
    tensors, ``forward_reference`` on CPU tensors. ``n_acc`` is R for the
    tiled variants (default 4 either way). Returns (batch, states)."""
    name, param, batch_tile = parse_spec(
        f'{variant}:{"" if n_acc is None else n_acc}:{batch_tile}')
    if name in SPREAD:
        raise ValueError(f'{name} runs through lab_spread')
    if observation.device.type == 'cpu':
        return forward_reference(name, observation, band, width)
    _check_inputs(observation, band, width)
    batch, frames, states = observation.shape
    out = torch.empty((batch, states), dtype=torch.float32,
                      device=observation.device)
    tiled = name in TILED
    lib = _library('lab_forward')
    with torch.cuda.device(observation.device):
        code = lib.lab_forward(
            build.pointer(observation), build.pointer(band),
            build.pointer(out), BODIES[name], 1 if tiled else param,
            param if tiled else 1, batch_tile, batch, frames, states, width,
            build.stream(observation.device))
    build.raise_on_error(lib, f'lab_forward ({variant})', code)
    lab_forward.launches += 1
    return out


lab_forward.launches = 0


def spread_reference(observation, band, width, sync_only=False):
    """Plain PyTorch version of the spread lab: ``full`` (``max`` with
    ``sync_only``) on one (frames, states) sequence; returns (states,)"""
    return forward_reference(
        'spread_sync' if sync_only else 'spread', observation[None], band,
        width)[0]


def lab_spread(observation, band, width, cluster=DEFAULT_CLUSTER,
               sync_only=False):
    """The spread lab: its kernel (csrc/lab_spread.cu, one cluster of
    ``cluster`` CTAs) on CUDA tensors, ``spread_reference`` on CPU tensors.
    observation: (frames, states) float32, one sequence. Raises when the
    card refuses the cluster. Returns the (states,) final posterior."""
    if cluster not in CLUSTERS:
        raise ValueError(f'cluster must be one of {CLUSTERS}')
    if observation.device.type == 'cpu':
        return spread_reference(observation, band, width, sync_only)
    frames, states = observation.shape
    _check_inputs(observation[None], band, width)
    out = torch.empty((states,), dtype=torch.float32,
                      device=observation.device)
    lib = _library('lab_spread')
    with torch.cuda.device(observation.device):
        code = lib.lab_spread(
            build.pointer(observation), build.pointer(band),
            build.pointer(out), frames, states, width, cluster,
            int(sync_only), build.stream(observation.device))
    probe = ', sync only' if sync_only else ''
    build.raise_on_error(lib, f'lab_spread (cluster {cluster}{probe})', code)
    lab_spread.launches += 1
    return out


lab_spread.launches = 0


def _library(name):
    lib = build.library(name)
    if name == 'lab_forward':
        lib.lab_forward.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.lab_forward.restype = ctypes.c_int
    else:
        lib.lab_spread.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.lab_spread.restype = ctypes.c_int
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
    last = {}
    if name in SPREAD:
        sequence = observation[0]
        batch = 1

        def call():
            last['output'] = lab_spread(sequence, band, width, param,
                                        name == 'spread_sync')
            return last['output']

        fetch = lambda result: result[0]  # noqa: E731
    else:
        def call():
            last['output'] = lab_forward(name, observation, band, width,
                                         param, batch_tile)
            return last['output']

        fetch = lambda result: result[0, 0]  # noqa: E731
    seconds = profile.time_submissions(call, fetch, iters)
    sms, clock_hz = profile.device_rates()
    candidates = batch * max(frames - 1, 0) * width * states
    return {
        'variant': spec,
        'ms': seconds * 1e3,
        'ms_per_frame': seconds * 1e3 / max(frames - 1, 1),
        'G_candidates_per_s': candidates / seconds / 1e9,
        'candidates_per_sm_clock': candidates / (seconds * sms * clock_hz),
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


def main(argv=None):
    """Run the lab; returns the 'results' ({spec: result row}), the
    'outputs' of each spec's last timed call ((batch, states) posteriors,
    (states,) for the spread variants), the 'inputs' (observation, band)
    and the 'ideals' of the forward variants' shape"""
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
        help='not ported yet (ROADMAP.md A12)')
    args = parser.parse_args(argv)
    if args.check_mod12:
        raise _unported('mod12')

    from ..utils import profile
    from ..utils.convert import resolve_device

    device = resolve_device(args.device)
    if args.check:
        sys.exit(0 if check_tilted(args, device) else 1)
    if args.check_spread:
        sys.exit(0 if check_spread(args, device) else 1)

    specs = args.variants.split(',')
    for spec in specs:
        parse_spec(spec)
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
