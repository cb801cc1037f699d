"""Time the dense forward pass (K2), or a banded forward pass beside it,
at given shapes.

    python -m torbi_tpu_torch.scripts.dense_timing \\
        [--shapes 8x64x1440,512x512x1280] [--iters 5] [--sms N] [--sweep] \\
        [--band HALFWIDTH [--decode]] [--device cuda]

For each batch x frames x states shape it makes random dense inputs on the
device from seed 0 (a row-normalised random transition and log-uniform
observations, in log space; the last two sequences stop early, at half the
frames and at 7), calls ``ops.dense.viterbi_forward_dense`` once, then
times ``--iters`` calls with CUDA events, and prints one JSON line per
shape. It uses only ``viterbi_forward_dense``, so the same script times an
older checkout of the package: run it from that checkout's root. ``--sms``
plans over that many CTAs in place of the card's SMs (a layout on part of
the card) and prints the plan. ``--sweep`` times every plan of
``ops.dense.dense_plans`` in its place, one line each with the plan, its
modelled cost and whether ``dense_plan`` picks it. On CPU tensors
(``--device cpu``) it times the plain version: no number from such a run
is a device time.

``--band HALFWIDTH`` times K1 instead, in the design that
``ops.band.forward_kernel`` picks for the shape (an older checkout picks
its own), on peaked pitch posteriorgrams (``models/pitch.py``, seed 0, in
log space, the epsilon step folded into the kernel) under a triangular
band of that half-width over log(tiny), beside K2 on the same transition
as a dense matrix (the same function, on the converted observation): one
line per shape with both times, the design's name and whether the two
streams are equal. ``--decode`` also times ``from_probabilities`` on the
same inputs (host clock, a new device tensor each call, median), the
route a user's call takes (one long sequence auto-chunks). ``--sms`` and
``--sweep`` then plan K1's wide-band design (``ops.band.wide_plans``).
"""
import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..ops import band, dense, dispatch

TINY = 1.1754943508222875e-38


def inputs(batch, frames, states, device, seed=0):
    """(observation, batch_frames, transition, initial) of one shape"""
    generator = torch.Generator(device).manual_seed(seed)
    transition = torch.rand((states, states), generator=generator,
                            device=device)
    transition = torch.log(
        transition / transition.sum(dim=1, keepdim=True) + TINY)
    observation = torch.log(torch.rand(
        (batch, frames, states), generator=generator, device=device) + TINY)
    lengths = [frames] * batch
    for row, length in zip(range(max(0, batch - 2), batch),
                           (frames // 2, 7)):
        lengths[row] = max(1, min(frames, length))
    batch_frames = torch.tensor(lengths, dtype=torch.int32, device=device)
    initial = torch.full((states,), -float(torch.log(torch.tensor(
        float(states)))), device=device)
    return observation, batch_frames, transition, initial


def band_inputs(batch, frames, states, halfwidth, device, seed=0):
    """(raw observation, batch_frames, initial, transition) of a banded
    shape: peaked pitch posteriorgrams in log space, every sequence whole,
    a uniform initial distribution, the triangular band of ``halfwidth``
    taken to log(p + tiny)"""
    from ..models import pitch
    from ..utils import fixtures

    observation = torch.from_numpy(pitch.synthetic_posteriorgrams(
        batch, frames, states, seed=seed)).to(device)
    transition = torch.from_numpy(
        fixtures.triangular_log(states, halfwidth)).to(device)
    batch_frames = torch.full((batch,), frames, dtype=torch.int32,
                              device=device)
    initial = torch.full((states,), -float(np.log(states)), device=device)
    return observation, batch_frames, initial, transition


def decode_ms(observation, transition, initial, iters, device):
    """Median ms of ``iters`` calls of from_probabilities, each on a new
    copy of the observation and ending in a synchronize (host clock)"""
    import torbi_tpu_torch

    gpu = 'cpu' if device.type == 'cpu' else device.index or 0
    fresh = [observation.clone() for _ in range(iters + 1)]
    times = []
    for copy in fresh:
        start = time.perf_counter()
        torbi_tpu_torch.from_probabilities(
            copy, transition=transition, initial=initial, log_probs=True,
            gpu=gpu)
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times[1:])


def time_band(shape, halfwidth, args, device, card):
    """The lines of one banded shape: K1's design beside K2 on the dense
    matrix"""
    batch, frames, states = shape
    observation, batch_frames, initial, transition = band_inputs(
        batch, frames, states, halfwidth, device)
    lo, width, floor = band.detect_band(transition)
    rest = (batch_frames, initial, (lo, width, floor),
            band.build_band_matrix(transition, lo, width))
    name, forward = band.forward_kernel(states, width)
    converted = dispatch.convert(observation, True, True).contiguous()

    def k2():
        return dense.viterbi_forward_dense(
            converted, batch_frames, transition, initial)

    plans = [None]
    if device.type == 'cuda' and (args.sms or args.sweep):
        sms = args.sms or dense._sms(device)
        plans = list(band.wide_plans(batch, states, width, sms)) \
            if args.sweep else [band.wide_plan(batch, states, width, sms)]
    k2_ms = time_ms(k2, args.iters, device)
    rows = []
    for plan in plans:
        options = {} if plan is None else {'plan': plan}

        def k1():
            return forward(observation, *rest, True, True, **options)

        row = {'shape': f'{batch}x{frames}x{states}', 'band_lo': lo,
               'band_width': width, 'forward': name,
               'ms': time_ms(k1, args.iters, device), 'dense_k2_ms': k2_ms,
               'equal_to_k2': bool(torch.equal(k1()[0], k2()[0])),
               'iters': args.iters, 'device': card,
               'kernel': device.type == 'cuda', **options}
        if args.decode:
            row['decode_ms'] = decode_ms(
                observation, transition, initial, args.iters, device)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def parse_shapes(text):
    return [tuple(int(x) for x in shape.split('x'))
            for shape in text.split(',') if shape]


def time_ms(fn, iters, device):
    """Mean ms per call after one warm-up call: CUDA events on the card,
    the host clock on the CPU"""
    fn()
    if device.type == 'cpu':
        start = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - start) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def card_name(device):
    if device.type == 'cpu':
        return 'cpu'
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    return (smi.stdout.strip().splitlines() or [
        torch.cuda.get_device_name(device)])[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--shapes', default='8x64x1440,512x512x1280')
    parser.add_argument('--iters', type=int, default=5)
    parser.add_argument('--sms', type=int, default=None)
    parser.add_argument('--sweep', action='store_true')
    parser.add_argument('--band', type=int, default=None,
                        metavar='HALFWIDTH')
    parser.add_argument('--decode', action='store_true')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA card: pass --device cpu to time the '
                           'plain version')
    results = []
    card = card_name(device)
    for batch, frames, states in parse_shapes(args.shapes):
        if args.band is not None:
            results += time_band(
                (batch, frames, states), args.band, args, device, card)
            continue
        data = inputs(batch, frames, states, device)
        plans = [None]
        if device.type == 'cuda' and (args.sms or args.sweep):
            sms = args.sms or dense._sms(device)
            chosen = dense.dense_plan(batch, states, sms)
            if chosen is None:
                raise ValueError(f'no plan fits {batch}x{states} on {sms} '
                                 'CTAs')
            plans = list(dense.dense_plans(batch, states, sms)) \
                if args.sweep else [chosen]
        for plan in plans:
            options = {} if plan is None else {'plan': plan}
            ms = time_ms(
                lambda: dense.viterbi_forward_dense(*data, **options),
                args.iters, device)
            row = {'shape': f'{batch}x{frames}x{states}', 'ms': ms,
                   'iters': args.iters, 'device': card,
                   'kernel': device.type == 'cuda', **options}
            if plan is not None:
                row['chosen'] = plan == chosen
            print(json.dumps(row), flush=True)
            results.append(row)
        del data
    return results


if __name__ == '__main__':
    main()
