"""Time the dense forward pass (K2) at given shapes.

    python -m torbi_tpu_torch.scripts.dense_timing \\
        [--shapes 8x64x1440,512x512x1280] [--iters 5] [--sms N] [--sweep] \\
        [--device cuda]

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
"""
import argparse
import json
import subprocess
import time

import torch

from ..ops import dense

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
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA card: pass --device cpu to time the '
                           'plain version')
    results = []
    card = card_name(device)
    for batch, frames, states in parse_shapes(args.shapes):
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
