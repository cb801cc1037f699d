"""Time K8 (the (max, +) product) and K7 (the constant route's recurrence)
at the shapes of chip_smoke.py, with the routes that run them.

    python -m torbi_tpu_torch.scripts.modes_timing
        [--parts k8,routes,launches,k7]
        [--frames 32768] [--states 64] [--single 10240] [--batch 512]
        [--batch-frames 512] [--big 1440] [--device cuda]

- ``k8``: K8 at the associative scan's first level of one sequence of
  ``--frames`` x ``--states`` (``log(Dirichlet(0.3) + tiny)`` under a
  random dense transition, seed 31, as chip_smoke.py's modes phase) and
  on one ``--big`` cubed product (CUDA events, mean of 5), each beside its
  bound;
- ``routes``: the time-sharded route (``backend='timesharded'`` through
  ``from_probabilities`` over a one-rank NCCL group) and the associative
  route (``viterbi_decode_scan``) on that sequence: ms a call (host clock,
  warm median of 3), and K8's share of one call (CUDA events around each
  launch) beside the bound of those launches, summed from each launch's
  operations and bytes;
- ``launches``: each K8 launch of one time-sharded call on that sequence,
  replayed alone on its own operands, 5 calls captured in a CUDA graph
  and replayed 4 times: K8's time on the card without the host's work,
  launch by launch (its batch, and which operand is broadcast);
- ``k7``: K7 on random frame maxima at 1 x ``--single`` (whole and cut at
  7000) and at ``--batch`` x ``--batch-frames`` with chip_smoke.py's ragged
  lengths (seed 11): per call through the wrapper (CUDA events, mean of
  10, the host's work included where it is the longer) and per kernel (20
  calls captured in a CUDA graph, replayed 5 times), beside the chain of
  frames; and the uniform route (``from_probabilities`` without a
  transition, the closed form) at ``--batch`` x ``--batch-frames`` x 1440
  pitch with ragged lengths, host clock, warm median of 10.

On the card it first runs about a quarter second of matrix products, so
that the clocks have risen before the first timing. It prints one JSON
line, with the card's name and power limit. It uses
only entry points that earlier checkouts have (``maxplus_matmul(a, b)``,
``recurrence(...)``, ``from_probabilities``), so the same script times an
older checkout: copy it in and run it from that checkout's root. On CPU
tensors (``--device cpu``, small sizes) it runs the plain versions and no
number it prints is a device time.
"""
import argparse
import json
import os
import socket
import statistics
import subprocess
import time

import numpy as np
import torch

TINY = 1.1754943508222875e-38


def cuda_ms(fn, iters):
    """Mean ms of ``fn`` over ``iters`` calls after one (CUDA events)"""
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


def graph_ms(fn, calls=20, replays=5):
    """Mean ms of one of ``calls`` calls of ``fn`` captured in a CUDA graph
    and replayed ``replays`` times: the kernels without the host's work"""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (calls * replays)


def host_ms(fn, calls, sync, barrier=None):
    """Warm median ms of ``calls`` host-clock calls, each synchronised and,
    with ``barrier``, each started after it"""
    fn()
    sync()
    times = []
    for _ in range(calls):
        if barrier is not None:
            barrier()
        start = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def rates(device):
    """(SMs, SM clock in Hz) of the card, for the bounds"""
    from ..utils import profile

    if device.type != 'cuda':
        return None, None
    return profile.device_rates()


def bound_ms(bytes_moved, operations, sms, clock_hz):
    """The larger of the bytes at 3.35 TB/s and the FP32 instructions at
    128 an SM and clock (utils/profile.py's model), in ms"""
    from ..utils import profile

    if sms is None:
        return None
    return max(bytes_moved / 3.35e12,
               operations / (profile.FP32_LANES_PER_SM * sms * clock_hz)
               ) * 1e3


def distinct(x):
    """The distinct matrices of a (..., rows, cols) operand: 1 for a
    single matrix or a batch stride of 0"""
    return int(np.prod(x.shape[:-2])) if x.ndim > 2 and x.stride(0) else 1


def product_work(a, b):
    """(bytes, FP32 instructions) of one (max, +) product of a by b: each
    distinct operand matrix read once (a broadcast one once), the output
    written once; an add and a max a candidate"""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = int(np.prod(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])))
    moved = 4 * (distinct(a) * m * k + distinct(b) * k * n + batch * m * n)
    return moved, 2 * batch * m * k * n


def share(fn):
    """K8's share of one call of ``fn``: ``k8_ms``, its launches' time on
    the card (CUDA events around each, the card's waits on the host
    included), ``k8_launches``, and the ``bytes`` and ``operations`` of
    those launches (``product_work`` of each, summed)"""
    from ..ops import associative

    real = associative.maxplus_matmul
    marks, work = [], [0, 0, 0]

    def timed(a, b):
        events = None
        if a.device.type == 'cuda':
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        out = real(a, b)
        if events:
            events[1].record()
            marks.append(events)
        # An empty product launches nothing
        if out.numel():
            work[:] = (w + x for w, x in zip(
                work, (*product_work(a, b), 1)))
        return out

    # The kernel's own count goes to the stand-in while it stands in
    timed.launches = 0
    associative.maxplus_matmul = timed
    try:
        fn()
    finally:
        associative.maxplus_matmul = real
    if marks:
        torch.cuda.synchronize()
    return {'k8_ms': sum(start.elapsed_time(stop) for start, stop in marks),
            'k8_launches': work[2], 'bytes': work[0], 'operations': work[1]}


def modes_inputs(frames, states, device):
    rng = np.random.default_rng(31)
    obs = np.log(rng.dirichlet(np.full(states, 0.3), size=frames)
                 .astype(np.float32) + TINY)
    trans = np.log(rng.dirichlet(np.ones(states), size=states)
                   .astype(np.float32) + TINY)
    init = np.log(np.full(states, 1.0 / states, np.float32) + TINY)
    return tuple(torch.from_numpy(x).to(device) for x in (obs, trans, init))


def time_k8(args, device, sms, clock_hz):
    from ..ops import associative, dispatch

    obs, trans, _ = modes_inputs(args.frames, args.states, device)
    steps = trans[None] + dispatch.convert(obs, True, True)[1:, :, None]
    first_a, first_b = steps[1::2], steps[0:-1:2]
    generator = torch.Generator().manual_seed(81)
    big_a = (torch.randn((args.big, args.big), generator=generator)
             * 10).to(device)
    big_b = (torch.randn((args.big, args.big), generator=generator)
             * 10).to(device)
    result = {}
    for label, a, b in (('level', first_a, first_b), ('big', big_a, big_b)):
        def call():
            return associative.maxplus_matmul(a, b)

        if device.type == 'cuda':
            ms = cuda_ms(call, 5)
        else:
            start = time.perf_counter()
            call()
            ms = (time.perf_counter() - start) * 1e3
        result[label] = {'shape': [*a.shape, b.shape[-1]], 'ms': ms,
                         'bound_ms': bound_ms(*product_work(a, b), sms,
                                              clock_hz)}
    return result


def free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def run_ranks(argv_for_rank, world, timeout, env=None, cwd=None):
    """Run a world of ``world`` rank processes on one free local port:
    ``argv_for_rank(rank, port)`` is each rank's command line, ``env`` is
    added to this process's environment. Waits up to ``timeout`` seconds
    for each rank, kills any still running, and returns each rank's output
    (standard output and error) by rank; raises RuntimeError with each
    failed rank's exit code and the end of its output."""
    port = free_port()
    procs = [
        subprocess.Popen(
            argv_for_rank(rank, port), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=cwd,
            env=dict(os.environ, **(env or {})))
        for rank in range(world)]
    texts = []
    try:
        for proc in procs:
            texts.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [(rank, proc.returncode, text[-3000:])
              for rank, (proc, text) in enumerate(zip(procs, texts))
              if proc.returncode]
    if failed:
        raise RuntimeError(f'ranks of a world of {world} failed: {failed}')
    return texts


def time_routes(args, device, sms, clock_hz):
    import torch.distributed as dist

    import torbi_tpu_torch
    from ..ops import associative, dispatch

    obs, trans, init = modes_inputs(args.frames, args.states, device)
    gpu = device.index or 0 if device.type == 'cuda' else 'cpu'
    sync = (torch.cuda.synchronize if device.type == 'cuda'
            else (lambda: None))

    def timesharded():
        return torbi_tpu_torch.from_probabilities(
            obs[None], transition=trans, initial=init, log_probs=True,
            gpu=gpu, backend='timesharded')

    def scan():
        converted = dispatch.convert(obs, True, True).contiguous()
        return associative.viterbi_decode_scan(converted, trans, init)

    result = {}
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    dist.init_process_group(
        backend, init_method=f'tcp://127.0.0.1:{free_port()}',
        world_size=1, rank=0)
    try:
        result['timesharded'] = {'ms': host_ms(timesharded, 3, sync),
                                 **share(timesharded)}
    finally:
        dist.destroy_process_group()
    result['associative'] = {'ms': host_ms(scan, 3, sync), **share(scan)}
    for route in result.values():
        route['k8_bound_ms'] = bound_ms(route['bytes'], route['operations'],
                                        sms, clock_hz)
    return result


def time_launches(args, device, sms, clock_hz):
    import torch.distributed as dist

    import torbi_tpu_torch
    from ..ops import associative

    obs, trans, init = modes_inputs(args.frames, args.states, device)
    gpu = device.index or 0 if device.type == 'cuda' else 'cpu'
    real = associative.maxplus_matmul
    launches = []

    def recorded(a, b):
        out = real(a, b)
        if out.numel():
            launches.append((a, b))
        return out

    recorded.launches = 0
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    dist.init_process_group(
        backend, init_method=f'tcp://127.0.0.1:{free_port()}',
        world_size=1, rank=0)
    associative.maxplus_matmul = recorded
    try:
        torbi_tpu_torch.from_probabilities(
            obs[None], transition=trans, initial=init, log_probs=True,
            gpu=gpu, backend='timesharded')
    finally:
        associative.maxplus_matmul = real
        dist.destroy_process_group()
    rows, total = [], 0.
    for a, b in launches:
        batch = int(np.prod(torch.broadcast_shapes(a.shape[:-2],
                                                   b.shape[:-2])))
        row = {'batch': batch, 'broadcast': ''.join(
            name for name, x in (('a', a), ('b', b))
            if batch > 1 and distinct(x) == 1)}
        if device.type == 'cuda':
            row['ms'] = graph_ms(lambda: real(a, b), 5, 4)
            total += row['ms']
        rows.append(row)
    return {'launches': len(rows), 'total_ms': total, 'each': rows}


def time_k7(args, device, sms, clock_hz):
    import math

    import torbi_tpu_torch
    from ..models import pitch
    from ..ops import constant

    rng = np.random.default_rng(11)
    ragged = rng.integers(1, args.batch_frames + 1,
                          size=args.batch).astype(np.int32)
    ragged[:4] = [args.batch_frames, 1, 2, args.batch_frames + 9][
        :len(ragged[:4])]
    floor = float(np.float32(math.log(1. / 1440)))
    result = {}
    for label, batch, frames, lengths in (
            (f'1 x {args.single}', 1, args.single, [args.single]),
            (f'1 x {args.single} cut at 7000', 1, args.single,
             [min(7000, args.single)]),
            (f'{args.batch} x {args.batch_frames} ragged', args.batch,
             args.batch_frames, ragged)):
        maxima = torch.from_numpy((rng.normal(size=(batch, frames)) * 5)
                                  .astype(np.float32)).to(device)
        g0 = torch.from_numpy(rng.normal(size=batch)
                              .astype(np.float32)).to(device)
        bf = torch.tensor(np.asarray(lengths, np.int32), device=device)

        def call():
            return constant.recurrence(maxima, g0, bf, floor)

        entry = {'chain_ms': (frames - 1) * 8 / clock_hz * 1e3
                 if clock_hz else None}
        if device.type == 'cuda':
            entry['ms'] = cuda_ms(call, 10)
            entry['graph_ms'] = graph_ms(call)
        result[label] = entry
    observation = torch.from_numpy(pitch.synthetic_posteriorgrams(
        args.batch, args.batch_frames, 1440)).to(device)
    ragged_t = torch.from_numpy(ragged).to(device)
    gpu = device.index or 0 if device.type == 'cuda' else 'cpu'
    sync = (torch.cuda.synchronize if device.type == 'cuda'
            else (lambda: None))
    result['uniform_ms'] = host_ms(
        lambda: torbi_tpu_torch.from_probabilities(
            observation, batch_frames=ragged_t, log_probs=True, gpu=gpu),
        10, sync)
    return result


def card():
    """The card's name and power limit, as nvidia-smi gives them"""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--parts', default='k8,routes,launches,k7')
    parser.add_argument('--frames', type=int, default=32768)
    parser.add_argument('--states', type=int, default=64)
    parser.add_argument('--single', type=int, default=10240)
    parser.add_argument('--batch', type=int, default=512)
    parser.add_argument('--batch-frames', type=int, default=512)
    parser.add_argument('--big', type=int, default=1440)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA card: pass --device cpu to run the '
                               'plain versions')
        device = torch.device('cuda', device.index or 0)
        torch.cuda.set_device(device)
        warm = torch.randn((4096, 4096), device=device)
        start = time.perf_counter()
        while time.perf_counter() - start < 0.25:
            warm @ warm
            torch.cuda.synchronize()
        del warm
    sms, clock_hz = rates(device)
    parts = {'k8': time_k8, 'routes': time_routes,
             'launches': time_launches, 'k7': time_k7}
    report = {'card': card() if device.type == 'cuda' else None,
              'device': str(device)}
    for part in args.parts.split(','):
        report[part] = parts[part](args, device, sms, clock_hz)
    print(json.dumps(report), flush=True)
    return report


if __name__ == '__main__':
    main()
