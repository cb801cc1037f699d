"""Scale-out measurement: the batch decode split over ranks.

    python -m torbi_tpu_torch.scripts.scaling [--mode overhead|weak]
        [--ranks 1,2] [--rows-per-device 256] [--frames 512] [--states 1440]
        [--iters 5] [--gpu cpu] [--output FILE]

Counterpart of the repo's ``scripts/scaling.py``. A rank is one process of
a ``torch.distributed`` world that the script starts itself (one
``python`` a rank on a free local port); each rank makes the inputs from
seed 0 (1440 states: pitch posteriorgrams under the pitch transition,
else a band of the same shape) and decodes through
``parallel.decode_sharded``.

``--mode overhead`` (the default) decodes the same total batch
(``--rows-per-device`` x the largest rank count) unsharded in this process
(``dispatch.decode``), then split over a world of each larger rank count,
and reports ``seconds_per_call`` (the slowest rank's warm median),
``work_overhead`` (sharded over unsharded) and ``projected_efficiency``
(its inverse); its first row also times ``--rows-per-device`` rows
decoded alone in this process (``rows_per_device_seconds``), what one
rank's slice costs on a card of its own. Ranks that share a card (more
ranks than cards) join a gloo world and time-slice the card: the ratio
then measures only the total work the split adds, not a speed-up. Ranks
with a card each join an NCCL world. ``--mode weak`` runs ``--rows-per-device`` rows a rank over worlds
of 1, 2, 4, ... ranks up to the cards there are, a card each, and reports
``efficiency`` = throughput_n / (n x throughput_1).

Each split row also holds every rank's ms a call, its slice's decode
alone and the gather alone (ms, host clock, warm median) and its peak
device memory. The last line printed is the artifact (also appended to
``--output``), with the card's name and power limit. With ``--gpu cpu``
the ranks decode on the CPU (the kernels' plain versions) over gloo: a
rehearsal at small sizes, and no number it prints is a device time.
"""
import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .modes_timing import card, host_ms, run_ranks

ROOT = Path(__file__).resolve().parents[2]
# Seconds a world may take, its start and inputs included
WORLD_TIMEOUT = 600
NOTE = (
    'ranks that share a card time-slice it, so the overhead ratio measures '
    'only the total work the split adds (the slices decoded one after the '
    'other, and the gather), not a speed-up; a scaling figure needs a card '
    'a rank')


def inputs(batch, frames, states, device):
    """(observation, batch_frames, transition, initial) on ``device``, from
    seed 0"""
    from .. import bench
    from ..models import pitch

    tiny = np.finfo(np.float32).tiny
    obs = pitch.synthetic_posteriorgrams(batch, frames, states, seed=0)
    trans = np.log(bench.transition_probabilities(states) + tiny)
    init = np.log(np.full(states, 1.0 / states, np.float32) + tiny)
    return (torch.from_numpy(obs).to(device),
            torch.full((batch,), frames, dtype=torch.int32, device=device),
            torch.from_numpy(trans.astype(np.float32)).to(device),
            torch.from_numpy(init).to(device))


def world_backend(world, cards):
    """The backend of a world of ``world`` ranks on ``cards`` cards: NCCL
    with a card a rank; gloo when ranks share a card (NCCL takes no two
    ranks of one device) or there is none"""
    return 'nccl' if 0 < world <= cards else 'gloo'


def run_rank(args):
    """One rank of a world: decode the batch split over the world, timed"""
    import torch.distributed as dist

    from ..ops import dispatch
    from ..parallel import decode_sharded
    from ..parallel.sharded import gather_rows, slice_rows

    cards = 0 if args.gpu == 'cpu' else torch.cuda.device_count()
    device = (torch.device('cuda', args.rank % cards) if cards
              else torch.device('cpu'))
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    backend = world_backend(args.world, cards)
    dist.init_process_group(
        backend, init_method=f'tcp://127.0.0.1:{args.port}',
        world_size=args.world, rank=args.rank)
    try:
        sync = (torch.cuda.synchronize if device.type == 'cuda'
                else (lambda: None))
        obs, bf, trans, init = inputs(
            args.batch, args.frames, args.states, device)
        start, stop = slice_rows(args.batch, args.world, args.rank)
        if device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(device)

        def call():
            return decode_sharded(obs, bf, trans, init,
                                  finite_observation=True, device=device)

        def alone():
            with dispatch.rank_share(args.batch):
                return dispatch.decode(
                    obs[start:stop], bf[start:stop], trans, init,
                    finite_observation=True, device=device)

        path = torch.zeros((stop - start, args.frames), dtype=torch.int32,
                           device=device)
        result = {
            'rank': args.rank, 'rows': stop - start, 'backend': backend,
            'device': str(device),
            'ms': host_ms(call, args.iters, sync, dist.barrier),
            'decode_ms': host_ms(alone, args.iters, sync),
            'gather_ms': host_ms(
                lambda: gather_rows(path, args.batch, args.world, None),
                args.iters, sync, dist.barrier)}
        if device.type == 'cuda':
            result['peak_gb'] = torch.cuda.max_memory_allocated(device) / 1e9
        Path(args.result).write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def run_world(args, world, batch, directory):
    """Every rank's result of a world of ``world`` ranks decoding ``batch``
    rows; raises when a rank fails"""
    run_ranks(
        lambda rank, port: [
            sys.executable, '-m', 'torbi_tpu_torch.scripts.scaling',
            '--rank', str(rank), '--world', str(world), '--port', str(port),
            '--result', str(directory / f'rank{rank}.json'),
            '--batch', str(batch), '--frames', str(args.frames),
            '--states', str(args.states), '--iters', str(args.iters)]
        + (['--gpu', 'cpu'] if args.gpu == 'cpu' else []),
        world, WORLD_TIMEOUT,
        env=dict(OMP_NUM_THREADS='1', GLOO_SOCKET_IFNAME='lo',
                 PYTHONPATH=os.pathsep.join(filter(None, (
                     str(ROOT), os.environ.get('PYTHONPATH'))))))
    return [json.loads((directory / f'rank{rank}.json').read_text())
            for rank in range(world)]


def split_row(world, batch, ranks):
    return {
        'ranks': world, 'batch': batch, 'backend': ranks[0]['backend'],
        'seconds_per_call': max(rank['ms'] for rank in ranks) / 1e3,
        **{key: [rank[key] for rank in ranks]
           for key in ('rows', 'ms', 'decode_ms', 'gather_ms', 'peak_gb')
           if key in ranks[0]}}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--mode', choices=('weak', 'overhead'),
                        default='overhead')
    parser.add_argument(
        '--ranks', default=None,
        help='rank counts, comma-separated (default: overhead 1 and 2, or '
             'powers of two up to the cards; weak powers of two up to the '
             'cards)')
    parser.add_argument('--rows-per-device', type=int, default=256)
    parser.add_argument('--frames', type=int, default=512)
    parser.add_argument('--states', type=int, default=1440)
    parser.add_argument('--iters', type=int, default=5)
    parser.add_argument('--gpu', choices=('cpu',), default=None,
                        help='decode on the CPU (a rehearsal)')
    parser.add_argument(
        '--output', default=None,
        help='append the artifact to this JSON list file')
    # One rank of a world the script started
    parser.add_argument('--rank', type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument('--world', type=int, help=argparse.SUPPRESS)
    parser.add_argument('--port', type=int, help=argparse.SUPPRESS)
    parser.add_argument('--batch', type=int, help=argparse.SUPPRESS)
    parser.add_argument('--result', help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        return run_rank(args)

    from ..ops import dispatch

    if args.gpu == 'cpu':
        device, cards, sync = torch.device('cpu'), 0, (lambda: None)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'the scaling measurement needs a CUDA card; pass --gpu cpu '
                'to rehearse it on the CPU')
        device, cards = torch.device('cuda', 0), torch.cuda.device_count()
        sync = torch.cuda.synchronize
    powers = [n for n in (1, 2, 4, 8, 16, 32) if n <= max(cards, 1)]
    if args.ranks:
        scales = sorted({int(n) for n in args.ranks.split(',')} | {1})
    elif args.mode == 'overhead':
        scales = powers if len(powers) > 1 else [1, 2]
    else:
        scales = powers
    if args.mode == 'weak' and scales[-1] > max(cards, 1) and cards:
        raise ValueError(f'--mode weak runs a card a rank; {cards} cards')
    rows = []
    with tempfile.TemporaryDirectory() as scratch:
        scratch = Path(scratch)
        if args.mode == 'overhead':
            batch = args.rows_per_device * scales[-1]
            obs, bf, trans, init = inputs(
                batch, args.frames, args.states, device)

            def seconds(count):
                """Seconds a call of ``count`` rows decoded in this
                process"""
                return host_ms(lambda: dispatch.decode(
                    obs[:count], bf[:count], trans, init,
                    finite_observation=True, device=device),
                    args.iters, sync) / 1e3

            unsharded, piece = seconds(batch), seconds(args.rows_per_device)
            del obs
            if device.type == 'cuda':
                torch.cuda.empty_cache()
            rows.append({'ranks': 1, 'batch': batch,
                         'seconds_per_call': unsharded,
                         'rows_per_device_seconds': piece,
                         'work_overhead': 1.0, 'projected_efficiency': 1.0})
            print(json.dumps(rows[-1]), flush=True)
            for world in scales[1:]:
                row = split_row(world, batch, run_world(
                    args, world, batch, scratch))
                row['work_overhead'] = row['seconds_per_call'] / unsharded
                row['projected_efficiency'] = (
                    unsharded / row['seconds_per_call'])
                rows.append(row)
                print(json.dumps(row), flush=True)
        else:
            base = None
            for world in scales:
                batch = args.rows_per_device * world
                row = split_row(world, batch, run_world(
                    args, world, batch, scratch))
                throughput = batch * args.frames / row['seconds_per_call']
                base = base or throughput
                row.update(timesteps_per_s=throughput,
                           efficiency=throughput / (world * base))
                rows.append(row)
                print(json.dumps(row), flush=True)
    artifact = {
        'mode': args.mode,
        'platform': device.type,
        'device_kind': (torch.cuda.get_device_name(0)
                        if device.type == 'cuda' else 'cpu'),
        'card': card() if device.type == 'cuda' else None,
        'cards': cards,
        'physical_cpus': os.cpu_count(),
        'rows_per_device': args.rows_per_device,
        'frames': args.frames,
        'states': args.states,
        'iters': args.iters,
        'note': NOTE if scales[-1] > max(cards, 1) else None,
        'scales': rows,
    }
    if args.output:
        existing = []
        if os.path.exists(args.output):
            with open(args.output) as file:
                existing = json.load(file)
        with open(args.output, 'w') as file:
            json.dump(existing + [artifact], file, indent=1)
    print(json.dumps(artifact), flush=True)
    return artifact


if __name__ == '__main__':
    main()
