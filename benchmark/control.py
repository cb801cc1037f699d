"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed in a lower precision.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        [--dtype bfloat16]

The configurations state float32; no matrix product is involved, so the
next precision below is bfloat16. For each seed it makes the rows that
a run of the cell checks, at the cell's own sizes, decodes
them with the reference in float32 and in ``--dtype``, and prints the
frames where the two paths differ, which the check counts against its
limit of 0 (``check.py``): one line of JSON a seed, then their least.
A cell on several cards checks the same rows on every rank, so its
control runs on one card. It needs a CUDA card unless ``--device cpu``.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seeds, device, dtype):
    """{seed: (frames that differ, frames checked)}"""
    import torch

    from benchmark import check, run
    from benchmark.reference import viterbi as reference

    result = {}
    for seed in seeds:
        ctx = run.Context(cell, seed, 0, False, device, None)
        observations, lengths, transition, initial = (
            cell.caller().control_samples(ctx))
        exact = reference.decode_blocks(
            observations, lengths, transition, initial)
        lower = reference.decode_blocks(
            observations, lengths, transition, initial,
            dtype=getattr(torch, dtype))
        result[seed] = (sum(check.differing(low, path)
                            for low, path in zip(lower, exact)),
                        sum(lengths))
        del observations, exact, lower
        if device.type == 'cuda':
            torch.cuda.empty_cache()
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--dtype', default='bfloat16')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    import torch

    from benchmark import spec

    if args.device == 'cuda' and not torch.cuda.is_available():
        print('the control runs at the cell\'s size on a CUDA card',
              file=sys.stderr)
        return 2
    cell = spec.Cell(ROOT, args.workload)
    seeds = [int(seed) for seed in args.seeds.split(',')]
    found = readings(cell, seeds, torch.device(args.device), args.dtype)
    for seed, (differing, checked) in found.items():
        print(json.dumps({'workload': cell.name, 'seed': seed,
                          'dtype': args.dtype, 'mismatched_frames': differing,
                          'checked_frames': checked}), flush=True)
    print(json.dumps({'workload': cell.name, 'dtype': args.dtype,
                      'least_mismatched_frames': min(
                          d for d, _ in found.values())}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
