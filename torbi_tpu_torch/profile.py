"""Decode-pipeline profiler on the card: where does a batch-512 call spend
its time?

Counterpart of the repo's root ``profile.py``. Runs the headline workload
(512 x 512 peaked synthetic pitch posteriorgrams under the 1440-state pitch
transition taken to log(p + tiny), with the epsilon step that
``from_probabilities`` applies), times each stage with
``utils/profile.time_stages``, compares the forward kernel with the H100
model of ``utils/profile.speed_of_light`` and, with ``--trace``, captures a
``torch.profiler`` trace of one decode and prints its top device ops.

Usage:
    python -m torbi_tpu_torch.profile [--batch 512] [--frames 512]
        [--states 1440] [--iters 8] [--trace DIR] [--json] [--device cuda]

It runs on the card (``--device``, default ``cuda``) and raises without
one; ``--device cpu`` times the kernels' plain versions, which says nothing
of the card.
"""
import argparse
import json

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--batch', type=int, default=512)
    parser.add_argument('--frames', type=int, default=512)
    parser.add_argument('--states', type=int, default=1440)
    parser.add_argument('--iters', type=int, default=8)
    parser.add_argument(
        '--trace', default=None,
        help='also capture a torch.profiler trace into this directory')
    parser.add_argument(
        '--json', action='store_true', help='print machine-readable JSON')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    import torch

    from torbi_tpu_torch.models import pitch
    from torbi_tpu_torch.ops import dispatch
    from torbi_tpu_torch.utils import profile as prof
    from torbi_tpu_torch.utils.convert import resolve_device

    device = resolve_device(args.device)
    tiny = np.finfo(np.float32).tiny
    obs = torch.from_numpy(pitch.synthetic_posteriorgrams(
        args.batch, args.frames, args.states)).to(device)
    if args.states == pitch.PITCH_BINS:
        trans_host = np.log(pitch.transition_matrix() + tiny)
    else:
        rng = np.random.default_rng(0)
        trans_host = np.log(
            rng.dirichlet(np.ones(args.states), size=args.states)
            .astype(np.float32) + tiny)
    transition = torch.from_numpy(trans_host.astype(np.float32)).to(device)
    initial = torch.from_numpy(np.log(
        np.full(args.states, 1.0 / args.states, dtype=np.float32)
        + tiny)).to(device)
    batch_frames = torch.full(
        (args.batch,), args.frames, dtype=torch.int32, device=device)

    stages = prof.time_stages(
        obs, batch_frames, transition, initial, iters=args.iters,
        apply_epsilon=True)
    band = stages.pop('band')
    kernels = stages.pop('kernels')
    sol = prof.speed_of_light(
        args.batch, args.frames, args.states, band, stages['forward_ms'])

    timesteps = args.batch * args.frames
    report = {
        'config': {
            'batch': args.batch, 'frames': args.frames,
            'states': args.states, 'band': band, 'kernels': kernels,
            'device': (torch.cuda.get_device_name(device)
                       if device.type == 'cuda' else 'cpu')},
        'stages_ms': stages,
        'speed_of_light': {
            key: sol[key] for key in (
                'issue_ideal_ms', 'smem_ideal_ms', 'hbm_ideal_ms',
                'bound_by', 'utilization', 'sms', 'clock_hz')},
        'throughput': {
            'pipeline_timesteps_per_s': timesteps / stages['pipeline_ms']
            * 1e3,
            'e2e_timesteps_per_s': timesteps / stages['e2e_ms'] * 1e3},
    }

    trace_rows = []
    if args.trace:
        def run_once():
            return dispatch.decode(
                obs, batch_frames, transition, initial,
                apply_epsilon=True, device=device)

        prof.capture(run_once, args.trace)
        trace_rows = prof.device_op_times(args.trace, top=15)
        report['trace_top_ops'] = trace_rows

    if args.json:
        print(json.dumps(report))
        return report

    config = report['config']
    print(f"# decode profile: batch={config['batch']} "
          f"frames={config['frames']} states={config['states']} "
          f"device={config['device']} band={config['band']} "
          f"kernels={config['kernels']}")
    print(f"{'stage':<14}{'ms':>10}")
    for key in ('forward_ms', 'backtrace_ms', 'glue_ms', 'pipeline_ms',
                'host_ms', 'e2e_ms'):
        print(f"{key[:-3]:<14}{stages[key]:>10.3f}")
    print(f"\nspeed-of-light ({sol['sms']} SMs at "
          f"{sol['clock_hz'] / 1e9:.3f} GHz): issue "
          f"{sol['issue_ideal_ms']:.3f} ms / shared memory "
          f"{sol['smem_ideal_ms']:.3f} ms / HBM {sol['hbm_ideal_ms']:.3f} ms"
          f" -> the forward kernel at {sol['utilization'] * 100:.1f}% of the "
          f"binding ({sol['bound_by']}) ideal")
    throughput = report['throughput']
    print(f"throughput: pipeline "
          f"{throughput['pipeline_timesteps_per_s']:,.0f} ts/s, e2e "
          f"{throughput['e2e_timesteps_per_s']:,.0f} ts/s")
    if trace_rows:
        print('\ntop device ops (trace):')
        for row in trace_rows:
            print(f"  {row['total_ms']:>9.3f} ms  x{row['count']:<5} "
                  f"{row['name'][:70]}")
    elif args.trace:
        print('\ntrace: no device events found')
    return report


if __name__ == '__main__':
    main()
