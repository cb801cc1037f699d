"""Repeat the CPU conversion's first parallel call in fresh processes.

    python tests/torch_vml_first_call.py [--processes 400] [--parallel 6]

Each process starts as a test process does (JAX on an 8-device CPU mesh,
one JAX product run), then converts one (9, 61, 64) batch of log-space
observations, ``log(exp(x) + tiny)``, twice on 8 intra-op threads and
counts the values that differ between the two calls. Half the processes
import ``torbi_tpu_torch`` before their first torch operation, and its
import runs exp and log once on its own thread
(``torbi_tpu_torch._initialize_vector_math``); the other half import only
torch, so that their first exp is the parallel one. PyTorch's CPU builds
with MKL compute float exp and log with MKL's vector math: where its
first call is a parallel one, a worker thread can compute its chunk at
the low-accuracy setting, and that call's result differs from the next
one's. ``--parallel`` processes run at once. Prints one JSON line: per
kind, the processes run and those whose two calls differed.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path


def child(warm):
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
    import jax
    import jax.numpy as jnp

    jax.config.update('jax_platforms', 'cpu')
    if warm:
        sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
        import torbi_tpu_torch  # noqa: F401
    import numpy as np
    import torch

    torch.set_num_threads(8)
    tiny = float(np.finfo(np.float32).tiny)
    rng = np.random.default_rng(0)
    observation = torch.from_numpy(np.log(rng.dirichlet(
        np.ones(64) * 0.3, size=(9, 61)).astype(np.float32) + tiny))
    product = jnp.ones((512, 512))
    (product @ product).block_until_ready()

    def convert():
        return torch.exp(observation).add_(tiny).log_()

    print(int((convert() != convert()).sum()))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--processes', type=int, default=400)
    parser.add_argument('--parallel', type=int, default=6)
    parser.add_argument('--child', choices=('warm', 'cold'),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        return child(args.child == 'warm')
    counts = {kind: {'processes': 0, 'differed': 0}
              for kind in ('warm', 'cold')}
    kinds = ['warm', 'cold'] * (args.processes // 2)
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    for start in range(0, len(kinds), args.parallel):
        batch = kinds[start:start + args.parallel]
        procs = [subprocess.Popen(
            [sys.executable, __file__, '--child', kind],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            env=env) for kind in batch]
        for kind, proc in zip(batch, procs):
            output = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f'a {kind} process failed')
            counts[kind]['processes'] += 1
            counts[kind]['differed'] += int(output.split()[-1]) > 0
    print(json.dumps(counts))


if __name__ == '__main__':
    main()
