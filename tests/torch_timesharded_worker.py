"""One rank of a gloo world for tests/test_torch_timesharded.py.

    python tests/torch_timesharded_worker.py RANK WORLD PORT INPUTS OUTPUT

Joins a gloo process group of WORLD ranks at tcp://127.0.0.1:PORT, decodes
every case of the ``.npz`` file INPUTS on the CPU and writes this rank's
paths to the ``.npz`` file OUTPUT. A case ``<name>`` holds
``<name>/observation``, ``<name>/transition``, ``<name>/initial`` and, for
the dispatcher, ``<name>/valid``: without it the case goes straight to
``decode_time_sharded``, with it through ``dispatch.decode(...,
backend='timesharded')`` at that many valid frames. A case whose decode
raises ``ValueError`` writes ``<name>/value_error``. Imports only
torbi_tpu_torch (never JAX or torbi_tpu).
"""
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torbi_tpu_torch.ops import dispatch  # noqa: E402
from torbi_tpu_torch.parallel import decode_time_sharded  # noqa: E402


def main(rank, world, port, inputs, output):
    dist.init_process_group(
        'gloo', init_method=f'tcp://127.0.0.1:{port}', world_size=world,
        rank=rank)
    cases = np.load(inputs)
    names = sorted({key.split('/')[0] for key in cases.files})
    results = {}
    try:
        for name in names:
            obs, trans, init = (
                torch.from_numpy(cases[f'{name}/{part}'])
                for part in ('observation', 'transition', 'initial'))
            try:
                if f'{name}/valid' in cases.files:
                    path = dispatch.decode(
                        obs[None], cases[f'{name}/valid'], trans, init,
                        backend='timesharded', device='cpu')[0]
                else:
                    path = decode_time_sharded(obs, trans, init)
            except ValueError:
                results[f'{name}/value_error'] = np.ones(1, np.int32)
                continue
            results[f'{name}/path'] = path.numpy()
        np.savez(output, **results)
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
