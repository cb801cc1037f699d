"""One rank of a gloo world for tests/test_torch_sharded.py and
tests/test_torch_multiprocess.py.

    python tests/torch_sharded_worker.py TASK RANK WORLD PORT INPUTS OUTPUT

Joins a gloo process group of WORLD ranks at tcp://127.0.0.1:PORT, runs
TASK on the CPU and writes this rank's results to OUTPUT:

- ``decode``: every case of the ``.npz`` file INPUTS (``<name>/observation``,
  ``<name>/batch_frames``, ``<name>/transition``, ``<name>/initial``)
  through ``parallel.decode_sharded``, its path to ``<name>/path`` of the
  ``.npz`` file OUTPUT, with the kernel routes this rank's slice took in
  ``<name>/decodes`` (1 when it decoded rows, 0 when its slice was empty);
  a case whose decode raises ``ValueError`` writes ``<name>/value_error``;
- ``files``: ``parallel.files.from_files_to_files`` on the JSON file INPUTS
  (``inputs``, ``outputs``, ``transition``), this rank's share of the
  inputs to the JSON file OUTPUT;
- ``evaluate``: ``evaluate.datasets`` on the corpus the JSON file INPUTS
  points at (``cache``, ``partitions``, ``eval``, ``transition``, ``config``,
  ``dataset``); to the JSON file OUTPUT the results, the writes of the
  results file, and the timing contexts before and after aggregation.

``run_world`` starts a world of these workers from a test. Imports only
torbi_tpu_torch (never JAX or torbi_tpu).
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torbi_tpu_torch  # noqa: E402
from torbi_tpu_torch.ops import dispatch  # noqa: E402
from torbi_tpu_torch.parallel import decode_sharded, files  # noqa: E402
from torbi_tpu_torch.scripts.modes_timing import run_ranks  # noqa: E402


def decode(inputs, output):
    cases = np.load(inputs)
    names = sorted({key.split('/')[0] for key in cases.files})
    results = {}
    real = dispatch.kernel_route
    for name in names:
        obs, bf, trans, init = (
            torch.from_numpy(cases[f'{name}/{part}'])
            for part in ('observation', 'batch_frames', 'transition',
                         'initial'))
        routes = []

        def counted(*args, **kwargs):
            routes.append(1)
            return real(*args, **kwargs)

        dispatch.kernel_route = counted
        try:
            backend = 'timesharded' if name.startswith('timesharded') else None
            path = decode_sharded(obs, bf, trans, init, backend=backend,
                                  device='cpu')
        except ValueError:
            results[f'{name}/value_error'] = np.ones(1, np.int32)
            continue
        finally:
            dispatch.kernel_route = real
        results[f'{name}/path'] = path.numpy()
        results[f'{name}/decodes'] = np.array([len(routes)], np.int32)
    np.savez(output, **results)


def files_task(inputs, output):
    spec = json.loads(Path(inputs).read_text())
    mine, _ = files.shard_files_balanced(spec['inputs'], spec['outputs'])
    files.from_files_to_files(
        spec['inputs'], spec['outputs'], transition_file=spec['transition'],
        log_probs=True, gpu='cpu')
    Path(output).write_text(json.dumps({'share': mine}))


def evaluate_task(inputs, output):
    from torbi_tpu_torch.evaluate import core

    spec = json.loads(Path(inputs).read_text())
    torbi_tpu_torch.CONFIG = spec['config']
    torbi_tpu_torch.CACHE_DIR = Path(spec['cache'])
    torbi_tpu_torch.PARTITION_DIR = Path(spec['partitions'])
    torbi_tpu_torch.EVAL_DIR = Path(spec['eval'])
    torbi_tpu_torch.PITCH_TRANSITION_MATRIX = Path(spec['transition'])
    writes, seconds = [], []
    real_write, real_seconds = core._write, core._aggregate_seconds

    def write(results):
        writes.append(1)
        real_write(results)

    def aggregate_seconds(timings):
        aggregated = real_seconds(timings)
        seconds.append((dict(timings), dict(aggregated)))
        return aggregated

    core._write, core._aggregate_seconds = write, aggregate_seconds
    results = torbi_tpu_torch.evaluate.datasets([spec['dataset']], gpu='cpu')
    Path(output).write_text(json.dumps({
        'results': results, 'writes': len(writes), 'seconds': seconds}))


def run_world(task, world, inputs, directory, timeout=120):
    """Start a gloo world of ``world`` workers running ``task``
    (``modes_timing.run_ranks``); returns the output paths by rank once
    every rank has exited 0, and fails with each failed rank's exit code
    and output otherwise"""
    suffix = '.npz' if task == 'decode' else '.json'
    outputs = [Path(directory) / f'{task}{world}_rank{rank}{suffix}'
               for rank in range(world)]
    run_ranks(
        lambda rank, port: [
            sys.executable, __file__, task, str(rank), str(world), str(port),
            str(inputs), str(outputs[rank])],
        world, timeout, env=dict(OMP_NUM_THREADS='1', GLOO_SOCKET_IFNAME='lo'))
    return outputs


def main(task, rank, world, port, inputs, output):
    dist.init_process_group(
        'gloo', init_method=f'tcp://127.0.0.1:{port}', world_size=world,
        rank=rank)
    try:
        {'decode': decode, 'files': files_task,
         'evaluate': evaluate_task}[task](inputs, output)
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5], sys.argv[6])
