"""Benchmark of torbi_tpu_torch on CUDA cards: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout. The cell, its configuration, its traffic
mix and its metrics are named in ``BENCHMARK.json`` and found by name
under this folder (``spec.py``). A run sets up (the kernels built into
the checkout's ``build/``, the inputs made on the card from ``--seed``,
every shape of the cell called once), measures a closed loop for
``--seconds`` (``loop.py``), then checks the outputs of the timed calls
against the plain reference (``check.py``) and prints one JSON line last
on standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the end-to-end metrics; with ``--trace 1`` the per-layer ones, read from
a profiled stretch of the window), ``device``, with ``--trace 1``
``breakdown``, and ``checks``, each number compared beside its limit. A
cell on more than one card starts one process a card itself, over NCCL
on a free local port; rank 0's clock times the window.

It exits with another code than 0, and prints no result, without a CUDA
card (or with fewer cards than the cell asks for), where the program is
not in the checkout, and where JAX or the JAX package was loaded.
"""
import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

STARTED = time.time()
ROOT = Path(__file__).resolve().parent.parent
PROGRAM = 'torbi_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'torbi_tpu')
# Seconds a world of ranks may take, from its start to its results
WORLD_TIMEOUT = 320

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import check, spec  # noqa: E402


def log(message):
    print(f'[bench] {message}', file=sys.stderr, flush=True)


class Failure(Exception):
    """A run that cannot give a result"""


###############################################################################
# Set-up
###############################################################################


def cache_environment(root=ROOT):
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, so that only a checkout's first run builds"""
    build = Path(root) / 'build'
    os.environ['TORCH_EXTENSIONS_DIR'] = str(build / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(build / 'triton')
    os.environ['CUDA_CACHE_PATH'] = str(build / 'cuda_cache')


def import_program(root=ROOT):
    """The program, imported from this checkout"""
    try:
        import torbi_tpu_torch
    except ImportError as error:
        raise Failure(f'{PROGRAM} does not import: {error}') from error
    where = Path(torbi_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in where.parents:
        raise Failure(f'{PROGRAM} imports from {where}, not from the '
                      f'checkout at {root}')
    return torbi_tpu_torch


def configure(program, config):
    """Apply the configuration's upper-case keys, torbi's configuration
    constants, onto the program, as its --config files do"""
    from torbi_tpu_torch.config.static import derive

    for key, value in config.items():
        if key.isupper():
            setattr(program, key, value)
    derive()


def build_kernels(log_line):
    """Build the decode kernels where they are not built yet; returns the
    seconds the build took, None where everything was built"""
    from torbi_tpu_torch.csrc import build

    if all(build.target(name).exists() for name in build.DECODE_SOURCES):
        return None
    started = time.perf_counter()
    build.build(build.DECODE_SOURCES)
    seconds = time.perf_counter() - started
    log_line(f'compile_s {seconds}')
    return seconds


def forbidden_modules():
    """The loaded modules whose top-level name is JAX's or the JAX
    package's"""
    return sorted({name.split('.')[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


###############################################################################
# A run's context
###############################################################################


class Context:
    """What a caller gets: the cell, the run's settings, the device, the
    program, and a world's rank"""

    def __init__(self, cell, seed, seconds, trace, device, program, rank=0,
                 world=1):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.program = program
        self.rank = rank
        self.world = world

    def log(self, message):
        log(f'rank {self.rank}: {message}' if self.world > 1 else message)

    def synchronize(self):
        import torch

        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def barrier(self):
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier()

    def agree_cycles(self, cycle_seconds):
        """The window's cycles, the same on every rank of a world (rank
        0's count wins); None for one process, which times its window"""
        if self.world == 1:
            return None
        import torch
        import torch.distributed as dist

        count = torch.tensor(
            [max(1, -int(-self.seconds // max(cycle_seconds, 1e-6)))],
            device=self.device)
        dist.broadcast(count, 0)
        return int(count)

    def memory_peak(self):
        import torch

        if self.device.type != 'cuda':
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self):
        import gc

        import torch

        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()


def execute(cell, seed, seconds, trace, device, program, rank=0, world=1):
    """One process's run of ``cell`` on ``device``: its record"""
    configure(program, cell.config)
    ctx = Context(cell, seed, seconds, trace, device, program, rank, world)
    compile_s = build_kernels(ctx.log) if device.type == 'cuda' else None
    record = cell.caller().run(ctx)
    record['compile_s'] = compile_s
    record['forbidden'] = forbidden_modules()
    return record


###############################################################################
# A world of ranks
###############################################################################


def free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def rank_record(root, workload, seed, seconds, trace, rank, world, port,
                device_type='cuda'):
    """One rank's record of a world: on the card of its rank over NCCL, or
    on the CPU over gloo (the kernels' plain versions, for tests)"""
    import torch
    import torch.distributed as dist

    program = import_program()
    cell = spec.Cell(root, workload)
    if device_type == 'cuda':
        device, backend = torch.device('cuda', rank), 'nccl'
        torch.cuda.set_device(device)
    else:
        device, backend = torch.device('cpu'), 'gloo'
    dist.init_process_group(
        backend, init_method=f'tcp://127.0.0.1:{port}', world_size=world,
        rank=rank)
    try:
        return execute(cell, seed, seconds, trace, device, program, rank,
                       world)
    finally:
        dist.destroy_process_group()


def rank_main(args):
    """One rank of a world that ``run_world`` started: writes its record
    to ``args.result``"""
    record = rank_record(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), args.rank, args.world, args.port)
    Path(args.result).write_text(json.dumps(record))


def run_world(cell, args):
    """Start one process a card, wait for them, and return their records
    by rank"""
    world = cell.chips
    port = free_port()
    with tempfile.TemporaryDirectory(prefix='torbi-world-') as folder:
        results = [Path(folder) / f'rank{rank}.json' for rank in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             '--workload', cell.name, '--seed', str(args.seed),
             '--seconds', str(args.seconds), '--trace', str(args.trace),
             '--rank', str(rank), '--world', str(world), '--port', str(port),
             '--result', str(results[rank])],
            stdout=sys.stderr, cwd=str(ROOT),
            env=dict(os.environ, OMP_NUM_THREADS='1'))
            for rank in range(world)]
        deadline = time.monotonic() + WORLD_TIMEOUT
        try:
            for proc in procs:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        failed = [rank for rank, proc in enumerate(procs) if proc.returncode]
        if failed or not all(path.exists() for path in results):
            raise Failure(f'ranks {failed} of a world of {world} failed '
                          f'(exit codes {[p.returncode for p in procs]})')
        return [json.loads(path.read_text()) for path in results]


###############################################################################
# The result
###############################################################################


def combine(records):
    """One record of a world's (rank 0's clock and counts; failures,
    differing frames and modules summed over the ranks; the fullest
    card's peak)"""
    first = dict(records[0])
    first['failed'] = sum(record['failed'] for record in records)
    first['memory_peak_bytes'] = max(
        record['memory_peak_bytes'] for record in records)
    first['checks'] = {
        name: [sum(record['checks'][name][0] for record in records), limit]
        for name, (_, limit) in records[0]['checks'].items()}
    first['forbidden'] = sorted({name for record in records
                                 for name in record['forbidden']})
    first['stretches'] = [record.get('stretch') for record in records]
    return first


def card_lines():
    """The card's name, power limit and clocks, as nvidia-smi reads them"""
    try:
        answer = subprocess.run(
            ['nvidia-smi', '--query-gpu=index,name,power.limit,power.draw,'
             'clocks.sm,clocks.max.sm,temperature.gpu',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60)
        return answer.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return []


def result(cell, record, traced, kind):
    """The final line's object"""
    record = dict(record, started=STARTED)
    metrics = {}
    for entry in cell.metrics(traced):
        value = cell.reader(entry['name']).read(record)
        if value is not None:
            metrics[entry['name']] = {'value': value, 'unit': entry['unit']}
    device = {'platform': 'gpu', 'kind': kind, 'count': cell.chips,
              'memory_peak_bytes': record['memory_peak_bytes']}
    line = {'correct': check.passed(record['checks']),
            'attempted': record['attempted'], 'failed': record['failed'],
            'metrics': metrics, 'device': device}
    stretches = [s for s in record.get('stretches') or [] if s]
    if traced and stretches:
        device['busy_s'] = statistics.fmean(s['busy_s'] for s in stretches)
        device['window_s'] = statistics.fmean(s['span_s'] for s in stretches)
        first = stretches[0]
        line['breakdown'] = {
            'device_ops': [[name, seconds] for name, (seconds, _) in list(
                first['device_ops'].items())[:10]],
            'idle_gaps': first['idle_gaps'][:10]}
    line['checks'] = {name: {'value': value, 'limit': limit}
                      for name, (value, limit) in record['checks'].items()}
    return line


def parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    # One rank of a world this script started
    for name in ('--rank', '--world', '--port'):
        parser.add_argument(name, type=int, help=argparse.SUPPRESS)
    parser.add_argument('--result', help=argparse.SUPPRESS)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    cache_environment()
    if args.rank is not None:
        return rank_main(args)
    try:
        cell = spec.Cell(ROOT, args.workload)
        program = import_program()
        import torch

        if not torch.cuda.is_available():
            raise Failure('no CUDA card: this benchmark measures the card '
                          'and never falls back to the CPU')
        if torch.cuda.device_count() < cell.chips:
            raise Failure(f'{cell.name} needs {cell.chips} cards; there are '
                          f'{torch.cuda.device_count()}')
        if cell.chips > 1:
            record = combine(run_world(cell, args))
        else:
            record = combine([execute(
                cell, args.seed, args.seconds, bool(args.trace),
                torch.device('cuda', 0), program)])
        kind = torch.cuda.get_device_name(0)
    except Failure as failure:
        log(f'failed: {failure}')
        return 2
    found = sorted(set(record['forbidden']) | set(forbidden_modules()))
    if found:
        log(f'failed: modules of JAX or the JAX package were loaded: {found}')
        return 3
    line = result(cell, record, bool(args.trace), kind)
    for card in card_lines():
        print(f'card {card}', flush=True)
    print(f"window calls {record['attempted']} frames "
          f"{record.get('frames', 0)} seconds {record['window_s']} "
          f"memory_peak_bytes {record['memory_peak_bytes']}", flush=True)
    if record.get('compile_s') is not None:
        print(f"first run compile_s {record['compile_s']}", flush=True)
    check.report(record['checks'])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
