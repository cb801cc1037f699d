"""The port's benchmark: the configurations of the repo's ``bench.py`` on
one CUDA card, one JSON line per metric.

    python -m torbi_tpu_torch.bench [--quick] [--only toy,batch512,...]
        [--gpu cpu]

The configurations, sizes and metric names are ``bench.py``'s:

1. the README toy (batch 1, 3 frames, 3 states): exact path [1, 2, 2];
2. the headline: 512 x 512 frames of peaked synthetic pitch
   posteriorgrams under the 1440-state pitch transition taken to
   log(p + tiny), through ``dispatch.decode``; measured first, and its
   line printed again last;
3. one pitch sequence of 10,240 frames (256 at ``--quick``, under the
   same metric names): ``from_probabilities`` latency, the default
   auto-chunk route, the serial route (auto-chunking off) with its stages
   (``utils/profile.time_stages``), the uniform transition;
4. one 1,048,576-frame file through the entropy-chunked file path
   (``MIN_CHUNK_SIZE = 512``);
5. ``from_files_to_files`` over 256 files of 400-1600 frames (seed 3):
   the loader's assembly rate, whether the native loader filled the
   batches (``files_native_loader``), decode time, wall time.

Configurations 4 and 5 also give a device-resident figure: the loader's
batches staged on the card once (untimed), then their decode timed.

Each throughput is the median of ``BENCH_REPS`` runs of queued calls that
end in one scalar fetch (``utils/profile.time_submissions``, which
synchronizes before the clock stops), after a warm-up call; each latency
the median of single calls ending in a synchronize; the file metrics the
last of two passes (the first builds and caches). A metric line holds
``metric``, ``value``, ``unit``, ``device`` (the card's name, or 'cpu')
and, where the reference published one, its A40 figure as ``baseline``
with ``vs_baseline``. No TPU figure is a baseline.

Configurations 4 and 5 run under a wall-clock budget (``BENCH_BUDGET_S``,
900 s by default): one that the time left cannot fit prints
``skipped:wall-clock-budget`` lines; a configuration that fails raises.
``--gpu cpu`` (with ``--quick``: 16 x 32 x 64, small files) checks the
benchmark's own logic on the kernels' plain versions; its figures are CPU
figures. Without ``--gpu`` it needs a CUDA card and exits 2 without one.
Imports nothing of JAX.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import torbi_tpu_torch
from torbi_tpu_torch.data import native
from torbi_tpu_torch.models import pitch
from torbi_tpu_torch.ops import autochunk, band as band_ops, dispatch
from torbi_tpu_torch.utils import io, profile, timing
from torbi_tpu_torch.utils.convert import resolve_device

# The reference's published A40 figures (its README.md:19-20, as the
# repo's bench.py quotes them; timed without a device synchronize)
BASELINE_A40_BATCH1 = {
    'name': 'reference torbi on an A40, batch 1 (README.md:19)',
    'value': 3_944_452}
BASELINE_A40_BATCH512 = {
    'name': 'reference torbi on an A40, batch 512 (README.md:20)',
    'value': 692_160_422}

TINY = np.finfo(np.float32).tiny
HEADLINE = 'timesteps_decoded_per_second_1440_states_batch512'

# Seconds that configurations 4 and 5 may take at full size, their file
# generation included (chunked: 6 GB written, read and collated on the host;
# files: 256 files), with margin over what they took on an H100 machine
# (about 140 s and 11 s, PERF.md section 5); with less budget left, the
# budget skips them
CHUNKED_COST_S = 200
FILES_COST_S = 60


class Bench:
    """One run's settings, device and clock"""

    def __init__(self, device, quick, reps, budget_s):
        self.device = device
        self.cuda = device.type == 'cuda'
        self.device_name = (
            torch.cuda.get_device_name(device) if self.cuda else 'cpu')
        self.batch, self.frames, self.states = (
            (16, 32, 64) if quick else (512, 512, pitch.PITCH_BINS))
        self.reps = reps
        self.budget_s = budget_s
        self.start = time.monotonic()

    def remaining(self):
        return self.budget_s - (time.monotonic() - self.start)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def emit(self, metric, value, unit, baseline=None):
        print(json.dumps({
            'metric': metric,
            'value': value,
            'unit': unit,
            'device': self.device_name,
            'baseline': baseline,
            'vs_baseline': (
                value / baseline['value']
                if baseline is not None and value is not None else None),
        }), flush=True)

    def emit_skipped(self, metric):
        self.emit(metric, None, 'skipped:wall-clock-budget')

    def tensor(self, array, dtype=torch.float32):
        return torch.as_tensor(array, dtype=dtype).to(self.device)

    def seconds_per_call(self, fn, label, iters=8):
        """Median over ``reps`` runs of ``iters`` queued calls of ``fn``,
        each run ending in one scalar fetch"""
        times = [profile.time_submissions(fn, lambda r: r[0, 0], iters)
                 for _ in range(self.reps)]
        info(f'{label} runs ms/call: '
             + ', '.join(f'{t * 1e3:.3f}' for t in times))
        return statistics.median(times)

    def latency_ms(self, fn, calls=5):
        """Median ms of single calls of ``fn``, each ending in a
        synchronize, after a warm-up call"""
        fn()
        self.sync()
        times = []
        for _ in range(calls):
            start = time.perf_counter()
            fn()
            self.sync()
            times.append((time.perf_counter() - start) * 1e3)
        return statistics.median(times)


def info(message):
    """A progress or diagnostic line (not JSON)"""
    print(f'[bench] {message}', flush=True)


def transition_probabilities(states):
    """The 1440-state pitch matrix, or at other state counts (--quick) a
    band of the same shape"""
    if states == pitch.PITCH_BINS:
        return pitch.transition_matrix()
    halfwidth = max(states // 16, 4)
    bins = np.arange(states)
    trans = np.clip(
        halfwidth + 1.0 - np.abs(bins[:, None] - bins[None, :]), 0, None)
    return (trans / trans.sum(axis=1, keepdims=True)).astype(np.float32)


def write_corpus(directory, lengths, states):
    """The file corpus: one log-space .npy file of synthetic pitch
    posteriorgrams per length (seeds 1000, 1001, ...), and the transition's
    probability file; returns (input paths, output paths, transition
    path)"""
    trans_path = os.path.join(directory, 'transition.npy')
    np.save(trans_path, transition_probabilities(states))
    inputs, outputs = [], []
    for i, length in enumerate(lengths):
        path = os.path.join(directory, f'{i:05d}.npy')
        np.save(path, pitch.synthetic_posteriorgrams(
            1, int(length), states, seed=1000 + i)[0])
        inputs.append(path)
        outputs.append(os.path.join(directory, f'{i:05d}_out.npy'))
    return inputs, outputs, trans_path


def bench_toy(bench):
    """The README toy: exact path [1, 2, 2]"""
    observation = np.array([[
        [0.25, 0.5, 0.25],
        [0.25, 0.25, 0.5],
        [0.33, 0.33, 0.33]]], dtype=np.float32)
    transition = np.array([
        [0.5, 0.25, 0.25],
        [0.33, 0.34, 0.33],
        [0.25, 0.25, 0.5]], dtype=np.float32)
    initial = np.array([0.4, 0.35, 0.25], dtype=np.float32)
    indices = torbi_tpu_torch.from_probabilities(
        observation, transition=transition, initial=initial,
        log_probs=False, gpu=bench.device).cpu().numpy()
    bench.emit('toy_exact_match', float((indices[0] == [1, 2, 2]).all()),
               'bool')


def bench_batch512(bench):
    """The headline: single-call latency, then the throughput of queued
    calls, returned for the last line"""
    info('headline: generating inputs...')
    obs = bench.tensor(pitch.synthetic_posteriorgrams(
        bench.batch, bench.frames, bench.states))
    transition = bench.tensor(
        np.log(transition_probabilities(bench.states) + TINY))
    initial = bench.tensor(np.log(
        np.full(bench.states, 1.0 / bench.states, dtype=np.float32) + TINY))
    batch_frames = torch.full(
        (bench.batch,), bench.frames, dtype=torch.int32, device=bench.device)

    def run():
        return dispatch.decode(
            obs, batch_frames, transition, initial, finite_observation=True,
            device=bench.device)

    bench.emit('decode_call_latency_ms_batch512', bench.latency_ms(run),
               'ms')
    return bench.batch * bench.frames / bench.seconds_per_call(
        run, 'batch512')


def bench_batch1(bench, frames):
    """One pitch sequence: from_probabilities latency, the auto-chunk
    route, the serial route and its stages, the uniform transition"""
    host = pitch.synthetic_posteriorgrams(1, frames, bench.states, seed=1)
    trans_prob = transition_probabilities(bench.states)

    bench.emit(
        'decode_call_latency_ms_batch1_10240_frames',
        bench.latency_ms(lambda: torbi_tpu_torch.from_probabilities(
            host, transition=np.log(trans_prob + TINY), log_probs=True,
            gpu=bench.device)),
        'ms')

    obs = bench.tensor(host)
    bf = torch.full((1,), frames, dtype=torch.int32, device=bench.device)
    transition = bench.tensor(np.log(trans_prob + TINY))
    initial = torbi_tpu_torch.core._default_initial(
        bench.states, bench.device)

    def run():
        return dispatch.decode(
            obs, bf, transition, initial, apply_epsilon=True,
            device=bench.device)

    band = band_ops.detect_band(transition)
    entropy = autochunk.framewise_entropy(obs, bench.states, True)
    plan = autochunk.plan_splits(
        entropy.cpu().numpy(), frames,
        int(torbi_tpu_torch.BATCH1_CHUNK_FRAMES))
    info(f'batch1: band {band}; auto-chunk plan '
         + ('none (serial route)' if plan is None else
            f'{len(plan[0])} rows x <= {int(plan[1].max())} frames'))
    bench.emit('timesteps_per_second_batch1_10240_frames',
               frames / bench.seconds_per_call(run, 'batch1'),
               'timesteps/s', BASELINE_A40_BATCH1)

    saved = torbi_tpu_torch.BATCH1_AUTO_CHUNK
    torbi_tpu_torch.BATCH1_AUTO_CHUNK = False
    try:
        bench.emit('timesteps_per_second_batch1_10240_frames_serial',
                   frames / bench.seconds_per_call(run, 'batch1-serial'),
                   'timesteps/s')
        stages = profile.time_stages(
            obs, bf, transition, initial, apply_epsilon=True)
        info(f'batch1 serial stages timed {stages["kernels"]}')
        for key in ('forward_ms', 'backtrace_ms', 'pipeline_ms', 'e2e_ms',
                    'glue_ms', 'host_ms'):
            bench.emit(f'batch1_{key}', float(stages[key]), 'ms')
    finally:
        torbi_tpu_torch.BATCH1_AUTO_CHUNK = saved

    uniform = torbi_tpu_torch.core._default_transition(
        bench.states, bench.device)
    bench.emit(
        'timesteps_per_second_batch1_10240_frames_uniform',
        frames / bench.seconds_per_call(lambda: dispatch.decode(
            obs, bf, uniform, initial, apply_epsilon=True,
            device=bench.device), 'batch1-uniform'),
        'timesteps/s')


def device_resident_throughput(bench, input_files, trans_path, iters=4):
    """Timesteps and seconds of decoding the loader's batches of
    ``input_files`` staged on the card once (untimed): the decode without
    the file reads and the copies"""
    transition = bench.tensor(np.log(np.load(trans_path) + TINY))
    initial = torbi_tpu_torch.core._default_initial(
        bench.states, bench.device)
    total_steps, total_sec = 0, 0.0
    for observation, batch_frames, _, _ in torbi_tpu_torch.data.loader(
            input_files):
        obs = bench.tensor(observation)
        bf = bench.tensor(batch_frames, torch.int32)

        def run():
            return dispatch.decode(
                obs, bf, transition, initial, apply_epsilon=True,
                device=bench.device)

        sec = profile.time_submissions(run, lambda r: r[0, 0], iters=iters)
        total_steps += int(bf.sum()) * iters
        total_sec += sec * iters
        del obs
    return total_steps, total_sec


def files_pass(bench, inputs, outputs, trans_path):
    """One from_files_to_files pass: (wall s, decode s)"""
    timing.reset()
    bench.sync()
    start = time.perf_counter()
    torbi_tpu_torch.from_files_to_files(
        inputs, outputs, transition_file=trans_path, log_probs=True,
        gpu=bench.device)
    wall_s = time.perf_counter() - start
    return wall_s, timing.results()['torbi']


def check_outputs(inputs, outputs, frames):
    """Every output holds one int32 index per frame of its input"""
    for path, output, length in zip(inputs, outputs, frames):
        indices = io.load(output)
        if indices.dtype != np.int32 or indices.shape != (length,):
            raise RuntimeError(
                f'{output}: {indices.dtype} {indices.shape}, expected '
                f'int32 ({length},) for {path}')


def bench_chunked(bench, frames, passes=2):
    """One long sequence through the entropy-chunked file path"""
    began = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        obs_path = os.path.join(tmp, 'long.npy')
        out_path = os.path.join(tmp, 'long_out.npy')
        trans_path = os.path.join(tmp, 'transition.npy')
        np.save(trans_path, transition_probabilities(bench.states))

        info(f'chunked: generating {frames} frames to disk...')
        out = np.lib.format.open_memmap(
            obs_path, mode='w+', dtype=np.float32,
            shape=(frames, bench.states))
        step = 1 << 16
        for start in range(0, frames, step):
            stop = min(start + step, frames)
            out[start:stop] = pitch.synthetic_posteriorgrams(
                1, stop - start, bench.states, seed=start)[0]
        out.flush()
        del out

        saved = torbi_tpu_torch.MIN_CHUNK_SIZE
        torbi_tpu_torch.MIN_CHUNK_SIZE = 512
        try:
            for _ in range(passes):
                wall_s, decode_s = files_pass(
                    bench, [obs_path], [out_path], trans_path)
                info(f'chunked pass: wall {wall_s:.3f} s, decode '
                     f'{decode_s:.3f} s')
            check_outputs([obs_path], [out_path], [frames])
            steps, seconds = device_resident_throughput(
                bench, [obs_path], trans_path)
        finally:
            torbi_tpu_torch.MIN_CHUNK_SIZE = saved
    info(f'chunked: {time.monotonic() - began:.0f} s in all')
    name = ('timesteps_per_second_1m_frames_chunked' if frames == 1 << 20
            else f'timesteps_per_second_chunked_{frames}_frames')
    bench.emit(name, frames / decode_s, 'timesteps/s', BASELINE_A40_BATCH512)
    bench.emit(name + '_device', steps / seconds, 'timesteps/s',
               BASELINE_A40_BATCH512)


def bench_loader_assembly(bench, input_files):
    """The loader's batch assembly rate on the host (no decode): bytes of
    batches per second, the last of three passes (the first two fill the
    page cache and the pinned buffers), with the buffers the file path
    uses (pinned for a decode on the card)"""
    for _ in range(3):
        total_bytes, batches = 0, 0
        start = time.perf_counter()
        for observation, _, _, _ in torbi_tpu_torch.data.loader(
                input_files, pin_memory=bench.cuda):
            total_bytes += observation.numel() * observation.element_size()
            batches += 1
        elapsed = time.perf_counter() - start
    info(f'loader assembly: {total_bytes / 1e6:.0f} MB in {elapsed:.3f} s '
         f'({batches} batches)')
    bench.emit('files_loader_assembly_bytes_per_s', total_bytes / elapsed,
               'bytes/s')


def bench_files(bench, n_files, seed=3, passes=2):
    """from_files_to_files over a synthetic corpus: native loader, copies,
    decode, saves"""
    began = time.monotonic()
    rng = np.random.default_rng(seed)
    lengths = rng.integers(400, 1600, size=n_files)
    with tempfile.TemporaryDirectory() as tmp:
        info(f'files: generating {n_files} files...')
        inputs, outputs, trans_path = write_corpus(tmp, lengths,
                                                   bench.states)
        bench_loader_assembly(bench, inputs)

        for _ in range(passes):
            native.counts.update(filled=0, fallback=0)
            wall_s, decode_s = files_pass(bench, inputs, outputs, trans_path)
            info(f'files pass: wall {wall_s:.3f} s, decode {decode_s:.3f} s,'
                 f' native batches {native.counts}')
        check_outputs(inputs, outputs, lengths)
        bench.emit('files_native_loader', float(
            native.counts['filled'] > 0 and native.counts['fallback'] == 0),
            'bool')
        steps, seconds = device_resident_throughput(bench, inputs, trans_path)

    info(f'files: {time.monotonic() - began:.0f} s in all')
    timesteps = int(lengths.sum())
    bench.emit('timesteps_per_second_files_decode', timesteps / decode_s,
               'timesteps/s', BASELINE_A40_BATCH512)
    bench.emit('timesteps_per_second_files_wall', timesteps / wall_s,
               'timesteps/s', BASELINE_A40_BATCH512)
    bench.emit('timesteps_per_second_files_device', steps / seconds,
               'timesteps/s', BASELINE_A40_BATCH512)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        '--quick', action='store_true',
        help='tiny sizes: a check of the benchmark logic itself')
    parser.add_argument(
        '--only', default=None,
        help='comma-separated subset: toy,batch512,batch1,chunked,files')
    parser.add_argument(
        '--gpu', default=None,
        help="decode device: a CUDA index, or 'cpu' (default cuda:0)")
    args = parser.parse_args(argv)

    gpu = args.gpu
    if gpu is not None and gpu != 'cpu':
        gpu = int(gpu)
    if gpu != 'cpu' and not torch.cuda.is_available():
        print('torbi_tpu_torch.bench: no CUDA card (pass --gpu cpu to '
              'check the benchmark on the CPU)', file=sys.stderr)
        sys.exit(2)
    bench = Bench(
        resolve_device(gpu), args.quick,
        reps=1 if args.quick else int(os.environ.get('BENCH_REPS', 5)),
        budget_s=float(os.environ.get('BENCH_BUDGET_S', 900)))
    info(f'device {bench.device_name}, torch {torch.__version__}, '
         f'{bench.batch} x {bench.frames} x {bench.states}')
    if bench.cuda:
        # The card's power limit: a card set below 700 W runs slower
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True)
        info(f'nvidia-smi: {smi.stdout.strip() or smi.stderr.strip()}')

    selected = args.only.split(',') if args.only else [
        'toy', 'batch512', 'batch1', 'chunked', 'files']
    headline = None
    if 'toy' in selected:
        bench_toy(bench)
    if 'batch512' in selected:
        headline = bench_batch512(bench)
        bench.emit(HEADLINE, headline, 'timesteps/s', BASELINE_A40_BATCH512)
    if 'batch1' in selected:
        bench_batch1(bench, frames=256 if args.quick else 10240)
    if 'chunked' in selected:
        if args.quick:
            bench_chunked(bench, frames=1 << 12)
        elif bench.remaining() > CHUNKED_COST_S:
            bench_chunked(bench, frames=1 << 20)
        else:
            bench.emit_skipped('timesteps_per_second_1m_frames_chunked')
            bench.emit_skipped(
                'timesteps_per_second_1m_frames_chunked_device')
    if 'files' in selected:
        if args.quick or bench.remaining() > FILES_COST_S:
            bench_files(bench, n_files=8 if args.quick else 256)
        else:
            for metric in (
                    'files_loader_assembly_bytes_per_s',
                    'files_native_loader',
                    'timesteps_per_second_files_decode',
                    'timesteps_per_second_files_wall',
                    'timesteps_per_second_files_device'):
                bench.emit_skipped(metric)

    info(f'total wall: {time.monotonic() - bench.start:.0f} s (budget '
         f'{bench.budget_s:.0f} s)')
    # The headline, measured first, is also the last line
    if headline is not None:
        bench.emit(HEADLINE, headline, 'timesteps/s', BASELINE_A40_BATCH512)


if __name__ == '__main__':
    main()
