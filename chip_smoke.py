"""Smoke run of torbi_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel bitwise against its plain PyTorch version on the card, decodes the
README toy, and drives the two decode paths through the public entry point
``from_probabilities`` with the launch counters reset just before and read
just after:

- the banded path (the headline): 512 sequences x 512 frames of peaked
  synthetic pitch posteriorgrams under the 1440-state pitch transition
  taken to log(p + tiny) -- the banded forward kernel, then the backtrace;
- the dense path: a random dense 1440-state transition at 8 x 64, and the
  README toy -- the dense forward kernel, then the backtrace.

Prints the card's name and power limit, per-kernel times beside their
bounds and their plain versions' times, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
without the last line. Needs one CUDA card; imports nothing of JAX.
"""
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TINY = np.finfo(np.float32).tiny
BATCH, FRAMES, STATES = 512, 512, 1440
DENSE_BATCH, DENSE_FRAMES = 8, 64

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and FP32 outside the
# tensor cores (FMA counted as two operations)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def info(message):
    print(f'[smoke] {message}', flush=True)


def fail(message):
    info(f'FAILED: {message}')
    sys.exit(1)


def synthetic_posteriorgrams(batch, frames, states, seed=0):
    """Peaked synthetic pitch posteriorgrams in log space (float32); the
    generator of bench.py"""
    rng = np.random.default_rng(seed)
    centers = np.clip(
        np.cumsum(rng.integers(-3, 4, size=(batch, frames)), axis=1)
        + states // 2,
        0, states - 1)
    bins = np.arange(states, dtype=np.float32)[None, None, :]
    out = np.empty((batch, frames, states), dtype=np.float32)
    for start in range(0, batch, 64):
        stop = min(start + 64, batch)
        dist = np.abs(bins - centers[start:stop, :, None].astype(np.float32))
        logits = -0.5 * (dist / 3.0) ** 2
        obs = logits - np.log(
            np.exp(logits).sum(axis=-1, keepdims=True))
        out[start:stop] = np.log(np.exp(obs) + TINY)
    return out


def cuda_ms(torch, fn, iters, warmup=1):
    """Mean ms per call of ``fn`` on the card (CUDA events)"""
    for _ in range(warmup):
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


def max_abs_err(torch, got, expected):
    if torch.equal(got, expected):
        return 0.0
    diff = (got.double() - expected.double()).abs()
    return float(torch.nan_to_num(diff, nan=float('inf')).max())


def require_equal(torch, name, got, expected):
    err = max_abs_err(torch, got, expected)
    if not torch.equal(got, expected):
        fail(f'{name}: kernel differs from its plain version '
             f'(max abs err {err}; tolerance: bitwise)')
    info(f'{name}: bitwise equal to its plain version (tolerance: bitwise)')
    return err


def bound_ms(bytes_moved, operations):
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op_ms = operations / PEAK_FP32_PER_S * 1e3
    return (max(byte_ms, op_ms),
            'bytes' if byte_ms >= op_ms else 'operations')


def valid_steps(batch_frames, frames):
    """Frame steps t >= 1 with t < batch_frames, summed over the batch"""
    return int((batch_frames.clamp(max=frames) - 1).clamp(min=0).sum())


def main():
    try:
        import torch
    except ImportError:
        fail('PyTorch is not installed')
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke run needs a '
             'CUDA card')
    if not (ROOT / 'torbi_tpu_torch' / '__init__.py').is_file():
        fail(f'torbi_tpu_torch is not beside {Path(__file__).name}')
    sys.path.insert(0, str(ROOT))

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    if smi.returncode or not smi.stdout.strip():
        fail(f'nvidia-smi failed: {smi.stderr.strip()}')
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    info(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
         f'CUDA {torch.version.cuda}')

    import torbi_tpu_torch
    from torbi_tpu_torch.csrc import build
    from torbi_tpu_torch.models import pitch
    from torbi_tpu_torch.ops import backtrace, band, dense, dispatch

    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)

    # 1. Build every kernel (one nvcc per source, in parallel)
    start = time.perf_counter()
    build.build()
    info(f'built {", ".join(build.SOURCES)} in '
         f'{time.perf_counter() - start:.1f} s')
    for name, output in build.compiler_output.items():
        for line in output.splitlines():
            if 'registers' in line or 'spill' in line:
                info(f'{name}: {line.strip()}')

    # Inputs of the banded path, made from a seed
    start = time.perf_counter()
    obs_host = synthetic_posteriorgrams(BATCH, FRAMES, STATES)
    trans_host = np.log(pitch.transition_matrix() + TINY).astype(np.float32)
    init_host = np.log(
        np.full(STATES, 1.0 / STATES, dtype=np.float32) + TINY)
    obs = torch.from_numpy(obs_host).to(device)
    trans = torch.from_numpy(trans_host).to(device)
    init = torch.from_numpy(init_host).to(device)
    bf = torch.full((BATCH,), FRAMES, dtype=torch.int32, device=device)
    info(f'inputs made in {time.perf_counter() - start:.1f} s')

    band_tuple = band.detect_band(trans)
    info(f'band (lo, width, floor) = {band_tuple}')
    if band_tuple is None or band_tuple[1] != 175:
        fail(f'unexpected band {band_tuple} for the pitch transition')
    lo, width, _ = band_tuple
    band_matrix = band.build_band_matrix(trans, lo, width)
    # What the main path hands the kernels: the epsilon step applied once
    obs_k = dispatch.convert(obs, True, True).contiguous()
    convert_ms = cuda_ms(
        torch, lambda: dispatch.convert(obs, True, True), iters=5)
    info(f'epsilon step (plain torch elementwise, headline shape): '
         f'{convert_ms:.3f} ms')

    kernels = {}

    # 2. Each kernel against its plain version on the card
    # K1: banded forward at the headline shape
    post_k, posterior_k = band.viterbi_forward_band(
        obs_k, bf, init, band_tuple, band_matrix)
    post_r, _ = band.band_forward_reference(
        obs_k, bf, init, band_tuple, band_matrix)
    torch.cuda.synchronize()
    err = require_equal(torch, 'K1 band_forward', post_k, post_r)
    del post_r
    k1_ms = cuda_ms(torch, lambda: band.viterbi_forward_band(
        obs_k, bf, init, band_tuple, band_matrix), iters=5)
    k1_plain_ms = cuda_ms(torch, lambda: band.band_forward_reference(
        obs_k, bf, init, band_tuple, band_matrix), iters=1, warmup=0)
    steps = valid_steps(bf, FRAMES)
    # In-range (source, destination) pairs of the band: the candidates a
    # step needs
    j = torch.arange(STATES)
    in_range = int((torch.clamp(STATES - lo - j, max=width)
                    - torch.clamp(-lo - j, min=0)).clamp(min=0).sum())
    k1_bytes = (2 * BATCH * FRAMES * STATES + width * STATES + STATES) * 4
    # Per step: an add and a max per candidate; per state the floor max,
    # the posterior max and the observation add
    k1_ops = steps * (2 * in_range + 3 * STATES)
    kernels['band_forward'] = dict(
        name='band_forward', route='cuda',
        source='torbi_tpu_torch/csrc/band_forward.cu',
        replaces='torbi_tpu/ops/band.py:512', path='banded',
        max_abs_err=err, ms=k1_ms, plain_ms=k1_plain_ms,
        bound=bound_ms(k1_bytes, k1_ops), library_ms=None)
    info(f'K1 band_forward: {k1_ms:.3f} ms, plain {k1_plain_ms:.1f} ms')

    # K3: backtrace on K1's output
    idx_k = backtrace.backtrace_posteriors(post_k, trans, posterior_k, bf)
    idx_r = backtrace.backtrace_reference(post_k, trans, posterior_k, bf)
    torch.cuda.synchronize()
    err = require_equal(torch, 'K3 backtrace (banded stream)', idx_k, idx_r)
    k3_ms = cuda_ms(torch, lambda: backtrace.backtrace_posteriors(
        post_k, trans, posterior_k, bf), iters=5)
    k3_plain_ms = cuda_ms(torch, lambda: backtrace.backtrace_reference(
        post_k, trans, posterior_k, bf), iters=1, warmup=0)
    # Stream rows the chase reads, the final posterior, the transition
    # once, the indices out
    k3_bytes = (steps * STATES + BATCH * STATES + STATES * STATES
                + BATCH * FRAMES) * 4
    k3_ops = (steps + BATCH) * 2 * STATES
    kernels['backtrace'] = dict(
        name='backtrace', route='cuda',
        source='torbi_tpu_torch/csrc/backtrace.cu',
        replaces='torbi_tpu/ops/backtrace.py:293', path='banded',
        max_abs_err=err, ms=k3_ms, plain_ms=k3_plain_ms,
        bound=bound_ms(k3_bytes, k3_ops), library_ms=None)
    info(f'K3 backtrace: {k3_ms:.3f} ms, plain {k3_plain_ms:.1f} ms')
    del post_k, posterior_k

    # K2: dense forward at the dense path's shape and on the toy; K3 on
    # its output
    rng = np.random.default_rng(1)
    dense_obs_host = np.log(
        rng.dirichlet(np.ones(STATES), size=(DENSE_BATCH, DENSE_FRAMES))
        .astype(np.float32) + TINY).astype(np.float32)
    dense_trans_host = np.log(
        rng.dirichlet(np.ones(STATES), size=STATES).astype(np.float32)
        + TINY).astype(np.float32)
    dense_obs = torch.from_numpy(dense_obs_host).to(device)
    dense_trans = torch.from_numpy(dense_trans_host).to(device)
    dense_bf = torch.tensor(
        [DENSE_FRAMES] * (DENSE_BATCH - 2) + [DENSE_FRAMES // 2, 1],
        dtype=torch.int32, device=device)
    if band.detect_band(dense_trans) is not None:
        fail('the random dense transition was detected as banded')
    dense_obs_k = dispatch.convert(dense_obs, True, True).contiguous()
    dpost_k, dposterior_k = dense.viterbi_forward_dense(
        dense_obs_k, dense_bf, dense_trans, init)
    dpost_r, _ = dense.dense_forward_reference(
        dense_obs_k, dense_bf, dense_trans, init)
    torch.cuda.synchronize()
    err = require_equal(torch, 'K2 dense_forward', dpost_k, dpost_r)
    toy_obs = torch.log(torch.tensor([[
        [0.25, 0.5, 0.25],
        [0.25, 0.25, 0.5],
        [0.33, 0.33, 0.33]]], device=device))
    toy_trans = torch.log(torch.tensor([
        [0.5, 0.25, 0.25],
        [0.33, 0.34, 0.33],
        [0.25, 0.25, 0.5]], device=device))
    toy_init = torch.log(torch.tensor([0.4, 0.35, 0.25], device=device))
    toy_bf = torch.tensor([3], dtype=torch.int32, device=device)
    tpost_k, tposterior_k = dense.viterbi_forward_dense(
        toy_obs, toy_bf, toy_trans, toy_init)
    tpost_r, _ = dense.dense_forward_reference(
        toy_obs, toy_bf, toy_trans, toy_init)
    err = max(err, require_equal(
        torch, 'K2 dense_forward (toy)', tpost_k, tpost_r))
    k2_ms = cuda_ms(torch, lambda: dense.viterbi_forward_dense(
        dense_obs_k, dense_bf, dense_trans, init), iters=5)
    k2_plain_ms = cuda_ms(torch, lambda: dense.dense_forward_reference(
        dense_obs_k, dense_bf, dense_trans, init), iters=1, warmup=0)
    dsteps = valid_steps(dense_bf, DENSE_FRAMES)
    k2_bytes = (2 * DENSE_BATCH * DENSE_FRAMES * STATES + STATES * STATES
                + STATES) * 4
    k2_ops = dsteps * (2 * STATES * STATES + STATES)
    kernels['dense_forward'] = dict(
        name='dense_forward', route='cuda',
        source='torbi_tpu_torch/csrc/dense_forward.cu',
        replaces='torbi_tpu/ops/pallas.py:48', path='dense',
        max_abs_err=err, ms=k2_ms, plain_ms=k2_plain_ms,
        bound=bound_ms(k2_bytes, k2_ops), library_ms=None)
    info(f'K2 dense_forward: {k2_ms:.3f} ms, plain {k2_plain_ms:.1f} ms '
         f'({DENSE_BATCH} x {DENSE_FRAMES} x {STATES})')
    for label, post, posterior, tr, frames_of in (
            ('dense stream', dpost_k, dposterior_k, dense_trans, dense_bf),
            ('toy stream', tpost_k, tposterior_k, toy_trans, toy_bf)):
        got = backtrace.backtrace_posteriors(post, tr, posterior, frames_of)
        want = backtrace.backtrace_reference(post, tr, posterior, frames_of)
        kernels['backtrace']['max_abs_err'] = max(
            kernels['backtrace']['max_abs_err'],
            require_equal(torch, f'K3 backtrace ({label})', got, want))
    del dpost_k, dpost_r

    counters = {
        'band_forward': band.viterbi_forward_band,
        'dense_forward': dense.viterbi_forward_dense,
        'backtrace': backtrace.backtrace_posteriors,
    }

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in counters.items()}

    # 3 + dense path: the README toy and the dense decode through the
    # public entry point, counters reset just before and read just after
    toy_probs = (
        np.array([[[0.25, 0.5, 0.25], [0.25, 0.25, 0.5],
                   [0.33, 0.33, 0.33]]], dtype=np.float32),
        np.array([[0.5, 0.25, 0.25], [0.33, 0.34, 0.33],
                  [0.25, 0.25, 0.5]], dtype=np.float32),
        np.array([0.4, 0.35, 0.25], dtype=np.float32))
    reset_counts()
    toy = torbi_tpu_torch.from_probabilities(
        toy_probs[0], transition=toy_probs[1], initial=toy_probs[2],
        gpu=0)
    dense_out = torbi_tpu_torch.from_probabilities(
        dense_obs, batch_frames=dense_bf, transition=dense_trans,
        initial=init, log_probs=True, gpu=0)
    torch.cuda.synchronize()
    dense_counts = read_counts()
    info(f'dense path launches: {dense_counts}')
    if toy.device != device or toy.dtype != torch.int32:
        fail(f'toy result is {toy.dtype} on {toy.device}')
    if toy.tolist() != [[1, 2, 2]]:
        fail(f'README toy decoded to {toy.tolist()}, expected [[1, 2, 2]]')
    info('README toy decodes to [[1, 2, 2]] on the card')
    if dense_counts['dense_forward'] < 1 or dense_counts['backtrace'] < 1:
        fail('the dense path did not launch the dense forward and '
             'backtrace kernels')
    dense_scan = torbi_tpu_torch.from_probabilities(
        dense_obs, batch_frames=dense_bf, transition=dense_trans,
        initial=init, log_probs=True, gpu=0, backend='scan')
    dense_cpu = torbi_tpu_torch.from_probabilities(
        dense_obs_host, batch_frames=dense_bf.cpu(),
        transition=dense_trans_host, initial=init_host, log_probs=True,
        gpu='cpu')
    if not torch.equal(dense_out, dense_scan):
        fail('dense path differs from the plain scan route on the card')
    if not torch.equal(dense_out.cpu(), dense_cpu):
        fail('dense path differs from the plain route on the CPU')
    info('dense path equals the plain scan route on the card and the '
         'plain route on the CPU')

    # 4. The banded path (the headline) through from_probabilities
    def headline():
        return torbi_tpu_torch.from_probabilities(
            obs, transition=trans, initial=init, log_probs=True, gpu=0)

    reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    result = headline()
    torch.cuda.synchronize()
    band_counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    info(f'banded path launches: {band_counts}')
    if band_counts['band_forward'] < 1 or band_counts['backtrace'] < 1:
        fail('the banded path did not launch the banded forward and '
             'backtrace kernels')
    if tuple(result.shape) != (BATCH, FRAMES) or result.dtype != torch.int32:
        fail(f'headline result is {result.dtype} {tuple(result.shape)}')
    if int(result.min()) < 0 or int(result.max()) >= STATES:
        fail('headline result holds indices out of range')
    plain = torbi_tpu_torch.from_probabilities(
        obs, transition=trans, initial=init, log_probs=True, gpu=0,
        backend='scan')
    if not torch.equal(result, plain):
        fail(f'headline differs from the plain scan route on the card in '
             f'{int((result != plain).sum())} positions')
    del plain
    cpu = torbi_tpu_torch.from_probabilities(
        obs_host[:8], transition=trans_host, initial=init_host,
        log_probs=True, gpu='cpu')
    if not torch.equal(result[:8].cpu(), cpu):
        fail('headline rows 0-7 differ from the plain route on the CPU')
    info('headline equals the plain scan route on the card, and the plain '
         'route on the CPU for rows 0-7')

    times = []
    headline()
    for _ in range(10):
        start = time.perf_counter()
        headline()
        times.append(time.perf_counter() - start)
    median_s = statistics.median(times)
    info(f'headline: {median_s * 1e3:.3f} ms/call warm median of 10 '
         f'(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), '
         f'{BATCH * FRAMES / median_s:.0f} timesteps/s, peak device memory '
         f'{peak_gb:.2f} GB, on {card}')
    info(f'headline per-kernel ms (CUDA events): band_forward '
         f'{kernels["band_forward"]["ms"]:.3f} (plain '
         f'{kernels["band_forward"]["plain_ms"]:.1f}), backtrace '
         f'{kernels["backtrace"]["ms"]:.3f} (plain '
         f'{kernels["backtrace"]["plain_ms"]:.1f}), epsilon step '
         f'{convert_ms:.3f}')

    # 5. The kernels line, then the device line last
    lines = []
    for name in ('band_forward', 'dense_forward', 'backtrace'):
        entry = dict(kernels[name])
        bound, bound_by = entry.pop('bound')
        counts = dense_counts if entry['path'] == 'dense' else band_counts
        lines.append(dict(
            name=entry['name'], route=entry['route'],
            source=entry['source'], replaces=entry['replaces'],
            launches=counts[name], max_abs_err=entry['max_abs_err'],
            ms=entry['ms'], plain_ms=entry['plain_ms'], bound_ms=bound,
            bound_by=bound_by, library_ms=entry['library_ms'],
            path=entry['path']))
    print(json.dumps({'kernels': lines}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu',
        'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    try:
        main()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        info('FAILED: unexpected error')
        sys.exit(1)
