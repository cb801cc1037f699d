"""Profiling on the card: trace capture, device-time breakdown, stage
timing, and a speed-of-light model of the banded forward pass.

Counterpart of ``torbi_tpu/utils/profile.py``, on ``torch.profiler`` and
CUDA:

- ``trace``/``capture``: run a callable under ``torch.profiler.profile``
  (CPU and CUDA activities) and export the Chrome trace into a directory.
- ``device_op_times``: parse that trace into per-op device time (Kineto's
  kernel, memcpy and memset events; host events are left out).
- ``time_submissions``/``time_chained``: host-clock seconds per call of
  queued work that ends in one scalar fetch (which synchronises).
- ``time_stages``: the forward kernel, the backtrace kernel, the whole
  ``dispatch.decode`` and one end-to-end call, for one input.
- ``speed_of_light``: the H100 model of the banded forward recursion: issue
  rate, shared-memory load rate and device-memory rate.

On CPU tensors the timers time the plain versions; no number from such a
run is a device number.
"""
import contextlib
import glob
import gzip
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .convert import resolve_device

# H100 SXM (NVIDIA's data sheet): SMs, maximum SM clock and HBM3 rate. The
# card's own SM count and clock replace the first two where one answers
H100_SMS = 132
H100_SM_CLOCK_HZ = 1.98e9
H100_HBM_BYTES_PER_S = 3.35e12
# Results per clock per SM at compute capability 9.0, from the throughput
# table of native arithmetic instructions in NVIDIA's CUDA C++ Programming
# Guide: FP32 add, multiply and multiply-add 128 (also the lanes an SM's
# four schedulers issue to per clock); compare, minimum and maximum 64. And
# the 4-byte words an SM's shared memory delivers per clock (32 banks)
FP32_LANES_PER_SM = 128
MINMAX_PER_SM_CLOCK = 64
SMEM_WORDS_PER_SM_CLOCK = 32

# Kineto's categories of device events in a Chrome trace
DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
TRACE_FILE = 'torbi_tpu_torch.trace.json'

_rates = {}


def _log(message):
    print(f'[profile] {message}', file=sys.stderr, flush=True)


###############################################################################
# Trace capture
###############################################################################


@contextlib.contextmanager
def trace(trace_dir):
    """Context manager that profiles its body (CPU and, with a card, CUDA
    activity) and writes the Chrome trace to ``trace_dir/TRACE_FILE``"""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as profiler:
        yield trace_dir
        if cuda:
            torch.cuda.synchronize()
    profiler.export_chrome_trace(os.path.join(str(trace_dir), TRACE_FILE))


def capture(fn, trace_dir):
    """Run ``fn()`` under the profiler; returns (result, trace_dir)"""
    with trace(trace_dir):
        result = fn()
    return result, trace_dir


###############################################################################
# Trace parsing
###############################################################################


def _load_trace(path):
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as file:
        return json.load(file)


def _complete_events(trace_dir):
    """(event, is_device) for every complete event of the Chrome traces
    under ``trace_dir``"""
    paths = sorted(
        glob.glob(os.path.join(str(trace_dir), '**', '*.json'),
                  recursive=True)
        + glob.glob(os.path.join(str(trace_dir), '**', '*.json.gz'),
                    recursive=True))
    for path in paths:
        data = _load_trace(path)
        events = data.get('traceEvents', []) if isinstance(data, dict) \
            else data
        for event in events:
            if event.get('ph') == 'X':
                yield event, (str(event.get('cat', '')).lower()
                              in DEVICE_CATEGORIES)


def device_op_times(trace_dir, top=None):
    """Per-op device time of the Chrome traces under ``trace_dir``.

    Returns ``{name, total_ms, count}`` rows sorted by total time, from
    complete events whose category is a device one (``DEVICE_CATEGORIES``);
    ``[]`` when there is no trace or it holds no device event.
    """
    totals = {}
    for event, is_device in _complete_events(trace_dir):
        if is_device:
            name = event.get('name', '?')
            total, count = totals.get(name, (0.0, 0))
            totals[name] = (total + float(event.get('dur', 0.0)), count + 1)
    rows = [{'name': name, 'total_ms': total / 1e3, 'count': count}
            for name, (total, count) in totals.items()]
    rows.sort(key=lambda row: -row['total_ms'])
    return rows[:top] if top else rows


def device_busy(trace_dir):
    """How much of the traced time the device worked: ``busy_ms`` is the
    union of the device events' intervals, ``span_ms`` runs from the first
    complete event of any kind to the last, and ``idle_share`` is
    1 - busy / span (None for an empty trace)"""
    spans, device = [], []
    for event, is_device in _complete_events(trace_dir):
        start = float(event.get('ts', 0.0))
        interval = (start, start + float(event.get('dur', 0.0)))
        spans.append(interval)
        if is_device:
            device.append(interval)
    if not spans:
        return {'busy_ms': 0.0, 'span_ms': 0.0, 'idle_share': None}
    busy, reach = 0.0, float('-inf')
    for start, end in sorted(device):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    span = max(end for _, end in spans) - min(start for start, _ in spans)
    return {'busy_ms': busy / 1e3, 'span_ms': span / 1e3,
            'idle_share': 1.0 - busy / span if span else None}


###############################################################################
# Timing
###############################################################################


def time_submissions(fn, fetch_scalar, iters=8):
    """Steady-state seconds per call of ``fn``.

    Queues ``iters`` calls back to back (the card runs them in order on the
    stream while the host goes on) and ends with one scalar fetch from the
    last result, ``fetch_scalar(result)``, which waits for all of them. One
    warm-up call and fetch come first. On CPU tensors it times the calls.
    """
    result = fn()
    float(fetch_scalar(result))
    start = time.perf_counter()
    for _ in range(iters):
        result = fn()
    float(fetch_scalar(result))
    elapsed = time.perf_counter() - start
    _log(f'{elapsed / iters * 1e3:.3f} ms/call over {iters} calls')
    return elapsed / iters


def time_chained(build_step, iters=8, warmup=True, device=None):
    """Seconds per step of ``iters`` dependent steps.

    ``build_step(carry)`` returns a new scalar tensor that depends on the
    timed work, so every step waits for the one before; the loop starts
    from a zero scalar on ``device`` (None is the card) and ends with one
    fetch of the carry.
    """
    carry0 = torch.zeros((), dtype=torch.float32,
                         device=resolve_device(device))

    def run():
        carry = carry0
        for _ in range(iters):
            carry = build_step(carry)
        return float(carry)

    if warmup:
        run()
    start = time.perf_counter()
    run()
    return (time.perf_counter() - start) / iters


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def time_stages(observation, batch_frames, transition, initial, iters=8,
                log_input=True, apply_epsilon=False):
    """Forward kernel, backtrace kernel, the whole decode, and one call, for
    one input.

    Inputs are tensors on one device, as ``dispatch.decode`` takes them:
    observation (batch, frames, states) log-probabilities (probabilities
    when ``log_input=False``; its state dimension may be padded to the next
    multiple of 128), batch_frames, transition, initial; ``apply_epsilon``
    as ``decode`` takes it (``from_probabilities`` sets it). The forward
    and backtrace stages call the kernels that ``dispatch.kernel_route``
    picks for this input, as ``decode`` does: K1 (cluster or wide-band
    design) or K4 converting the observation as they load it, or K2 on the
    observation ``dispatch.convert`` made first, then K3, K5 or K6 (a
    constant transition, which dispatch decodes in closed form, times K1's
    wide-band design and the chase on it; a long single sequence, which
    dispatch may auto-chunk, times the serial route's kernels). Returns
    milliseconds:

    - forward_ms, backtrace_ms: steady-state time per call (queued calls)
    - pipeline_ms: ``dispatch.decode`` per call (queued calls)
    - e2e_ms: one decode call ending in a synchronize (host clock)
    - glue_ms: pipeline - forward - backtrace (everything but the kernels)
    - host_ms: e2e - pipeline (launch and synchronisation overhead)

    and ``band`` (from ``detect_band``) and ``kernels`` (the names of the
    two kernels timed).
    """
    from ..ops import band as band_ops
    from ..ops import dispatch

    if observation.ndim != 3:
        raise ValueError(
            'observation must be (batch, frames, states), got shape '
            f'{tuple(observation.shape)} (the packed 4-D layout of the JAX '
            'package exists only for its TPU kernel)')
    device = observation.device
    states = int(transition.shape[0])
    obs = observation[..., :states].to(torch.float32).contiguous()
    batch_frames = batch_frames.to(device=device, dtype=torch.int32)
    transition = transition.to(device=device, dtype=torch.float32)
    initial = initial.to(device=device, dtype=torch.float32)

    band = band_ops.gate_band(
        band_ops.detect_band(transition), initial, observation=None,
        finite_observation=True)
    (forward_name, forward), (backtrace_name, chase) = dispatch.kernel_route(
        transition, band, observation.shape[0])
    # The banded kernels convert as they load (dispatch's fold); the dense
    # route's conversion is glue, outside the forward stage
    flags = {}
    if band is None:
        obs = dispatch.convert(obs, log_input, apply_epsilon)
    else:
        flags = {'log_input': log_input, 'apply_epsilon': apply_epsilon}

    _log(f'stage: forward ({forward_name})')
    forward_ms = time_submissions(
        lambda: forward(obs, batch_frames, initial, **flags),
        lambda result: result[1][0, 0], iters) * 1e3

    post_seq, posterior = forward(obs, batch_frames, initial, **flags)
    _log(f'stage: backtrace ({backtrace_name})')
    backtrace_ms = time_submissions(
        lambda: chase(post_seq, posterior, batch_frames),
        lambda result: result[0, 0], iters) * 1e3
    del post_seq, posterior

    def pipeline():
        return dispatch.decode(
            observation, batch_frames, transition, initial,
            finite_observation=True, log_input=log_input,
            apply_epsilon=apply_epsilon, device=device)

    _log('stage: dispatch.decode')
    pipeline_ms = time_submissions(
        pipeline, lambda result: result[0, 0], iters) * 1e3

    pipeline()
    _sync(device)
    start = time.perf_counter()
    pipeline()
    _sync(device)
    e2e_ms = (time.perf_counter() - start) * 1e3

    return {
        'forward_ms': forward_ms,
        'backtrace_ms': backtrace_ms,
        'pipeline_ms': pipeline_ms,
        'e2e_ms': e2e_ms,
        'glue_ms': pipeline_ms - forward_ms - backtrace_ms,
        'host_ms': e2e_ms - pipeline_ms,
        'band': band,
        'kernels': (forward_name, backtrace_name),
    }


###############################################################################
# Speed-of-light model
###############################################################################


def device_rates():
    """(SM count, maximum SM clock in Hz) of CUDA card 0, read from the
    card (``torch.cuda.get_device_properties`` and ``nvidia-smi``), or the
    H100 SXM's where there is no card or ``nvidia-smi`` does not answer"""
    if 'rates' not in _rates:
        sms, clock_hz = H100_SMS, H100_SM_CLOCK_HZ
        if torch.cuda.is_available():
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            try:
                answer = subprocess.run(
                    ['nvidia-smi', '--query-gpu=clocks.max.sm',
                     '--format=csv,noheader,nounits'],
                    capture_output=True, text=True, timeout=60)
                clock_hz = float(answer.stdout.split()[0]) * 1e6
            except (OSError, ValueError, IndexError,
                    subprocess.TimeoutExpired):
                _log('nvidia-smi gave no SM clock; taking the H100 SXM '
                     f'{H100_SM_CLOCK_HZ / 1e9} GHz')
        _rates['rates'] = (sms, clock_hz)
    return _rates['rates']


def band_candidates(states, band, circular=False):
    """Candidates of one frame of one sequence: the in-range (source,
    destination) pairs of the band that K1 visits (its loop is clipped to
    sources in [0, states)), ``states * width`` for the lab's circular
    recursion, ``states ** 2`` for a dense transition (``band`` None)"""
    if band is None:
        return states * states
    lo, width = int(band[0]), int(band[1])
    if circular:
        return states * width
    j = np.arange(states)
    begin = np.maximum(0, -lo - j)
    end = np.minimum(width, states - lo - j)
    return int(np.maximum(end - begin, 0).sum())


def speed_of_light(batch, frames, states, band, measured_forward_ms,
                   sms=None, clock_hz=None, circular=False):
    """H100 model of the banded forward recursion.

    Each candidate is an add and a max, two FP32 instructions, and loads
    its source from shared memory. So the least times are:

    - issue_ideal_ms: one max per candidate at ``MINMAX_PER_SM_CLOCK`` per
      SM and clock (the add runs at twice that rate beside it; the two
      instructions at ``FP32_LANES_PER_SM`` issue slots per SM and clock
      take the same time);
    - smem_ideal_ms: one 4-byte shared-memory load per candidate at
      ``SMEM_WORDS_PER_SM_CLOCK`` per SM and clock;
    - hbm_ideal_ms: the observation read and the posterior stream written
      once, at 3.35 TB/s.

    ``binding_ideal_ms`` is the largest (``bound_by`` names it) and
    ``utilization`` its share of the measured time. SM count and clock are
    the card's (``device_rates``) unless given. Candidates are counted as
    ``band_candidates`` counts them, over ``frames - 1`` steps.
    """
    if sms is None or clock_hz is None:
        card_sms, card_clock = device_rates()
        sms = card_sms if sms is None else sms
        clock_hz = card_clock if clock_hz is None else clock_hz
    candidates = (batch * max(frames - 1, 0)
                  * band_candidates(states, band, circular))
    issue_ms = candidates / (MINMAX_PER_SM_CLOCK * sms * clock_hz) * 1e3
    smem_ms = candidates / (SMEM_WORDS_PER_SM_CLOCK * sms * clock_hz) * 1e3
    hbm_ms = batch * frames * states * 4 * 2 / H100_HBM_BYTES_PER_S * 1e3
    ideals = {'issue': issue_ms, 'smem': smem_ms, 'hbm': hbm_ms}
    bound_by = max(ideals, key=ideals.get)
    binding_ms = ideals[bound_by]
    return {
        'candidates': candidates,
        'issue_ideal_ms': issue_ms,
        'smem_ideal_ms': smem_ms,
        'hbm_ideal_ms': hbm_ms,
        'binding_ideal_ms': binding_ms,
        'bound_by': bound_by,
        'utilization': (
            binding_ms / measured_forward_ms if measured_forward_ms else 0.0),
        'sms': sms,
        'clock_hz': clock_hz,
    }
