"""Timing on the card and a speed-of-light model of the banded forward
pass, for the labs (``scripts/``) and ``chip_smoke.py``.

Counterpart of ``torbi_tpu/utils/profile.py``'s timers, on CUDA:

- ``time_submissions``/``time_chained``: host-clock seconds per call of
  queued work that ends in one scalar fetch (which synchronises).
- ``speed_of_light``: the H100 model of the banded forward recursion: issue
  rate, shared-memory load rate and device-memory rate.

On CPU tensors the timers time the plain versions; no number from such a
run is a device number. The port's traces are read by
``benchmark/trace.py``.
"""
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

_rates = {}


def _log(message):
    print(f'[profile] {message}', file=sys.stderr, flush=True)


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
