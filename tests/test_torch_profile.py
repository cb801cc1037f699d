"""The port's timers and speed-of-light model
(torbi_tpu_torch/utils/profile.py) on the CPU.

What a CPU run can check: the timers' control flow on CPU tensors, and the
H100 model's arithmetic against the numbers worked out by hand for the
headline (512 x 512 x 1440 pitch, band width 175). No time measured here
is a device time.
"""
import numpy as np
import pytest
import torch

from torbi_tpu.models import pitch as jax_pitch
from torbi_tpu_torch.ops import band
from torbi_tpu_torch.utils import profile

TINY = np.finfo(np.float32).tiny


def test_timers_on_cpu_tensors():
    calls = []

    def fn():
        calls.append(1)
        return torch.arange(4.0)

    seconds = profile.time_submissions(fn, lambda result: result[-1], 3)
    assert seconds >= 0 and len(calls) == 4
    steps = []

    def step(carry):
        steps.append(1)
        return carry + 1.0

    assert profile.time_chained(step, iters=5, device='cpu') >= 0
    assert len(steps) == 10


def test_speed_of_light_headline():
    """At 512 x 512 x 1440 with the pitch band (width 175, K1's clipped
    candidates) on 132 SMs at 1.98 GHz: ~3.8 ms of issue, ~7.6 ms of
    shared-memory loads, and less for HBM"""
    trans = np.log(jax_pitch.transition_matrix() + TINY)
    pitch_band = band.detect_band(torch.from_numpy(trans))
    assert pitch_band[:2] == (-87, 175)
    assert profile.band_candidates(1440, pitch_band) == 244_344
    sol = profile.speed_of_light(
        512, 512, 1440, pitch_band, 20.698, sms=132, clock_hz=1.98e9)
    assert sol['issue_ideal_ms'] == pytest.approx(3.8, rel=0.1)
    # One max per candidate at the published 64 per SM and clock
    assert sol['issue_ideal_ms'] == pytest.approx(
        sol['candidates'] / (64 * 132 * 1.98e9) * 1e3)
    assert sol['smem_ideal_ms'] == pytest.approx(7.6, rel=0.1)
    assert sol['hbm_ideal_ms'] < sol['issue_ideal_ms']
    assert sol['bound_by'] == 'smem'
    assert sol['utilization'] == pytest.approx(
        sol['smem_ideal_ms'] / 20.698)
    circular = profile.speed_of_light(
        512, 512, 1440, pitch_band, None, sms=132, clock_hz=1.98e9,
        circular=True)
    assert circular['candidates'] == 512 * 511 * 1440 * 175
    assert circular['utilization'] == 0.0
    assert profile.band_candidates(1440, None) == 1440 ** 2


def test_device_rates_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(profile, '_rates', {})
    assert profile.device_rates() == (132, 1.98e9)


def test_synthetic_posteriorgrams_are_bench_generator(monkeypatch):
    """The port's copy of bench.py's generator gives bench.py's arrays"""
    from pathlib import Path

    from torbi_tpu_torch.models import pitch

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent))
    import bench

    for batch, frames, states, seed in ((3, 17, 1440, 0), (70, 5, 96, 1)):
        np.testing.assert_array_equal(
            pitch.synthetic_posteriorgrams(batch, frames, states, seed),
            bench.synthetic_posteriorgrams(batch, frames, states, seed))
