"""The port's profiler (torbi_tpu_torch/utils/profile.py and the
``python -m torbi_tpu_torch.profile`` command) on the CPU.

What a CPU run can check: the trace parser on a synthetic Kineto-shaped
trace, the timers' control flow on CPU tensors, which kernels the stage
timer picks, and the H100 model's arithmetic against the numbers worked out
by hand for the headline (512 x 512 x 1440 pitch, band width 175). No time
measured here is a device time.
"""
import gzip
import json

import numpy as np
import pytest
import torch

from torbi_tpu.models import pitch as jax_pitch
from torbi_tpu_torch import profile as profile_cli
from torbi_tpu_torch.ops import band, dispatch
from torbi_tpu_torch.utils import profile

TINY = np.finfo(np.float32).tiny
STAGE_KEYS = {'forward_ms', 'backtrace_ms', 'pipeline_ms', 'e2e_ms',
              'glue_ms', 'host_ms', 'band', 'kernels'}


def kineto_trace():
    return {'traceEvents': [
        {'ph': 'M', 'name': 'process_name', 'pid': 0,
         'args': {'name': 'python'}},
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::add', 'dur': 900.0},
        {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
         'dur': 800.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'band_forward_kernel',
         'dur': 2000.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'band_forward_kernel',
         'dur': 1500.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'backtrace_kernel',
         'dur': 500.0},
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD',
         'dur': 100.0},
        {'ph': 'i', 'cat': 'kernel', 'name': 'instant', 'dur': 5.0},
    ]}


def test_device_op_times_parses_kineto_trace(tmp_path):
    """Device events are summed by name and sorted; host events are left
    out; a gzipped trace is read too"""
    (tmp_path / 'run.json').write_text(json.dumps(kineto_trace()))
    (tmp_path / 'sub').mkdir()
    with gzip.open(tmp_path / 'sub' / 'run.json.gz', 'wt') as file:
        file.write(json.dumps({'traceEvents': [
            {'ph': 'X', 'cat': 'gpu_memset', 'name': 'Memset',
             'dur': 50.0}]}))
    rows = profile.device_op_times(tmp_path)
    assert rows == [
        {'name': 'band_forward_kernel', 'total_ms': 3.5, 'count': 2},
        {'name': 'backtrace_kernel', 'total_ms': 0.5, 'count': 1},
        {'name': 'Memcpy HtoD', 'total_ms': 0.1, 'count': 1},
        {'name': 'Memset', 'total_ms': 0.05, 'count': 1}]
    assert profile.device_op_times(tmp_path, top=1) == rows[:1]
    (tmp_path / 'empty').mkdir()
    assert profile.device_op_times(tmp_path / 'empty') == []


def test_device_busy_merges_intervals(tmp_path):
    """Busy time is the union of the device intervals; the span runs from
    the first event of any kind to the last"""
    events = [
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'decode', 'ts': 0.0,
         'dur': 1000.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'a', 'ts': 100.0, 'dur': 300.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'b', 'ts': 200.0, 'dur': 300.0},
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'c', 'ts': 700.0,
         'dur': 100.0},
    ]
    (tmp_path / 'run.json').write_text(json.dumps({'traceEvents': events}))
    busy = profile.device_busy(tmp_path)
    assert busy['busy_ms'] == pytest.approx(0.5)
    assert busy['span_ms'] == pytest.approx(1.0)
    assert busy['idle_share'] == pytest.approx(0.5)
    (tmp_path / 'empty').mkdir()
    assert profile.device_busy(tmp_path / 'empty')['idle_share'] is None


def test_capture_writes_a_trace(tmp_path):
    """On the CPU the trace holds host events only, so no device rows"""
    result, where = profile.capture(
        lambda: torch.ones(64).cumsum(0), tmp_path / 'trace')
    assert float(result[-1]) == 64.0
    assert (where / profile.TRACE_FILE).is_file()
    assert profile.device_op_times(where) == []


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


def banded_case(batch, frames, states, halfwidth, seed, tiny=TINY):
    rng = np.random.default_rng(seed)
    obs = np.log(rng.dirichlet(np.ones(states), size=(batch, frames))
                 .astype(np.float32) + TINY)
    bins = np.arange(states)
    tri = np.clip(halfwidth + 1.0 - np.abs(bins[:, None] - bins[None, :]),
                  0, None)
    with np.errstate(divide='ignore'):
        trans = np.log((tri / tri.sum(axis=1, keepdims=True))
                       .astype(np.float32) + np.float32(tiny))
    init = np.log(np.full(states, 1.0 / states, dtype=np.float32) + TINY)
    return (torch.from_numpy(obs), torch.full((batch,), frames,
                                              dtype=torch.int32),
            torch.from_numpy(trans.astype(np.float32)),
            torch.from_numpy(init))


def record_kernel_calls(monkeypatch):
    """Replace each kernel wrapper where dispatch looks it up by one that
    records its launch-counter name; returns the list of names"""
    calls = []
    for module, attr, name in (
            (band, 'viterbi_forward_band', 'band_forward'),
            (band, 'viterbi_forward_band_spread', 'band_spread'),
            (dispatch, 'viterbi_forward_dense', 'dense_forward'),
            (dispatch, 'backtrace_posteriors', 'backtrace'),
            (dispatch, 'backtrace_fused1', 'backtrace_fused1'),
            (dispatch, 'backtrace_window', 'backtrace_window')):
        def wrapper(*args, original=getattr(module, attr), name=name,
                    **kwargs):
            calls.append(name)
            return original(*args, **kwargs)

        monkeypatch.setattr(module, attr, wrapper)
    return calls


@pytest.mark.parametrize('batch, states, tiny, window, expected', [
    (3, 64, TINY, False, ('band_forward', 'backtrace')),
    (1, 64, TINY, False, ('band_spread', 'backtrace_fused1')),
    (1, 256, 0.0, True, ('band_spread', 'backtrace_window'))])
def test_time_stages_picks_dispatch_kernels(monkeypatch, batch, states, tiny,
                                            window, expected):
    """The stages time the kernels that dispatch.decode launches for the
    input, in its order (the window chase needs two 128-state rows), on a
    folded route: the epsilon step runs inside the forward kernel in both,
    and nothing converts outside it"""
    import torbi_tpu_torch

    obs, bf, trans, init = banded_case(batch, 12, states, 3, seed=4,
                                       tiny=tiny)
    if window:
        monkeypatch.setattr(torbi_tpu_torch, 'BACKTRACE_BATCH1_FUSED', False)
        monkeypatch.setattr(torbi_tpu_torch, 'BACKTRACE_BATCH1_WINDOW', True)
    flags = []
    for attr in ('viterbi_forward_band', 'viterbi_forward_band_spread'):
        monkeypatch.setattr(band, attr, (
            lambda *args, original=getattr(band, attr): (
                flags.append(args[5:]) or original(*args))))
    calls = record_kernel_calls(monkeypatch)
    dispatch.decode(obs, bf, trans, init, apply_epsilon=True, device='cpu')
    assert tuple(calls) == expected
    assert flags == [(True, True)]
    stages = profile.time_stages(obs, bf, trans, init, iters=1,
                                 apply_epsilon=True)
    assert set(flags) == {(True, True)}
    assert set(stages) == STAGE_KEYS
    assert stages['kernels'] == expected
    assert set(calls) == set(expected)
    assert stages['band'] == band.detect_band(trans)
    assert stages['glue_ms'] == pytest.approx(
        stages['pipeline_ms'] - stages['forward_ms'] - stages['backtrace_ms'])


def test_time_stages_dense_and_packed():
    obs, bf, _, init = banded_case(2, 8, 32, 3, seed=5)
    rng = np.random.default_rng(6)
    dense = torch.from_numpy(np.log(
        rng.dirichlet(np.ones(32), size=32).astype(np.float32) + TINY))
    stages = profile.time_stages(obs, bf, dense, init, iters=1)
    assert stages['kernels'] == ('dense_forward', 'backtrace')
    assert stages['band'] is None
    with pytest.raises(ValueError, match='packed'):
        profile.time_stages(obs[None], bf, dense, init)


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


def test_profile_command_on_cpu(tmp_path, capsys, monkeypatch):
    """python -m torbi_tpu_torch.profile runs end to end when asked for the
    CPU, and raises without a card otherwise"""
    report = profile_cli.main([
        '--device', 'cpu', '--batch', '2', '--frames', '8', '--iters', '1',
        '--trace', str(tmp_path), '--json'])
    assert set(report['stages_ms']) == STAGE_KEYS - {'band', 'kernels'}
    assert report['config']['kernels'] == ('band_forward', 'backtrace')
    assert report['trace_top_ops'] == []
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        'config']['device'] == 'cpu'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        profile_cli.main(['--iters', '1'])


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
