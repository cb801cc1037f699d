"""The trace arithmetic of benchmark/trace.py on a synthetic Chrome
trace"""
import json

import pytest

from benchmark import trace


def chrome(path, events):
    path.write_text(json.dumps({'traceEvents': [
        {'ph': 'X', 'name': name, 'cat': category, 'ts': start, 'dur': dur}
        for name, category, start, dur in events] + [
        {'ph': 'i', 'name': 'marker', 'ts': 5}]}))
    return path


def test_busy_span_ops_and_gaps(tmp_path):
    path = chrome(tmp_path / 'trace.json', [
        ('call', 'user_annotation', 0, 100),
        ('aten::copy_', 'cpu_op', 20, 10),
        ('cudaLaunchKernel', 'cuda_runtime', 10, 5),
        ('k1', 'kernel', 10, 30),          # 10-40
        ('k2', 'kernel', 30, 20),          # 30-50, overlaps k1
        ('Memcpy DtoH', 'gpu_memcpy', 70, 10),   # 70-80
        ('k1', 'kernel', 90, 5),           # 90-95
        ('ncclKernel_AllGather', 'kernel', 85, 10),  # 85-95
        ('call', 'gpu_user_annotation', 0, 100),
    ])
    summary = trace.summarize(trace.complete_events(path))
    assert summary['span_s'] == pytest.approx(100e-6)
    assert summary['busy_s'] == pytest.approx((40 + 10 + 10) * 1e-6)
    # The compute kernels alone: no copy, no collective
    assert summary['compute_busy_s'] == pytest.approx((40 + 5) * 1e-6)
    assert summary['device_events'] == 5
    assert summary['device_ops']['k1'] == [pytest.approx(35e-6), 2]
    assert list(summary['device_ops']) == ['k1', 'k2', 'Memcpy DtoH',
                                           'ncclKernel_AllGather']
    # Gaps 0-10, 50-70, 80-85, 95-100: the middles 5, 60, 82.5, 97.5 all
    # lie in 'call' alone
    assert summary['idle_gaps'] == [['call', pytest.approx(40e-6)]]


def test_gap_takes_the_innermost_host_event(tmp_path):
    path = chrome(tmp_path / 'trace.json', [
        ('outer', 'user_annotation', 0, 100),
        ('aten::index', 'cpu_op', 40, 30),
        ('k', 'kernel', 0, 30),
        ('k', 'kernel', 80, 20),
    ])
    summary = trace.summarize(trace.complete_events(path))
    assert summary['idle_gaps'] == [['aten::index', pytest.approx(50e-6)]]
    assert trace.busy_intervals([(5, 9), (0, 2), (1, 3)]) == [[0, 3], [5, 9]]


def test_no_events_no_summary(tmp_path):
    assert trace.summarize(trace.complete_events(
        chrome(tmp_path / 'trace.json', []))) is None
