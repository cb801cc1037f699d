"""The program's spans in a synthetic Chrome trace (``benchmark/program.py``)
and the readers of its per-layer metrics"""
import json

import pytest

from benchmark import program, spec, trace

METRICS = spec.HERE / 'metrics'

# A caller's loop around two calls, as Kineto writes it: the host ranges
# of the program's spans ('user_annotation'), the device ranges of the
# same names over their kernels ('gpu_user_annotation'), and the caller's
# fetch outside every span (times in microseconds)
CALLER = [
    ('aten::to', 'cpu_op', 0, 5),
    ('k1', 'kernel', 15, 25),                 # 15-40
    ('k3', 'kernel', 40, 10),                 # 40-50
    ('aten::copy_', 'cpu_op', 60, 40),        # the fetch, 60-100
    ('cudaMemcpyAsync', 'cuda_runtime', 62, 30),
    ('Memcpy DtoH', 'gpu_memcpy', 90, 5),     # 90-95
    ('k1', 'kernel', 120, 15),                # 120-135
    ('aten::copy_', 'cpu_op', 130, 10),       # 130-140
]
SPANS = [
    ('torbi.from_probabilities', 'user_annotation', 0, 60),
    ('torbi.decode', 'user_annotation', 5, 50),
    ('torbi.build', 'user_annotation', 6, 2),
    ('torbi.forward.band_forward', 'user_annotation', 10, 10),
    ('torbi.forward.band_forward', 'gpu_user_annotation', 15, 25),
    ('torbi.chase.backtrace', 'user_annotation', 20, 10),
    ('torbi.chase.backtrace', 'gpu_user_annotation', 40, 10),
    ('torbi.from_probabilities', 'user_annotation', 100, 30),
    ('torbi.decode', 'user_annotation', 105, 20),
    ('torbi.forward.band_forward', 'user_annotation', 110, 8),
    ('torbi.forward.band_forward', 'gpu_user_annotation', 120, 15),
]


def events(tmp_path, entries):
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': [
        {'ph': 'X', 'name': name, 'cat': category, 'ts': start, 'dur': dur}
        for name, category, start, dur in entries]}))
    return trace.complete_events(path)


def test_spans_and_idle_inside_them(tmp_path):
    found = program.summarize(events(tmp_path, CALLER + SPANS))
    assert found['spans'] == {
        'torbi.build': [pytest.approx(2e-6), 1, 0.0],
        'torbi.chase.backtrace': [pytest.approx(10e-6), 1,
                                  pytest.approx(10e-6)],
        'torbi.decode': [pytest.approx(70e-6), 2, 0.0],
        'torbi.forward.band_forward': [pytest.approx(18e-6), 2,
                                       pytest.approx(40e-6)],
        'torbi.from_probabilities': [pytest.approx(90e-6), 2, 0.0],
    }
    # Device busy 15-50, 90-95, 120-135 of 0-140; the spans hold 0-60 and
    # 100-130. Gaps: 0-15 inside; 50-90 half inside (50-60), the rest in
    # the fetch; 95-120 inside from 100; 135-140 in the fetch alone
    assert found['idle_in_program_s'] == pytest.approx((15 + 10 + 20) * 1e-6)


def test_no_spans_no_record(tmp_path):
    assert program.summarize(events(tmp_path, CALLER)) is None
    # Another program's annotations are not the program's
    assert program.summarize(events(tmp_path, CALLER + [
        ('ProfilerStep#1', 'user_annotation', 0, 140)])) is None


def test_spans_leave_the_trace_summary_as_it_was(tmp_path):
    without = trace.summarize(events(tmp_path, CALLER))
    with_spans = trace.summarize(events(tmp_path, CALLER + SPANS))
    for key in ('span_s', 'busy_s', 'compute_busy_s', 'device_events',
                'device_ops'):
        assert with_spans[key] == without[key], key
    # The same idle time, some of it now named by the innermost span
    assert sum(s for _, s in with_spans['idle_gaps']) == pytest.approx(
        sum(s for _, s in without['idle_gaps']))
    # The gap 95-120 (its middle in the second call's decode)
    assert dict(with_spans['idle_gaps'])['torbi.decode'] == pytest.approx(
        25e-6)


def read(metric, record):
    return spec.load(METRICS / f'{metric}.py').read(record)


def stretch(span_s, calls, idle, forward, chase):
    return {'span_s': span_s, 'busy_s': span_s / 2, 'device_events': 5,
            'calls': calls, 'program': {
                'idle_in_program_s': idle,
                'spans': {'torbi.decode': [1.0, calls, 0.0],
                          'torbi.forward.band_spread': [0.1, calls, forward],
                          'torbi.chase.backtrace_fused1': [0.1, calls, chase],
                          'torbi.build': [0.1, 1, 0.0]}}}


def test_readers_of_one_rank(tmp_path):
    record = {'stretches': [dict(
        trace.summarize(events(tmp_path, CALLER + SPANS)), calls=2,
        program=program.summarize(events(tmp_path, CALLER + SPANS)))]}
    assert read('dispatch_idle_share', record) == pytest.approx(45 / 140)
    assert read('forward_ms_per_call', record) == pytest.approx(40e-3 / 2)
    assert read('chase_ms_per_call', record) == pytest.approx(10e-3 / 2)
    assert read('rank_skew_ms_per_call', record) is None
    # Each in the batch-1 cells under its alias
    for metric in ('dispatch_idle_share', 'forward_ms_per_call',
                   'chase_ms_per_call'):
        assert read(f'{metric}.batch1', record) == read(metric, record)
    # Within its device idle share
    assert read('dispatch_idle_share', record) <= read(
        'device_idle_share', record)


def test_readers_of_four_ranks():
    record = {'stretches': [
        stretch(0.5, 8, 0.05, 0.20, 0.02),
        stretch(0.4, 8, 0.02, 0.26, 0.02),
        stretch(0.5, 8, 0.10, 0.30, 0.03),
        stretch(0.5, 8, 0.00, 0.31, 0.02),
    ]}
    assert read('dispatch_idle_share', record) == pytest.approx(
        (0.1 + 0.05 + 0.2 + 0.0) / 4)
    # Rank 0's kernels over rank 0's calls
    assert read('forward_ms_per_call', record) == pytest.approx(200 / 8)
    assert read('chase_ms_per_call', record) == pytest.approx(20 / 8)
    # Rank 3's 0.33 s less rank 0's 0.22 s
    assert read('rank_skew_ms_per_call', record) == pytest.approx(110 / 8)


@pytest.mark.parametrize('metric', (
    'dispatch_idle_share', 'dispatch_idle_share.batch1',
    'forward_ms_per_call', 'forward_ms_per_call.batch1',
    'chase_ms_per_call', 'chase_ms_per_call.batch1',
    'rank_skew_ms_per_call'))
def test_readers_without_spans_read_nothing(metric):
    plain = {'span_s': 0.5, 'busy_s': 0.4, 'device_events': 5, 'calls': 8}
    # An untraced run, a traced program without spans, and a trace whose
    # summary found no program spans
    assert read(metric, {'stretches': None}) is None
    assert read(metric, {'stretches': [plain, plain]}) is None
    assert read(metric, {'stretches': [dict(plain, program=None)] * 2}) \
        is None
