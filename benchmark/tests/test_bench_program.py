"""The program's spans in a synthetic Chrome trace (``benchmark/program.py``),
their self time, the record a traced run of a tiny cell keeps, and the
readers of its per-layer metrics"""
import json

import pytest
import torch

from benchmark import program, run, spec, trace
from benchmark.tests.layout import tiny_layout

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


def test_self_time_of_nested_spans(tmp_path):
    found = program.summarize(events(tmp_path, CALLER + SPANS))
    # Each call's entry less its decode (0-60 less 5-55; 100-130 less
    # 105-125); each decode less the build and the kernels' spans inside
    # it (50 less 2 + 10 + 10; 20 less 8); the build and the kernels'
    # spans hold no span
    assert found['self_s'] == {
        'torbi.build': pytest.approx(2e-6),
        'torbi.chase.backtrace': pytest.approx(10e-6),
        'torbi.decode': pytest.approx((28 + 12) * 1e-6),
        'torbi.forward.band_forward': pytest.approx(18e-6),
        'torbi.from_probabilities': pytest.approx((10 + 10) * 1e-6),
    }
    # Nothing counted twice: the self times add up to the spans' union
    assert sum(found['self_s'].values()) == pytest.approx(90e-6)


def test_self_time_of_a_span_nested_in_its_own_name(tmp_path):
    """The memory guard's row groups: ``torbi.decode`` inside
    ``torbi.decode``, one with a kernel span inside it, one ending where
    the outer one ends, and a span after them that holds none"""
    found = program.summarize(events(tmp_path, [
        ('torbi.decode', 'user_annotation', 0, 100),
        ('torbi.decode', 'user_annotation', 10, 30),             # 10-40
        ('torbi.forward.band_forward', 'user_annotation', 15, 10),
        ('torbi.decode', 'user_annotation', 50, 50),             # 50-100
        ('torbi.gather', 'user_annotation', 120, 7),
    ]))
    assert found['self_s'] == {
        'torbi.decode': pytest.approx((100 - 30 - 50 + 30 - 10 + 50) * 1e-6),
        'torbi.forward.band_forward': pytest.approx(10e-6),
        'torbi.gather': pytest.approx(7e-6),
    }
    # The host ranges' own sums stay as they were
    assert found['spans']['torbi.decode'][:2] == [pytest.approx(180e-6), 3]


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


def stretch(span_s, calls, idle, forward, chase, host=0.0):
    return {'span_s': span_s, 'busy_s': span_s / 2, 'device_events': 5,
            'calls': calls, 'program': {
                'idle_in_program_s': idle,
                'spans': {'torbi.decode': [1.0, calls, 0.0],
                          'torbi.forward.band_spread': [0.1, calls, forward],
                          'torbi.chase.backtrace_fused1': [0.1, calls, chase],
                          'torbi.build': [0.1, 1, 0.0]},
                'self_s': {'torbi.decode_sharded': host,
                           'torbi.decode': 2 * host,
                           'torbi.gather': 0.5,
                           'torbi.forward.band_spread': 0.1,
                           'torbi.build': 0.1}}}


def test_readers_of_one_rank(tmp_path):
    record = {'stretches': [dict(
        trace.summarize(events(tmp_path, CALLER + SPANS)), calls=2,
        program=program.summarize(events(tmp_path, CALLER + SPANS)))]}
    assert read('dispatch_idle_share', record) == pytest.approx(45 / 140)
    assert read('forward_ms_per_call', record) == pytest.approx(40e-3 / 2)
    assert read('chase_ms_per_call', record) == pytest.approx(10e-3 / 2)
    assert read('rank_skew_ms_per_call', record) is None
    # The entry's and the decode's self time (20 + 40 us) over two calls
    assert read('dispatch_host_ms_per_call', record) == pytest.approx(
        60e-3 / 2)
    # Each in the batch-1 cells under its alias
    for metric in ('dispatch_idle_share', 'forward_ms_per_call',
                   'chase_ms_per_call', 'dispatch_host_ms_per_call'):
        assert read(f'{metric}.batch1', record) == read(metric, record)
    # Within its device idle share
    assert read('dispatch_idle_share', record) <= read(
        'device_idle_share', record)


def test_readers_of_four_ranks():
    record = {'stretches': [
        stretch(0.5, 8, 0.05, 0.20, 0.02, host=0.004),
        stretch(0.4, 8, 0.02, 0.26, 0.02, host=0.009),
        stretch(0.5, 8, 0.10, 0.30, 0.03, host=0.009),
        stretch(0.5, 8, 0.00, 0.31, 0.02, host=0.009),
    ]}
    assert read('dispatch_idle_share', record) == pytest.approx(
        (0.1 + 0.05 + 0.2 + 0.0) / 4)
    # Rank 0's kernels over rank 0's calls
    assert read('forward_ms_per_call', record) == pytest.approx(200 / 8)
    assert read('chase_ms_per_call', record) == pytest.approx(20 / 8)
    # Rank 3's 0.33 s less rank 0's 0.22 s
    assert read('rank_skew_ms_per_call', record) == pytest.approx(110 / 8)
    # Rank 0's entry and decode self time (4 + 8 ms), not the gather's
    assert read('dispatch_host_ms_per_call', record) == pytest.approx(12 / 8)


@pytest.mark.parametrize('metric', (
    'dispatch_idle_share', 'dispatch_idle_share.batch1',
    'forward_ms_per_call', 'forward_ms_per_call.batch1',
    'chase_ms_per_call', 'chase_ms_per_call.batch1',
    'dispatch_host_ms_per_call', 'dispatch_host_ms_per_call.batch1',
    'rank_skew_ms_per_call'))
def test_readers_without_spans_read_nothing(metric):
    plain = {'span_s': 0.5, 'busy_s': 0.4, 'device_events': 5, 'calls': 8}
    # An untraced run, a traced program without spans, and a trace whose
    # summary found no program spans
    assert read(metric, {'stretches': None}) is None
    assert read(metric, {'stretches': [plain, plain]}) is None
    assert read(metric, {'stretches': [dict(plain, program=None)] * 2}) \
        is None


@pytest.mark.parametrize('cell, suffix', [('tiny-sorted', ''),
                                          ('tiny-single', '.batch1')])
def test_a_traced_run_keeps_the_programs_record(tmp_path, cell, suffix):
    """``loop.run``'s traced stretch holds ``program.summarize``'s record
    beside ``trace.summarize``'s, and the readers read it"""
    root = tiny_layout(tmp_path)
    record = run.combine([run.execute(
        spec.Cell(root, cell), 2 ** 31 + 11, 0.2, True, torch.device('cpu'),
        run.import_program())])
    stretch = record['stretches'][0]
    found = stretch['program']
    calls = stretch['calls']
    assert calls > 0
    assert found['spans']['torbi.from_probabilities'][1] == calls
    assert found['spans']['torbi.decode'][1] >= calls
    assert any(name.startswith(program.FORWARD) for name in found['spans'])
    # Every span's self time lies within its host time, and they add up
    # to no more than the stretch's span
    for name, (host_s, _, _) in found['spans'].items():
        assert 0 <= found['self_s'][name] <= host_s + 1e-9, name
    assert sum(found['self_s'].values()) <= stretch['span_s'] + 1e-9
    # No device events on the CPU: the readers of a trace read nothing
    assert read(f'dispatch_host_ms_per_call{suffix}', record) is None
    # With the stretch counted as holding device work, each reads the
    # record: the entry's and the decode's self time a call
    counted = {'stretches': [dict(stretch, device_events=1)]}
    assert read(f'dispatch_host_ms_per_call{suffix}', counted) == \
        pytest.approx(1e3 * (found['self_s']['torbi.from_probabilities']
                             + found['self_s']['torbi.decode']) / calls)
    assert 0 < read(f'dispatch_idle_share{suffix}', counted) <= 1
