"""The beat-tracking cell: its configuration as the harness reads it, the
pool and its work, madmom's HMM and the activations' generator, the whole
cell on the CPU at a small size (20 frames a second: 238 states), traced
and untraced, a planted fault, the arrival cell's mix, and the readers of
the cell's metrics on a program with and without the in-list route"""
import json

import numpy as np
import pytest
import torch

from benchmark import beats, check, inputs, roofline, run, spec, sparse_work
from benchmark.callers import beats as caller
from benchmark.reference import beats as reference
from benchmark.tests.layout import PROGRAM_METRICS, REPO, tiny_layout

SEED = 2 ** 33 + 29
CELL = 'dbnbeat-b16-tracks'
NEW_METRICS = ('timesteps_per_s', 'decode_roofline.beats',
               'sparse_forward_roofline.beats', 'sparse_chase_roofline.beats',
               'sparse_pairs_per_frame.beats', 'device_idle_share.beats',
               'device_ops_per_call.beats')


def beats_layout(root):
    """``tiny_layout`` with the cell's configuration at 20 frames a second
    (238 states, 365 pairs), batches of 4, and a pool of 8 short tracks,
    as ``tiny-beats``, reporting the real cell's metrics"""
    root = tiny_layout(root)
    folder = root / spec.HERE.name
    config = json.loads(
        (folder / 'configs' / 'dbnbeat5617-default.json').read_text())
    config['dbn'] = dict(config['dbn'], fps=20)
    config.update(states=238, BATCH_SIZE=4, reduced=['dbn', 'states'])
    (folder / 'configs' / 'tiny-beats.json').write_text(json.dumps(config))
    mix = json.loads(
        (folder / 'traffic' / 'dbnbeat-sorted-pool48.json').read_text())
    mix.update(pool=8, lengths={'median': 120, 'sigma': 0.3, 'low': 60,
                                'high': 200}, sample=3, trace_cycles=1)
    (folder / 'traffic' / 'tiny-beats.json').write_text(json.dumps(mix))
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({
        'name': 'tiny-beats', 'source': 'a test', 'reduced': config['reduced'],
        'file': f'{spec.HERE.name}/configs/tiny-beats.json', 'why': 'tests'})
    bench['workloads'].append({
        'name': 'tiny-beats', 'config': 'tiny-beats', 'traffic': 'tiny-beats',
        'chips': 1, 'why': 'tests'})
    for entry in bench['end_to_end'] + bench['per_layer']:
        if entry['name'] in NEW_METRICS:
            entry['workloads'].append('tiny-beats')
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    return root


@pytest.fixture
def program():
    return run.import_program()


@pytest.fixture(autouse=True)
def wide_gate(monkeypatch):
    """The 20-fps space's 365 of 238^2 pairs (0.64%) lie above the
    program's gate, set at the published size's 0.028%: a gate of 1%
    takes it through the in-list route here"""
    from torbi_tpu_torch.ops import sparse

    monkeypatch.setattr(sparse, 'MAX_SHARE', 0.01)


def run_cell(root, program, trace=False, seed=SEED):
    cell = spec.Cell(root, 'tiny-beats')
    record = run.combine([run.execute(cell, seed, 0.2, trace,
                                      torch.device('cpu'), program)])
    return cell, record


def read(metric, record):
    return spec.load(spec.HERE / 'metrics' / f'{metric}.py').read(record)


def test_the_configuration_as_the_harness_reads_it():
    cell = spec.Cell(REPO, CELL)
    config = cell.config
    assert cell.chips == config['chips'] == 1
    assert cell.config_entry['reduced'] == config['reduced'] == []
    assert cell.config_entry['source'] == config['source']
    assert len(config['source']) <= 200
    assert (config['BATCH_SIZE'], config['MIN_CHUNK_SIZE']) == (16, None)
    assert config['precision'] == 'float32'
    dbn = config['dbn']
    intervals, first, last, _ = reference.state_space(dbn)
    assert config['states'] == reference.states(dbn) == 5617
    assert [intervals[0], intervals[-1]] == dbn['intervals'] == [28, 109]
    assert len(intervals) == dbn['tempi'] == 82
    assert len(reference.edges(dbn)[0]) == dbn['positive_pairs'] == 8934
    assert int(reference.beat_states(dbn).sum()) == dbn['beat_states'] == 389
    assert cell.traffic['caller'] == 'beats'
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    reported = [entry['name'] for entry in bench['end_to_end']
                + bench['per_layer']
                if CELL in entry.get('workloads', [])]
    assert reported == list(NEW_METRICS) + PROGRAM_METRICS


def test_the_arrival_cell_is_the_sorted_pool_as_it_arrives():
    arrival = spec.Cell(REPO, 'default-b512-arrival')
    assert arrival.config == spec.Cell(REPO, 'default-b512-sorted').config
    sorted_mix = dict(spec.Cell(REPO, 'default-b512-sorted').traffic)
    assert arrival.traffic == dict(sorted_mix, order='arrival')
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    reported = [entry['name'] for entry in bench['end_to_end']
                + bench['per_layer']
                if 'default-b512-arrival' in entry.get('workloads', [])]
    assert reported == ['timesteps_per_s', 'device_idle_share',
                        'decode_roofline'] + PROGRAM_METRICS
    # Nearly every batch of 512 in the seed's order holds a row near 2000
    lengths = inputs.permuted(
        inputs.lengths(4096, **arrival.traffic['lengths']),
        inputs.host_generator(SEED))
    longest = [max(lengths[k:k + 512]) for k in range(0, 4096, 512)]
    assert min(longest) > 1500


def test_the_pool_and_its_work_at_the_cell_size():
    cell = spec.Cell(REPO, CELL)
    mix = cell.traffic
    lengths = inputs.lengths(mix['pool'], **mix['lengths'])
    assert (len(lengths), sum(lengths), min(lengths), max(lengths)) == (
        48, 1053064, 10498, 42006)
    batches = [lengths[k:k + 16] for k in range(0, 48, 16)]
    assert [max(rows) for rows in batches] == [18295, 23693, 42006]
    padded = sum(16 * max(rows) for rows in batches)
    assert padded == 1343904
    # The pairs the program visits a real frame, and the log densities
    # made on the card: 30.2 GB
    assert 8934 * padded / sum(lengths) == pytest.approx(11401.4, abs=0.1)
    assert 4 * 5617 * padded == pytest.approx(30.19e9, rel=1e-3)
    # The least time of a cycle: the observation read once, 7.06 ms
    least = sum(roofline.least_seconds(*sparse_work.forward_work(
        rows, 5617, 8934)) for rows in batches)
    assert least == pytest.approx(7.06e-3, abs=0.01e-3)
    _, transition, _ = reference.hmm(cell.config['dbn'])
    assert roofline.candidates_per_frame(torch.exp(transition)) == (
        8934, 5617)


def test_the_hmm():
    dbn = spec.Cell(REPO, CELL).config['dbn']
    (destinations, sources, logs), dense, initial = reference.hmm(dbn)
    first = reference.state_space(dbn)[1]
    degrees = torch.bincount(destinations, minlength=5617)
    assert (degrees == 1).sum() == 5535
    assert degrees[first].min() == 16 and degrees[first].max() == 58
    # Each source's probabilities sum to 1
    sums = torch.zeros(5617, dtype=torch.float64).index_add_(
        0, sources, logs.double().exp())
    assert torch.allclose(sums, torch.ones(5617, dtype=torch.float64),
                          atol=1e-6)
    assert torch.equal(dense[destinations, sources], logs)
    assert int(torch.isfinite(dense).sum()) == 8934
    assert torch.all(initial == torch.tensor(np.log(1 / 5617),
                                             dtype=torch.float32))


def test_activations_repeat_from_the_seed():
    law = spec.Cell(REPO, CELL).traffic['activations']

    def make(seed):
        return beats.activations([3000, 500], law, 100,
                                 inputs.host_generator(seed))

    first, again, other = make(SEED), make(SEED), make(SEED + 1)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not torch.equal(first[0], other[0])
    track = first[0]
    assert track.dtype == torch.float32 and track.shape == (3000,)
    assert float(track.min()) >= 1e-6 and float(track.max()) <= 1 - 1e-6
    # Beats of 0.4-0.95 about every 0.3-1.1 s (those above 0.5, beside
    # neighbours of at most half of them), over a background below 0.03
    peaks = torch.nonzero(track > 0.5).flatten()
    gaps = peaks[1:] - peaks[:-1]
    assert 20 <= len(peaks) <= 110
    assert int(gaps.min()) >= 25 and float(gaps.float().median()) < 110
    assert float((track < 0.031).float().mean()) > 0.8
    densities = beats.log_densities(first, {
        'observation_lambda': 16, **spec.Cell(REPO, CELL).config['dbn']},
        'cpu')
    assert densities.shape == (2, 3000, 5617)
    assert not densities[1, 500:].any()
    # Two values a frame
    assert len(torch.unique(densities[1, 10])) == 2


@pytest.mark.parametrize('trace', [False, True])
def test_the_cell_on_the_cpu(tmp_path, program, trace):
    cell, record = run_cell(beats_layout(tmp_path), program, trace)
    assert check.passed(record['checks'])
    assert record['checked']['tracks'] == 3
    lengths = inputs.lengths(8, 120, 0.3, 60, 200)
    padded = sum(4 * max(lengths[k:k + 4]) for k in range(0, 8, 4))
    assert record['frames'] == sum(lengths) * record['cycles']
    assert record['sparse_pairs'] == 365 * padded * record['cycles']
    line = run.result(cell, record, trace, 'cpu')
    assert line['correct']
    if trace:
        stretch = record['stretches'][0]
        assert stretch['calls'] == 2
        assert stretch['sparse_pairs'] == 365 * padded
        assert read('sparse_pairs_per_frame.beats', {'stretches': [
            dict(stretch, device_events=3)]}) == pytest.approx(
                365 * padded / sum(lengths))
        assert 'breakdown' in line
    else:
        assert set(line['metrics']) == {'setup_s', 'timesteps_per_s'}


def test_a_planted_fault_turns_correct_false(tmp_path, monkeypatch,
                                             program):
    """One frame of the longest track altered"""
    decode = program.from_probabilities
    longest = max(inputs.lengths(8, 120, 0.3, 60, 200))
    altered = []

    def faulty(observation, batch_frames, *args, **kwargs):
        out = decode(observation, batch_frames, *args, **kwargs).clone()
        if int(batch_frames.max()) == longest:
            row = int(batch_frames.argmax())
            out[row, 7] = (out[row, 7] + 1) % 238
            altered.append(row)
        return out

    monkeypatch.setattr(program, 'from_probabilities', faulty)
    _, record = run_cell(beats_layout(tmp_path), program)
    assert altered
    assert not check.passed(record['checks'])
    assert record['checks']['mismatched_frames'][0] == record['cycles']


def test_a_program_without_the_route(tmp_path, monkeypatch, program):
    """The parent of the route: the cell runs (on the dense route), counts
    no pairs, and the route's readers find nothing"""
    import importlib

    real = importlib.import_module

    def without(name, *args, **kwargs):
        if name.endswith('.ops.sparse'):
            raise ModuleNotFoundError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(caller.importlib, 'import_module', without)
    assert caller.counters(program) == {}
    _, record = run_cell(beats_layout(tmp_path), program, trace=True)
    assert check.passed(record['checks'])
    assert 'sparse_pairs' not in record
    stretch = dict(record['stretches'][0], device_events=5,
                   device_ops={'dense_forward_kernel': [0.5, 2]})
    traced = {'stretches': [stretch]}
    for metric in ('sparse_pairs_per_frame.beats',
                   'sparse_forward_roofline.beats',
                   'sparse_chase_roofline.beats'):
        assert read(metric, traced) is None


def test_readers_of_the_cell():
    stretch = {
        'span_s': 2.0, 'busy_s': 1.5, 'compute_busy_s': 1.2,
        'device_events': 9, 'calls': 3, 'frames': 1000,
        'operations': 8e9, 'bytes': 4e8, 'sparse_pairs': 11000000,
        'sparse_forward_operations': 6.7e9, 'sparse_forward_bytes': 3.35e10,
        'sparse_chase_bytes': 3.35e6,
        'device_ops': {
            'void (anonymous namespace)::sparse_forward_kernel<1, true>':
                [0.5, 3],
            'void (anonymous namespace)::sparse_backtrace_kernel(short '
            'const*)': [0.01, 3],
            'Memcpy DtoH': [0.02, 3]}}
    record = {'stretches': [stretch]}
    assert read('sparse_pairs_per_frame.beats', record) == 11000
    # 10 ms of bytes over 0.5 s of K9; 1 us over 10 ms of K10
    assert read('sparse_forward_roofline.beats', record) == pytest.approx(2.0)
    assert read('sparse_chase_roofline.beats', record) == pytest.approx(0.01)
    assert read('device_idle_share.beats', record) == read(
        'device_idle_share', record) == pytest.approx(0.25)
    assert read('decode_roofline.beats', record) == read(
        'decode_roofline', record)
    assert read('device_ops_per_call.beats', record) == read(
        'device_ops_per_call', record) == 3
    assert read('sparse_pairs_per_frame.beats', {'stretches': None}) is None
