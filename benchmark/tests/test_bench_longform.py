"""The long-recording cell: its generator, its reference plan, the whole
cell on the CPU at a small size, planted faults, and the readers of its
per-layer metrics on a program with and without the auto-chunk
counters"""
import json

import pytest
import torch

from benchmark import check, inputs, recordings, run, spec
from benchmark.callers import recordings as caller
from benchmark.reference import chunked
from benchmark.tests.layout import REPO, tiny_layout

SEED = 2 ** 33 + 19
STATES = 128
# Voiced frames 1 bin wide: a Gaussian of 3 bins over 128 states lies
# near the threshold (entropy 0.52)
VOICING = {
    'voiced': {'median': 25, 'sigma': 0.6, 'low': 5, 'high': 150, 'bins': 1},
    'unvoiced': {'median': 12, 'sigma': 1.0, 'low': 3, 'high': 300,
                 'bins': 200}}
TINY_LONGFORM = {
    'name': 'tiny-longform', 'states': STATES, 'precision': 'float32',
    'transition': {'kind': 'penn', 'cents_per_bin': 5, 'octave': 1200,
                   'max_octaves_per_second': 35.92, 'hopsize': 8,
                   'sample_rate': 8000},
    'BATCH_SIZE': 1, 'MIN_CHUNK_SIZE': None, 'ENTROPY_THRESHOLD': 0.5,
    'BATCH1_AUTO_CHUNK': True, 'BATCH1_CHUNK_FRAMES': 256,
    'BATCH1_AUTO_CHUNK_MIN_FRAMES': 1024, 'chips': 1, 'assumed': [],
    'reduced': ['states', 'BATCH1_CHUNK_FRAMES',
                'BATCH1_AUTO_CHUNK_MIN_FRAMES']}
TINY_MIX = {'caller': 'recordings', 'pool': 4,
            'lengths': {'median': 2000, 'sigma': 0.3, 'low': 1500,
                        'high': 3000},
            'voicing': VOICING, 'sample': 2, 'trace_cycles': 1}
NEW_METRICS = ('timesteps_per_s', 'device_idle_share.longform',
               'decode_roofline.longform', 'autochunk_idle_share',
               'autochunk_declined_share')


def longform_layout(root):
    """``tiny_layout`` with a small long-recording configuration, mix and
    cell, ``tiny-longform``, reporting the real cell's metrics"""
    root = tiny_layout(root)
    folder = root / spec.HERE.name
    (folder / 'configs' / 'tiny-longform.json').write_text(
        json.dumps(TINY_LONGFORM))
    (folder / 'traffic' / 'tiny-longform.json').write_text(
        json.dumps(TINY_MIX))
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({
        'name': 'tiny-longform', 'source': 'a test',
        'reduced': TINY_LONGFORM['reduced'],
        'file': f'{spec.HERE.name}/configs/tiny-longform.json',
        'why': 'tests'})
    bench['workloads'].append({
        'name': 'tiny-longform', 'config': 'tiny-longform',
        'traffic': 'tiny-longform', 'chips': 1, 'why': 'tests'})
    for entry in bench['end_to_end'] + bench['per_layer']:
        if entry['name'] in NEW_METRICS:
            entry['workloads'].append('tiny-longform')
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    return root


@pytest.fixture
def program(monkeypatch):
    """The program, its configuration constants put back after the
    test"""
    found = run.import_program()
    for key in TINY_LONGFORM:
        if key.isupper():
            monkeypatch.setattr(found, key, getattr(found, key))
    return found


def run_cell(root, program, trace=False, seed=SEED):
    cell = spec.Cell(root, 'tiny-longform')
    record = run.combine([run.execute(cell, seed, 0.2, trace,
                                      torch.device('cpu'), program)])
    return cell, record


def test_the_configuration_and_its_pool():
    cell = spec.Cell(REPO, 'nobatch-longfile')
    assert cell.chips == 1 and cell.config['states'] == 1440
    assert cell.config_entry['reduced'] == cell.config['reduced'] == []
    # The port's defaults, written out
    import torbi_tpu_torch

    for key in ('MIN_CHUNK_SIZE', 'ENTROPY_THRESHOLD', 'BATCH1_AUTO_CHUNK',
                'BATCH1_CHUNK_FRAMES', 'BATCH1_AUTO_CHUNK_MIN_FRAMES'):
        assert cell.config[key] == getattr(torbi_tpu_torch, key), key
    assert cell.config['BATCH_SIZE'] == 1
    lengths = inputs.lengths(cell.traffic['pool'], **cell.traffic['lengths'])
    assert (len(lengths), sum(lengths), max(lengths), min(lengths)) == (
        64, 2445209, 162957, 10240)
    # In the timed metric's cells, with the four metrics of its own
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    reported = [entry['name'] for entry in bench['end_to_end']
                + bench['per_layer']
                if 'nobatch-longfile' in entry.get('workloads', [])]
    assert reported == list(NEW_METRICS)


def test_recordings_repeat_from_the_seed_and_keep_off_the_threshold():
    def make(seed, frames=3000):
        return recordings.recording(
            frames, STATES, VOICING, 0.5,
            inputs.device_generator(seed, 'cpu'), 'cpu')

    first, again, other = make(SEED), make(SEED), make(SEED + 1)
    assert torch.equal(first.observation, again.observation)
    assert torch.equal(first.voiced, again.voiced)
    assert not torch.equal(first.observation, other.observation)
    # Each frame a distribution in log space, off the threshold by 0.1
    assert torch.allclose(torch.logsumexp(first.observation, dim=-1),
                          torch.zeros(3000), atol=1e-5)
    assert float((first.entropy - 0.5).abs().min()) >= recordings.MARGIN
    assert torch.all(first.entropy[first.voiced] < 0.4)
    assert torch.all(first.entropy[~first.voiced] > 0.6)
    # Runs alternate within their laws' bounds (the last one cut)
    edges = torch.nonzero(first.voiced[1:] != first.voiced[:-1])[:, 0] + 1
    bounds = [0] + edges.tolist() + [3000]
    for start, stop in zip(bounds[1:-1], bounds[2:-1]):
        law = VOICING['voiced' if first.voiced[start] else 'unvoiced']
        assert law['low'] <= stop - start <= law['high']
    assert 0.4 < float(first.voiced.float().mean()) < 0.8
    # The first run's kind comes from the seed
    assert {bool(make(seed, 16).voiced[0]) for seed in range(8)} == {
        True, False}
    # A voiced Gaussian of 3 bins over 128 states lies within 0.1 of 0.5
    with pytest.raises(ValueError, match='threshold'):
        recordings.recording(
            200, STATES, dict(VOICING, voiced=dict(VOICING['voiced'],
                                                   bins=3)),
            0.5, inputs.device_generator(SEED, 'cpu'), 'cpu')


def entropy_of(below):
    """An entropy list: 0.2 where ``below`` holds, 0.9 elsewhere"""
    return [0.2 if frame in below else 0.9 for frame in range(40)]


def test_reference_plan_against_hand_worked_splits():
    # 40 frames, 5 a chunk: n_target 8, min_chunk 5. Pairs below 0.5 end
    # at frames 4, 5, 10, 21, 22, 23, 31, 39; the walk takes 5 (>= 5),
    # 10 (>= 10), 21 (>= 15), 31 (>= 26), 39 (>= 36)
    below = {3, 4, 5, 9, 10, 14, 20, 21, 22, 23, 30, 31, 38, 39}
    assert chunked.split_points(entropy_of(below), 40, 5, 0.5) == [
        5, 10, 21, 31, 39]
    assert chunked.plan(entropy_of(below), 40, 5, 0.5, 8) == [
        (0, 5), (5, 5), (10, 11), (21, 10), (31, 8), (39, 1)]
    # The first 30 frames: 30 // max(8, 6) = 3 apart, and no split at
    # or past the valid length: 4 (>= 3), 10 (>= 7), 21 (>= 13)
    assert chunked.split_points(entropy_of(below), 30, 5, 0.5) == [
        4, 10, 21]
    # Two split points: the whole sequence
    assert chunked.plan(entropy_of({3, 4, 5, 20, 21}), 40, 5, 0.5, 8) == [
        (0, 40)]
    # Fewer valid frames than the route's least: the whole sequence
    assert chunked.plan(entropy_of(below), 40, 5, 0.5, 41) == [(0, 40)]
    # A lone frame below the threshold is no split
    assert chunked.split_points(entropy_of({7, 15, 25}), 40, 5, 0.5) == []


@pytest.mark.parametrize('trace', [False, True])
def test_the_cell_on_the_cpu(tmp_path, program, trace):
    cell, record = run_cell(longform_layout(tmp_path), program, trace)
    assert check.passed(record['checks'])
    # Both checked recordings in every call of the window
    assert record['checked']['recordings'] == 2
    assert record['checked']['calls'] == 2 * record['cycles']
    # Every call took the route and planned afresh
    assert record['autochunk_declines'] == 0
    assert record['autochunk_plans'] == record['attempted']
    assert record['autochunk_rows'] >= 8 * record['attempted']
    line = run.result(cell, record, trace, 'cpu')
    assert line['correct']
    if trace:
        # No device events on the CPU: the trace's readers find nothing
        assert 'breakdown' in line
        stretch = record['stretches'][0]
        assert stretch['autochunk_declines'] == 0
        assert stretch['autochunk_plans'] == stretch['calls'] == 4
    else:
        assert set(line['metrics']) == {'setup_s', 'timesteps_per_s'}


def alter_one_frame(decode):
    """One frame of every path altered"""
    def altered(*args, **kwargs):
        out = decode(*args, **kwargs).clone()
        out[:, out.shape[1] // 2] = (out[:, out.shape[1] // 2] + 1) % STATES
        return out
    return altered


def zero_last_chunk(decode):
    """The last chunk of the longest recording's path zeroed"""
    def zeroed(observation, *args, **kwargs):
        out = decode(observation, *args, **kwargs).clone()
        frames = observation.shape[1]
        if frames == max(inputs.lengths(TINY_MIX['pool'],
                                        **TINY_MIX['lengths'])):
            start, _ = chunked.plan(
                chunked.entropy(observation[0]).tolist(), frames,
                TINY_LONGFORM['BATCH1_CHUNK_FRAMES'], 0.5,
                TINY_LONGFORM['BATCH1_AUTO_CHUNK_MIN_FRAMES'])[-1]
            out[0, start:] = 0
        return out
    return zeroed


@pytest.mark.parametrize('fault', [alter_one_frame, zero_last_chunk])
def test_check_fails_a_broken_decode(tmp_path, monkeypatch, program, fault):
    monkeypatch.setattr(program, 'from_probabilities',
                        fault(program.from_probabilities))
    _, record = run_cell(longform_layout(tmp_path), program)
    assert not check.passed(record['checks'])
    assert record['checks']['mismatched_frames'][0] > 0


def test_a_program_without_the_counters(tmp_path, monkeypatch, program):
    """The parent of the counters: the cell runs, counts no auto-chunk
    keys, and the counters' metric is left out"""
    from torbi_tpu_torch.ops import autochunk

    route = autochunk.decode_chunked

    def uncounted(*args, **kwargs):
        return route(*args, **kwargs)

    monkeypatch.setattr(autochunk, 'decode_chunked', uncounted)
    assert caller.counters(program) == {}
    cell, record = run_cell(longform_layout(tmp_path), program, trace=True)
    assert check.passed(record['checks'])
    assert not any(key.startswith('autochunk_') for key in record)
    stretch = record['stretches'][0]
    assert not any(key.startswith('autochunk_') for key in stretch)
    # A stretch with device work and no counts reads nothing
    traced = {'stretches': [dict(stretch, device_events=5)]}
    assert spec.load(spec.HERE / 'metrics' / 'autochunk_declined_share.py'
                     ).read(traced) is None


def read(metric, record):
    return spec.load(spec.HERE / 'metrics' / f'{metric}.py').read(record)


def test_readers_of_the_cell():
    stretch = {'span_s': 2.0, 'busy_s': 1.5, 'compute_busy_s': 1.2,
               'device_events': 40, 'calls': 8, 'operations': 8e9,
               'bytes': 4e8, 'autochunk_declines': 2,
               'idle_gaps': [['torbi.autochunk.plan', 0.2],
                             ['torbi.from_probabilities', 0.1],
                             ['torbi.autochunk.entropy', 0.05],
                             ['shorter gaps', 0.15]]}
    record = {'stretches': [stretch]}
    assert read('autochunk_declined_share', record) == pytest.approx(0.25)
    assert read('autochunk_idle_share', record) == pytest.approx(0.25 / 2)
    assert read('device_idle_share.longform', record) == read(
        'device_idle_share', record) == pytest.approx(0.25)
    assert read('decode_roofline.longform', record) == read(
        'decode_roofline', record)
    # No gap named after an auto-chunk span: nothing to read
    quiet = dict(stretch, idle_gaps=[['torbi.decode', 0.3]])
    assert read('autochunk_idle_share', {'stretches': [quiet]}) is None
    assert read('autochunk_idle_share', {'stretches': None}) is None
    assert read('autochunk_declined_share', {'stretches': None}) is None
