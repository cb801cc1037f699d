"""The pYIN cell: its configuration as the harness reads it, its HMM and
generator, the whole cell on the CPU at a small size, a planted fault,
and the reader of its conversion counter on a program with and without
that counter"""
import json

import numpy as np
import pytest
import torch

from benchmark import check, inputs, pyin, roofline, run, spec
from benchmark.callers import pyin as caller
from benchmark.reference import pyin as reference
from benchmark.tests.layout import PROGRAM_METRICS, REPO, tiny_layout

SEED = 2 ** 33 + 23
# C3-C5 in half semitones: 49 pitch bins, 98 states, a window of 21 bins
TINY_PYIN = dict(json.loads(
    (REPO / 'benchmark' / 'configs' / 'pyin1202-default.json').read_text()
)['pyin'], fmin=130.8127826502993, fmax=523.2511306011972, resolution=0.5,
    pitch_bins=49, transition_width=21)
TINY_CONFIG = {
    'name': 'tiny-pyin', 'states': 98, 'pyin': TINY_PYIN,
    'precision': 'float32', 'BATCH_SIZE': 8, 'MIN_CHUNK_SIZE': None,
    'chips': 1, 'assumed': [], 'reduced': ['pyin', 'states']}
TINY_MIX = {
    'caller': 'pyin', 'pool': 24,
    'lengths': {'median': 12, 'sigma': 0.6, 'low': 4, 'high': 40},
    'order': 'sorted',
    'voicing': {
        'voiced': {'median': 4, 'sigma': 0.6, 'low': 2, 'high': 12},
        'unvoiced': {'median': 2, 'sigma': 1.0, 'low': 1, 'high': 12}},
    'frames': {'step': 3, 'peak': [0.5, 0.9], 'octave_chance': 0.2,
               'octave_mass': [0.05, 0.2], 'octave_bins': 24,
               'stray_chance': 0.5, 'stray_mass': [0.0, 0.2]},
    'sample': 6, 'trace_cycles': 1}
NEW_METRICS = ('timesteps_per_s', 'decode_roofline.pyin',
               'device_idle_share.pyin', 'convert_values_per_frame.pyin',
               'device_ops_per_call.pyin')


def pyin_layout(root):
    """``tiny_layout`` with a small pYIN configuration, mix and cell,
    ``tiny-pyin``, reporting the real cell's metrics"""
    root = tiny_layout(root)
    folder = root / spec.HERE.name
    (folder / 'configs' / 'tiny-pyin.json').write_text(
        json.dumps(TINY_CONFIG))
    (folder / 'traffic' / 'tiny-pyin.json').write_text(json.dumps(TINY_MIX))
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({
        'name': 'tiny-pyin', 'source': 'a test',
        'reduced': TINY_CONFIG['reduced'],
        'file': f'{spec.HERE.name}/configs/tiny-pyin.json', 'why': 'tests'})
    bench['workloads'].append({
        'name': 'tiny-pyin', 'config': 'tiny-pyin', 'traffic': 'tiny-pyin',
        'chips': 1, 'why': 'tests'})
    for entry in bench['end_to_end'] + bench['per_layer']:
        if entry['name'] in NEW_METRICS:
            entry['workloads'].append('tiny-pyin')
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    return root


@pytest.fixture
def program():
    return run.import_program()


def run_cell(root, program, trace=False, seed=SEED):
    cell = spec.Cell(root, 'tiny-pyin')
    record = run.combine([run.execute(cell, seed, 0.2, trace,
                                      torch.device('cpu'), program)])
    return cell, record


def test_the_configuration_as_the_harness_reads_it():
    cell = spec.Cell(REPO, 'pyin-b512-sorted')
    config = cell.config
    assert cell.chips == config['chips'] == 1
    assert cell.config_entry['reduced'] == config['reduced'] == []
    assert cell.config_entry['source'] == config['source']
    assert len(config['source']) <= 200
    assert (config['BATCH_SIZE'], config['MIN_CHUNK_SIZE']) == (512, None)
    assert config['precision'] == 'float32'
    # The sizes follow from librosa's parameters, and are written out
    pyin_ = config['pyin']
    assert reference.sizes(pyin_) == (
        pyin_['pitch_bins'], pyin_['transition_width']) == (601, 101)
    assert config['states'] == 2 * pyin_['pitch_bins'] == 1202
    # Configuration constants the harness sets on the program
    import torbi_tpu_torch

    assert config['MIN_CHUNK_SIZE'] == torbi_tpu_torch.MIN_CHUNK_SIZE
    assert cell.traffic['caller'] == 'pyin'
    # In the timed metric's cells, with the four metrics of its own
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    reported = [entry['name'] for entry in bench['end_to_end']
                + bench['per_layer']
                if 'pyin-b512-sorted' in entry.get('workloads', [])]
    assert reported == list(NEW_METRICS) + PROGRAM_METRICS


def test_the_pool_and_its_work_at_the_cell_size():
    mix = spec.Cell(REPO, 'pyin-b512-sorted').traffic
    lengths = inputs.lengths(mix['pool'], **mix['lengths'])
    assert (len(lengths), sum(lengths), min(lengths), max(lengths)) == (
        4096, 840932, 43, 861)
    batches = [lengths[k:k + 512] for k in range(0, 4096, 512)]
    assert [max(rows) for rows in batches] == [
        86, 115, 142, 172, 208, 258, 343, 861]
    # The conversion's values a real frame: every state of every padded
    # frame
    padded = sum(512 * max(rows) for rows in batches)
    assert 1202 * padded / sum(lengths) == pytest.approx(1599.06, abs=0.01)
    # The positive pairs (four blocks of the band) and the floor's max
    transition, initial = reference.hmm(
        spec.Cell(REPO, 'pyin-b512-sorted').config['pyin'])
    pairs, floor = roofline.candidates_per_frame(transition)
    assert (pairs, floor) == (232604, 1202)
    operations, moved = roofline.decode_work(batches[-1], 1202, pairs, floor)
    steps = sum(batches[-1]) - 512
    assert operations == 2 * steps * (232604 + 1202)
    assert moved == 4 * (sum(batches[-1]) * 1202 + 232604 + sum(batches[-1]))
    # The least time of a cycle at the H100's peaks, about 11.7 ms
    least = sum(roofline.least_seconds(*roofline.decode_work(
        rows, 1202, pairs, floor)) for rows in batches)
    assert least == pytest.approx(0.0117, abs=0.0002)


def test_the_hmm_in_librosa_orientation():
    transition, initial = reference.hmm(
        spec.Cell(REPO, 'pyin-b512-sorted').config['pyin'])
    by_source = reference.transition_by_source(
        spec.Cell(REPO, 'pyin-b512-sorted').config['pyin'])
    # librosa's rows (sources) sum to 1: the program's columns
    assert np.allclose(by_source.sum(axis=1), 1)
    assert torch.allclose(transition.sum(dim=0).double(),
                          torch.ones(1202, dtype=torch.float64), atol=1e-6)
    assert torch.equal(transition, torch.from_numpy(by_source.T).float())
    # Asymmetric near the edges, where the rows normalise over fewer bins
    assert float((transition - transition.T).abs().max()) > 0.008
    assert float(initial[:601].sum()) == 0
    assert torch.all(initial[601:] == torch.tensor(1 / 601))
    # librosa's window: scipy.signal.windows.triang(101)
    window = reference.triang(101)
    assert window[50] == 1 and window[0] == window[100] == 2 / 102


def make(seed, lengths=(40, 33, 7, 4), bins=49):
    return pyin.observations(list(lengths), bins, TINY_MIX,
                             inputs.device_generator(seed, 'cpu'), 'cpu')


def test_observations_repeat_from_the_seed_and_sum_to_one():
    first, again, other = make(SEED), make(SEED), make(SEED + 1)
    assert first.shape == (4, 40, 98) and first.dtype == torch.float32
    assert torch.equal(first, again) and not torch.equal(first, other)
    for row, length in enumerate((40, 33, 7, 4)):
        frames = first[row, :length]
        assert torch.allclose(frames.sum(dim=1), torch.ones(length),
                              atol=1e-6)
        # The unvoiced half: one value a frame, (1 - voiced) / bins
        unvoiced = frames[:, 49:]
        assert torch.all(unvoiced == unvoiced[:, :1])
        voiced = frames[:, :49].sum(dim=1).clamp(0, 1)
        assert torch.equal(unvoiced[:, 0], (1 - voiced) / 49)
        # At most two voiced bins a frame, none negative
        assert int((frames[:, :49] > 0).sum(dim=1).max()) <= 2
        assert float(frames.min()) >= 0
        # Padding is zero
        assert not torch.any(first[row, length:])
    # Voiced frames carry a peak of 0.5-0.9
    peaks = first[..., :49].amax(dim=-1)
    assert bool(((peaks >= 0.5) & (peaks <= 0.9)).any())


@pytest.mark.parametrize('trace', [False, True])
def test_the_cell_on_the_cpu(tmp_path, program, trace):
    cell, record = run_cell(pyin_layout(tmp_path), program, trace)
    assert check.passed(record['checks'])
    assert record['checked']['rows'] == 6
    # The conversion converts every state of every padded frame
    lengths = inputs.lengths(24, **TINY_MIX['lengths'])
    padded = sum(8 * max(lengths[k:k + 8]) for k in range(0, 24, 8))
    assert record['convert_values'] == 98 * padded * record['cycles']
    assert record['frames'] == sum(lengths) * record['cycles']
    line = run.result(cell, record, trace, 'cpu')
    assert line['correct']
    if trace:
        stretch = record['stretches'][0]
        assert stretch['calls'] == 3
        assert stretch['convert_values'] == 98 * padded
        # No device events on the CPU: the trace's readers find nothing
        assert 'breakdown' in line
    else:
        assert set(line['metrics']) == {'setup_s', 'timesteps_per_s'}


def test_a_planted_fault_turns_correct_false(tmp_path, monkeypatch,
                                             program):
    """One frame of one checked row altered"""
    decode = program.from_probabilities
    altered = []

    def faulty(observation, batch_frames, *args, **kwargs):
        out = decode(observation, batch_frames, *args, **kwargs).clone()
        if int(batch_frames.max()) == 40:
            row = int(batch_frames.argmax())
            out[row, 5] = (out[row, 5] + 1) % 98
            altered.append(row)
        return out

    monkeypatch.setattr(program, 'from_probabilities', faulty)
    _, record = run_cell(pyin_layout(tmp_path), program)
    assert altered
    assert not check.passed(record['checks'])
    # The longest row is always checked: one frame in each kept cycle
    assert record['checks']['mismatched_frames'][0] == min(
        3, record['cycles'])


def test_a_program_without_the_counter(tmp_path, monkeypatch, program):
    """The parent of the counter: the cell runs, counts no conversion,
    and the metric is left out"""
    from torbi_tpu_torch.ops import dispatch

    real = dispatch.convert

    def uncounted(*args, **kwargs):
        return real(*args, **kwargs)

    monkeypatch.setattr(dispatch, 'convert', uncounted)
    assert caller.counters(program) == {}
    _, record = run_cell(pyin_layout(tmp_path), program, trace=True)
    assert check.passed(record['checks'])
    assert 'convert_values' not in record
    stretch = record['stretches'][0]
    assert 'convert_values' not in stretch
    traced = {'stretches': [dict(stretch, device_events=5)]}
    assert read('convert_values_per_frame.pyin', traced) is None


def read(metric, record):
    return spec.load(spec.HERE / 'metrics' / f'{metric}.py').read(record)


def test_readers_of_the_cell():
    stretch = {'span_s': 2.0, 'busy_s': 1.5, 'compute_busy_s': 1.2,
               'device_events': 40, 'calls': 16, 'frames': 1000,
               'operations': 8e9, 'bytes': 4e8, 'convert_values': 1600000}
    record = {'stretches': [stretch]}
    assert read('convert_values_per_frame.pyin', record) == 1600
    assert read('convert_values_per_frame.pyin', {'stretches': [
        dict(stretch, convert_values=0)]}) == 0
    assert read('device_idle_share.pyin', record) == read(
        'device_idle_share', record) == pytest.approx(0.25)
    assert read('decode_roofline.pyin', record) == read(
        'decode_roofline', record)
    assert read('device_ops_per_call.pyin', record) == read(
        'device_ops_per_call', record) == 2.5
    assert read('convert_values_per_frame.pyin', {'stretches': None}) is None
