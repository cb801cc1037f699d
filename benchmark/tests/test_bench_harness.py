"""The harness: its refusals, BENCHMARK.json's names, the import check,
the discovery of cells by name, and the check failing on a broken
program"""
import ast
import hashlib
import json
import multiprocessing
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import check, run, spec
from benchmark.tests.layout import REPO, tiny_layout

FOLDER = REPO / spec.HERE.name
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
SEED = 2 ** 31 + 5


def cli(root, *arguments):
    return subprocess.run(
        [sys.executable, str(root / 'benchmark' / 'run.py'), *arguments],
        cwd=root, capture_output=True, text=True, timeout=300)


def test_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is here')
    done = cli(REPO, '--workload', 'default-b512-sorted', '--seed',
               str(SEED), '--seconds', '1', '--trace', '0')
    assert done.returncode != 0
    assert '{' not in done.stdout
    assert 'no CUDA card' in done.stderr


def test_fails_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(REPO / 'BENCHMARK.json', tmp_path)
    shutil.copytree(FOLDER, tmp_path / FOLDER.name,
                    ignore=shutil.ignore_patterns('__pycache__'))
    done = cli(tmp_path, '--workload', 'default-b512-sorted', '--seed',
               str(SEED), '--seconds', '1', '--trace', '0')
    assert done.returncode != 0
    assert '{' not in done.stdout
    assert 'torbi_tpu_torch' in done.stderr


def test_benchmark_json_names_keys_and_files():
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert bench['paths'] == [FOLDER.name]
    assert all(PATH.match(path) for path in bench['paths'])
    assert bench['command'][1] == f'{FOLDER.name}/run.py'
    assert 1 <= bench['run_seconds'] <= 51
    names = set()
    for config in bench['configs']:
        assert set(config) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(config['name']) and config['name'] not in names
        names.add(config['name'])
        assert (REPO / config['file']).is_file()
        assert config['file'].startswith(f'{FOLDER.name}/')
        assert all(NAME.match(key) for key in config['reduced'])
        body = json.loads((REPO / config['file']).read_text())
        assert body['reduced'] == config['reduced']
    used = set()
    four = 0
    for cell in bench['workloads']:
        assert set(cell) == {'name', 'config', 'traffic', 'chips', 'why'}
        for key in ('name', 'config', 'traffic'):
            assert NAME.match(cell[key])
        assert cell['name'] not in names
        names.add(cell['name'])
        assert cell['chips'] in (1, 4)
        four += cell['chips'] == 4
        used.add(cell['config'])
        assert (FOLDER / 'traffic' / f"{cell['traffic']}.json").is_file()
    assert used == {config['name'] for config in bench['configs']}
    assert four <= max(1, len(bench['workloads']) // 4)
    for kind in ('end_to_end', 'per_layer'):
        for metric in bench[kind]:
            keys = {'name', 'unit', 'better', 'source'} | (
                {'bound'} if kind == 'end_to_end' else {'layer', 'moves'})
            assert set(metric) - {'workloads'} == keys
            assert NAME.match(metric['name'])
            assert metric['name'] not in names
            names.add(metric['name'])
            assert UNIT.match(metric['unit'])
            assert metric['better'] in ('lower', 'higher')
            assert (FOLDER / 'metrics' / f"{metric['name']}.py").is_file()
            if kind == 'end_to_end':
                assert metric['source'] in ('host_clock', 'device_trace')
                assert 0.01 <= metric['bound'] <= 0.25
            else:
                assert metric['source'] in ('device_trace', 'program_span',
                                            'program_counter', 'host_clock')
                assert metric['moves'] in {m['name']
                                           for m in bench['end_to_end']}
    texts = [c['why'] for c in bench['configs'] + bench['workloads']] + [
        c['source'] for c in bench['configs']] + [
        m['layer'] for m in bench['per_layer']] + bench['command']
    assert all(0 < len(t) <= 200 and '\n' not in t and '\t' not in t
               for t in texts)
    for cell in bench['workloads']:
        reported = {m['name'] for m in bench['end_to_end']
                    if cell['name'] in m.get('workloads', [cell['name']])}
        assert 'setup_s' in reported and len(reported) >= 2
        assert any(cell['name'] in m.get('workloads', [cell['name']])
                   for m in bench['per_layer'])
    for path in FOLDER.rglob('*'):
        if '__pycache__' not in path.parts:
            assert PATH.match(str(path.relative_to(REPO)))
    assert len((REPO / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split('.')[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split('.')[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for path in FOLDER.rglob('*.py'):
        found = top_level_imports(path)
        assert not found & {'jax', 'jaxlib', 'flax', 'torbi_tpu'}, path
        if 'reference' in path.relative_to(FOLDER).parts:
            assert 'torbi_tpu_torch' not in found, path
    # The run's own check compares whole top-level names
    sys.modules['jax_free_module.part'] = sys.modules['json']
    try:
        assert 'jax' not in run.forbidden_modules()
    finally:
        del sys.modules['jax_free_module.part']
    assert run.forbidden_modules() == sorted(
        {'jax', 'torbi_tpu'} & {name.split('.')[0] for name in sys.modules})


def digests(root):
    return {path: hashlib.sha256(path.read_bytes()).hexdigest()
            for path in root.rglob('*') if path.is_file()
            and '__pycache__' not in path.parts}


def test_finds_a_new_cell_mix_config_and_metric_by_name(tmp_path):
    """A configuration, a mix and a metric added as files, with their
    entries, run without any file of the layout edited"""
    root = tiny_layout(tmp_path)
    folder = root / FOLDER.name
    before = digests(folder)
    config = json.loads((folder / 'configs' / 'tiny.json').read_text())
    config['BATCH_SIZE'] = 4
    (folder / 'configs' / 'tiny-other.json').write_text(json.dumps(config))
    mix = json.loads((folder / 'traffic' / 'tiny-sorted.json').read_text())
    mix['order'] = 'arrival'
    (folder / 'traffic' / 'tiny-arrival.json').write_text(json.dumps(mix))
    (folder / 'metrics' / 'calls_per_s.py').write_text(
        'def read(record):\n'
        '    return record["attempted"] / record["window_s"]\n')
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({
        'name': 'tiny-other', 'source': 'a test', 'reduced': ['states'],
        'file': f'{FOLDER.name}/configs/tiny-other.json', 'why': 'tests'})
    bench['workloads'].append({
        'name': 'tiny-new', 'config': 'tiny-other',
        'traffic': 'tiny-arrival', 'chips': 1, 'why': 'tests'})
    bench['end_to_end'].append({
        'name': 'calls_per_s', 'unit': 'calls/s', 'better': 'higher',
        'bound': 0.05, 'source': 'host_clock', 'workloads': ['tiny-new']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    assert all(digests(folder)[path] == digest
               for path, digest in before.items())
    cell = spec.Cell(root, 'tiny-new')
    assert cell.config['BATCH_SIZE'] == 4
    assert cell.traffic['order'] == 'arrival'
    record = run.combine([run.execute(cell, SEED, 0.2, False,
                                      torch.device('cpu'),
                                      run.import_program())])
    line = run.result(cell, record, False, 'cpu')
    assert line['correct']
    assert set(line['metrics']) == {'setup_s', 'calls_per_s'}
    assert list(line)[-1] == 'checks'
    traced = run.result(cell, run.combine([run.execute(
        cell, SEED, 0.2, True, torch.device('cpu'),
        run.import_program())]), True, 'cpu')
    assert 'breakdown' in traced and 'busy_s' in traced['device']


def run_cell(root, name, program, seed=SEED, trace=False):
    cell = spec.Cell(root, name)
    return run.combine([run.execute(cell, seed, 0.2, trace,
                                    torch.device('cpu'), program)])


def alter_first_frame(decode):
    """A token altered where it is produced: frame 0 of every row"""
    def altered(*args, **kwargs):
        out = decode(*args, **kwargs).clone()
        out[:, 0] = (out[:, 0] + 1) % 64
        return out
    return altered


def leave_out_half(decode):
    """Half the batch left out: the first half decoded, the rest zero"""
    def half(observation, batch_frames, *args, **kwargs):
        rows = max(1, observation.shape[0] // 2)
        out = torch.zeros(observation.shape[:2], dtype=torch.int32)
        out[:rows] = decode(observation[:rows], batch_frames[:rows], *args,
                            **kwargs)
        return out
    return half


@pytest.mark.parametrize('cell, fault', [
    ('tiny-sorted', None), ('tiny-sorted', alter_first_frame),
    ('tiny-sorted', leave_out_half),
    # A batch of one has no half to leave out
    ('tiny-single', None), ('tiny-single', alter_first_frame)])
def test_check_fails_a_broken_decode(tmp_path, monkeypatch, cell, fault):
    program = run.import_program()
    if fault is not None:
        monkeypatch.setattr(program, 'from_probabilities',
                            fault(program.from_probabilities))
    record = run_cell(tiny_layout(tmp_path), cell, program)
    assert check.passed(record['checks']) == (fault is None)
    if fault is not None:
        assert record['checks']['mismatched_frames'][0] > 0


def test_a_call_that_raises_counts_as_failed(tmp_path, monkeypatch):
    program = run.import_program()
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 5:
            raise RuntimeError('a planted failure')
        return decode(*args, **kwargs)

    decode = program.from_probabilities
    monkeypatch.setattr(program, 'from_probabilities', flaky)
    record = run_cell(tiny_layout(tmp_path), 'tiny-sorted', program)
    assert record['checks']['failed_calls'][0] == 1
    assert not check.passed(record['checks'])


def world_rank(root, rank, world, port, fault):
    """One rank of a CPU world over gloo, its gather left out if asked"""
    if fault:
        from torbi_tpu_torch.parallel import sharded

        def local_only(path, batch, count, group):
            import torch.distributed as dist

            start, stop = sharded.slice_rows(batch, count, dist.get_rank())
            out = torch.zeros((batch, path.shape[1]), dtype=path.dtype)
            out[start:stop] = path
            return out
        sharded.gather_rows = local_only
    return run.rank_record(root, 'tiny-sharded', SEED, 0.2, True, rank,
                           world, port, device_type='cpu')


@pytest.mark.parametrize('fault', [False, True])
def test_world_on_the_cpu_and_its_exchange_left_out(tmp_path, fault):
    root = tiny_layout(tmp_path)
    world, port = 2, run.free_port()
    with multiprocessing.get_context('spawn').Pool(world) as pool:
        records = pool.starmap(world_rank, [
            (root, rank, world, port, fault) for rank in range(world)],
            chunksize=1)
    record = run.combine(records)
    assert check.passed(record['checks']) == (not fault)
    line = run.result(spec.Cell(root, 'tiny-sharded'), record, True, 'cpu')
    assert line['device']['window_s'] > 0
    # Every rank's stretch keeps the program's record of its own spans
    for stretch in record['stretches']:
        assert 'torbi.decode_sharded' in stretch['program']['self_s']
        assert ('torbi.gather' in stretch['program']['self_s']) != fault
