"""A small copy of the benchmark's layout for tests on the CPU: the
folder copied, a configuration of 64 states and mixes of a few short
utterances written beside the real ones, and a BENCHMARK.json of cells
that use them."""
import json
import shutil
from pathlib import Path

from benchmark import spec

REPO = Path(__file__).resolve().parents[2]
# The program's span metrics that every throughput cell reports, in
# BENCHMARK.json's order
PROGRAM_METRICS = ['dispatch_idle_share', 'dispatch_host_ms_per_call',
                   'forward_ms_per_call', 'chase_ms_per_call']
LENGTHS = {'median': 12, 'sigma': 0.6, 'low': 4, 'high': 40}
TINY_CONFIG = {
    'name': 'tiny', 'states': 64, 'precision': 'float32',
    'transition': {'kind': 'penn', 'cents_per_bin': 5, 'octave': 1200,
                   'max_octaves_per_second': 35.92, 'hopsize': 8,
                   'sample_rate': 8000},
    'BATCH_SIZE': 8, 'MIN_CHUNK_SIZE': None, 'chips': 1, 'assumed': [],
    'reduced': ['states']}
TINY_MIXES = {
    'tiny-sorted': {'caller': 'batches', 'entry': 'from_probabilities',
                    'pool': 24, 'lengths': LENGTHS, 'order': 'sorted',
                    'sample': 6, 'trace_cycles': 1},
    'tiny-single': {'caller': 'batches', 'entry': 'from_probabilities',
                    'pool': 6, 'lengths': LENGTHS, 'order': 'arrival',
                    'batch': 1, 'sample': 3, 'trace_cycles': 1},
    'tiny-sharded': {'caller': 'batches', 'entry': 'decode_sharded',
                     'pool': 16, 'lengths': LENGTHS, 'order': 'sorted',
                     'batch': 8, 'sample': 6, 'trace_cycles': 1},
}


def tiny_layout(root):
    """Copy the benchmark into ``root`` and add the tiny configuration,
    mixes and cells; returns ``root``"""
    root = Path(root)
    shutil.copytree(REPO / spec.HERE.name, root / spec.HERE.name,
                    ignore=shutil.ignore_patterns('__pycache__'))
    benchmark = json.loads((REPO / 'BENCHMARK.json').read_text())
    folder = root / spec.HERE.name
    (folder / 'configs' / 'tiny.json').write_text(json.dumps(TINY_CONFIG))
    for name, mix in TINY_MIXES.items():
        (folder / 'traffic' / f'{name}.json').write_text(json.dumps(mix))
    benchmark['configs'].append({
        'name': 'tiny', 'source': 'a test', 'reduced': ['states'],
        'file': f'{spec.HERE.name}/configs/tiny.json', 'why': 'tests'})
    # One cell a mix, of the same name
    for name in TINY_MIXES:
        benchmark['workloads'].append({
            'name': name, 'config': 'tiny', 'traffic': name, 'chips': 1,
            'why': 'tests'})
    for entry in benchmark['per_layer']:
        if 'workloads' in entry:
            entry['workloads'] += list(TINY_MIXES)
    (root / 'BENCHMARK.json').write_text(json.dumps(benchmark))
    return root
