"""Find a cell's pieces by name.

``BENCHMARK.json`` at the root names every cell (``workloads``), its
configuration (``configs``: a JSON file of sizes and settings) and its
traffic mix (``traffic/<mix>.json``: the parameters that one caller,
``callers/<caller>.py``, reads). Every metric is a reader of its own,
``metrics/<metric>.py``, whose ``read(record)`` returns the metric's value
from a run's record, or None where it finds nothing to read. So a later
cell, mix, configuration or metric is a new file and a new entry, and no
file here changes.
"""
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Cell:
    """One entry of ``workloads``, with its configuration, its mix and the
    metrics it reports, loaded from the checkout at ``root``"""

    def __init__(self, root, name):
        self.root = Path(root)
        self.benchmark = json.loads((self.root / 'BENCHMARK.json').read_text())
        cells = {cell['name']: cell for cell in self.benchmark['workloads']}
        if name not in cells:
            raise KeyError(
                f'no workload {name!r} in BENCHMARK.json; there are '
                f'{sorted(cells)}')
        self.name = name
        self.workload = cells[name]
        self.chips = int(self.workload['chips'])
        configs = {config['name']: config
                   for config in self.benchmark['configs']}
        self.config_entry = configs[self.workload['config']]
        self.config = json.loads(
            (self.root / self.config_entry['file']).read_text())
        self.traffic = json.loads(
            (self.folder / 'traffic' / f"{self.workload['traffic']}.json")
            .read_text())

    @property
    def folder(self):
        """The benchmark's folder in this checkout"""
        return self.root / HERE.name

    def metrics(self, traced):
        """The metric entries this cell reports: the per-layer ones in a
        traced run, else the end-to-end ones; an entry with ``workloads``
        only in the cells it lists"""
        entries = self.benchmark['per_layer' if traced else 'end_to_end']
        return [entry for entry in entries
                if self.name in entry.get('workloads', [self.name])]

    def caller(self):
        """The module of ``callers/<caller>.py`` that runs this mix"""
        return load(self.folder / 'callers' / f"{self.traffic['caller']}.py")

    def reader(self, metric):
        """The module of ``metrics/<metric>.py``"""
        return load(self.folder / 'metrics' / f'{metric}.py')


def load(path):
    """Import the Python file at ``path`` by its path (names may hold '.'
    and '-'), once per process"""
    path = Path(path)
    key = f'_benchmark_{path.parent.name}_{path.stem}_{abs(hash(path))}'
    if key not in sys.modules:
        if not path.is_file():
            raise FileNotFoundError(f'{path} does not exist')
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]
