"""The file split and the evaluation harness of torbi_tpu_torch in a
two-rank gloo world on the CPU, against one process and against torbi_tpu.

Each world is one ``python tests/torch_sharded_worker.py`` a rank on a
free local port, started once per module:

- ``parallel.files.from_files_to_files`` over two small banded corpora,
  one with random band weights (unique optimal paths) and the benchmark's
  (``bench.write_corpus``: a symmetric band, so exact ties of path
  scores, where a conversion a few ulps off picks another path): the
  shares are disjoint, cover the corpus and are ``shard_files_balanced``'s
  partition; every output equals the single-process port's and
  ``torbi_tpu.from_files_to_files``'s;
- ``evaluate.datasets`` over a 1440-state pitch corpus with rank 0's
  reference targets already on disk: the metrics and frames equal the
  single-process run's, every rank returns them, the timing contexts are
  the union of the ranks' with each context's seconds the max, and the
  results file is written once, by rank 0.
"""
import json
import shutil

import numpy as np
import pytest
import torch

import torbi_tpu
import torbi_tpu_torch
from torbi_tpu_torch import bench
from torbi_tpu_torch.evaluate import core
from torbi_tpu_torch.models import pitch
from torbi_tpu_torch.parallel import files
from torch_sharded_worker import run_world

TINY = np.finfo(np.float32).tiny
WORLD = 2
STATES = 64
LENGTHS = (37, 5, 22, 61, 14, 30, 9, 48, 17)
DATASET = 'synth'
EVAL_LENGTHS = (40, 73, 25, 66, 51, 32)


def _corpus(directory, kind):
    """Log-space .npy files under a banded transition's probability file:
    'ties', the benchmark's corpus; 'unique', random band weights, so that
    every file has a unique optimal path"""
    directory.mkdir()
    if kind == 'ties':
        return bench.write_corpus(str(directory), LENGTHS, STATES)
    rng = np.random.default_rng(50)
    bins = np.arange(STATES)
    band = np.abs(bins[:, None] - bins[None, :]) <= 3
    weights = np.where(band, rng.uniform(0.05, 1, (STATES, STATES)), 0)
    trans = directory / 'transition.npy'
    np.save(trans, (weights / weights.sum(axis=1, keepdims=True)).astype(
        np.float32))
    inputs, outputs = [], []
    for i, frames in enumerate(LENGTHS):
        path = directory / f'{i}.npy'
        np.save(path, np.log(rng.dirichlet(
            np.ones(STATES) * 0.3, size=frames).astype(np.float32) + TINY))
        inputs.append(str(path))
        outputs.append(str(directory / f'{i}_out.npy'))
    return inputs, outputs, str(trans)


@pytest.fixture(scope='module', params=('unique', 'ties'))
def file_world(request, tmp_path_factory):
    directory = tmp_path_factory.mktemp(f'files_{request.param}')
    inputs, outputs, trans = _corpus(directory / 'corpus', request.param)
    spec = directory / 'files.json'
    spec.write_text(json.dumps(
        {'inputs': inputs, 'outputs': outputs, 'transition': trans}))
    shares = [json.loads(path.read_text())['share']
              for path in run_world('files', WORLD, spec, directory)]
    return inputs, outputs, trans, shares


def test_file_shares_partition_the_corpus(file_world):
    inputs, outputs, _, shares = file_world
    assert not set(shares[0]) & set(shares[1])
    assert sorted(shares[0] + shares[1]) == sorted(inputs)
    for rank, share in enumerate(shares):
        assert share == files.shard_files_balanced(
            inputs, outputs, rank, WORLD)[0]
        assert share


def test_file_outputs_equal_one_process_and_jax(file_world, tmp_path):
    """Every output of the two ranks equals the single-process port's and
    torbi_tpu's from_files_to_files"""
    inputs, outputs, trans, _ = file_world
    port = [str(tmp_path / f'port{i}.npy') for i in range(len(inputs))]
    jax = [str(tmp_path / f'jax{i}.npy') for i in range(len(inputs))]
    torbi_tpu_torch.from_files_to_files(
        inputs, port, transition_file=trans, log_probs=True, gpu='cpu')
    torbi_tpu.from_files_to_files(
        inputs, jax, transition_file=trans, log_probs=True)
    for split, single, reference in zip(outputs, port, jax):
        got = np.load(split)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.load(single))
        np.testing.assert_array_equal(got, np.load(reference))


def _eval_corpus(root):
    cache = root / 'cache' / DATASET
    cache.mkdir(parents=True)
    stems = [f'{i:06d}' for i in range(len(EVAL_LENGTHS))]
    for i, (stem, frames) in enumerate(zip(stems, EVAL_LENGTHS)):
        obs = pitch.synthetic_posteriorgrams(1, frames, seed=70 + i)[0]
        torch.save(torch.from_numpy(obs), cache / f'{stem}.pt')
    (root / 'partitions').mkdir()
    (root / 'partitions' / f'{DATASET}.json').write_text(json.dumps(stems))
    return stems


@pytest.fixture(scope='module')
def eval_world(tmp_path_factory):
    """(single-process results, each rank's output, the world's work
    directory): the single process runs first, in its own directory; the
    world starts with rank 0's reference targets copied from it"""
    root = tmp_path_factory.mktemp('evaluation')
    stems = _eval_corpus(root)
    single, split = root / 'single', root / 'split'
    saved = {name: getattr(torbi_tpu_torch, name) for name in (
        'CACHE_DIR', 'EVAL_DIR', 'PARTITION_DIR', 'PITCH_TRANSITION_MATRIX')}
    try:
        torbi_tpu_torch.CACHE_DIR = root / 'cache'
        torbi_tpu_torch.PARTITION_DIR = root / 'partitions'
        torbi_tpu_torch.EVAL_DIR = single / 'eval'
        torbi_tpu_torch.PITCH_TRANSITION_MATRIX = single / 'transition.pt'
        results = torbi_tpu_torch.evaluate.datasets([DATASET], gpu='cpu')
    finally:
        for name, value in saved.items():
            setattr(torbi_tpu_torch, name, value)
    inputs = [root / 'cache' / DATASET / f'{stem}.pt' for stem in stems]
    mine, _ = files.shard_files_balanced(inputs, stems, 0, WORLD)
    cached = split / 'eval' / DATASET / 'reference'
    cached.mkdir(parents=True)
    for path in mine:
        shutil.copy(
            single / 'eval' / DATASET / 'reference' / path.name, cached)
    spec = root / 'evaluate.json'
    spec.write_text(json.dumps({
        'cache': str(root / 'cache'), 'partitions': str(root / 'partitions'),
        'eval': str(split / 'eval'), 'transition': str(split / 't.pt'),
        'config': 'split', 'dataset': DATASET}))
    ranks = [json.loads(path.read_text())
             for path in run_world('evaluate', WORLD, spec, root)]
    return results, ranks, split


def test_evaluation_metrics_equal_one_process(eval_world):
    single, ranks, _ = eval_world
    for rank in ranks:
        got = rank['results'][DATASET]
        assert got['rpa'] == single[DATASET]['rpa']
        assert got['rpa']['0'] == pytest.approx(1.0)
        assert got['frames'] == single[DATASET]['frames'] == sum(
            EVAL_LENGTHS)
        assert got == ranks[0]['results'][DATASET]


def test_evaluation_seconds_are_the_max_over_the_union(eval_world):
    """Rank 0 found its targets on disk and never ran the reference pass;
    the aggregated contexts are the union, each the slowest rank's"""
    _, ranks, _ = eval_world
    local = [rank['seconds'][0][0] for rank in ranks]
    assert 'librosa' not in local[0] and 'librosa' in local[1]
    for rank in ranks:
        aggregated = rank['seconds'][0][1]
        assert set(aggregated) == set(local[0]) | set(local[1])
        for key, value in aggregated.items():
            assert value == max(seconds.get(key, 0.0) for seconds in local)
        assert set(rank['results'][DATASET]['rtf']) == set(aggregated)


def test_evaluation_writes_once(eval_world):
    """Rank 0 alone writes EVAL_DIR/<CONFIG>.json, holding the results"""
    _, ranks, split = eval_world
    assert [rank['writes'] for rank in ranks] == [1, 0]
    written = json.loads((split / 'eval' / 'split.json').read_text())
    assert written == ranks[0]['results']


def test_evaluation_shares_are_disjoint(eval_world):
    """Each rank decoded its own share: the outputs of both cover every
    stem once"""
    _, _, split = eval_world
    outputs = sorted(path.stem for path in (
        split / 'eval' / DATASET / 'split').iterdir())
    assert outputs == [f'{i:06d}' for i in range(len(EVAL_LENGTHS))]


def test_aggregation_is_a_no_op_in_one_process():
    metrics = torbi_tpu_torch.evaluate.Metrics()
    metrics.update(np.array([1, 2, 3]), np.array([1, 2, 4]))
    before = [(rpa.total, rpa.count) for rpa in metrics.rpas]
    core._aggregate_metrics(metrics)
    assert [(rpa.total, rpa.count) for rpa in metrics.rpas] == before
    assert core._aggregate_seconds({'torbi': 1.5}) == {'torbi': 1.5}
    stems, inputs = ['a', 'b'], ['a.pt', 'b.pt']
    assert core._process_shard(stems, inputs) == (stems, inputs)
