"""The batch scale-out of torbi_tpu_torch against torbi_tpu, on the CPU.

``parallel.decode_sharded`` runs in gloo worlds of 1, 2 and 3 ranks, one
``python tests/torch_sharded_worker.py`` a rank on a free local port,
every case in each world; each rank's path is held bitwise against
``torbi_tpu.parallel.decode_sharded`` on a mesh of as many of conftest's 8
CPU devices (its ``'xla'`` backend) and against ``viterbi_numpy``. The
file split (``parallel.files``) is held against ``torbi_tpu.parallel.files``
on the same inputs, and the auto-policy repair (a decode of one rank's
share joins no collective) at a faked shard count.
"""
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import torbi_tpu_torch
from torbi_tpu.ops import oracle
from torbi_tpu.parallel import batch_mesh
from torbi_tpu.parallel import decode_sharded as jax_decode_sharded
from torbi_tpu.parallel import files as jax_files
from torbi_tpu_torch.ops import autochunk, dispatch
from torbi_tpu_torch.parallel import decode_sharded, files, mesh
from torbi_tpu_torch.parallel.sharded import slice_rows
from torch_sharded_worker import run_world

TINY = np.finfo(np.float32).tiny
WORLDS = (1, 2, 3)


def band_transition(rng, states, floor=True):
    """Offsets -3..3, each entry log(U(0.05, 1)), over log(tiny) (or -inf
    with ``floor`` False)"""
    trans = np.full((states, states),
                    np.log(TINY) if floor else -np.inf, np.float32)
    rows = np.arange(states)
    for offset in range(-3, 4):
        keep = (rows + offset >= 0) & (rows + offset < states)
        trans[rows[keep], rows[keep] + offset] = np.log(
            rng.uniform(0.05, 1, keep.sum())).astype(np.float32)
    return trans


def _case(seed, batch, frames, states, banded, ragged=False):
    rng = np.random.default_rng(seed)
    obs = np.log(rng.dirichlet(np.ones(states) * 0.3, size=(batch, frames))
                 .astype(np.float32) + TINY).astype(np.float32)
    if banded:
        trans = band_transition(rng, states)
    else:
        trans = np.log(rng.dirichlet(np.ones(states), size=states)
                       .astype(np.float32) + TINY).astype(np.float32)
    init = np.log(rng.dirichlet(np.ones(states)).astype(np.float32) + TINY)
    bf = (rng.integers(1, frames + 1, size=batch) if ragged
          else np.full(batch, frames)).astype(np.int32)
    return obs, bf, trans, init.astype(np.float32)


CASES = {
    # The banded route with a floor (K1, K3 on the card)
    'banded-floor': _case(0, 5, 24, 40, banded=True),
    # The dense route (K2, K3 on the card)
    'dense': _case(1, 4, 16, 12, banded=False),
    'ragged': _case(2, 6, 20, 40, banded=True, ragged=True),
    # 7 rows: 4 + 3 in a world of 2, 3 + 3 + 1 in a world of 3
    'uneven': _case(3, 7, 12, 12, banded=False),
    # Fewer rows than ranks in a world of 3: the last rank's slice is empty
    'pair': _case(4, 2, 10, 40, banded=True),
}
# backend='timesharded' splits frames, not the batch: every rank raises
REJECTED = {'timesharded': _case(5, 1, 8, 4, banded=False)}


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]}"""
    directory = tmp_path_factory.mktemp('sharded')
    inputs = directory / 'inputs.npz'
    arrays = {}
    for name, case in {**CASES, **REJECTED}.items():
        arrays.update(zip(
            (f'{name}/{part}' for part in (
                'observation', 'batch_frames', 'transition', 'initial')),
            case))
    np.savez(inputs, **arrays)
    return {world: [dict(np.load(path)) for path in run_world(
        'decode', world, inputs, directory)] for world in WORLDS}


def _jax_path(obs, bf, trans, init, world):
    return np.asarray(jax_decode_sharded(
        obs, bf, trans, init, backend='xla',
        mesh=batch_mesh(devices=jax.devices()[:world])))


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', sorted(CASES))
def test_decode_sharded_equals_jax(worlds, world, name):
    """Every rank returns the whole path, bitwise torbi_tpu's on a mesh of
    as many devices and the oracle's"""
    obs, bf, trans, init = CASES[name]
    expected = _jax_path(obs, bf, trans, init, world)
    np.testing.assert_array_equal(
        expected, oracle.viterbi_numpy(obs, bf, trans, init))
    for rank, results in enumerate(worlds[world]):
        got = results[f'{name}/path']
        assert got.dtype == np.int32 and got.shape == obs.shape[:2]
        np.testing.assert_array_equal(got, expected, err_msg=f'rank {rank}')


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', sorted(CASES))
def test_each_rank_decodes_its_slice(worlds, world, name):
    """A rank decodes through the kernel route once when its slice holds
    rows, and not at all when it is empty (it only joins the gather)"""
    batch = CASES[name][0].shape[0]
    for rank, results in enumerate(worlds[world]):
        start, stop = slice_rows(batch, world, rank)
        assert int(results[f'{name}/decodes'][0]) == int(stop > start)


def test_an_empty_slice_joins_the_gather(worlds):
    """Batch 2 in a world of 3: rank 2 decodes nothing and still returns
    the whole path"""
    assert slice_rows(2, 3, 2) == (2, 2)
    assert int(worlds[3][2]['pair/decodes'][0]) == 0
    np.testing.assert_array_equal(
        worlds[3][2]['pair/path'], worlds[3][0]['pair/path'])


@pytest.mark.parametrize('world', WORLDS)
def test_timesharded_backend_raises_on_every_rank(worlds, world):
    for results in worlds[world]:
        assert 'timesharded/value_error' in results


@pytest.mark.parametrize('name', sorted(CASES))
def test_without_a_group_is_dispatch_decode(name):
    """No process group: decode_sharded is dispatch.decode"""
    obs, bf, trans, init = CASES[name]
    got = decode_sharded(obs, bf, trans, init, device='cpu')
    assert torch.equal(
        got, dispatch.decode(obs, bf, trans, init, device='cpu'))


@pytest.mark.parametrize('batch', (0, 1, 2, 7, 512, 509))
@pytest.mark.parametrize('count', (1, 2, 3, 8))
def test_slices_cover_the_batch_in_order(batch, count):
    """Contiguous slices in rank order, ceil(batch / count) rows each but
    the last ones, covering every row once"""
    slices = [slice_rows(batch, count, rank) for rank in range(count)]
    assert slices[0][0] == 0 and slices[-1][1] == batch
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert all(stop - start <= -(-batch // count) for start, stop in slices)


def test_a_slice_of_a_batch_does_not_auto_chunk(monkeypatch):
    """A one-row slice of a larger batch routes as the whole batch (no
    auto-chunking); a one-row slice of a one-row job auto-chunks as the
    single-process decode does"""
    monkeypatch.setattr(torbi_tpu_torch, 'BATCH1_AUTO_CHUNK_MIN_FRAMES', 32)
    chunked = []
    real = autochunk.decode_chunked

    def spy(*args, **kwargs):
        chunked.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(autochunk, 'decode_chunked', spy)
    obs, bf, trans, init = _case(6, 1, 64, 40, banded=True)
    expected = oracle.viterbi_numpy(obs, bf, trans, init)
    with dispatch.rank_share(2):
        got = dispatch.decode(obs, bf, trans, init, device='cpu')
    assert not chunked
    np.testing.assert_array_equal(got.numpy(), expected)
    with dispatch.rank_share(1):
        dispatch.decode(obs, bf, trans, init, device='cpu')
    assert chunked


def _write_corpus(directory, kind):
    """(input files, output files) of a small corpus: 'npy' float32 .npy
    files, 'float64' .npy files (numpy's header reader), 'mixed' with a .pt
    file (the corpus-wide fallback to byte sizes), 'tail' a heavy tail of
    lengths"""
    rng = np.random.default_rng(7)
    lengths = {'npy': (30, 7, 19, 44, 12, 25, 9),
               'float64': (5, 40, 22, 13, 31),
               'mixed': (14, 3, 27, 50, 8, 19),
               'tail': (400, 3, 4, 5, 3, 6, 4, 5, 300, 2)}[kind]
    inputs, outputs = [], []
    for i, frames in enumerate(lengths):
        obs = rng.random((frames, 6)).astype(
            np.float64 if kind == 'float64' else np.float32)
        if kind == 'mixed' and i == 2:
            path = directory / f'{i}.pt'
            torch.save(torch.from_numpy(obs), path)
        else:
            path = directory / f'{i}.npy'
            np.save(path, obs)
        inputs.append(str(path))
        outputs.append(str(directory / f'{i}_out.npy'))
    return inputs, outputs


KINDS = ('npy', 'float64', 'mixed', 'tail')


@pytest.mark.parametrize('kind', KINDS)
def test_probe_lengths_equal_jax(tmp_path, kind):
    inputs, _ = _write_corpus(tmp_path, kind)
    got = files.probe_lengths(inputs)
    assert got == jax_files.probe_lengths(inputs)
    if kind == 'mixed':
        assert got == [Path(path).stat().st_size for path in inputs]
    else:
        assert got == [len(np.load(path)) for path in inputs]


@pytest.mark.parametrize('count', (1, 2, 3, 4))
@pytest.mark.parametrize('kind', KINDS)
def test_shard_files_balanced_equals_jax(tmp_path, kind, count):
    """Every rank's share is torbi_tpu's; the shares partition the list"""
    inputs, outputs = _write_corpus(tmp_path, kind)
    seen = []
    for rank in range(count):
        got = files.shard_files_balanced(inputs, outputs, rank, count)
        assert got == jax_files.shard_files_balanced(
            inputs, outputs, rank, count)
        seen += got[0]
    assert sorted(seen) == sorted(inputs)


@pytest.mark.parametrize('lengths', (None, [5, 5, 5, 1, 9, 2, 2], 'tail'))
@pytest.mark.parametrize('count', (2, 3))
def test_shard_files_equals_jax(lengths, count):
    """Round-robin without lengths, LPT with them (ties to the lowest
    rank)"""
    names = [f'f{i}' for i in range(7 if lengths != 'tail' else 10)]
    if lengths == 'tail':
        lengths = [400, 3, 4, 5, 3, 6, 4, 5, 300, 2]
    outs = [name + '.out' for name in names]
    for rank in range(count):
        assert files.shard_files(names, outs, rank, count, lengths) == (
            jax_files.shard_files(names, outs, rank, count, lengths))


def _fake_group(monkeypatch, rank, count):
    """This process as ``rank`` of a default group of ``count`` ranks, as
    ``parallel.files`` sees it"""
    monkeypatch.setattr(files, 'mesh', SimpleNamespace(
        shards=lambda group=None: (count, 'world'),
        local_device=mesh.local_device))
    monkeypatch.setattr(files, 'dist', SimpleNamespace(
        get_rank=lambda group=None: rank))


def test_shard_files_reads_the_default_group(monkeypatch):
    """Without arguments the rank and count are the default group's (here
    faked), and a single process keeps every file"""
    names, outs = ['a', 'b', 'c'], ['A', 'B', 'C']
    assert files.shard_files(names, outs) == (names, outs)
    _fake_group(monkeypatch, 1, 2)
    assert files.shard_files(names, outs) == (['b'], ['B'])


def test_file_sharded_decode_calls_no_collective(tmp_path, monkeypatch):
    """The repair: with the shard count faked to 8 and this process rank 0
    of 2, a file-sharded decode of a long one-sequence file over 3 states
    (the time-sharded auto policy's case) takes no time-sharded route and
    calls no collective, and decodes the oracle's path. The same file
    through the plain file API, which runs on every rank, still takes the
    time-sharded route at that count."""
    monkeypatch.setattr(torbi_tpu_torch, 'TIME_SHARDED_MIN_FRAMES', 32)
    monkeypatch.setattr(dispatch, '_shard_count', lambda: 8)
    _fake_group(monkeypatch, 0, 2)
    routed, collectives = [], []
    real = dispatch._decode_timesharded

    def spy(*args, **kwargs):
        routed.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(dispatch, '_decode_timesharded', spy)
    for name in ('all_gather', 'broadcast', 'all_gather_object', 'barrier'):
        monkeypatch.setattr(
            torch.distributed, name,
            lambda *args, name=name, **kwargs: collectives.append(name))
    rng = np.random.default_rng(9)
    probs = rng.dirichlet(np.ones(3) * 0.3, size=64).astype(np.float32)
    trans = rng.dirichlet(np.ones(3), size=3).astype(np.float32)
    source = tmp_path / 'long.npy'
    np.save(source, np.log(probs + TINY))
    np.save(tmp_path / 'transition.npy', trans)
    out = tmp_path / 'long_out.npy'
    files.from_files_to_files(
        [str(source)], [str(out)], transition_file=tmp_path / 'transition.npy',
        log_probs=True, gpu='cpu')
    assert not routed and not collectives
    expected = torbi_tpu_torch.from_probabilities(
        np.load(source)[None], transition=np.log(trans + TINY),
        log_probs=True, gpu='cpu', backend='scan')[0]
    np.testing.assert_array_equal(np.load(out), expected.numpy())
    torbi_tpu_torch.from_files_to_files(
        [str(source)], [str(out)], transition_file=tmp_path / 'transition.npy',
        log_probs=True, gpu='cpu')
    assert routed and not collectives


def test_timesharded_backend_raises_in_a_share():
    obs, bf, trans, init = REJECTED['timesharded']
    with dispatch.rank_share(), pytest.raises(ValueError, match='share'):
        dispatch.decode(obs, bf, trans, init, backend='timesharded',
                        device='cpu')


def test_local_device(monkeypatch):
    """LOCAL_RANK picks the card modulo the cards there are; without it
    (or with gpu given) the usual device; never the CPU unless asked"""
    monkeypatch.setenv('LOCAL_RANK', '5')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    assert mesh.local_device() == torch.device('cuda', 1)
    assert mesh.local_device('cpu') == torch.device('cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        mesh.local_device()
    monkeypatch.delenv('LOCAL_RANK')
    with pytest.raises(RuntimeError, match='CUDA'):
        mesh.local_device()


def test_a_ranks_plain_decode_never_splits_its_batch(monkeypatch):
    """torbi_tpu's AUTO_SHARD has no counterpart: at a faked count of 8
    shards, dispatch.decode still decodes the whole batch in one kernel
    route on this rank; splitting it is decode_sharded"""
    import torbi_tpu

    assert hasattr(torbi_tpu, 'AUTO_SHARD')
    assert not hasattr(torbi_tpu_torch, 'AUTO_SHARD')
    monkeypatch.setattr(mesh, 'shards', lambda group=None: (8, None))
    monkeypatch.setattr(dispatch, '_shard_count', lambda: 8)
    batches = []
    real = dispatch.kernel_route

    def spy(transition, band, batch):
        batches.append(batch)
        return real(transition, band, batch)

    monkeypatch.setattr(dispatch, 'kernel_route', spy)
    obs, bf, trans, init = CASES['uneven']
    got = dispatch.decode(obs, bf, trans, init, device='cpu')
    assert batches == [obs.shape[0]]
    np.testing.assert_array_equal(
        got.numpy(), oracle.viterbi_numpy(obs, bf, trans, init))


@pytest.mark.parametrize('world, cards, backend', (
    (2, 1, 'gloo'), (2, 0, 'gloo'), (1, 1, 'nccl'), (2, 2, 'nccl'),
    (4, 8, 'nccl'), (8, 4, 'gloo')))
def test_ranks_sharing_a_card_use_gloo(world, cards, backend):
    from torbi_tpu_torch.scripts import scaling

    assert scaling.world_backend(world, cards) == backend


def test_scaling_rehearsal_on_the_cpu():
    """scripts.scaling --gpu cpu: one process, then a gloo world of two
    ranks on the same total batch; its rows and artifact"""
    from torbi_tpu_torch.scripts import scaling

    artifact = scaling.main([
        '--gpu', 'cpu', '--ranks', '1,2', '--rows-per-device', '3',
        '--frames', '8', '--states', '40', '--iters', '1'])
    one, two = artifact['scales']
    assert one['ranks'] == 1 and one['work_overhead'] == 1.0
    assert two['ranks'] == 2 and two['batch'] == one['batch'] == 6
    assert two['backend'] == 'gloo' and two['rows'] == [3, 3]
    assert two['work_overhead'] == pytest.approx(
        two['seconds_per_call'] / one['seconds_per_call'])
    assert artifact['platform'] == 'cpu' and artifact['card'] is None


def test_scale_out_imports_pull_in_no_jax():
    """The scale-out modules and the worker load neither JAX nor the JAX
    package"""
    root = Path(__file__).resolve().parent.parent
    code = (
        'import sys; sys.path.insert(0, "tests"); '
        'import torbi_tpu_torch.parallel.sharded, '
        'torbi_tpu_torch.parallel.files, torbi_tpu_torch.evaluate.core, '
        'torbi_tpu_torch.scripts.scaling, torch_sharded_worker; '
        'bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")'
        ' or m == "torbi_tpu" or m.startswith("torbi_tpu.")]; '
        'print(bad); sys.exit(1 if bad else 0)')
    result = subprocess.run(
        [sys.executable, '-c', code], capture_output=True, text=True,
        timeout=120, cwd=root)
    assert result.returncode == 0, result.stdout + result.stderr
