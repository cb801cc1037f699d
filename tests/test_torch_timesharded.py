"""The exact time-sharded decode of torbi_tpu_torch against torbi_tpu.

``parallel.decode_time_sharded`` is held bitwise against the JAX function on
worlds of 1, 2 and 4 shards: the port's world 1 runs in this process (no
process group), worlds 2 and 4 as gloo process groups of one ``python`` a
rank (``tests/torch_timesharded_worker.py``, on a free local port); the
JAX side runs on meshes of as many of conftest's 8 CPU devices. The
dispatcher's ``backend='timesharded'`` route is held against the oracle
on inputs with a unique optimum, and its auto policy's predicate at a
faked shard count.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torbi_tpu_torch
from torbi_tpu.ops import oracle
from torbi_tpu.parallel import batch_mesh
from torbi_tpu.parallel import decode_time_sharded as jax_time_sharded
from torbi_tpu_torch.ops import dispatch
from torbi_tpu_torch.parallel import decode_time_sharded, mesh
from torbi_tpu_torch.scripts.modes_timing import run_ranks

TINY = np.finfo(np.float32).tiny
WORKER = Path(__file__).with_name('torch_timesharded_worker.py')
WORLDS = (1, 2, 4)
# Seconds a gloo world may take to decode every case
WORLD_TIMEOUT = 120


def _case(seed, frames, states, concentration=0.05):
    rng = np.random.default_rng(seed)
    obs = np.log(
        rng.dirichlet(np.ones(states) * concentration, size=frames)
        .astype(np.float32) + TINY)
    trans = np.log(
        rng.dirichlet(np.ones(states), size=states).astype(np.float32)
        + TINY)
    init = np.log(rng.dirichlet(np.ones(states)).astype(np.float32) + TINY)
    return obs, trans, init


def _ties():
    """Every score a sum of log(0.25) and log(0.5): ties everywhere. The
    time-sharded decode resolves them otherwise than the oracle's chase"""
    rng = np.random.default_rng(0)
    frames, states = 16, 4
    obs = np.log(rng.choice([0.25, 0.5], size=(frames, states))).astype(
        np.float32)
    trans = np.log(rng.choice([0.25, 0.5], size=(states, states))).astype(
        np.float32)
    init = np.full(states, np.log(0.25), np.float32)
    return obs, trans, init


def _banded():
    """A transition with -inf outside a band of offsets -1..1"""
    obs, trans, init = _case(5, 32, 5, concentration=0.2)
    rows, cols = np.indices(trans.shape)
    trans = np.where(np.abs(rows - cols) <= 1, trans, -np.inf).astype(
        np.float32)
    return obs, trans, init


# Straight to decode_time_sharded: frames divisible by 1, 2 and 4
DIRECT = {
    'random': _case(7, 48, 6),
    'dense48': _case(13, 64, 48, concentration=1.0),
    'ties': _ties(),
    'banded': _banded(),
}
# Through dispatch.decode(..., backend='timesharded'): (observation,
# transition, initial, valid frames); unique optima, so the oracle's path
DISPATCH = {
    'full': (*_case(7, 48, 6), 48),
    'padded': (*_case(8, 48, 5), 36),
    # 42 valid frames: 2 shards of a world of 2, 3 of a world of 4
    'leading-ranks': (*_case(9, 44, 5), 42),
}
# Frames that 2 and 4 shards do not divide
NOT_DIVISIBLE = {'odd': _case(3, 7, 4)}


def _inputs():
    arrays = {}
    for name, (obs, trans, init) in {**DIRECT, **NOT_DIVISIBLE}.items():
        arrays.update({f'{name}/observation': obs,
                       f'{name}/transition': trans,
                       f'{name}/initial': init})
    for name, (obs, trans, init, valid) in DISPATCH.items():
        arrays.update({f'{name}/observation': obs,
                       f'{name}/transition': trans,
                       f'{name}/initial': init,
                       f'{name}/valid': np.array([valid], np.int32)})
    return arrays


def _run_world(world, directory):
    """Every case decoded by a gloo world of ``world`` ranks: one dict of
    arrays a rank"""
    inputs = directory / 'inputs.npz'
    np.savez(inputs, **_inputs())
    run_ranks(
        lambda rank, port: [
            sys.executable, str(WORKER), str(rank), str(world), str(port),
            str(inputs), str(directory / f'rank{rank}.npz')],
        world, WORLD_TIMEOUT,
        env=dict(OMP_NUM_THREADS='1', GLOO_SOCKET_IFNAME='lo'))
    return [dict(np.load(directory / f'rank{rank}.npz'))
            for rank in range(world)]


def _run_in_process():
    """Every case decoded in this process: one shard, no process group"""
    results = {}
    for name, (obs, trans, init) in DIRECT.items():
        results[f'{name}/path'] = decode_time_sharded(
            torch.from_numpy(obs), torch.from_numpy(trans),
            torch.from_numpy(init)).numpy()
    for name, (obs, trans, init, valid) in DISPATCH.items():
        results[f'{name}/path'] = dispatch.decode(
            obs[None], np.array([valid], np.int32), trans, init,
            backend='timesharded', device='cpu')[0].numpy()
    return [results]


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]}"""
    results = {1: _run_in_process()}
    for world in WORLDS[1:]:
        results[world] = _run_world(
            world, tmp_path_factory.mktemp(f'world{world}'))
    return results


def _jax_path(obs, trans, init, shards):
    return np.asarray(jax_time_sharded(
        jnp.asarray(obs), jnp.asarray(trans), jnp.asarray(init),
        mesh=batch_mesh(devices=jax.devices()[:shards])))


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', sorted(DIRECT))
def test_decode_time_sharded_equals_jax(worlds, world, name):
    """Bitwise the JAX function on a mesh of as many devices, on every
    rank"""
    expected = _jax_path(*DIRECT[name], world)
    for rank, results in enumerate(worlds[world]):
        got = results[f'{name}/path']
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, expected, err_msg=f'rank {rank}')


@pytest.mark.parametrize('world', WORLDS)
def test_ties_follow_jax_not_the_oracle(worlds, world):
    """On the tie-heavy input the JAX function's path differs from the
    oracle's chase; the port gives the JAX function's"""
    obs, trans, init = DIRECT['ties']
    expected = _jax_path(obs, trans, init, world)
    chase = oracle.viterbi_numpy(
        obs[None], np.array([obs.shape[0]], np.int32), trans, init)[0]
    assert not np.array_equal(expected, chase)
    np.testing.assert_array_equal(worlds[world][0]['ties/path'], expected)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('name', sorted(DISPATCH))
def test_dispatch_timesharded_equals_oracle(worlds, world, name):
    """backend='timesharded' through the dispatcher: the oracle's path
    (unique optima), padded frames holding the last decoded state, on
    every rank; also bitwise the JAX function on the valid frames at the
    shard count the dispatcher picks"""
    obs, trans, init, valid = DISPATCH[name]
    bf = np.array([valid], np.int32)
    expected = oracle.viterbi_numpy(obs[None], bf, trans, init)[0]
    shards = dispatch.timesharded_shard_count(valid, world)
    direct = _jax_path(obs[:valid], trans, init, shards)
    for rank, results in enumerate(worlds[world]):
        got = results[f'{name}/path']
        np.testing.assert_array_equal(got, expected, err_msg=f'rank {rank}')
        np.testing.assert_array_equal(got[:valid], direct)
        assert (got[valid - 1:] == got[valid - 1]).all()


@pytest.mark.parametrize('world', WORLDS[1:])
def test_frames_not_divisible_raise_in_a_world(worlds, world):
    """Every rank of a world raises ValueError for frames its shard count
    does not divide (before any collective, so no rank waits)"""
    for results in worlds[world]:
        assert 'odd/value_error' in results


def test_frames_not_divisible_raise(monkeypatch):
    monkeypatch.setattr(mesh, 'shards', lambda group=None: (4, None))
    obs, trans, init = NOT_DIVISIBLE['odd']
    with pytest.raises(ValueError, match='multiple'):
        decode_time_sharded(
            torch.from_numpy(obs), torch.from_numpy(trans),
            torch.from_numpy(init))


def test_dispatch_timesharded_rejects_a_batch():
    obs, trans, init, _ = DISPATCH['full']
    with pytest.raises(ValueError, match='batch 1'):
        dispatch.decode(
            np.stack([obs, obs]), np.array([48, 48], np.int32), trans, init,
            backend='timesharded', device='cpu')


def test_shard_count_divides_the_frames():
    """The JAX dispatcher's _timesharded_mesh_size"""
    from torbi_tpu.ops.dispatch import _timesharded_mesh_size

    for frames in (1, 7, 36, 42, 48, 97):
        for shards in (1, 2, 3, 4, 8):
            assert dispatch.timesharded_shard_count(frames, shards) == (
                _timesharded_mesh_size(frames, shards))


def test_auto_policy_predicate(monkeypatch):
    """The auto policy opens only for the kernel backend, one sequence of
    TIME_SHARDED_MIN_FRAMES or more, and more shards than twice the
    states; on one shard (one card) it never opens"""
    monkeypatch.setattr(torbi_tpu_torch, 'TIME_SHARDED_MIN_FRAMES', 32)
    assert dispatch.timesharded_auto('kernel', 1, 64, 3, 8)
    assert not dispatch.timesharded_auto('kernel', 1, 64, 16, 8)
    assert not dispatch.timesharded_auto('kernel', 2, 64, 3, 8)
    assert not dispatch.timesharded_auto('kernel', 1, 31, 3, 8)
    assert not dispatch.timesharded_auto('scan', 1, 64, 3, 8)
    assert not any(dispatch.timesharded_auto('kernel', 1, 64, states, 1)
                   for states in (1, 2, 3))
    monkeypatch.setattr(torbi_tpu_torch, 'TIME_SHARDED_AUTO', False)
    assert not dispatch.timesharded_auto('kernel', 1, 64, 3, 8)


def test_auto_policy_routes_at_a_faked_shard_count(monkeypatch):
    """With the shard count faked to 8 the kernel backend sends a long
    3-state sequence to the time-sharded route (the JAX test's case), and
    with the real count (one shard) it does not"""
    monkeypatch.setattr(torbi_tpu_torch, 'TIME_SHARDED_MIN_FRAMES', 32)
    calls = []
    real = dispatch._decode_timesharded

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(dispatch, '_decode_timesharded', spy)
    obs, trans, init = _case(9, 64, 3)
    bf = np.array([64], np.int32)
    expected = oracle.viterbi_numpy(obs[None], bf, trans, init)[0]
    got = dispatch.decode(obs[None], bf, trans, init, device='cpu')
    assert not calls
    np.testing.assert_array_equal(got[0].numpy(), expected)
    monkeypatch.setattr(dispatch, '_shard_count', lambda: 8)
    got = dispatch.decode(obs[None], bf, trans, init, device='cpu')
    assert calls
    np.testing.assert_array_equal(got[0].numpy(), expected)


def test_from_probabilities_timesharded():
    """from_probabilities and decode pass backend='timesharded' through:
    probabilities in, the epsilon step, the oracle's path"""
    obs, trans, init, _ = DISPATCH['full']
    probs = np.exp(obs)
    expected = torbi_tpu_torch.from_probabilities(
        probs[None], transition=np.exp(trans), initial=np.exp(init),
        gpu='cpu')
    got = torbi_tpu_torch.from_probabilities(
        probs[None], transition=np.exp(trans), initial=np.exp(init),
        gpu='cpu', backend='timesharded')
    assert torch.equal(got, expected)
    got = torbi_tpu_torch.decode(
        obs, np.array([48], np.int32), trans, init, gpu='cpu',
        backend='timesharded')
    np.testing.assert_array_equal(
        got[0].numpy(),
        oracle.viterbi_numpy(obs[None], np.array([48]), trans, init)[0])


def test_initialize_distributed_is_a_no_op_without_a_world(monkeypatch):
    """A single process (RANK and WORLD_SIZE unset) stays without a process
    group, so there is one shard"""
    from torbi_tpu_torch.parallel import initialize_distributed

    monkeypatch.delenv('RANK', raising=False)
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    initialize_distributed()
    initialize_distributed()
    assert not torch.distributed.is_initialized()
    assert mesh.shards() == (1, None)
    assert mesh.leading_group(1) is None


def test_modes_import_pulls_in_no_jax():
    """The new modules load neither JAX nor the JAX package"""
    code = (
        'import sys, torbi_tpu_torch.parallel, '
        'torbi_tpu_torch.parallel.mesh, '
        'torbi_tpu_torch.parallel.timesharded, torbi_tpu_torch.ops.lse, '
        'torbi_tpu_torch.ops.associative, '
        'torbi_tpu_torch.scripts.lse_accuracy; '
        'bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")'
        ' or m == "torbi_tpu" or m.startswith("torbi_tpu.")]; '
        'print(bad); sys.exit(1 if bad else 0)')
    result = subprocess.run(
        [sys.executable, '-c', code], capture_output=True, text=True,
        timeout=120, cwd=Path(__file__).resolve().parent.parent)
    assert result.returncode == 0, result.stdout + result.stderr
