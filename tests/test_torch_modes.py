"""The port's extra decode modes against torbi_tpu, on the CPU.

- ``ops/associative.py``: the plain (max, +) product against the JAX
  ``_maxplus_matmul``, the mirrored combine tree against
  ``lax.associative_scan``, and the scan's posteriors and decode against
  the JAX functions, all bitwise (each candidate is one fp32 add and the
  fp32 maximum does not depend on order, so the same tree gives the same
  bits).
- ``ops/lse.py``: the smoothed-max posteriors within a stated tolerance of
  the JAX function's, and equal paths on the JAX tests' peaked cases;
  ``backend='lse'`` through the dispatcher, ``from_probabilities``, the
  file API and the evaluation harness against the direct call.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import torbi_tpu_torch
from torbi_tpu.ops import associative as jax_associative
from torbi_tpu.ops import lse as jax_lse
from torbi_tpu.ops import oracle
from torbi_tpu_torch.ops import associative, dispatch, lse
from torbi_tpu_torch.utils import io

TINY = np.finfo(np.float32).tiny
# The smoothed-max posteriors of the two packages: XLA's CPU exp and log
# are its own approximations (a few ulps from PyTorch's), and its dot adds
# in another order than the CPU BLAS; each step's difference of about 1e-6
# relative carries into the next
LSE_RTOL = 1e-5
LSE_ATOL = 1e-3
# Except where a frame's product v[j] falls below 2^-100: its terms reach
# the subnormal range, which XLA's CPU flushes to zero and PyTorch keeps
# (ROADMAP.md's subnormal-exp difference). The clamp at tiny = 2^-126 then
# bounds the score from below on both sides, so it moves by at most
# log(2^-100 / 2^-126) / beta; such a state lies 69/beta nats or more
# below the frame's best and off the decoded path
LSE_FLUSH_BELOW = 2.0 ** -100


def _case(rng, frames, states, concentration=0.1):
    """tests/test_modes.py's inputs"""
    obs = np.log(
        rng.dirichlet(np.ones(states) * concentration, size=frames)
        .astype(np.float32) + TINY)
    trans = np.log(
        rng.dirichlet(np.ones(states), size=states).astype(np.float32)
        + TINY)
    init = np.log(rng.dirichlet(np.ones(states)).astype(np.float32) + TINY)
    return obs, trans, init


def _operands(states, layout, seed=0):
    """(a, b) of a product at ``states``: 'batched' (3, S, S) by (3, S, S),
    'broadcast' (3, S, S) by (S, S), 'neg_inf' with -inf rows of a and
    -inf columns of b (and the time-sharded code's identity), 'nan' with
    +inf entries of a meeting -inf of b"""
    rng = np.random.default_rng(seed + states)
    a = rng.standard_normal((3, states, states)).astype(np.float32) * 10
    b = rng.standard_normal((3, states, states)).astype(np.float32) * 10
    if layout == 'broadcast':
        b = b[0]
    elif layout == 'neg_inf':
        a[0, 0, :] = -np.inf
        a[1, :, states // 2] = -np.inf
        b[0, :, 0] = -np.inf
        b[2] = np.where(np.eye(states, dtype=bool), 0.0, -np.inf)
    elif layout == 'nan':
        a[0, :, 0] = np.inf
        b[0, 0, :] = -np.inf
        a[1, 0, 0] = np.nan
    return a, b


@pytest.mark.parametrize('layout', ['batched', 'broadcast', 'neg_inf', 'nan'])
@pytest.mark.parametrize('states', [1, 5, 33, 64, 65])
def test_maxplus_reference_equals_jax(states, layout):
    a, b = _operands(states, layout)
    expected = np.asarray(
        jax_associative._maxplus_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = associative.maxplus_matmul_reference(
        torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, expected)
    # The wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(associative.maxplus_matmul(
        torch.from_numpy(a), torch.from_numpy(b)).numpy(), expected)


def test_maxplus_reference_rectangular():
    """(M, K) by (K, N) with leading dimensions that broadcast both ways"""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 1, 7, 11)).astype(np.float32)
    b = rng.standard_normal((3, 11, 5)).astype(np.float32)
    expected = np.asarray(
        jax_associative._maxplus_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = associative.maxplus_matmul_reference(
        torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (2, 3, 7, 5)
    np.testing.assert_array_equal(got, expected)


def test_maxplus_strided_views():
    """The scan's operands are strided views (every other matrix, a
    broadcast one); the wrapper takes them as they are"""
    rng = np.random.default_rng(5)
    elems = torch.from_numpy(
        rng.standard_normal((9, 6, 6)).astype(np.float32))
    got = associative.maxplus_matmul(elems[0:-1:2], elems[1::2])
    expected = associative.maxplus_matmul_reference(
        elems[0:-1:2].contiguous(), elems[1::2].contiguous())
    assert torch.equal(got, expected)
    got = associative.maxplus_matmul(elems, elems[4][None])
    expected = associative.maxplus_matmul_reference(
        elems, elems[4][None].expand(9, 6, 6).contiguous())
    assert torch.equal(got, expected)


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('length', [1, 2, 7, 16, 17])
def test_associative_scan_equals_jax(length, reverse):
    """The mirrored tree gives lax.associative_scan's bits, with the
    prefix scan's operand order (the later element on the left)"""
    rng = np.random.default_rng(length)
    elems = rng.standard_normal((length, 5, 5)).astype(np.float32) * 4
    expected = np.asarray(lax.associative_scan(
        lambda a, b: jax_associative._maxplus_matmul(b, a),
        jnp.asarray(elems), reverse=reverse))
    got = associative.associative_scan(
        lambda a, b: associative.maxplus_matmul(b, a),
        torch.from_numpy(elems), reverse=reverse).numpy()
    np.testing.assert_array_equal(got, expected)


def test_associative_scan_is_not_a_sequential_scan():
    """The tree matters: a left-to-right scan rounds otherwise on some
    input, so only the mirrored tree can be bitwise"""
    rng = np.random.default_rng(0)
    elems = torch.from_numpy(
        rng.standard_normal((17, 6, 6)).astype(np.float32) * 1000)
    tree = associative.associative_scan(
        lambda a, b: associative.maxplus_matmul(b, a), elems)
    sequential = [elems[0]]
    for step in elems[1:]:
        sequential.append(associative.maxplus_matmul(step, sequential[-1]))
    assert not torch.equal(tree, torch.stack(sequential))
    torch.testing.assert_close(tree, torch.stack(sequential))


SCAN_CASES = [(1, 4, 0), (17, 9, 1), (25, 12, 2), (64, 3, 3)]


@pytest.mark.parametrize('frames,states,seed', SCAN_CASES)
def test_viterbi_posteriors_scan_equals_jax(frames, states, seed):
    obs, trans, init = _case(np.random.default_rng(seed), frames, states)
    expected = np.asarray(jax_associative.viterbi_posteriors_scan(
        jnp.asarray(obs), jnp.asarray(trans), jnp.asarray(init)))
    got = associative.viterbi_posteriors_scan(
        torch.from_numpy(obs), torch.from_numpy(trans),
        torch.from_numpy(init)).numpy()
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize('frames,states,seed', SCAN_CASES)
def test_viterbi_decode_scan_equals_jax(frames, states, seed):
    obs, trans, init = _case(np.random.default_rng(seed), frames, states)
    expected = np.asarray(jax_associative.viterbi_decode_scan(
        jnp.asarray(obs), jnp.asarray(trans), jnp.asarray(init)))
    got = associative.viterbi_decode_scan(
        torch.from_numpy(obs), torch.from_numpy(trans),
        torch.from_numpy(init))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expected)
    if frames > 1:
        np.testing.assert_array_equal(got.numpy(), oracle.viterbi_numpy(
            obs[None], np.array([frames]), trans, init)[0])


def _peaked(beta):
    """tests/test_modes.py::test_lse_decode_matches_exact_on_peaked_inputs"""
    obs, trans, init = _case(np.random.default_rng(2), 40, 24, 0.05)
    return obs[None], np.array([40], np.int32), trans, init, beta


def _padded():
    """tests/test_modes.py::test_lse_decode_padded_batch"""
    rng = np.random.default_rng(3)
    obs, trans, init = _case(rng, 30, 16, concentration=0.05)
    obs2, _, _ = _case(rng, 30, 16, concentration=0.05)
    return (np.stack([obs, obs2]), np.array([30, 11], np.int32), trans, init,
            8.0)


LSE_CASES = {'peaked8': _peaked(8.0), 'peaked32': _peaked(32.0),
             'padded': _padded()}


def _jax_lse(obs, bf, trans, init, beta):
    """(paths, posteriors) of the JAX decode_lse: its path as jitted, its
    posteriors captured from its forward scan, run without jit"""
    args = (jnp.asarray(obs), jnp.asarray(bf), jnp.asarray(trans),
            jnp.asarray(init))
    paths = np.asarray(jax_lse.decode_lse(*args, beta=beta))
    captured = []

    def scan(*scan_args, **kwargs):
        out = lax.scan(*scan_args, **kwargs)
        captured.append(out)
        return out

    real = jax_lse.lax
    jax_lse.lax = types.SimpleNamespace(scan=scan)
    try:
        with jax.disable_jit():
            eager = np.asarray(jax_lse.decode_lse(*args, beta=beta))
    finally:
        jax_lse.lax = real
    np.testing.assert_array_equal(eager, paths)
    post0 = np.asarray(args[0][:, 0, :] + args[3][None, :])
    rest = np.swapaxes(np.asarray(captured[0][1]), 0, 1)
    return paths, np.concatenate([post0[:, None], rest], axis=1)


def _tensors(*arrays):
    return [torch.from_numpy(np.asarray(array)) for array in arrays]


def _products(posts, trans, beta):
    """Each frame's smoothed-max product v (frames 1.., in float64) from
    the previous frame's posteriors; frame 0 holds 1"""
    posts = posts.astype(np.float64)
    trans = trans.astype(np.float64)
    prev = posts[:, :-1]
    u = np.exp(beta * (prev - prev.max(axis=-1, keepdims=True)))
    rowmax = trans.max(axis=1)
    rowmax = np.where(np.isfinite(rowmax), rowmax, 0.0)
    v = u @ np.exp(beta * (trans - rowmax[:, None])).T
    return np.concatenate([np.ones_like(posts[:, :1]), v], axis=1)


@pytest.mark.parametrize('name', sorted(LSE_CASES))
def test_lse_posteriors_within_tolerance_of_jax(name):
    obs, bf, trans, init, beta = LSE_CASES[name]
    _, expected = _jax_lse(obs, bf, trans, init, beta)
    posts, posterior = lse.forward_lse(
        *_tensors(obs, bf, trans, init), beta=beta)
    posts = posts.numpy()
    flushed = _products(posts, trans, beta) < LSE_FLUSH_BELOW
    np.testing.assert_allclose(
        posts[~flushed], expected[~flushed], rtol=LSE_RTOL, atol=LSE_ATOL)
    assert (np.abs(posts[flushed] - expected[flushed])
            <= 26 * np.log(2) / beta + LSE_ATOL).all()
    posts = torch.from_numpy(posts)
    assert torch.equal(posterior, posts[torch.arange(len(bf)),
                                         torch.from_numpy(bf).long() - 1])


@pytest.mark.parametrize('name', sorted(LSE_CASES))
def test_lse_paths_equal_jax(name):
    obs, bf, trans, init, beta = LSE_CASES[name]
    expected, _ = _jax_lse(obs, bf, trans, init, beta)
    got = lse.decode_lse(*_tensors(obs, bf, trans, init), beta=beta)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize('beta', [8.0, 32.0])
def test_lse_agrees_with_exact_on_peaked_inputs(beta):
    """As the JAX test holds its own: 95% of the oracle's path or more"""
    obs, bf, trans, init, _ = _peaked(beta)
    expected = oracle.viterbi_numpy(obs, bf, trans, init)[0]
    got = lse.decode_lse(*_tensors(obs, bf, trans, init), beta=beta)
    assert float(np.mean(got[0].numpy() == expected)) >= 0.95


def test_lse_chase_is_the_backtrace_on_its_posteriors():
    """The chase is backtrace_reference (K3's plain version) on the stored
    posteriors, the seed the final posterior's lowest-index argmax; padded
    frames hold the seed"""
    obs, bf, trans, init, beta = LSE_CASES['padded']
    args = _tensors(obs, bf, trans, init)
    posts, posterior = lse.forward_lse(*args, beta=beta)
    from torbi_tpu_torch.ops.backtrace import backtrace_reference

    got = lse.decode_lse(*args, beta=beta)
    assert torch.equal(got, backtrace_reference(
        posts, args[2], posterior, args[1]))
    assert (got[1, 10:] == got[1, 10]).all()


def test_lse_single_frame_is_the_seed():
    obs, _, trans, init, _ = _peaked(8.0)
    args = _tensors(obs[:, :1], np.array([1], np.int32), trans, init)
    got = lse.decode_lse(*args)
    expected = np.asarray(jax_lse.decode_lse(
        *(jnp.asarray(x.numpy()) for x in args)))
    assert got.shape == (1, 1)
    np.testing.assert_array_equal(got.numpy(), expected)
    assert int(got[0, 0]) == int((args[0][0, 0] + args[3]).argmax())


def test_lse_pins_full_float32_matmuls():
    """A caller's lower float32 matmul precision changes nothing, and is
    the caller's again afterwards"""
    args = _tensors(*LSE_CASES['peaked8'][:4])
    expected = lse.forward_lse(*args)[0]
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision('medium')
        assert torch.equal(lse.forward_lse(*args)[0], expected)
        assert torch.get_float32_matmul_precision() == 'medium'
    finally:
        torch.set_float32_matmul_precision(saved)


def test_lse_unreachable_destination_stays_finite():
    """An all -inf transition row normalizes by 0 (no NaN), as in JAX"""
    obs, bf, trans, init, beta = LSE_CASES['peaked8']
    trans = trans.copy()
    trans[3, :] = -np.inf
    expected, _ = _jax_lse(obs, bf, trans, init, beta)
    got = lse.decode_lse(*_tensors(obs, bf, trans, init), beta=beta)
    np.testing.assert_array_equal(got.numpy(), expected)
    assert not (got.numpy() == 3).any()


def _dispatch_case():
    """64 x 21 x 16 with one short sequence (the JAX dispatch test's)"""
    rng = np.random.default_rng(6)
    obs = np.stack([_case(rng, 21, 16, concentration=0.05)[0]
                    for _ in range(64)])
    _, trans, init = _case(rng, 21, 16, concentration=0.05)
    bf = np.full(64, 21, dtype=np.int32)
    bf[5] = 9
    return obs, bf, trans, init


def test_lse_backend_through_dispatch_equals_direct(monkeypatch):
    """backend='lse' through the dispatcher (whole, split by the memory
    guard, and with the states pre-padded to 128) returns exactly the
    direct call at LSE_BETA"""
    obs, bf, trans, init = _dispatch_case()
    direct = lse.decode_lse(
        *_tensors(obs, bf, trans, init), beta=torbi_tpu_torch.LSE_BETA)
    got = dispatch.decode(obs, bf, trans, init, backend='lse', device='cpu')
    assert torch.equal(got, direct)
    padded = np.pad(obs, ((0, 0), (0, 0), (0, 112)),
                    constant_values=-np.inf)
    assert torch.equal(dispatch.decode(
        padded, bf, trans, init, backend='lse', device='cpu'), direct)
    # A budget of 10 rows per group: the guard splits the batch
    monkeypatch.setattr(torbi_tpu_torch, 'DECODE_MEMORY_BUDGET',
                        10 * 21 * (16 + 16) * 4)
    assert torch.equal(dispatch.decode(
        obs, bf, trans, init, backend='lse', device='cpu'), direct)
    monkeypatch.setattr(torbi_tpu_torch, 'LSE_BETA', 32.0)
    assert torch.equal(
        dispatch.decode(obs, bf, trans, init, backend='lse', device='cpu'),
        lse.decode_lse(*_tensors(obs, bf, trans, init), beta=32.0))


def test_lse_backend_equals_jax_dispatch():
    """The JAX dispatcher's backend='lse' and the port's give one path"""
    from torbi_tpu.ops.dispatch import decode as jax_decode

    obs, bf, trans, init = _dispatch_case()
    expected = np.asarray(jax_decode(
        jnp.asarray(obs), jnp.asarray(bf), jnp.asarray(trans),
        jnp.asarray(init), backend='lse'))
    got = dispatch.decode(obs, bf, trans, init, backend='lse', device='cpu')
    np.testing.assert_array_equal(got.numpy(), expected)


def test_from_probabilities_lse_equals_direct():
    """from_probabilities and decode pass backend='lse' through: the
    conversion (log, the epsilon step) first, then the direct call"""
    obs, bf, trans, init = _dispatch_case()
    probs = np.exp(obs)
    converted = dispatch.convert(torch.from_numpy(probs), False, True)
    direct = lse.decode_lse(
        converted, torch.from_numpy(bf),
        torch.log(torch.from_numpy(np.exp(trans))),
        torch.log(torch.from_numpy(np.exp(init))),
        beta=torbi_tpu_torch.LSE_BETA)
    got = torbi_tpu_torch.from_probabilities(
        probs, batch_frames=bf, transition=np.exp(trans),
        initial=np.exp(init), gpu='cpu', backend='lse')
    assert torch.equal(got, direct)
    got = torbi_tpu_torch.decode(
        obs, bf, trans, init, gpu='cpu', backend='lse')
    assert torch.equal(got, lse.decode_lse(
        *_tensors(obs, bf, trans, init), beta=torbi_tpu_torch.LSE_BETA))


def test_files_lse_equal_from_probabilities(tmp_path):
    """from_files_to_files(backend='lse') writes what from_probabilities
    (backend='lse') returns for each file alone"""
    rng = np.random.default_rng(10)
    _, trans, _ = _case(rng, 1, 12)
    inputs, outputs, arrays = [], [], []
    for i, frames in enumerate((17, 30, 9)):
        obs = _case(rng, frames, 12, concentration=0.05)[0]
        arrays.append(obs)
        inputs.append(tmp_path / f'in{i}.npy')
        outputs.append(tmp_path / f'out{i}.npy')
        np.save(inputs[-1], obs)
    # Transition files hold probabilities
    np.save(tmp_path / 'transition.npy', np.exp(trans))
    torbi_tpu_torch.from_files_to_files(
        inputs, outputs, transition_file=tmp_path / 'transition.npy',
        log_probs=True, gpu='cpu', backend='lse')
    for obs, output in zip(arrays, outputs):
        expected = torbi_tpu_torch.from_probabilities(
            obs[None], transition=np.log(np.exp(trans) + TINY),
            log_probs=True, gpu='cpu', backend='lse')[0]
        np.testing.assert_array_equal(io.load(output), expected.numpy())


def test_evaluation_with_lse_backend(tmp_path, monkeypatch):
    """EVAL_BACKEND='lse': the harness decodes through the smoothed-max
    route; every output file is that route's path and the scores are
    fractions of the frames"""
    from test_torch_evaluate import DATASET, corpus, point

    stems = corpus(tmp_path, (40, 57))
    point(monkeypatch, torbi_tpu_torch, tmp_path, tmp_path / 'port')
    monkeypatch.setattr(torbi_tpu_torch, 'EVAL_BACKEND', 'lse')
    result = torbi_tpu_torch.evaluate.datasets([DATASET], gpu='cpu')[DATASET]
    assert result['frames'] == 97
    assert all(0.0 <= result['rpa'][k] <= 1.0 for k in ('0', '1', '2'))
    transition = np.log(
        io.load(torbi_tpu_torch.PITCH_TRANSITION_MATRIX) + TINY)
    for stem in stems:
        obs = io.load(tmp_path / 'cache' / DATASET / f'{stem}.pt')
        expected = torbi_tpu_torch.from_probabilities(
            obs[None], transition=transition, log_probs=True, gpu='cpu',
            backend='lse')[0]
        got = io.load(tmp_path / 'port' / 'eval' / DATASET
                      / torbi_tpu_torch.CONFIG / f'{stem}.pt')
        np.testing.assert_array_equal(got, expected.numpy())


def test_lse_accuracy_script_equals_jax(monkeypatch, capsys):
    """The accuracy script on the CPU at a small size prints the JAX
    script's rows (the same inputs, equal paths)"""
    import importlib.util
    import json
    import sys
    from pathlib import Path

    from torbi_tpu_torch.scripts import lse_accuracy

    args = ['--batch', '2', '--frames', '24', '--states', '48',
            '--betas', '2,8,64']
    rows = lse_accuracy.main(args + ['--gpu', 'cpu'])
    assert [row['beta'] for row in rows] == [2.0, 8.0, 64.0]
    for row in rows:
        assert 0.0 <= row['rpa0'] <= row['rpa1'] <= row['rpa2'] <= 1.0
    capsys.readouterr()
    spec = importlib.util.spec_from_file_location(
        'jax_lse_accuracy',
        Path(__file__).resolve().parent.parent / 'scripts' / 'lse_accuracy.py')
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, 'argv', ['lse_accuracy.py', *args])
    script.main()
    expected = [json.loads(line)
                for line in capsys.readouterr().out.splitlines()]
    assert rows == expected
