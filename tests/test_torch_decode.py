"""The port's decode path as a whole against torbi_tpu and the oracle.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU (``gpu='cpu'``/``device='cpu'``), where its kernel
routes run the kernels' plain versions. Decoded paths are compared
bitwise. The probability->log step is the one place where the two
packages round differently (``torch.log`` and ``jnp.log`` differ by one
ulp on some inputs): converted values are held to within 1 ulp, and paths
from probability-space inputs are compared on inputs with clear margins.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torbi_tpu
import torbi_tpu_torch
from torbi_tpu.ops import oracle
from torbi_tpu.ops.dispatch import decode as jax_decode
from torbi_tpu_torch.models import pitch
from torbi_tpu_torch.ops import band, dense, dispatch
from torbi_tpu_torch.utils import cache

TINY = np.finfo(np.float32).tiny


def random_case(rng, batch, frames, states, padded=False):
    def log_dirichlet(shape):
        return np.log(
            rng.dirichlet(np.ones(states), size=shape).astype(np.float32)
            + TINY).astype(np.float32)

    observation = log_dirichlet((batch, frames))
    transition = log_dirichlet(states)
    initial = log_dirichlet(())
    if padded:
        batch_frames = rng.integers(1, frames + 1, size=batch).astype(np.int32)
        batch_frames[0] = frames
    else:
        batch_frames = np.full(batch, frames, dtype=np.int32)
    return observation, batch_frames, transition, initial


def synthetic_posteriorgrams(batch, frames, states, seed=0):
    """Peaked synthetic pitch posteriorgrams in log space (bench.py's)"""
    rng = np.random.default_rng(seed)
    centers = np.clip(
        np.cumsum(rng.integers(-3, 4, size=(batch, frames)), axis=1)
        + states // 2, 0, states - 1)
    bins = np.arange(states, dtype=np.float32)[None, None, :]
    dist = np.abs(bins - centers[:, :, None].astype(np.float32))
    logits = -0.5 * (dist / 3.0) ** 2
    obs = logits - np.log(np.exp(logits).sum(axis=-1, keepdims=True))
    return np.log(np.exp(obs) + TINY).astype(np.float32)


def toy():
    observation = np.array([[
        [0.25, 0.5, 0.25],
        [0.25, 0.25, 0.5],
        [0.33, 0.33, 0.33]]], dtype=np.float32)
    transition = np.array([
        [0.5, 0.25, 0.25],
        [0.33, 0.34, 0.33],
        [0.25, 0.25, 0.5]], dtype=np.float32)
    initial = np.array([0.4, 0.35, 0.25], dtype=np.float32)
    return observation, transition, initial


def port_decode(obs, bf, trans, init, backend=None):
    out = dispatch.decode(
        torch.from_numpy(obs), torch.from_numpy(bf), torch.from_numpy(trans),
        torch.from_numpy(init), backend=backend, device='cpu')
    assert out.dtype == torch.int32 and out.device.type == 'cpu'
    return out.numpy()


def reference_decode(obs, bf, trans, init):
    return np.asarray(jax_decode(
        jnp.asarray(obs), jnp.asarray(bf), jnp.asarray(trans),
        jnp.asarray(init), backend='xla'))


CASES = [
    (1, 3, 3, False),
    (2, 16, 8, False),
    (4, 33, 17, True),
    (3, 50, 64, True),
    (8, 20, 130, True),
    (2, 230, 16, True),
]


@pytest.mark.parametrize('backend', ['kernel', 'scan'])
@pytest.mark.parametrize('batch,frames,states,padded', CASES)
def test_decode_matches_jax_and_oracle(batch, frames, states, padded,
                                       backend):
    """Random dense cases of tests/test_parity.py: bitwise equal to
    torbi_tpu's decode(backend='xla') and the numpy oracle"""
    rng = np.random.default_rng(42 + batch + frames + states)
    case = random_case(rng, batch, frames, states, padded)
    expected = oracle.viterbi_numpy(*case)
    np.testing.assert_array_equal(reference_decode(*case), expected)
    np.testing.assert_array_equal(port_decode(*case, backend), expected)


@pytest.mark.parametrize('backend', ['kernel', 'scan'])
def test_constant_transition_matches(backend):
    """The uniform transition takes the closed-form route and decodes
    bitwise as torbi_tpu and the oracle do, padded frames included"""
    rng = np.random.default_rng(8)
    obs, bf, _, init = random_case(rng, 5, 21, 12, padded=True)
    trans = np.full((12, 12), np.log(1. / 12), dtype=np.float32)
    assert band.detect_band(torch.from_numpy(trans))[1] == 0
    expected = oracle.viterbi_numpy(obs, bf, trans, init)
    np.testing.assert_array_equal(
        reference_decode(obs, bf, trans, init), expected)
    np.testing.assert_array_equal(
        port_decode(obs, bf, trans, init, backend), expected)


def test_pitch_case_matches():
    """The 1440-state pitch transition at batch 2 x 64: banded route with
    its floor, bitwise equal to torbi_tpu's decode"""
    obs = synthetic_posteriorgrams(2, 64, 1440, seed=4)
    trans = np.log(pitch.transition_matrix() + TINY).astype(np.float32)
    init = np.log(np.full(1440, 1 / 1440, dtype=np.float32) + TINY)
    bf = np.array([64, 41], dtype=np.int32)
    assert band.detect_band(torch.from_numpy(trans))[1] == 175
    expected = reference_decode(obs, bf, trans, init)
    np.testing.assert_array_equal(port_decode(obs, bf, trans, init), expected)


def test_prepadded_observation():
    """Observations pre-padded to the next 128 multiple with -inf decode as
    the unpadded ones"""
    rng = np.random.default_rng(12)
    obs, bf, trans, init = random_case(rng, 3, 10, 100, padded=True)
    padded = np.full((3, 10, 128), -np.inf, dtype=np.float32)
    padded[..., :100] = obs
    np.testing.assert_array_equal(
        port_decode(padded, bf, trans, init),
        oracle.viterbi_numpy(obs, bf, trans, init))


@pytest.mark.parametrize('route', ['band', 'dense', 'constant',
                                   'band_nonfinite'])
def test_routes(route, monkeypatch):
    """Dispatch picks the route the JAX dispatcher picks: banded, dense,
    closed form; a non-finite observation drops the band to the dense
    route"""
    calls = []
    monkeypatch.setattr(
        band, 'band_forward_reference',
        _spy(band.band_forward_reference, calls, 'band'))
    monkeypatch.setattr(
        dense, 'dense_forward_reference',
        _spy(dense.dense_forward_reference, calls, 'dense'))
    rng = np.random.default_rng(21)
    obs, bf, trans, init = random_case(rng, 2, 12, 64, padded=True)
    if route in ('band', 'band_nonfinite'):
        xx, yy = np.meshgrid(np.arange(64), np.arange(64), indexing='ij')
        probs = np.clip(5.0 - np.abs(xx - yy), 0, None)
        trans = np.log(
            probs / probs.sum(axis=1, keepdims=True) + TINY).astype(
                np.float32)
    if route == 'band_nonfinite':
        obs[1, 4, 7] = -np.inf
    if route == 'constant':
        trans = np.zeros((64, 64), dtype=np.float32)
    got = port_decode(obs, bf, trans, init)
    np.testing.assert_array_equal(
        got, oracle.viterbi_numpy(obs, bf, trans, init))
    expected_calls = {
        'band': ['band'], 'dense': ['dense'], 'constant': [],
        'band_nonfinite': ['dense']}[route]
    assert calls == expected_calls


def _spy(fn, calls, name):
    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)
    return spy


def test_from_probabilities_toy():
    """The README toy decodes to [[1, 2, 2]] through the public entry
    point, as in torbi_tpu"""
    observation, transition, initial = toy()
    got = torbi_tpu_torch.from_probabilities(
        observation, transition=transition, initial=initial, gpu='cpu')
    assert got.dtype == torch.int32 and got.device.type == 'cpu'
    assert got.tolist() == [[1, 2, 2]]
    expected = np.asarray(torbi_tpu.from_probabilities(
        observation, transition=transition, initial=initial))
    np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize('kind', ['dense', 'pitch', 'uniform'])
def test_from_probabilities_log_space_matches(kind):
    """log_probs=True inputs: bitwise equal to torbi_tpu.from_probabilities
    (its epsilon step log(exp(x) + tiny) rounds as the port's)"""
    rng = np.random.default_rng(30)
    if kind == 'pitch':
        obs = synthetic_posteriorgrams(2, 32, 1440, seed=5)
        trans = np.log(pitch.transition_matrix() + TINY).astype(np.float32)
        init = None
    else:
        obs, _, trans, init = random_case(rng, 3, 17, 20)
        if kind == 'uniform':
            trans = init = None
    bf = np.array([obs.shape[1]] * (obs.shape[0] - 1) + [5], dtype=np.int32)
    got = torbi_tpu_torch.from_probabilities(
        obs, batch_frames=bf, transition=trans, initial=init,
        log_probs=True, gpu='cpu')
    expected = np.asarray(torbi_tpu.from_probabilities(
        obs, batch_frames=bf, transition=trans, initial=init,
        log_probs=True))
    np.testing.assert_array_equal(got.numpy(), expected)


def test_from_probabilities_probability_space_matches():
    """log_probs=False on peaked pitch posteriorgrams (clear margins):
    the same path as torbi_tpu"""
    obs = np.exp(synthetic_posteriorgrams(2, 32, 1440, seed=6))
    trans = pitch.transition_matrix()
    got = torbi_tpu_torch.from_probabilities(
        obs, transition=trans, gpu='cpu')
    expected = np.asarray(
        torbi_tpu.from_probabilities(obs, transition=trans))
    np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize('log_input', [False, True])
def test_convert_within_one_ulp(log_input):
    """The probability->log and epsilon steps within 1 ulp of torbi_tpu's
    (bitwise for log-space input)"""
    rng = np.random.default_rng(40)
    probs = rng.dirichlet(np.ones(64), size=512).astype(np.float32)
    if log_input:
        x = np.log(probs + TINY).astype(np.float32)
    else:
        probs[0, :4] = 0.0
        x = probs
    got = dispatch.convert(torch.from_numpy(x), log_input, True).numpy()
    expected = jnp.asarray(x)
    if not log_input:
        expected = jnp.log(expected)
    expected = np.asarray(jnp.log(jnp.exp(expected) + np.float32(TINY)))
    assert np.isfinite(got).all()
    np.testing.assert_array_max_ulp(got, expected, maxulp=1)
    if log_input:
        np.testing.assert_array_equal(got, expected)


def test_epsilon_keeps_subnormal_exp():
    """On an entry that already holds log(tiny), exp gives a subnormal; the
    port keeps it, as numpy and the PyTorch reference do, so the epsilon
    step gives log(exp(x) + tiny) ~ -86.64. (XLA's CPU runtime flushes the
    subnormal to zero and gives log(tiny) ~ -87.34 there: a known
    difference from torbi_tpu, listed in ROADMAP.md.)"""
    x = np.full(4, np.log(np.float32(TINY)), dtype=np.float32)
    got = dispatch.convert(torch.from_numpy(x), True, True).numpy()
    with np.errstate(under='ignore'):
        expected = np.log(np.exp(x) + np.float32(TINY))
    np.testing.assert_array_equal(got, expected)
    assert (got > -86.7).all()


def test_memory_guard_splits(monkeypatch):
    """A budget of 1 byte splits the batch into one-row groups, and the
    result is still bitwise the unsplit decode"""
    rng = np.random.default_rng(63)
    obs, bf, trans, init = random_case(rng, 12, 10, 9, padded=True)
    expected = oracle.viterbi_numpy(obs, bf, trans, init)
    calls = []
    monkeypatch.setattr(
        dispatch, 'decode', _spy(dispatch.decode, calls, 'decode'))
    monkeypatch.setattr(torbi_tpu_torch, 'DECODE_MEMORY_BUDGET', 1)
    got = dispatch.decode(obs, bf, trans, init, device='cpu')
    np.testing.assert_array_equal(got.numpy(), expected)
    assert len(calls) == 1 + 12


def test_cache_invalidated_by_inplace_edit():
    """The identity cache misses after an in-place edit of the tensor, and
    band detection then sees the new content"""
    computed = []
    store = {}
    tensor = torch.zeros(4)

    def compute():
        computed.append(1)
        return float(tensor.sum())

    assert cache.identity_cached(store, tensor, compute) == 0.0
    assert cache.identity_cached(store, tensor, compute) == 0.0
    assert len(computed) == 1
    tensor.add_(1.0)
    assert cache.identity_cached(store, tensor, compute) == 4.0
    assert len(computed) == 2

    trans = torch.full((16, 16), -5.0)
    assert band.detect_band(trans) == (0, 0, -5.0)
    trans.fill_diagonal_(-1.0)
    assert band.detect_band(trans) == (0, 1, -5.0)


def test_import_pulls_in_no_jax():
    """Importing the port, its profiler and its labs loads neither JAX nor
    the JAX package"""
    code = (
        'import sys, torbi_tpu_torch, torbi_tpu_torch.utils.profile, '
        'torbi_tpu_torch.scripts.kernel_lab, '
        'torbi_tpu_torch.scripts.chase_lab; '
        'bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")'
        ' or m == "torbi_tpu" or m.startswith("torbi_tpu.")]; '
        'print(bad); sys.exit(1 if bad else 0)')
    result = subprocess.run(
        [sys.executable, '-c', code], capture_output=True, text=True,
        timeout=120)
    assert result.returncode == 0, result.stdout + result.stderr


def test_no_cuda_raises_without_cpu_request(monkeypatch):
    """Without CUDA, a call that does not ask for the CPU raises; it never
    carries on on the CPU"""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    observation, transition, initial = toy()
    for gpu in (None, 0, 'cuda', 'gpu'):
        with pytest.raises(RuntimeError):
            torbi_tpu_torch.from_probabilities(
                observation, transition=transition, initial=initial, gpu=gpu)
    with pytest.raises(RuntimeError):
        torbi_tpu_torch.decode(
            np.log(observation), np.array([3], dtype=np.int32),
            np.log(transition), np.log(initial))


def test_rejected_inputs():
    """Packed 4-D observations are TPU-only; the time-sharded backend
    decodes one sequence; the JAX package's backend names raise"""
    rng = np.random.default_rng(1)
    obs, bf, trans, init = random_case(rng, 2, 4, 8)
    with pytest.raises(ValueError):
        dispatch.decode(obs[None], bf, trans, init, device='cpu')
    with pytest.raises(ValueError, match='batch 1'):
        dispatch.decode(obs, bf, trans, init, backend='timesharded',
                        device='cpu')
    with pytest.raises(ValueError):
        dispatch.decode(obs, bf, trans, init, backend='xla', device='cpu')
    with pytest.raises(ValueError):
        dispatch.decode(obs[..., :5], bf, trans, init, device='cpu')


def test_decode_promotes_single_sequence():
    """viterbi.decode promotes a (frames, states) sequence to batch 1"""
    rng = np.random.default_rng(2)
    obs, bf, trans, init = random_case(rng, 1, 9, 6)
    got = torbi_tpu_torch.decode(obs[0], bf, trans, init, gpu='cpu')
    np.testing.assert_array_equal(
        got.numpy(), oracle.viterbi_numpy(obs, bf, trans, init))
