"""The port's batch-1 auto-chunking against torbi_tpu's.

The cases of tests/test_autochunk.py, with the same small knobs set on both
packages (auto-chunking from 128 frames, 48-frame chunks) and the port's
private copy of the frame buckets set to the ones the JAX package runs with
in these tests. Inputs are made with numpy from a seed. The port runs on
the CPU (the kernels' plain versions), torbi_tpu through
``dispatch.decode(..., backend='pallas')`` in interpret mode. Paths and
plans are compared exactly; the framewise entropy within rtol 1e-5 and
atol 1e-6 (the two packages sum it in different orders).
"""
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torbi_tpu
import torbi_tpu_torch
from torbi_tpu.config import defaults as jax_defaults
from torbi_tpu.ops import autochunk as jax_autochunk
from torbi_tpu.ops import band as jax_band
from torbi_tpu.ops import oracle
from torbi_tpu.ops.dispatch import decode as jax_decode
from torbi_tpu_torch.ops import autochunk, backtrace, band, dispatch

from test_autochunk import peaked_case, per_chunk_oracle

TINY = np.finfo(np.float32).tiny


@pytest.fixture
def small_knobs(monkeypatch):
    for package in (torbi_tpu, torbi_tpu_torch):
        monkeypatch.setattr(
            package, 'BATCH1_AUTO_CHUNK_MIN_FRAMES', 128, raising=False)
        monkeypatch.setattr(
            package, 'BATCH1_CHUNK_FRAMES', 48, raising=False)
        monkeypatch.setattr(package, 'BATCH1_AUTO_CHUNK', True, raising=False)
    monkeypatch.setattr(
        torbi_tpu, 'BAND_KERNEL_LAYOUT', 'stitched', raising=False)
    monkeypatch.setattr(
        autochunk, '_FRAME_BUCKETS', tuple(torbi_tpu.FRAME_BUCKETS))


def spy_route(monkeypatch):
    """Record whether the port's auto-chunk route engaged"""
    results = []
    orig = autochunk.decode_chunked

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        results.append(out is not None)
        return out

    monkeypatch.setattr(autochunk, 'decode_chunked', wrapper)
    return results


def spy_kernels(monkeypatch):
    """Record the kernel wrappers a decode calls, by kernel name"""
    calls = []
    for module, name, label in (
            (band, 'viterbi_forward_band', 'K1'),
            (band, 'viterbi_forward_band_spread', 'K4'),
            (backtrace, 'backtrace_posteriors', 'K3'),
            (dispatch, 'backtrace_posteriors', 'K3'),
            (dispatch, 'backtrace_fused1', 'K5'),
            (dispatch, 'backtrace_window', 'K6')):
        orig = getattr(module, name)

        def spy(*args, _orig=orig, _label=label, **kwargs):
            calls.append(_label)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)
    return calls


def port_decode(obs, bf, trans, init, log_input=True, apply_epsilon=False):
    out = dispatch.decode(
        torch.from_numpy(obs), torch.from_numpy(bf), torch.from_numpy(trans),
        torch.from_numpy(init), finite_observation=True, log_input=log_input,
        apply_epsilon=apply_epsilon, device='cpu')
    assert out.dtype == torch.int32 and out.shape == obs.shape[:2]
    return out.numpy()


def reference_decode(obs, bf, trans, init, log_input=True,
                     apply_epsilon=False):
    return np.asarray(jax_decode(
        jnp.asarray(obs), jnp.asarray(bf), jnp.asarray(trans),
        jnp.asarray(init), backend='pallas', finite_observation=True,
        log_input=log_input, apply_epsilon=apply_epsilon))


def port_plan(obs, valid, states, log_input=True):
    ent = autochunk.framewise_entropy(
        torch.from_numpy(obs), states, log_input).numpy()
    return autochunk.plan_splits(
        ent, valid, int(torbi_tpu_torch.BATCH1_CHUNK_FRAMES))


def jax_plan(obs, valid, states, log_input=True):
    ent, _ = jax_autochunk._entropy_fn(False, log_input, states)(
        jnp.asarray(obs), jnp.asarray(np.array([valid], np.int32)))
    return jax_autochunk.plan_splits(
        np.asarray(ent), valid, int(torbi_tpu.BATCH1_CHUNK_FRAMES))


def test_matches_per_chunk_oracle_bitwise(small_knobs, monkeypatch):
    """The route's contract: bitwise the oracle run per chunk, and
    torbi_tpu's path; K1 and K3 run, the batch-1 kernels do not"""
    engaged = spy_route(monkeypatch)
    kernels = spy_kernels(monkeypatch)
    frames, states = 384, 384
    obs, trans, init = peaked_case(frames, states, halfwidth=6, seed=1)
    bf = np.array([frames], np.int32)
    plan = port_plan(obs, frames, states)
    assert plan is not None and len(plan[0]) >= 4
    starts, lengths = plan

    got = port_decode(obs, bf, trans, init)
    assert engaged == [True]
    assert kernels == ['K1', 'K3']
    np.testing.assert_array_equal(
        got, per_chunk_oracle(obs, trans, init, starts, lengths))
    np.testing.assert_array_equal(
        got, reference_decode(obs, bf, trans, init))


def test_matches_full_oracle_on_peaked_data(small_knobs, monkeypatch):
    """Peaked data splits only at near-deterministic frames: the chunked
    path is the full-sequence oracle's, and torbi_tpu's"""
    engaged = spy_route(monkeypatch)
    frames, states = 384, 256
    obs, trans, init = peaked_case(frames, states, halfwidth=5, seed=2)
    bf = np.array([frames], np.int32)
    got = port_decode(obs, bf, trans, init)
    assert engaged == [True]
    np.testing.assert_array_equal(
        got, oracle.viterbi_numpy(obs, bf, trans, init))
    np.testing.assert_array_equal(
        got, reference_decode(obs, bf, trans, init))


def test_diffuse_observation_declines(small_knobs, monkeypatch):
    """High-entropy frames give no plan: the route declines and the
    batch-1 kernels decode the full sequence oracle-exactly"""
    engaged = spy_route(monkeypatch)
    kernels = spy_kernels(monkeypatch)
    rng = np.random.default_rng(4)
    frames, states = 160, 256
    obs = np.log(
        rng.dirichlet(np.ones(states), size=(1, frames))
        .astype(np.float32) + TINY)
    xx, yy = np.meshgrid(np.arange(states), np.arange(states), indexing='ij')
    trans = np.clip(6 + 1.0 - np.abs(xx - yy), 0, None)
    trans = np.log(
        (trans / trans.sum(axis=1, keepdims=True)).astype(np.float32))
    init = np.log(np.full(states, 1.0 / states, dtype=np.float32) + TINY)
    bf = np.array([frames], np.int32)
    assert port_plan(obs, frames, states) is None
    assert jax_plan(obs, frames, states) is None

    got = port_decode(obs, bf, trans, init)
    assert engaged == [False]
    assert kernels == ['K4', 'K5']
    np.testing.assert_array_equal(
        got, oracle.viterbi_numpy(obs, bf, trans, init))
    np.testing.assert_array_equal(
        got, reference_decode(obs, bf, trans, init))


def test_flag_off_pins_serial_full_sequence(small_knobs, monkeypatch):
    for package in (torbi_tpu, torbi_tpu_torch):
        monkeypatch.setattr(package, 'BATCH1_AUTO_CHUNK', False)
    engaged = spy_route(monkeypatch)
    kernels = spy_kernels(monkeypatch)
    frames, states = 384, 256
    obs, trans, init = peaked_case(frames, states, halfwidth=5, seed=5)
    bf = np.array([frames], np.int32)
    got = port_decode(obs, bf, trans, init)
    assert engaged == []  # never consulted
    assert kernels == ['K4', 'K5']
    np.testing.assert_array_equal(
        got, oracle.viterbi_numpy(obs, bf, trans, init))
    np.testing.assert_array_equal(
        got, reference_decode(obs, bf, trans, init))


def test_padded_tail_freezes_at_last_valid_state(small_knobs, monkeypatch):
    """batch_frames < frames: the plan covers only the valid prefix and the
    tail holds the final decoded state"""
    engaged = spy_route(monkeypatch)
    frames, states, valid = 416, 256, 352
    obs, trans, init = peaked_case(frames, states, halfwidth=5, seed=6)
    bf = np.array([valid], np.int32)
    plan = port_plan(obs[:, :valid], valid, states)
    assert plan is not None
    starts, lengths = plan

    got = port_decode(obs, bf, trans, init)
    assert engaged == [True]
    expected_valid = per_chunk_oracle(
        obs[:, :valid], trans, init, starts, lengths)
    np.testing.assert_array_equal(got[:, :valid], expected_valid)
    np.testing.assert_array_equal(
        got[:, valid:],
        np.full((1, frames - valid), expected_valid[0, -1], got.dtype))
    np.testing.assert_array_equal(
        got, reference_decode(obs, bf, trans, init))


def test_probability_space_epsilon_pipeline(small_knobs, monkeypatch):
    """log_input=False with the epsilon step: the plan from the
    probability-space entropy, each chunk decoded on the stabilized log
    observation, as torbi_tpu does"""
    engaged = spy_route(monkeypatch)
    frames, states = 384, 256
    obs, trans, init = peaked_case(frames, states, halfwidth=5, seed=7)
    bf = np.array([frames], np.int32)
    probs = np.exp(obs)
    obs_eps = np.log(np.exp(np.log(probs)) + TINY)

    got = port_decode(
        probs, bf, trans, init, log_input=False, apply_epsilon=True)
    assert engaged == [True]
    plan = port_plan(probs, frames, states, log_input=False)
    assert plan is not None
    for mine, theirs in zip(
            plan, jax_plan(probs, frames, states, log_input=False)):
        np.testing.assert_array_equal(mine, theirs)
    starts, lengths = plan
    np.testing.assert_array_equal(
        got, per_chunk_oracle(obs_eps, trans, init, starts, lengths))
    np.testing.assert_array_equal(got, reference_decode(
        probs, bf, trans, init, log_input=False, apply_epsilon=True))


@pytest.mark.parametrize('frames,states,halfwidth,valid,seed', [
    (384, 384, 6, 384, 1),
    (384, 256, 5, 384, 2),
    (416, 256, 5, 352, 6),
    (600, 128, 4, 600, 11),
    (200, 256, 5, 200, 12),
])
def test_plan_equals_jax(small_knobs, frames, states, halfwidth, valid, seed):
    """(starts, lengths) equal to torbi_tpu's plan_splits on the same
    observation, the entropy within rtol 1e-5 and atol 1e-6"""
    obs, _, _ = peaked_case(frames, states, halfwidth, seed=seed)
    ent, _ = jax_autochunk._entropy_fn(False, True, states)(
        jnp.asarray(obs), jnp.asarray(np.array([valid], np.int32)))
    np.testing.assert_allclose(
        autochunk.framewise_entropy(
            torch.from_numpy(obs), states, True).numpy(),
        np.asarray(ent), rtol=1e-5, atol=1e-6)
    got = port_plan(obs[:, :valid], valid, states)
    expected = jax_plan(obs[:, :valid], valid, states)
    assert (got is None) == (expected is None)
    if got is not None:
        np.testing.assert_array_equal(got[0], expected[0])
        np.testing.assert_array_equal(got[1], expected[1])


@pytest.mark.parametrize('starts, valid, frames', [
    ([0, 9, 30, 38, 50, 61], 70, 70),
    ([0, 12, 20, 33, 47], 60, 75),
    ([0, 5, 11, 18, 24], 50, 50),
    ([0, 20, 26, 33, 40], 48, 48),
    ([0, 16, 32, 48], 64, 64),
], ids=['valid-is-frames', 'frozen-tail', 'last-longest', 'clamp',
        'four-rows'])
def test_plan_arrays_equal_the_host_construction(starts, valid, frames):
    """The plan's arrays built on the device from (starts, lengths) equal,
    element for element and in dtype and shape, their numpy construction"""
    starts = np.array(starts, np.int32)
    lengths = np.diff(np.append(starts, valid)).astype(np.int32)
    longest = int(lengths.max())
    gather = np.minimum(
        starts[:, None] + np.arange(longest)[None, :], frames - 1)
    t = np.minimum(np.arange(frames), valid - 1)
    row = np.searchsorted(starts, t, side='right') - 1
    expected = (gather, lengths, row, t - starts[row])

    got = autochunk.plan_arrays(starts, lengths, valid, frames, 'cpu')
    assert len(got) == len(expected)
    for mine, theirs in zip(got, expected):
        theirs = torch.from_numpy(theirs)
        assert mine.dtype == theirs.dtype
        assert mine.shape == theirs.shape
        assert torch.equal(mine, theirs)


def test_private_tables_are_jax_defaults():
    """The port's private frame buckets and row tile are the JAX package's
    defaults, so production plans follow the same rule"""
    autochunk_defaults = autochunk._FRAME_BUCKETS
    assert autochunk_defaults == tuple(jax_defaults.FRAME_BUCKETS)
    assert autochunk._ROW_TILE == jax_band.BATCH_TILE
    for name in ('BATCH1_AUTO_CHUNK', 'BATCH1_AUTO_CHUNK_MIN_FRAMES',
                 'BATCH1_CHUNK_FRAMES', 'ENTROPY_THRESHOLD',
                 'MIN_CHUNK_SIZE'):
        assert (getattr(torbi_tpu_torch.config.defaults, name)
                == getattr(jax_defaults, name)), name


REPEATS = ('same-tensors', 'batch-frames-none', 'host-array',
           'observation-edited', 'batch-frames-edited', 'probabilities')


@pytest.mark.parametrize('case', REPEATS)
def test_repeated_decodes_plan_afresh_and_keep_nothing(small_knobs,
                                                        monkeypatch, case):
    """Two decodes of one long sequence, handed in again as the case says:
    each call plans afresh, nothing of its plan outlives it, and each path
    is torbi_tpu's for what that call was given"""
    frames, states, valid = 384, 256, 352
    obs, trans, _ = peaked_case(frames, states, halfwidth=5, seed=9)
    other, _, _ = peaked_case(frames, states, halfwidth=5, seed=14)
    log_probs = case != 'probabilities'
    if not log_probs:
        obs, other = np.exp(obs), np.exp(other)
    probs = np.exp(trans)
    obs_t = torch.from_numpy(obs.copy())
    bf_t = torch.tensor([frames], dtype=torch.int32)
    planned = []
    real = autochunk.plan_arrays

    def spy(*args, **kwargs):
        arrays = real(*args, **kwargs)
        planned.extend(weakref.ref(array) for array in arrays)
        return arrays

    monkeypatch.setattr(autochunk, 'plan_arrays', spy)
    expected = {}
    for call in range(2):
        if call and case == 'observation-edited':
            obs_t.copy_(torch.from_numpy(other))
        if call and case == 'batch-frames-edited':
            bf_t.fill_(valid)
        observation = obs if case == 'host-array' else obs_t
        batch_frames = None if case == 'batch-frames-none' else bf_t
        plans = autochunk.decode_chunked.plans
        got = torbi_tpu_torch.from_probabilities(
            observation, batch_frames, transition=probs,
            log_probs=log_probs, gpu='cpu')
        assert autochunk.decode_chunked.plans == plans + 1
        assert len(planned) == 4 * (call + 1)
        gc.collect()
        assert [ref() for ref in planned] == [None] * len(planned)
        given = (obs_t.numpy().copy(), int(bf_t[0]))
        key = (given[0].tobytes(), given[1])
        if key not in expected:
            expected[key] = np.asarray(torbi_tpu.from_probabilities(
                given[0], np.array([given[1]], np.int32), transition=probs,
                log_probs=log_probs))
        np.testing.assert_array_equal(got.numpy(), expected[key])


def test_memory_rule_declines(small_knobs, monkeypatch):
    """A sequence whose observation takes more than 2/5 of the memory
    budget decodes serially, exactly"""
    engaged = spy_route(monkeypatch)
    frames, states = 384, 256
    obs, trans, init = peaked_case(frames, states, halfwidth=5, seed=10)
    bf = np.array([frames], np.int32)
    monkeypatch.setattr(
        torbi_tpu_torch, 'DECODE_MEMORY_BUDGET', obs.nbytes * 2)
    got = port_decode(obs, bf, trans, init)
    assert engaged == [False]
    np.testing.assert_array_equal(
        got, oracle.viterbi_numpy(obs, bf, trans, init))


def test_from_probabilities_batch1_matches(small_knobs, monkeypatch):
    """The public entry point on one long pitch-like sequence takes the
    route and returns torbi_tpu.from_probabilities' path"""
    engaged = spy_route(monkeypatch)
    frames, states = 384, 256
    obs, trans, _ = peaked_case(frames, states, halfwidth=5, seed=13)
    probs = np.exp(trans)
    got = torbi_tpu_torch.from_probabilities(
        obs, transition=probs, log_probs=True, gpu='cpu')
    again = torbi_tpu_torch.from_probabilities(
        obs, transition=probs, log_probs=True, gpu='cpu')
    assert engaged == [True, True]
    expected = np.asarray(torbi_tpu.from_probabilities(
        obs, transition=probs, log_probs=True))
    np.testing.assert_array_equal(got.numpy(), expected)
    np.testing.assert_array_equal(again.numpy(), expected)


@pytest.mark.parametrize('frames', [312_499, 312_500, 312_501, 2_777_777])
def test_memory_rule_equals_jax(frames):
    """At the default budgets the route declines exactly the single
    1440-state sequences that torbi_tpu's auto-chunk rule declines (checked
    on the byte count, without allocating)"""
    obs_bytes = frames * 1440 * 4
    expected = obs_bytes * 5 > 2 * int(torbi_tpu.DECODE_MEMORY_BUDGET)
    assert autochunk.declines_for_memory(obs_bytes) == expected
    assert expected == (frames > 312_500)
