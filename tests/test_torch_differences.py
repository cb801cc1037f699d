"""Deliberate differences from torbi_tpu, pinned (README, "Known
differences").

- ``backend='auto'`` on the CPU: the port resolves it to its kernel route
  on every device, so one long banded sequence decodes as entropy-chunk
  rows on the CPU as on the card; torbi_tpu resolves it to its scan route
  off the TPU and decodes the sequence whole.
- ``batch_frames`` past ``frames``: every route of the port clamps the
  chase's start to the last frame, which gives the oracle's path for
  ``min(batch_frames, frames)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torbi_tpu
import torbi_tpu_torch
from torbi_tpu_torch.ops import autochunk, dispatch, oracle

TINY = np.finfo(np.float32).tiny
STATES = 40


def band_transition(rng, states=STATES, floor=True):
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


def test_auto_on_the_cpu_chunks_a_long_sequence():
    """1 x 5000 frames of log(Dirichlet(0.1) + tiny): the port's CPU
    default is the oracle run chunk by chunk on its plan, torbi_tpu's the
    whole-sequence oracle, each on its own conversion of the epsilon step"""
    rng = np.random.default_rng(0)
    trans = band_transition(rng)
    obs = np.log(rng.dirichlet(np.full(STATES, 0.1), size=(1, 5000))
                 .astype(np.float32) + TINY)
    init = np.log(np.full(STATES, 1.0 / STATES, np.float32) + TINY)

    port = torbi_tpu_torch.from_probabilities(
        obs, transition=trans, initial=init, log_probs=True,
        gpu='cpu').numpy()
    converted = dispatch.convert(torch.from_numpy(obs), True, True).numpy()
    starts, lengths = autochunk.plan_splits(
        autochunk.framewise_entropy(
            torch.from_numpy(obs), STATES, True).numpy(),
        5000, int(torbi_tpu_torch.BATCH1_CHUNK_FRAMES))
    chunked = np.concatenate([
        oracle.viterbi_numpy(
            converted[:, start:start + length], [length], trans, init)
        for start, length in zip(starts, lengths)], axis=1)
    assert len(starts) >= 4
    np.testing.assert_array_equal(port, chunked)

    jax_path = np.asarray(torbi_tpu.from_probabilities(
        obs, transition=trans, initial=init, log_probs=True))
    jax_converted = np.asarray(jnp.log(jnp.exp(obs) + TINY))
    np.testing.assert_array_equal(
        jax_path, oracle.viterbi_numpy(jax_converted, [5000], trans, init))
    # The chunked path is not the whole one here
    assert (port != oracle.viterbi_numpy(
        converted, [5000], trans, init)).any()


def c4_case(route):
    """(observation, batch_frames, transition, switches) of one route"""
    rng = np.random.default_rng(4)
    if route in ('banded', 'dense', 'scan'):
        obs = np.log(rng.dirichlet(np.ones(STATES), size=(3, 7))
                     .astype(np.float32) + TINY)
        bf = np.array([9, 7, 3], np.int32)
    else:
        obs = np.log(rng.dirichlet(np.ones(STATES), size=(1, 64))
                     .astype(np.float32) + TINY)
        bf = np.array([80], np.int32)
    if route == 'dense':
        trans = np.log(rng.dirichlet(np.ones(STATES), size=STATES)
                       .astype(np.float32))
    else:
        trans = band_transition(rng, floor=route != 'window')
    switches = {
        'serial': dict(BAND_BATCH1_SPREAD=True, BACKTRACE_BATCH1_FUSED=True),
        'serial-k3': dict(BACKTRACE_BATCH1_FUSED=False,
                          BACKTRACE_BATCH1_WINDOW=False),
        'window': dict(BACKTRACE_BATCH1_FUSED=False,
                       BACKTRACE_BATCH1_WINDOW=True),
    }.get(route, {})
    return obs, bf, trans, switches


@pytest.mark.parametrize(
    'route', ['banded', 'dense', 'scan', 'serial', 'serial-k3', 'window'])
def test_batch_frames_past_frames_clamp(route, monkeypatch):
    obs, bf, trans, switches = c4_case(route)
    for name, value in switches.items():
        monkeypatch.setattr(torbi_tpu_torch, name, value)
    init = np.log(np.full(STATES, 1.0 / STATES, np.float32))
    got = dispatch.decode(
        obs, bf, trans, init, device='cpu',
        backend='scan' if route == 'scan' else 'kernel').numpy()
    clamped = np.minimum(bf, obs.shape[1])
    np.testing.assert_array_equal(
        got, oracle.viterbi_numpy(obs, clamped, trans, init))
