"""K2's padded sources (``ops/dense.py``) on the CPU.

K2 stages every row in 16-byte copies, so it reads rows whose stride is a
multiple of 4 floats: where the states are not one, a copy of the
transition padded with -inf columns (``padded_transition``, cached per
live tensor) and a padded two-frame exchange of the posterior in place
of the stream. The kernel runs only on the card (``chip_smoke.py`` holds
it bitwise against its plain version there); here the copy is checked, the
padding is shown not to move any output of the plain recursion, and the
wrapper's card-side steps run against a fake library that records what
K2 would be given. Tolerance: bitwise.
"""
import contextlib
import ctypes

import numpy as np
import pytest
import torch

from torbi_tpu_torch.models import pyin
from torbi_tpu_torch.ops import dense

TINY = np.finfo(np.float32).tiny


@pytest.mark.parametrize('states', [3, 8, 97, 1202, 1203])
def test_padded_transition_pads_with_neg_inf(states):
    """The copy holds the transition in its first ``states`` columns and
    -inf in the rest, its rows a multiple of 4 floats apart"""
    rng = np.random.default_rng(states)
    transition = torch.from_numpy(
        rng.standard_normal((states, states)).astype(np.float32))
    padded = dense.padded_transition(transition)
    sources = dense.sources(states)
    assert padded.shape == (states, sources) and padded.is_contiguous()
    assert padded.stride(0) % 4 == 0 and padded.dtype == torch.float32
    assert torch.equal(padded[:, :states], transition)
    assert bool((padded[:, states:] == float('-inf')).all())


def test_padded_transition_is_cached_until_an_edit():
    """The same live tensor gives the same copy; an in-place edit of it
    gives a new copy that holds the edit"""
    transition = torch.zeros((1202, 1202))
    first = dense.padded_transition(transition)
    assert dense.padded_transition(transition) is first
    transition[5, 7] = -3.0
    second = dense.padded_transition(transition)
    assert second is not first
    assert second[5, 7] == -3.0 and first[5, 7] == 0.0
    assert dense.padded_transition(transition) is second


def pad_inputs(observation, batch_frames, transition, initial):
    """The inputs at ``sources(states)`` states, -inf on every pad state:
    the observation's columns, the initial distribution, the transition's
    rows and columns"""
    batch, frames, states = observation.shape
    sources = dense.sources(states)
    obs = torch.full((batch, frames, sources), float('-inf'))
    obs[..., :states] = observation
    trans = torch.full((sources, sources), float('-inf'))
    trans[:states, :states] = transition
    init = torch.full((sources,), float('-inf'))
    init[:states] = initial
    return obs, batch_frames, trans, init


def pyin_inputs(rng, batch, frames):
    """pYIN's 1202-state HMM in log space (its zeros -inf) and random
    log-probabilities"""
    transition = torch.log(torch.from_numpy(pyin.transition_matrix()))
    initial = torch.log(torch.from_numpy(pyin.initial()))
    observation = torch.from_numpy(np.log(
        rng.random((batch, frames, pyin.STATES)).astype(np.float32) + TINY))
    return observation, transition, initial


def random_inputs(rng, batch, frames, states):
    """Random log-probabilities with ties: small integers"""
    observation = torch.from_numpy(rng.integers(
        -4, 1, size=(batch, frames, states)).astype(np.float32))
    transition = torch.from_numpy(rng.integers(
        -3, 1, size=(states, states)).astype(np.float32))
    initial = torch.from_numpy(np.log(
        rng.random(states).astype(np.float32) + TINY))
    return observation, transition, initial


@pytest.mark.parametrize('case', ['pyin', 'odd'])
def test_padding_moves_no_output(case):
    """The plain recursion on the inputs padded to ``sources(states)``
    with -inf pad states gives, in its first ``states`` columns, the
    unpadded stream bitwise: pYIN's HMM (1202 states) at a few short rows,
    and a random odd state count with ties"""
    rng = np.random.default_rng(24)
    if case == 'pyin':
        batch, frames = 3, 6
        observation, transition, initial = pyin_inputs(rng, batch, frames)
    else:
        batch, frames, states = 4, 9, int(rng.integers(20, 60)) * 2 + 1
        observation, transition, initial = random_inputs(
            rng, batch, frames, states)
    states = observation.shape[2]
    assert states % 4 != 0
    batch_frames = torch.tensor(
        [frames] + [int(x) for x in rng.integers(1, frames + 1, batch - 1)],
        dtype=torch.int32)
    want, _ = dense.dense_forward_reference(
        observation, batch_frames, transition, initial)
    got, _ = dense.dense_forward_reference(
        *pad_inputs(observation, batch_frames, transition, initial))
    assert torch.equal(got[..., :states], want)
    assert bool((got[..., states:] == float('-inf')).all())


class FakeLibrary:
    """Records every dense_forward call; every launch succeeds"""

    def __init__(self):
        self.calls = []

    def dense_forward(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """K2's card-side steps on CPU tensors: 132 SMs, the library records
    its calls, the launch counters from zero"""
    library = FakeLibrary()
    monkeypatch.setattr(dense, '_library', lambda: library)
    monkeypatch.setattr(dense, '_sms', lambda device: 132)
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(dense.build, 'stream',
                        lambda device: ctypes.c_void_p(0))
    wrapper = dense.viterbi_forward_dense
    monkeypatch.setattr(wrapper, 'launches', 0)
    monkeypatch.setattr(wrapper, 'padded_launches', 0)
    return library


def address(argument):
    return argument.value if isinstance(argument, ctypes.c_void_p) else None


@pytest.mark.parametrize('states, aligned, padded, copied', [
    (1202, True, True, True), (97, True, True, True),
    (1280, True, False, False), (1440, True, False, False),
    (1280, False, False, True)])
def test_launch_stages_from_padded_sources(fake_card, states, aligned,
                                           padded, copied):
    """Where the states are not a multiple of 4, K2 is given the padded
    transition and an exchange, and the launch counts in
    ``padded_launches``; at multiples of 4 it reads the caller's
    transition and the stream in place, unless the transition does not
    start on 16 bytes, when it streams the padded (here unpadded) copy"""
    batch, frames = 8, 5
    storage = torch.zeros(states * states + 1)
    transition = (storage[:-1] if aligned else storage[1:]).view(
        states, states)
    assert (transition.data_ptr() % 16 == 0) == aligned
    observation = torch.zeros((batch, frames, states))
    post_seq, _ = dense._launch(
        observation, torch.full((batch,), frames, dtype=torch.int32),
        transition, torch.zeros(states), None)
    (call,) = fake_card.calls
    want = (dense.padded_transition(transition) if copied
            else transition).data_ptr()
    assert address(call[3]) == want and want % 16 == 0
    assert address(call[4]) == post_seq.data_ptr()
    assert (address(call[5]) is not None) == padded
    if padded:
        assert address(call[5]) % 16 == 0
    assert call[7:10] == (batch, frames, states)
    plan = dense.dense_plan(batch, states, 132)
    assert call[10:-1] == tuple(int(plan[key]) for key in dense.PLAN_FIELDS)
    wrapper = dense.viterbi_forward_dense
    assert (wrapper.launches, wrapper.padded_launches) == (1, int(padded))
