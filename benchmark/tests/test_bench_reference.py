"""The plain reference against a brute-force Viterbi, and its control"""
import numpy as np
import pytest
import torch

from benchmark import control, spec
from benchmark.reference import viterbi as reference
from benchmark.tests.layout import tiny_layout


def brute_force(observation, lengths, transition, initial):
    """Literal loops in numpy: float32 sums, the first source on a tie"""
    rows, frames, states = observation.shape
    paths = np.full((rows, frames), -1, dtype=np.int64)
    for b in range(rows):
        post = observation[b, 0] + initial
        choices = np.zeros((frames, states), dtype=np.int64)
        for t in range(1, lengths[b]):
            new = np.empty(states, dtype=np.float32)
            for d in range(states):
                best, arg = None, 0
                for s in range(states):
                    value = np.float32(post[s] + transition[d, s])
                    if best is None or value > best:
                        best, arg = value, s
                new[d] = np.float32(observation[b, t, d] + best)
                choices[t, d] = arg
            post = new
        state = int(np.argmax(post))
        for t in range(lengths[b] - 1, -1, -1):
            paths[b, t] = state
            state = int(choices[t, state])
    return paths


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_reference_matches_brute_force_with_ties(seed):
    rng = np.random.default_rng(seed)
    rows, frames, states = 4, 9, 6
    # Small integers make ties common
    observation = rng.integers(-3, 1, (rows, frames, states)).astype(
        np.float32)
    transition = rng.integers(-2, 1, (states, states)).astype(np.float32)
    initial = rng.integers(-1, 1, states).astype(np.float32)
    lengths = [9, 5, 1, 7]
    expected = brute_force(observation, lengths, transition, initial)
    found = reference.decode(torch.from_numpy(observation), lengths,
                             torch.from_numpy(transition),
                             torch.from_numpy(initial))
    assert np.array_equal(found.numpy(), expected)
    rows_ = reference.decode_blocks(
        [torch.from_numpy(observation[b]) for b in range(rows)], lengths,
        torch.from_numpy(transition), torch.from_numpy(initial), block=3)
    for b in range(rows):
        assert np.array_equal(rows_[b].numpy(), expected[b, :lengths[b]])


def test_conversions_follow_the_entry_points():
    tiny = float(np.finfo(np.float32).tiny)
    x = torch.tensor([-1e4, -3.0, 0.0])
    assert torch.equal(reference.stabilised(x),
                       torch.log(torch.exp(x) + tiny))
    assert reference.default_initial(4)[0] == torch.tensor(
        np.log(0.25 + tiny), dtype=torch.float32)


@pytest.mark.parametrize('cell', ['tiny-sorted', 'tiny-sharded'])
def test_control_in_bfloat16_fails_the_check(tmp_path, cell):
    """The control at a size a test holds: the reference in bfloat16
    differs from it in float32 on every seed, so the check's limit of 0
    fails it"""
    found = control.readings(spec.Cell(tiny_layout(tmp_path), cell),
                             [3, 4, 5], torch.device('cpu'), 'bfloat16')
    assert all(differing > 0 for differing, _ in found.values())


@pytest.mark.cuda
def test_reference_on_the_card_matches_the_host(cuda_device):
    rng = np.random.default_rng(7)
    observation = torch.from_numpy(
        rng.integers(-3, 1, (8, 40, 64)).astype(np.float32))
    transition = torch.from_numpy(
        rng.integers(-2, 1, (64, 64)).astype(np.float32))
    initial = torch.zeros(64)
    lengths = [40, 3, 17, 40, 1, 25, 39, 8]
    host = reference.decode(observation, lengths, transition, initial)
    card = reference.decode(observation.to(cuda_device), lengths,
                            transition.to(cuda_device),
                            initial.to(cuda_device))
    assert torch.equal(host, card.cpu())
