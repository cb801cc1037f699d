"""madmom's DBN beat tracker (``models/beats.py``) through the port's
in-list route, on the CPU.

At the published size (100 fps: 5617 states) the port's HMM equals the
benchmark's plain reference (``benchmark/reference/beats.py``): 82 tempi,
8,934 positive pairs, in-degrees 1 and 16-58, 389 beat states. At 20 fps
(238 states, 365 pairs) decodes of the benchmark's generated activations
through ``from_probabilities(..., log_probs=True)`` -- the gate, widened to
that size's share, takes the transition, then K9's and K10's plain
versions -- give bitwise the paths
of the benchmark's reference (madmom's sparse Viterbi), of the port's
dense route and of torbi_tpu's oracle and ``from_probabilities``.
"""
import numpy as np
import pytest
import torch

import torbi_tpu
import torbi_tpu_torch
from benchmark import beats as beat_inputs, inputs
from benchmark.reference import beats as reference
from torbi_tpu.ops.oracle import viterbi_numpy
from torbi_tpu_torch.models import beats
from torbi_tpu_torch.ops import dispatch, sparse

DBN = {'min_bpm': 55.0, 'max_bpm': 215.0, 'fps': 100,
       'transition_lambda': 100.0, 'observation_lambda': 16}
SMALL = dict(DBN, fps=20)
LAW = {'tempo': {'median': 115.0, 'sigma': 0.25, 'low': 60.0, 'high': 200.0},
       'drift': 0.005, 'change_chance': 0.2, 'change': [0.67, 1.5],
       'bpm': [55.0, 215.0], 'beat': [0.4, 0.95], 'neighbour': [0.2, 0.5],
       'miss_chance': 0.1, 'offbeat_chance': 0.3, 'offbeat': [0.1, 0.4],
       'background': [0.001, 0.03], 'clip': 1e-06}
LENGTHS = [90, 7, 64, 1, 33]


@pytest.fixture(autouse=True)
def wide_gate(monkeypatch):
    """The 20-fps space's 365 of 238^2 pairs (0.64%) lie above the gate's
    share, which is set at the published size (8,934 of 5617^2 pairs,
    0.028%): a gate of 1% takes it through the route here"""
    monkeypatch.setattr(sparse, 'MAX_SHARE', 0.01)


def test_the_state_space():
    space = beats.state_space()
    assert beats.STATES == space.states == 5617
    assert (space.intervals[0], space.intervals[-1], len(space.intervals)) \
        == (28, 109, 82)
    assert space.first_states[:3].tolist() == [0, 28, 57]
    assert space.last_states[-1] == 5616
    assert np.array_equal(space.last_states[:-1] + 1, space.first_states[1:])
    assert int(beats.beat_states().sum()) == 389
    # 55.0-214.3 bpm
    assert 6000 / space.intervals[-1] == pytest.approx(55.05, abs=0.01)
    assert 6000 / space.intervals[0] == pytest.approx(214.29, abs=0.01)
    small = beats.state_space(fps=20)
    assert (small.states, small.intervals[0], small.intervals[-1]) == (
        238, 6, 22)


def test_the_hmm_equals_the_benchmark_reference():
    transition = beats.transition_matrix()
    _, want, want_initial = reference.hmm(DBN)
    assert transition.dtype == np.float32 and transition.shape == (5617,) * 2
    assert np.array_equal(transition, want.numpy())
    assert np.array_equal(beats.initial(), want_initial.numpy())
    finite = np.isfinite(transition)
    assert int(finite.sum()) == 8934
    degrees = finite.sum(axis=1)
    first = beats.state_space().first_states
    assert (degrees == 1).sum() == 5535
    assert degrees[first].min() == 16 and degrees[first].max() == 58
    # Row = destination: each source's probabilities sum to 1
    sums = np.exp(transition.astype(np.float64)).sum(axis=0)
    assert np.allclose(sums, 1, atol=1e-6)
    # Along a beat the next position, with probability 1
    assert transition[1, 0] == 0 and transition[5616, 5615] == 0
    assert not np.isfinite(transition[0, 0])
    assert np.all(beats.initial() == np.float32(np.log(1 / 5617)))
    small = beats.transition_matrix(fps=20)
    assert int(np.isfinite(small).sum()) == 365
    assert np.array_equal(small, reference.hmm(SMALL)[1].numpy())


def test_the_observation():
    p = np.array([[0.9, 0.2, 1e-6]], np.float32)
    densities = beats.observation(p)
    beat = beats.beat_states()
    assert densities.shape == (1, 3, 5617) and densities.dtype == np.float32
    assert np.all(densities[0, 0, beat] == np.log(np.float32(0.9)))
    assert np.allclose(densities[0, 0, ~beat], np.log(0.1 / 15))
    # Two values a frame
    assert len(np.unique(densities[0, 1])) == 2
    got = beats.observation(torch.from_numpy(p))
    assert torch.allclose(got, torch.from_numpy(densities))
    want = reference.log_densities(torch.from_numpy(p), DBN)
    assert torch.equal(got, want)
    positions, intervals = beats.positions(torch.tensor([0, 28, 30]))
    assert positions.tolist() == [0.0, 0.0, 2 / 29]
    assert intervals.tolist() == [28, 29, 29]


def small_case(seed, lengths=LENGTHS):
    host = inputs.host_generator(seed)
    tracks = beat_inputs.activations(lengths, LAW, SMALL['fps'], host)
    obs = beat_inputs.log_densities(tracks, SMALL, 'cpu')
    return (obs, torch.tensor(lengths, dtype=torch.int32),
            torch.from_numpy(beats.transition_matrix(fps=20)),
            torch.from_numpy(beats.initial(238)))


@pytest.mark.parametrize('seed', [0, 1, 2 ** 33 + 3])
def test_small_paths_equal_the_references(seed, monkeypatch):
    obs, bf, trans, init = small_case(seed)
    lists = sparse.detect_sparse(trans)
    assert (lists.pairs, lists.states) == (365, 238)
    got = torbi_tpu_torch.from_probabilities(
        obs, bf, trans, init, log_probs=True, gpu='cpu')
    stable = reference.stabilised(obs)
    want = reference.decode(stable, LENGTHS, reference.hmm(SMALL)[0], init)
    oracle = viterbi_numpy(stable.numpy(), bf.numpy(), trans.numpy(),
                           init.numpy())
    for row, length in enumerate(LENGTHS):
        assert torch.equal(got[row, :length].long(), want[row, :length])
        assert np.array_equal(got[row].numpy(), oracle[row])
    # The dense route (K2, K3's plain versions) on the same inputs
    monkeypatch.setattr(sparse, 'MAX_SHARE', 0.0)
    assert sparse.detect_sparse(trans.clone()) is None
    dense = torbi_tpu_torch.from_probabilities(
        obs, bf, trans.clone(), init, log_probs=True, gpu='cpu')
    assert torch.equal(got, dense)


def test_from_probabilities_equals_torbi_tpus():
    obs, bf, trans, init = small_case(4)
    got = torbi_tpu_torch.from_probabilities(
        obs, bf, trans, init, log_probs=True, gpu='cpu')
    want = np.asarray(torbi_tpu.from_probabilities(
        obs.numpy(), bf.numpy(), trans.numpy(), init.numpy(),
        log_probs=True))
    for row, length in enumerate(LENGTHS):
        assert np.array_equal(got[row, :length].numpy(), want[row, :length])


def test_one_track_and_one_frame():
    obs, bf, trans, init = small_case(5, lengths=[41])
    got = torbi_tpu_torch.from_probabilities(
        obs, bf, trans, init, log_probs=True, gpu='cpu')
    oracle = viterbi_numpy(reference.stabilised(obs).numpy(), bf.numpy(),
                           trans.numpy(), init.numpy())
    assert np.array_equal(got.numpy(), oracle)
    one = torbi_tpu_torch.from_probabilities(
        obs[:, :1], None, trans, init, log_probs=True, gpu='cpu')
    assert one.tolist() == [[int(torch.argmax(
        reference.stabilised(obs[0, 0]) + init))]]


def test_the_route_converts_nothing_and_counts_its_pairs():
    obs, bf, trans, init = small_case(6)
    values = dispatch.convert.values
    pairs = sparse.viterbi_forward_sparse.pairs
    torbi_tpu_torch.from_probabilities(
        obs, bf, trans, init, log_probs=True, gpu='cpu')
    assert dispatch.convert.values == values
    assert sparse.viterbi_forward_sparse.pairs - pairs == (
        365 * len(LENGTHS) * max(LENGTHS))
