"""The in-list route (``ops/sparse.py``) on the CPU.

K9's and K10's plain versions against the dense route's (K2's and K3's)
and against torbi_tpu's oracle, on random sparse HMMs whose candidates tie,
with -inf initial entries, destinations without a source and long in-lists,
ragged lengths, batch 1 and one frame, in the four conversions K9 folds;
the gate taking madmom's transition and declining pYIN's, penn's, a floor
band and non-finite pairs; an observation holding NaN or +inf sent to the
dense route; the launch layouts; the memory guard's row groups; the pairs
counter.
"""
import numpy as np
import pytest
import torch

import torbi_tpu_torch
from torbi_tpu.ops.oracle import viterbi_numpy
from torbi_tpu_torch.models import beats, pyin
from torbi_tpu_torch.ops import backtrace, dense, dispatch, sparse

TINY = np.finfo(np.float32).tiny


def sparse_case(batch, frames, states, degree, seed):
    """A random sparse HMM with ties in log space, numpy: each destination
    0 to 2 degree sources (one in 20 a list of 9-40, which K9's warps
    reduce), values and observation from a few levels, a -inf exterior,
    -inf initial entries, ragged lengths (the first row whole)"""
    rng = np.random.default_rng(seed)
    trans = np.full((states, states), -np.inf, np.float32)
    for j in range(states):
        count = (int(rng.integers(9, 41)) if rng.random() < 0.05
                 else int(rng.integers(0, 2 * degree + 1)))
        chosen = rng.choice(states, min(count, states), replace=False)
        trans[j, chosen] = np.log(rng.choice([0.25, 0.5, 1.0], len(chosen)))
    obs = np.log(rng.choice([0.1, 0.2, 0.4], (batch, frames, states)))
    with np.errstate(divide='ignore'):
        init = np.log(rng.choice([0.0, 0.5, 1.0], states))
    init[0] = 0.0
    lengths = rng.integers(0, frames + 1, batch)
    lengths[0] = frames
    return (obs.astype(np.float32), lengths.astype(np.int32), trans,
            init.astype(np.float32))


def tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


CONVERSIONS = [(True, False), (True, True), (False, False), (False, True)]


@pytest.mark.parametrize('conversion', CONVERSIONS)
@pytest.mark.parametrize('batch, frames, states, degree, seed', [
    (3, 20, 60, 2, 1), (1, 1, 40, 2, 2), (1, 17, 97, 1, 3),
    (4, 12, 130, 3, 4)])
def test_plain_kernels_equal_the_dense_route(batch, frames, states, degree,
                                             seed, conversion):
    obs, bf, trans, init = tensors(
        *sparse_case(batch, frames, states, degree, seed))
    raw = obs if conversion[0] else torch.exp(obs)
    lists = sparse.in_lists(trans)
    pointers, posterior = sparse.sparse_forward_reference(
        raw, bf, init, lists, *conversion)
    converted = dispatch.convert(raw, *conversion).contiguous()
    post_seq, last = dense.dense_forward_reference(converted, bf, trans, init)
    assert torch.equal(posterior, last)
    assert pointers.dtype == torch.int16
    # Each pointer is K3's recomputed backpointer: the lowest source of the
    # best candidate, 0 where every candidate is -inf
    for t in range(1, frames):
        scores = post_seq[:, t - 1, None, :] + trans[None]
        want = scores.argmax(dim=-1)
        want = torch.where(scores.amax(dim=-1) == float('-inf'), 0, want)
        for row in range(batch):
            if t < bf[row]:
                assert torch.equal(pointers[row, t].long(), want[row])
            else:
                assert not pointers[row, t].any()
    paths = sparse.backtrace_sparse_reference(pointers, posterior, bf)
    assert torch.equal(paths, backtrace.backtrace_reference(
        post_seq, trans, last, bf))


# Enough states that about two sources a state are under the gate's share
STATES = 2000


@pytest.mark.parametrize('seed', [5, 6, 2 ** 33 + 7])
def test_route_equals_torbi_tpus_oracle(seed):
    obs, bf, trans, init = sparse_case(5, 16, STATES, 1, seed)
    lists = sparse.detect_sparse(torch.from_numpy(trans))
    assert lists is not None
    assert lists.pairs <= sparse.MAX_SHARE * STATES ** 2
    launched = sparse.viterbi_forward_sparse.pairs
    got = dispatch.decode(obs, bf, trans, init, device='cpu')
    assert sparse.viterbi_forward_sparse.pairs - launched == (
        lists.pairs * 5 * 16)
    assert np.array_equal(got.numpy(), viterbi_numpy(obs, bf, trans, init))
    # The ties decide the paths: the highest source winning gives others
    reverse = np.arange(STATES - 1, -1, -1)
    flipped = dispatch.decode(
        obs[..., reverse], bf,
        np.ascontiguousarray(trans[reverse][:, reverse]), init[reverse],
        device='cpu')
    assert not np.array_equal(STATES - 1 - flipped.numpy(), got.numpy())


def test_a_frame_of_minus_inf():
    """Every posterior after it is -inf: the seed is 0, and the chase
    follows the pointers as the dense route's does"""
    obs, bf, trans, init = sparse_case(3, 16, STATES, 1, 9)
    obs[:, 7] = -np.inf
    got = dispatch.decode(obs, bf, trans, init, device='cpu')
    assert sparse.detect_sparse(torch.from_numpy(trans)) is not None
    assert np.array_equal(got.numpy(), viterbi_numpy(obs, bf, trans, init))


def madmom():
    return torch.from_numpy(beats.transition_matrix())


def test_the_gate():
    lists = sparse.detect_sparse(madmom())
    assert (lists.pairs, lists.states) == (8934, 5617)
    degrees = (lists.offsets[1:] - lists.offsets[:-1]).tolist()
    assert degrees.count(1) == 5535 and min(degrees) == 1
    # pYIN's 232,604 of 1202^2 pairs (16.1%) stay on K2
    with np.errstate(divide='ignore'):
        pyin_log = np.log(pyin.transition_matrix())
    assert sparse.detect_sparse(torch.from_numpy(pyin_log)) is None
    # penn's log(p + tiny) and any band over a finite floor: no -inf
    # exterior
    penn = torch.from_numpy(np.log(
        torbi_tpu_torch.models.pitch.transition_matrix() + TINY).astype(
            np.float32))
    assert sparse.detect_sparse(penn) is None
    floor = torch.full((600, 600), -50.0)
    floor[torch.arange(600), torch.arange(600)] = 0.0
    assert sparse.detect_sparse(floor) is None
    pure = torch.full((600, 600), float('-inf'))
    pure[torch.arange(600), torch.arange(600)] = 0.0
    assert sparse.detect_sparse(pure).pairs == 600
    # Past the gate's share: two sources a state of 600
    twice = pure.clone()
    twice[torch.arange(599), torch.arange(1, 600)] = 0.0
    assert sparse.detect_sparse(twice) is None
    # Pairs that are not finite, and a transition past the kernel's states
    for bad in (float('inf'), float('nan')):
        broken = pure.clone()
        broken[3, 5] = bad
        assert sparse.detect_sparse(broken) is None


def test_the_gate_declines_more_states_than_k9_holds(monkeypatch):
    trans = torch.from_numpy(sparse_case(1, 1, STATES, 1, 1)[2])
    assert sparse.detect_sparse(trans) is not None
    monkeypatch.setattr(sparse, 'MAX_STATES', STATES - 1)
    assert sparse.detect_sparse(trans.clone()) is None


def test_madmom_takes_the_route_and_pyin_k2(monkeypatch):
    """Launch-level routing on the CPU: the in-list route's forward and
    chase for madmom's 20 fps space (its 0.64% of the pairs taken under a
    gate widened to 1%), K2 for pYIN"""
    monkeypatch.setattr(sparse, 'MAX_SHARE', 0.01)
    seen = []
    real_sparse, real_dense = dispatch.sparse_route, dispatch.kernel_route

    def sparse_spy(lists):
        seen.append('sparse')
        return real_sparse(lists)

    def dense_spy(transition, band, batch):
        seen.append('dense' if band is None else 'band')
        return real_dense(transition, band, batch)

    monkeypatch.setattr(dispatch, 'sparse_route', sparse_spy)
    monkeypatch.setattr(dispatch, 'kernel_route', dense_spy)
    trans = beats.transition_matrix(fps=20)
    obs = beats.observation(np.full((2, 6), 0.3, np.float32), fps=20)
    reasons = dict(dispatch.decode.dense_reasons)
    torbi_tpu_torch.from_probabilities(
        obs, None, trans, beats.initial(238), log_probs=True, gpu='cpu')
    assert dispatch.decode.dense_reasons == reasons
    probs = np.full((2, 4, 1202), 1 / 1202, np.float32)
    torbi_tpu_torch.from_probabilities(
        probs, None, pyin.transition_matrix(), pyin.initial(), gpu='cpu')
    assert seen == ['sparse', 'dense']
    assert dispatch.decode.dense_reasons == dict(
        reasons, width=reasons['width'] + 1)


@pytest.mark.parametrize('log_input, bad', [
    (True, float('nan')), (True, float('inf')), (False, -1.0),
    (False, float('nan'))])
def test_an_observation_it_cannot_hold_goes_to_k2(log_input, bad):
    obs, bf, trans, init = sparse_case(2, 10, STATES, 1, 11)
    if not log_input:
        obs = np.exp(obs)
    obs[1, 4, 7] = bad
    reasons = dict(dispatch.decode.dense_reasons)
    calls = sparse.viterbi_forward_sparse.pairs
    dispatch.decode(obs, bf, trans, init, log_input=log_input, device='cpu')
    assert sparse.viterbi_forward_sparse.pairs == calls
    assert dispatch.decode.dense_reasons == dict(
        reasons, width=reasons['width'] + 1)


def test_minus_inf_observation_stays_on_the_route():
    obs, bf, trans, init = sparse_case(2, 10, STATES, 1, 12)
    obs[0, 3, :100] = -np.inf
    calls = sparse.viterbi_forward_sparse.pairs
    got = dispatch.decode(obs, bf, trans, init, device='cpu')
    assert sparse.viterbi_forward_sparse.pairs > calls
    assert np.array_equal(got.numpy(), viterbi_numpy(obs, bf, trans, init))


def test_memory_guard_splits_the_route(monkeypatch):
    """Each row group holds its observation (4 bytes a state) and its int16
    pointers (2 bytes a state), and decodes on the route"""
    obs, bf, trans, init = sparse_case(4, 10, STATES, 1, 13)
    monkeypatch.setattr(torbi_tpu_torch, 'DECODE_MEMORY_BUDGET',
                        2 * 10 * STATES * 6)
    calls = sparse.viterbi_forward_sparse.pairs
    got = dispatch.decode(obs, bf, trans, init, device='cpu')
    lists = sparse.in_lists(torch.from_numpy(trans))
    # Two groups of two rows
    assert sparse.viterbi_forward_sparse.pairs - calls == (
        2 * lists.pairs * 2 * 10)
    assert np.array_equal(got.numpy(), viterbi_numpy(obs, bf, trans, init))


def test_layouts():
    assert sparse.forward_layout(5617, 8934) == {
        'threads': 1024, 'per': 6, 'staged': True, 'resident': True,
        'smem_bytes': 20 * 5617 + 6 * 8934 + 4 * 5618, 'cluster': 1,
        'slice': 5617, 'pairs': 8934, 'fits': True}
    assert sparse.chase_layout(5617, 8934) == {
        'threads': 256, 'resident': True, 'smem_bytes': 4 * 5618 + 2 * 8934}
    # The ring takes 12 bytes a state: past 11,622 states the values are
    # loaded on their frame
    assert sparse.forward_layout(11622, 0)['staged']
    wide = sparse.forward_layout(11623, 5000)
    assert not wide['staged'] and wide['resident'] and wide['per'] == 12
    assert wide['smem_bytes'] == 8 * 11623 + 6 * 5000 + 4 * 11624
    # pYIN's pairs do not fit beside its posterior and ring
    layout = sparse.forward_layout(1202, 232604)
    assert layout['staged'] and not layout['resident']
    assert layout['smem_bytes'] == 20 * 1202
    assert sparse.forward_layout(40, 50)['threads'] == 64
    assert sparse.MAX_STATES == 29056
    assert sparse.forward_layout(29056, 0)['per'] == 29


def test_in_lists_are_cached_and_ordered():
    trans = madmom()
    first = sparse.in_lists(trans)
    assert sparse.in_lists(trans) is first
    sources = first.sources.long()
    offsets = first.offsets.long()
    for j in (0, 1, 27, 28, 5616):
        got = sources[offsets[j]:offsets[j + 1]]
        assert torch.equal(got, torch.nonzero(
            trans[j] > float('-inf')).flatten())
        assert torch.equal(first.values[offsets[j]:offsets[j + 1]],
                           trans[j, got])
    trans.add_(0.0)
    assert sparse.in_lists(trans) is not first
