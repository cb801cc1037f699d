"""The serial batch-1 route's two kernels redesigned for the H100: K5's two
phases and K4's layout mirror, on the CPU.

K5 runs as a parallel pass of backpointers from the gated band (phase 1,
``backtrace_pointers_reference``) and a blocked chase of them (phase 2,
``chase_pointers_reference``); ``backtrace_fused1`` on CPU tensors runs
both. Phase 1 is held bitwise against a brute-force argmax over the full
transition row, phase 2 against the step-by-step chase
(``backtrace_reference``) at several block sizes, and the route against
torbi_tpu's fused chase (``dispatch.decode(..., backend='pallas')`` in
interpret mode, as tests/test_torch_batch1.py runs it). K4's layout mirror
(``band.spread_layout``, ``band.spread_exchange``) is checked for the
invariants its exchange rests on. Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torbi_tpu
import torbi_tpu_torch
from torbi_tpu.ops import dispatch as jax_dispatch
from torbi_tpu.ops import oracle
from torbi_tpu.ops.dispatch import decode as jax_decode
from torbi_tpu_torch.ops import backtrace, band, dispatch
from torbi_tpu_torch.utils import edges

TINY = np.finfo(np.float32).tiny


def band_transition(rng, states, lo, width, floor, ties):
    """A transition whose band is exactly (lo, width) over a log(tiny)
    floor (or -inf); ``ties`` draws small integers, so that candidates tie"""
    exterior = np.log(np.float32(TINY)) if floor else -np.inf
    trans = np.full((states, states), exterior, dtype=np.float32)
    rows = np.arange(states)
    for d in range(width):
        cols = rows + lo + d
        keep = (cols >= 0) & (cols < states)
        if ties:
            values = rng.integers(-3, 0, size=int(keep.sum()))
        else:
            values = np.log(rng.uniform(0.05, 1.0, size=int(keep.sum())))
        trans[rows[keep], cols[keep]] = values.astype(np.float32)
    return trans


# name: (states, frames, lo, width, floor, ties, rows of -inf)
POINTER_CASES = {
    'floor': (64, 12, -5, 11, True, False, ()),
    'pure': (64, 12, -5, 11, False, False, ()),
    'asymmetric-above': (37, 10, 2, 9, True, False, ()),
    'asymmetric-pure': (37, 10, 0, 6, False, False, ()),
    'below-diagonal': (50, 9, -20, 8, True, False, ()),
    'edge-clipped-wide': (96, 8, -60, 41, True, False, ()),
    'ties-floor': (40, 14, -4, 9, True, True, ()),
    'ties-pure': (40, 14, -4, 9, False, True, ()),
    'inf-rows-floor': (33, 11, -3, 7, True, False, (2, 6)),
    'inf-rows-pure': (33, 11, -3, 7, False, False, (0, 6)),
}


def pointer_case(name, seed=3):
    states, frames, lo, width, floor, ties, inf_rows = POINTER_CASES[name]
    rng = np.random.default_rng(seed)
    trans = band_transition(rng, states, lo, width, floor, ties)
    if ties:
        post = rng.integers(-2, 1, size=(1, frames, states))
    else:
        post = rng.standard_normal((1, frames, states))
    post = post.astype(np.float32)
    for row in inf_rows:
        post[0, row] = -np.inf
    return post, trans


def brute_force_pointers(post, trans, top):
    """bp[t, j] = first argmax_i (post[t-1, i] + trans[j, i]), t <= top"""
    frames, states = post.shape[1:]
    table = np.zeros((frames, states), np.int16)
    for t in range(1, top + 1):
        scores = torch.from_numpy(post[0, t - 1][None, :] + trans)
        table[t] = scores.argmax(dim=1).numpy()
    return table


@pytest.mark.parametrize('name', list(POINTER_CASES))
def test_pointers_match_brute_force(name):
    """Phase 1's plain version from the gated band equals the argmax over
    the whole transition row, bitwise: floor and pure bands, asymmetric and
    edge-clipped ones, ties, rows of -inf (index 0)"""
    post, trans = pointer_case(name)
    trans_t = torch.from_numpy(trans)
    band_tuple = band.detect_band(trans_t)
    states, frames, lo, width, floor = POINTER_CASES[name][:5]
    assert band_tuple[:2] == (lo, width)
    assert (band_tuple[2] is None) == (not floor)
    matrix = band.build_band_matrix(trans_t, lo, width)
    lengths = (frames, frames - 3)
    for length in lengths:
        batch_frames = torch.tensor([length], dtype=torch.int32)
        got = backtrace.backtrace_pointers_reference(
            torch.from_numpy(post), band_tuple, matrix, batch_frames)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(
            got.numpy(), brute_force_pointers(post, trans, length - 1))
    # The dense form of the same transition gives the same table
    dense = backtrace.backtrace_pointers_reference(
        torch.from_numpy(post), backtrace.full_band(states),
        band.build_band_matrix(trans_t, *backtrace.full_band(states)[:2]),
        torch.tensor([frames], dtype=torch.int32))
    np.testing.assert_array_equal(
        dense.numpy(), brute_force_pointers(post, trans, frames - 1))


@pytest.mark.parametrize('block', [1, 7, 64, None])
@pytest.mark.parametrize('length', ['one', 'below', 'equal'])
def test_blocked_chase_matches_step_by_step(block, length):
    """Phase 2's plain version, at block sizes 1, 7, 64 and every frame in
    one block, gives the step-by-step chase's path, with batch_frames 1,
    below the frames and equal to them (a frozen tail holds the seed)"""
    post, trans = pointer_case('ties-floor', seed=5)
    frames = post.shape[1]
    trans_t = torch.from_numpy(trans)
    band_tuple = band.detect_band(trans_t)
    matrix = band.build_band_matrix(trans_t, band_tuple[0], band_tuple[1])
    value = {'one': 1, 'below': frames - 5, 'equal': frames}[length]
    batch_frames = torch.tensor([value], dtype=torch.int32)
    post_t = torch.from_numpy(post)
    table = backtrace.backtrace_pointers_reference(
        post_t, band_tuple, matrix, batch_frames)
    got = backtrace.chase_pointers_reference(
        table, post_t[:, -1], batch_frames, block)
    expected = backtrace.backtrace_reference(
        post_t, trans_t, post_t[:, -1], batch_frames)
    assert got.dtype == torch.int32
    torch.testing.assert_close(got, expected, rtol=0, atol=0)


@pytest.mark.parametrize('edge', edges.CHASE_EDGES, ids=lambda e: e.name)
def test_fused_chase_on_chase_edges(edge):
    """K5's CPU route (both phases, a dense transition as every offset) on
    the chase edges, one sequence at a time: ties and rows of -inf"""
    post, trans, lengths = (
        torch.from_numpy(a) for a in edges.chase_edge_inputs(edge))
    for b in range(edge.batch):
        seq = post[b:b + 1].contiguous()
        bf = lengths[b:b + 1].contiguous()
        torch.testing.assert_close(
            backtrace.backtrace_fused1(seq, trans, seq[:, -1], bf),
            backtrace.backtrace_reference(seq, trans, seq[:, -1], bf),
            rtol=0, atol=0)


def serial_case(with_floor, seed):
    """A single sequence over an asymmetric triangular band (the spread
    case of tests/test_parity.py), 61 frames of 128 states, a ragged end"""
    frames, states, halfwidth = 61, 128, 7
    rng = np.random.default_rng(seed)
    obs = np.log(rng.dirichlet(np.ones(states), size=(1, frames))
                 .astype(np.float32) + TINY).astype(np.float32)
    xx, yy = np.meshgrid(np.arange(states), np.arange(states), indexing='ij')
    probs = np.clip(halfwidth + 1.0 - np.abs(xx - yy + 2), 0, None)
    probs = (probs / probs.sum(axis=1, keepdims=True)).astype(np.float32)
    with np.errstate(divide='ignore'):
        trans = (np.log(probs + TINY) if with_floor
                 else np.log(probs)).astype(np.float32)
    init = np.log(np.full(states, 1.0 / states, dtype=np.float32) + TINY)
    return obs, np.array([47], np.int32), trans, init.astype(np.float32)


@pytest.mark.parametrize('with_floor', [False, True])
def test_serial_route_matches_jax_fused_chase(monkeypatch, with_floor):
    """The serial route (K4, then K5 in two phases) on the CPU returns
    torbi_tpu's path through its spread forward and fused chase, and the
    oracle's"""
    for package in (torbi_tpu, torbi_tpu_torch):
        for name, value in (('BAND_BATCH1_SPREAD', True),
                            ('BACKTRACE_BATCH1_FUSED', True)):
            monkeypatch.setattr(package, name, value, raising=False)
    monkeypatch.setattr(
        torbi_tpu, 'BAND_KERNEL_LAYOUT', 'stitched', raising=False)
    calls = []
    for module, name in ((band, 'viterbi_forward_band_spread'),
                         (dispatch, 'backtrace_fused1'),
                         (backtrace, 'backtrace_pointers'),
                         (backtrace, 'chase_pointers')):
        orig = getattr(module, name)

        def spy(*args, _orig=orig, _name=name, **kwargs):
            calls.append(_name)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)
    obs, bf, trans, init = serial_case(with_floor, seed=17)
    got = dispatch.decode(
        torch.from_numpy(obs), torch.from_numpy(bf), torch.from_numpy(trans),
        torch.from_numpy(init), finite_observation=True, device='cpu')
    assert calls == ['viterbi_forward_band_spread', 'backtrace_fused1',
                     'backtrace_pointers', 'chase_pointers']
    expected = np.asarray(jax_decode(
        jnp.asarray(obs), jnp.asarray(bf), jnp.asarray(trans),
        jnp.asarray(init), backend='pallas', finite_observation=True))
    np.testing.assert_array_equal(got.numpy(), expected)
    np.testing.assert_array_equal(
        expected, oracle.viterbi_numpy(obs, bf, trans, init))


# K4's layout on the band edges, at the pitch band, at its widest bands
# (centred and asymmetric) and on windows far from the diagonal:
# (states, lo, width)
LAYOUT_SHAPES = [
    (edge.states, edge.lo, edge.width) for edge in edges.BAND_EDGES] + [
    (1440, -87, 175), (1440, -96, 192), (1440, -128, 256), (1440, 0, 256),
    (1440, 0, 40), (1440, -300, 50), (37, -3, 64)]


@pytest.mark.parametrize('shape', LAYOUT_SHAPES, ids=str)
def test_spread_layout_invariants(shape):
    """K4's layout mirror: every destination is owned once; the slices a
    CTA receives cover every source its window reads, each landing where
    the CTA reads it; the bytes each CTA expects equal the bytes sent to
    it; the register tile and the shared memory fit"""
    states, lo, width = shape
    cluster = band.SPREAD_CLUSTER
    layout = band.spread_layout(states, width, lo)
    p = layout['per_cta']
    assert p % 4 == 0 and layout['groups'] * 4 == p
    assert layout['threads'] >= layout['groups'] * band.SPREAD_LANES
    owners = np.zeros(states, int)
    for r in range(cluster):
        for jl in range(p):
            if r * p + jl < states:
                owners[r * p + jl] += 1
    assert (owners == 1).all()
    receivers, expected = band.spread_exchange(states, width, lo)
    landing = {}
    for q, targets in enumerate(receivers):
        for r, slot in targets:
            assert 0 <= slot < layout['slices']
            landing[(r, q)] = slot
    for r in range(cluster):
        for jl in range(min(p, max(0, states - r * p))):
            for d in range(width):
                source = r * p + jl + lo + d
                if not 0 <= source < states:
                    continue
                q = source // p
                index = jl + d + layout['offset']
                assert index < layout['window']
                assert landing[(r, q)] * p + source - q * p == index
    sent = [cluster * 4] * cluster
    for targets in receivers:
        for r, _ in targets:
            sent[r] += p * 4
    assert sent == expected
    for tile, threads in band.SPREAD_TILES.items():
        assert threads * (4 * tile + band.SPREAD_REGISTER_OVERHEAD) <= 65536
    if layout['fits']:
        assert layout['run'] <= layout['dmax']
        assert layout['threads'] <= band.SPREAD_TILES[layout['dmax']]
        assert layout['smem_bytes'] <= band.SPREAD_SMEM_BYTES


def test_exchange_probe_computes_spread_sync():
    """The spread lab's exchange probe (spread_async) computes
    spread_sync's function; it takes no other"""
    from torbi_tpu_torch.scripts import kernel_lab

    obs, lab_band = kernel_lab.lab_inputs(1, 6, 96, 9, 'cpu')
    want = kernel_lab.spread_reference(obs[0], lab_band, 9, sync_only=True)
    for cluster in kernel_lab.CLUSTERS:
        torch.testing.assert_close(
            kernel_lab.lab_spread(obs[0], lab_band, 9, cluster, True,
                                  'async'), want, rtol=0, atol=0)
    assert kernel_lab.parse_spec('spread_async:16')[:2] == (
        'spread_async', 16)
    with pytest.raises(ValueError, match='sync_only'):
        kernel_lab.lab_spread(obs[0], lab_band, 9, 8, False, 'async')


# The window route (K6): K5's two phases on a pure -inf band, without the
# floor pass. name: (states, frames, batch_frames, lo, width)
WINDOW_CASES = {
    'symmetric': (256, 40, 33, -7, 15),
    'asymmetric': (384, 36, 36, 0, 9),
    'edge-cut': (256, 30, 24, -60, 121),
}


@pytest.mark.parametrize('name', list(WINDOW_CASES))
def test_window_route_matches_jax_window_chase(monkeypatch, name):
    """The window route on the CPU runs K6's phases as their plain versions
    (phase 1 from the pure band, then the blocked chase) and returns
    torbi_tpu's path through its window chase, and the oracle's, bitwise:
    a symmetric band, an asymmetric one (lo >= 0) and one cut by the state
    edges"""
    states, frames, length, lo, width = WINDOW_CASES[name]
    for package in (torbi_tpu, torbi_tpu_torch):
        for knob, value in (('BACKTRACE_BATCH1_FUSED', False),
                            ('BACKTRACE_BATCH1_WINDOW', True),
                            ('BATCH1_AUTO_CHUNK', False)):
            monkeypatch.setattr(package, knob, value, raising=False)
    monkeypatch.setattr(
        torbi_tpu, 'BAND_KERNEL_LAYOUT', 'stitched', raising=False)
    calls = []
    for module, fn in ((dispatch, 'backtrace_window'),
                       (backtrace, 'backtrace_pointers'),
                       (backtrace, 'window_pointers'),
                       (backtrace, 'backtrace_pointers_reference'),
                       (backtrace, 'chase_pointers'),
                       (backtrace, 'chase_pointers_reference')):
        orig = getattr(module, fn)

        def spy(*args, _orig=orig, _name=fn, **kwargs):
            calls.append(_name)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(module, fn, spy)
    rng = np.random.default_rng(states + width)
    trans = band_transition(rng, states, lo, width, floor=False, ties=False)
    obs = np.log(rng.dirichlet(np.ones(states), size=(1, frames))
                 .astype(np.float32) + TINY).astype(np.float32)
    bf = np.array([length], np.int32)
    init = np.log(np.full(states, 1.0 / states, dtype=np.float32) + TINY)
    assert band.detect_band(torch.from_numpy(trans)) == (lo, width, None)
    # torbi_tpu takes its window chase on this band
    assert jax_dispatch._use_window_chase(
        (lo, width, None), -(-states // 128) * 128, True)
    got = dispatch.decode(
        torch.from_numpy(obs), torch.from_numpy(bf), torch.from_numpy(trans),
        torch.from_numpy(init), finite_observation=True, device='cpu')
    assert calls == ['backtrace_window', 'window_pointers',
                     'backtrace_pointers_reference', 'chase_pointers',
                     'chase_pointers_reference']
    expected = np.asarray(jax_decode(
        jnp.asarray(obs), jnp.asarray(bf), jnp.asarray(trans),
        jnp.asarray(init), backend='pallas', finite_observation=True))
    np.testing.assert_array_equal(got.numpy(), expected)
    np.testing.assert_array_equal(
        expected, oracle.viterbi_numpy(obs, bf, trans, init))
    # K6's phases on the forward stream against its function-level plain
    # version (the full chase)
    trans_t = torch.from_numpy(trans)
    post_seq, posterior = band.band_forward_reference(
        torch.from_numpy(obs), torch.from_numpy(bf), torch.from_numpy(init),
        (lo, width, None), band.build_band_matrix(trans_t, lo, width))
    torch.testing.assert_close(
        backtrace.backtrace_window(post_seq, trans_t, posterior,
                                   torch.from_numpy(bf), (lo, width, None)),
        backtrace.backtrace_window_reference(
            post_seq, trans_t, posterior, torch.from_numpy(bf),
            (lo, width, None)), rtol=0, atol=0)
