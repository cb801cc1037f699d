"""The edge shapes of K1's layouts and K3's reduction, and the choice of
K1's design, on the CPU.

The edge list (torbi_tpu_torch/utils/edges.py) is the one chip_smoke.py
runs through the kernels on the card. Here every case goes through the
plain versions and torbi_tpu's kernels (interpret mode, padded as its
dispatcher pads them), bitwise. The layout mirror (ops/band.py
cluster_layout, cluster_plan, forward_kernel) is checked at the pitch
shape, a band too wide for any cluster layout and small state counts, and
dispatch is checked to name the design it runs.
Tolerance: bitwise everywhere.
"""
import numpy as np
import pytest
import torch

from test_torch_backtrace import jax_indices
from test_torch_band import jax_forward
from torbi_tpu_torch.ops import backtrace, band, dispatch
from torbi_tpu_torch.utils import edges

TINY = np.finfo(np.float32).tiny


def h100(sequences):
    """The clusters of 8 CTAs an H100 (132 SMs) holds at once at every
    cluster size of the tile table (band.resident_clusters on the card)"""
    return 15


def triangular(states, halfwidth):
    bins = np.arange(states)
    tri = np.clip(halfwidth + 1.0 - np.abs(bins[:, None] - bins[None, :]),
                  0, None)
    return np.log((tri / tri.sum(axis=1, keepdims=True)).astype(np.float32)
                  + TINY).astype(np.float32)


@pytest.mark.parametrize('edge', edges.BAND_EDGES, ids=lambda e: e.name)
def test_band_edges_match_jax(edge):
    """The plain K1, both wrappers on CPU tensors at every cluster size,
    and the plain K3 on the stream, bitwise torbi_tpu's"""
    obs, bf, trans, init = edges.band_edge_inputs(edge)
    band_tuple = band.detect_band(torch.from_numpy(trans))
    floor = float(np.float32(np.log(TINY))) if edge.floor else None
    assert band_tuple == (edge.lo, edge.width, floor)
    assert band.gate_band(band_tuple, torch.from_numpy(init),
                          finite_observation=True) == band_tuple
    expected_seq, expected_post = jax_forward(obs, bf, trans, init,
                                              band_tuple)
    matrix = band.build_band_matrix(
        torch.from_numpy(trans), edge.lo, edge.width)
    args = (torch.from_numpy(obs), torch.from_numpy(bf),
            torch.from_numpy(init), band_tuple, matrix)
    post_seq, posterior = band.band_forward_reference(*args)
    np.testing.assert_array_equal(post_seq.numpy(), expected_seq)
    np.testing.assert_array_equal(posterior.numpy(), expected_post)
    assert torch.equal(band.viterbi_forward_band(*args)[0], post_seq)
    for sequences in band.CLUSTER_TILES:
        got, _ = band._forward_band_clusters(*args, sequences)
        assert torch.equal(got, post_seq)
    assert torch.equal(band.viterbi_forward_band_wide(*args)[0], post_seq)
    seq = post_seq.numpy()
    got = backtrace.backtrace_reference(
        post_seq, torch.from_numpy(trans), posterior, torch.from_numpy(bf))
    np.testing.assert_array_equal(got.numpy(), jax_indices(seq, trans, bf))


@pytest.mark.parametrize('edge', edges.CHASE_EDGES, ids=lambda e: e.name)
def test_chase_edges_match_jax(edge):
    """The plain K3 and its wrapper on CPU tensors on exact ties and rows
    of -inf, bitwise torbi_tpu's"""
    post_seq, trans, bf = edges.chase_edge_inputs(edge)
    seq = torch.from_numpy(post_seq)
    args = (seq, torch.from_numpy(trans), seq[:, -1], torch.from_numpy(bf))
    got = backtrace.backtrace_reference(*args)
    assert torch.equal(backtrace.backtrace_posteriors(*args), got)
    expected = jax_indices(post_seq, trans, bf)
    np.testing.assert_array_equal(got.numpy(), expected)
    if edge.kind == 'ties':
        assert len(np.unique(expected)) > 1
    else:
        # The chase from frame 4 reads the -inf row 3
        assert (expected[bf > 4, 3] == 0).all()


def test_edge_lists_cover_the_layouts():
    """Every cluster size runs each band edge on the card; the list holds a
    band wider than a slice, bands off the diagonal on both sides, a batch
    that the larger cluster sizes do not divide, and length 1"""
    slices = {edge.name: band.cluster_layout(
        edge.states, edge.width, 32)['per_cta'] for edge in edges.BAND_EDGES}
    assert any(edge.width > slices[edge.name] for edge in edges.BAND_EDGES)
    assert any(edge.lo > 0 for edge in edges.BAND_EDGES)
    assert any(edge.lo + edge.width <= 0 for edge in edges.BAND_EDGES)
    assert any(edge.states % 8 for edge in edges.BAND_EDGES)
    for sequences in band.CLUSTER_TILES:
        if sequences > 1:
            assert any(edge.batch % sequences for edge in edges.BAND_EDGES)
    for edge in edges.BAND_EDGES:
        for sequences in band.CLUSTER_TILES:
            assert band.cluster_layout(
                edge.states, edge.width, sequences)['fits']
    assert any(1 in edges.band_edge_inputs(edge)[1]
               for edge in edges.BAND_EDGES)


@pytest.mark.parametrize('batch, plan', [
    (8, ((0, 8, 1),)),
    (16, ((0, 16, 4),)),
    (64, ((0, 64, 8),)),
    (96, ((0, 96, 8),)),
    (128, ((0, 128, 16),)),
    (512, ((0, 480, 32), (480, 32, 4))),
    (1024, ((0, 960, 32), (960, 64, 8))),
    (256, ((0, 256, 32),))])
def test_cluster_plan_pitch(batch, plan):
    """At 1440 states and the pitch band (width 175), 15 clusters held at
    once: the auto-chunk rows (batch 8) take 8 clusters of one sequence;
    the headline (batch 512) one whole wave of 15 clusters of 32, then 32
    sequences in 8 clusters of 4 (one wave, cheaper than 3 waves of 1 or a
    wave of 32); a batch of less than a wave of 32s, or such a rest, runs
    in one wave of clusters of 8 (64, 96 rows) or 16 (128 rows: 3 waves of
    clusters of 4 before the sizes between 4 and 32)"""
    assert band.cluster_plan(batch, 1440, 175, h100) == plan
    assert band.forward_kernel(1440, 175) == (
        'band_forward', band.viterbi_forward_band)
    # A card that holds 4 clusters at once: whole waves of 4 clusters of 32
    if batch % 128 == 0:
        assert band.cluster_plan(batch, 1440, 175, lambda sequences: 4) == (
            (0, batch, 32),)


@pytest.mark.parametrize('sequences, threads, smem', [
    (1, 736, 142_988), (4, 192, 137_680), (8, 192, 150_080),
    (16, 384, 173_824), (32, 384, 222_368)])
def test_cluster_layout_pitch(sequences, threads, smem):
    """Each CTA owns 180 of the 1440 destinations; the largest tile's band
    slice and 32 sequences' windows fill 217 KB of the 227 KB"""
    assert band.cluster_layout(1440, 175, sequences) == {
        'per_cta': 180, 'threads': threads, 'smem_bytes': smem,
        'fits': True}


@pytest.mark.parametrize('width, batch1, batch512', [
    (259, ((0, 1, 1),), ((0, 480, 8), (480, 32, 4))),
    (301, ((0, 1, 4),), ((0, 512, 4),)),
    (401, None, None)])
def test_cluster_plan_wide_bands(width, batch1, batch512):
    """Wider bands take fewer sequences per cluster (at most 8 at width
    259, 4 at 301); at width 401 no cluster layout fits 1440 states and the
    wide-band design runs"""
    assert band.cluster_plan(1, 1440, width, h100) == batch1
    assert band.cluster_plan(512, 1440, width, h100) == batch512
    if batch1 is None:
        assert band.forward_kernel(1440, width) == (
            'band_forward_wide', band.viterbi_forward_band_wide)


def test_cluster_layout_small_states():
    """Few states: a CTA's slice rounds up to the thread tile, so the last
    CTAs of the cluster may own nothing; a width-0 band takes the wide-band
    design"""
    assert band.cluster_layout(37, 7, 1)['per_cta'] == 5
    assert band.cluster_layout(37, 7, 32)['per_cta'] == 8
    assert band.cluster_layout(37, 7, 4)['per_cta'] == 5
    assert band.cluster_plan(5, 37, 7, h100) == ((0, 5, 1),)
    assert band.cluster_plan(40, 37, 7, h100) == ((0, 40, 4),)
    assert not band.cluster_layout(37, 0, 4)['fits']
    assert band.forward_kernel(37, 0)[0] == 'band_forward_wide'
    # 4096 states: the band slice alone passes 227 KB
    assert band.cluster_plan(512, 4096, 175, h100) is None


def test_size_launch_counter():
    """Beside K1's launch count, a count per cluster size, one entry for
    every size of the tile table, none yet on the CPU (the plain version
    launches nothing)"""
    obs = torch.zeros((2, 3, 4))
    band.viterbi_forward_band(
        obs, torch.full((2,), 3, dtype=torch.int32), torch.zeros(4),
        (0, 1, None), torch.zeros((1, 4)))
    assert band.viterbi_forward_band.size_launches == dict.fromkeys(
        band.CLUSTER_TILES, 0)


def test_forward_wrapper_rejects_sequences():
    obs = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match='sequences per cluster'):
        band._forward_band_clusters(
            obs, torch.ones(1, dtype=torch.int32), torch.zeros(4),
            (0, 1, None), torch.zeros((1, 4)), 3)


@pytest.mark.parametrize('batch, halfwidth, expected', [
    (3, 3, 'band_forward'), (3, 200, 'band_forward_wide'),
    (8, 87, 'band_forward')])
def test_kernel_route_names_design(monkeypatch, batch, halfwidth, expected):
    """dispatch.kernel_route names the design of K1 that decode runs on the
    same input, and decode's path equals the plain scan route"""
    states, frames = 1440, 5
    rng = np.random.default_rng(halfwidth)
    obs = torch.from_numpy(np.log(
        rng.dirichlet(np.ones(states), size=(batch, frames))
        .astype(np.float32) + TINY))
    trans = torch.from_numpy(triangular(states, halfwidth))
    init = torch.full((states,), float(np.log(1.0 / states + TINY)))
    bf = torch.full((batch,), frames, dtype=torch.int32)
    calls = []
    for attr, name in (('viterbi_forward_band', 'band_forward'),
                       ('viterbi_forward_band_wide', 'band_forward_wide')):
        def spy(*args, _orig=getattr(band, attr), _name=name, **kwargs):
            calls.append(_name)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(band, attr, spy)
    gated = band.gate_band(band.detect_band(trans), init,
                           finite_observation=True)
    (forward_name, _), (chase_name, _) = dispatch.kernel_route(
        trans, gated, batch)
    assert (forward_name, chase_name) == (expected, 'backtrace')
    out = dispatch.decode(obs, bf, trans, init, finite_observation=True,
                          device='cpu')
    assert calls == [expected]
    scan = dispatch.decode(obs, bf, trans, init, backend='scan',
                           device='cpu')
    assert torch.equal(out, scan)
