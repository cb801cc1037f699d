"""The launch plan of K1's wide-band design (``ops/band.py::wide_plan``)
and K1's choice of design, on the CPU.

The wide-band design (csrc/band_wide.cu) runs one persistent CTA per SM,
K2's plan restricted to the band: each CTA owns a slice of destinations
for a group of sequences and reads only its source window of the last
frame's posterior. The kernel itself runs only on the card (chip_smoke.py
holds it bitwise against its plain version there); here the plan is
checked for the invariants the kernel rests on, at shapes from the
kernel's main paths to its edges: every (sequence, destination) has
exactly one owner; each CTA's window, as the kernel computes it
(``wide_windows``), holds every in-band, in-range source of its
destinations, starts on 4 floats and fits the plan's window; the plan fits
the H100 (227 KB of opt-in shared memory, 132 SMs, 512 threads a CTA);
and it is the cheapest of the plans that fit.
"""
import numpy as np
import pytest

from torbi_tpu_torch.ops import band, dense

# The H100's SMs: one CTA each
SMS = 132

# (batch, states, width): the wide paths of chip_smoke.py (1 x 1440 at
# width 401, 512 x 1440 at the pitch band of a 20 ms hop, its auto-chunk
# rows at 8 sequences), the auto-chunk rows of the 10 ms pitch band,
# bands up to half the states (BAND_MAX_FRACTION), few states, a width-0
# band over a floor, 4096 states (no cluster layout holds any width) and
# 8200 (no resident slice fits a wide band)
SHAPES = (
    (1, 1440, 401), (8, 1440, 347), (512, 1440, 347), (8, 1440, 175),
    (512, 1440, 720), (3, 97, 61), (5, 37, 7), (37, 203, 11),
    (130, 2048, 601), (1, 37, 0), (2, 4096, 175), (1, 4096, 2048),
    (64, 8200, 175), (1, 8200, 4001))
IDS = [f'{b}x{s}w{w}' for b, s, w in SHAPES]


def band_positions(states, width):
    """lo of a band centred on the diagonal, one above it and one below
    it (touching the states from inside), for the window checks"""
    return sorted({-(width // 2), min(3, states - width),
                   max(-(states - 1), -width - 2)})


@pytest.mark.parametrize('batch, states, width', SHAPES, ids=IDS)
def test_plan_owns_every_output_once(batch, states, width):
    plan = band.wide_plan(batch, states, width, SMS)
    assert plan is not None
    count = np.zeros((batch, states), dtype=np.int64)
    for cta in range(plan['ctas']):
        g, d = divmod(cta, plan['dest_groups'])
        count[g * plan['bc']:(g + 1) * plan['bc'],
              d * plan['jc']:(d + 1) * plan['jc']] += 1
    assert (count == 1).all()
    # No group or slice past the outputs
    assert (plan['groups'] - 1) * plan['bc'] < batch
    assert (plan['dest_groups'] - 1) * plan['jc'] < states


@pytest.mark.parametrize('batch, states, width', SHAPES, ids=IDS)
def test_windows_cover_the_band(batch, states, width):
    """Each CTA's window holds every in-band source in [0, states) of its
    destinations, starts on 4 floats (16-byte copies where the states are
    a multiple of 4) and holds at most the plan's window of sources"""
    plan = band.wide_plan(batch, states, width, SMS)
    assert plan['window'] == dense.band_window(states, plan['jc'], width)
    assert plan['window'] % 4 == 0
    for lo in band_positions(states, width):
        windows = band.wide_windows(plan, states, lo, width)
        assert len(windows) == plan['dest_groups']
        for d, (first, sources) in enumerate(windows):
            assert first % 4 == 0 and sources % 4 == 0
            assert 0 <= first and first + sources <= -(-states // 4) * 4
            assert sources <= plan['window']
            j = np.arange(d * plan['jc'], min(states, (d + 1) * plan['jc']))
            i = (j[:, None] + lo + np.arange(width)[None, :]).ravel()
            i = i[(i >= 0) & (i < states)]
            assert ((i >= first) & (i < first + sources)).all(), (lo, d)


@pytest.mark.parametrize('batch, states, width', SHAPES, ids=IDS)
def test_plan_fits_the_card(batch, states, width):
    """Shared memory within 227 KB, as the kernel counts it (the slice
    over the window or two chunks of it, two chunks of posterior rows, the
    table of row maxima, the floor terms and batch_frames), at most one
    CTA per SM and
    512 threads, the tile's shapes and row strides of K2"""
    plan = band.wide_plan(batch, states, width, SMS)
    assert plan['smem_bytes'] <= dense.SMEM_BYTES == 232448
    assert plan['ctas'] == plan['groups'] * plan['dest_groups'] <= SMS
    assert plan['threads'] % 32 == 0
    assert plan['threads'] <= dense.MAX_THREADS == 512
    tile = dense.TILE
    cells = (plan['bp'] // tile) * (plan['jc'] // tile)
    assert cells * plan['split'] <= plan['threads']
    assert plan['bp'] % tile == 0 and plan['bc'] % plan['bp'] == 0
    assert plan['jc'] % tile == 0 and 32 % plan['split'] == 0
    assert plan['chunk'] % max(8, 4 * plan['split']) == 0
    assert plan['vec'] == (states % 4 == 0)
    chunk_stride = dense.chunk_stride(plan['chunk'])
    slice_stride = dense.slice_stride(
        plan['window'], plan['chunk'], plan['resident'])
    for stride in (chunk_stride, slice_stride):
        assert stride % 4 == 0 and (stride // 4) % 2 == 1
    if plan['resident']:
        assert slice_stride >= plan['window']
    assert plan['smem_bytes'] == 4 * (
        (1 if plan['resident'] else 2) * plan['jc'] * slice_stride
        + 2 * plan['bp'] * chunk_stride
        + plan['bp'] * plan['jc'] // tile + 2 * plan['bc'])


@pytest.mark.parametrize('batch, states, width', SHAPES, ids=IDS)
def test_plan_is_the_cheapest(batch, states, width):
    """wide_plan takes the least modelled cost of every plan that fits;
    the cost counts the window's sources where K2's counts the states"""
    plans = list(band.wide_plans(batch, states, width, SMS))
    chosen = band.wide_plan(batch, states, width, SMS)
    assert chosen in plans
    assert chosen['cost'] == min(plan['cost'] for plan in plans)
    window = chosen['window']
    if window:
        assert chosen['cost'] >= 2 * chosen['bc'] * chosen['jc'] * window / (
            dense.FP32_PER_CLOCK)


@pytest.mark.parametrize('batch, states, width, resident', [
    (1, 1440, 401, True), (2, 4096, 175, True), (1, 8200, 4001, False)])
def test_slice_mode(batch, states, width, resident):
    """The band slice stays resident wherever it fits; at 8200 states a
    band of half the states leaves no resident layout, and it streams"""
    assert band.wide_plan(batch, states, width, SMS)['resident'] == resident


def test_dense_plans_carry_no_window():
    """Without a band, dense_plans gives K2's plans: no window, and the
    shared memory of K2's layout (no table of row maxima)"""
    for plan in dense.dense_plans(512, 1280, SMS):
        assert 'window' not in plan
        assert plan['smem_bytes'] == 4 * (
            (1 if plan['resident'] else 2) * plan['jc'] * dense.slice_stride(
                1280, plan['chunk'], plan['resident'])
            + 2 * plan['bp'] * dense.chunk_stride(plan['chunk']))


@pytest.mark.parametrize('states, width, kernel', [
    (1440, 175, 'band_forward'), (1440, 261, 'band_forward'),
    (1440, 301, 'band_forward'), (1440, 302, 'band_forward_wide'),
    (1440, 347, 'band_forward_wide'), (1440, 401, 'band_forward_wide'),
    (1440, 720, 'band_forward_wide'), (4096, 175, 'band_forward_wide'),
    (37, 0, 'band_forward_wide')])
def test_forward_kernel_routes(states, width, kernel):
    """The cluster design wherever a cluster layout fits (at 1440 states
    up to width 301, so the pitch band's routes stay), the wide-band
    design elsewhere: wider bands, 4096 states, a width-0 band"""
    name, fn = band.forward_kernel(states, width)
    assert name == kernel
    assert fn is {'band_forward': band.viterbi_forward_band,
                  'band_forward_wide': band.viterbi_forward_band_wide}[name]
    assert bool(band.cluster_sizes(states, width)) == (
        kernel == 'band_forward')


def test_band_timing_runs_the_plain_versions_on_cpu():
    """The timing script's --band option runs end to end on CPU tensors:
    K1 in the design forward_kernel picks (the plain version here) and K2
    on the same transition as a dense matrix give equal streams, and the
    decode through from_probabilities is timed"""
    from torbi_tpu_torch.scripts import dense_timing

    rows = dense_timing.main(['--device', 'cpu', '--shapes', '2x9x64',
                              '--band', '12', '--decode', '--iters', '1'])
    assert len(rows) == 1
    row = rows[0]
    assert (row['shape'], row['band_lo'], row['band_width']) == (
        '2x9x64', -12, 25)
    assert row['forward'] == band.forward_kernel(64, 25)[0]
    assert row['equal_to_k2'] and not row['kernel']
    assert row['device'] == 'cpu' and row['decode_ms'] > 0



def test_batch_fixture_reaches_the_straight_run_outputs():
    """The fixture case wide-batch-prob (192 sequences at width 347) gets
    a plan with fewer than four lanes an output on 132 SMs: the kernel's
    straight-run conversion branch (split < 4), which the edge list and
    the smaller wide cases (split 32) do not reach, so that chip_smoke.py
    holds that branch against torbi_tpu's paths in probability space"""
    from torbi_tpu_torch.utils import edges, fixtures

    case = {case.name: case for case in fixtures.CASES}['wide-batch-prob']
    obs, _, trans, _ = fixtures.case_inputs(case)
    assert case.name in fixtures.WIDE and not case.log_probs
    batch, _, states = obs.shape
    with np.errstate(divide='ignore'):
        width = band.detect_band(np.log(trans))[1]
    assert band.forward_kernel(states, width)[0] == 'band_forward_wide'
    assert band.wide_plan(batch, states, width, SMS)['split'] < 4
    for edge in edges.BAND_EDGES:
        assert band.wide_plan(
            edge.batch, edge.states, edge.width, SMS)['split'] >= 4
