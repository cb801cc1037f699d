"""K2's launch plan (``ops/dense.py::dense_plan``) on the CPU.

The dense forward kernel (csrc/dense_forward.cu) runs one persistent CTA
per SM; the plan splits the (batch x states) outputs of every frame into
sequence groups and destination slices. The kernel itself runs only on the
card (chip_smoke.py holds it bitwise against its plain version there);
here the plan is checked for the invariants the kernel rests on: every
(sequence, destination) has exactly one owner, and the plan fits the
H100's 227 KB of opt-in shared memory and its 512 threads a CTA, with
the row strides its 16-byte shared loads need.
"""
import numpy as np
import pytest

from torbi_tpu_torch.ops import dense

# The H100's SMs: one CTA each
SMS = 132


def owners(plan, batch, states):
    """The number of CTAs that own each (sequence, destination) under
    ``plan``, by the kernel's indexing: CTA (g, d) owns sequences
    [g bc, g bc + bc) and destinations [d jc, d jc + jc)"""
    count = np.zeros((batch, states), dtype=np.int64)
    for cta in range(plan['ctas']):
        g, d = divmod(cta, plan['dest_groups'])
        count[g * plan['bc']:(g + 1) * plan['bc'],
              d * plan['jc']:(d + 1) * plan['jc']] += 1
    return count


@pytest.mark.parametrize('states', [
    3, 96, 256, 1201, 1202, 1203, 1280, 1440, 2048])
@pytest.mark.parametrize('batch', [1, 3, 8, 130, 512])
def test_plan_owns_every_output_once(batch, states):
    plan = dense.dense_plan(batch, states, SMS)
    assert plan is not None
    assert (owners(plan, batch, states) == 1).all()
    assert plan['ctas'] == plan['groups'] * plan['dest_groups'] <= SMS
    assert plan['smem_bytes'] <= dense.SMEM_BYTES
    tile = dense.TILE
    assert plan['bp'] % tile == 0 and plan['bc'] % plan['bp'] == 0
    assert plan['jc'] % tile == 0
    # No group or slice past the outputs
    assert (plan['groups'] - 1) * plan['bc'] < batch
    assert (plan['dest_groups'] - 1) * plan['jc'] < states
    cells = (plan['bp'] // tile) * (plan['jc'] // tile)
    assert plan['threads'] % 32 == 0
    assert cells * plan['split'] <= plan['threads'] <= dense.MAX_THREADS
    assert 32 % plan['split'] == 0
    assert plan['chunk'] % max(8, 4 * plan['split']) == 0
    # One staging path, 16-byte copies over the states rounded up to 4: no
    # choice of copies or loads left in the plan; every staged row stride
    # a multiple of 4 floats (the stream's rows where the states are one,
    # read in place; else the padded transition's and the exchange's), and
    # every chunk, the last one too, whole groups of 4 sources
    assert 'vec' not in plan
    sources = dense.sources(states)
    assert 0 <= sources - states < 4
    strides = (sources, 2 * sources) if states % 4 else (states, states)
    assert all(stride % 4 == 0 for stride in strides)
    last = sources - (-(-sources // plan['chunk']) - 1) * plan['chunk']
    assert 0 < last <= plan['chunk'] and last % 4 == 0
    # Shared row strides: 16-byte rows, an odd number of 16-byte words each
    # (8 consecutive rows on 32 banks), the slice's rows whole when resident
    chunk_stride = dense.chunk_stride(plan['chunk'])
    slice_stride = dense.slice_stride(
        states, plan['chunk'], plan['resident'])
    for stride in (chunk_stride, slice_stride):
        assert stride % 4 == 0 and (stride // 4) % 2 == 1
    if plan['resident']:
        assert slice_stride >= states
    assert plan['smem_bytes'] == 4 * (
        (1 if plan['resident'] else 2) * plan['jc'] * slice_stride
        + 2 * plan['bp'] * chunk_stride)


def test_throughput_plan_shares_the_transition():
    """At 512 x 1280 each CTA reads its slice of the transition once a
    frame for many sequences, on nearly every SM"""
    plan = dense.dense_plan(512, 1280, SMS)
    assert plan['bc'] >= 64
    assert plan['ctas'] >= 120


@pytest.mark.parametrize('streamed', [False, True])
def test_plan_options_hold_the_plan(streamed):
    """dense_plans holds a plan of each slice mode at 4 groups, each
    owning every output once"""
    plan = next(plan for plan in dense.dense_plans(512, 1280, SMS)
                if plan['groups'] == 4 and plan['resident'] != streamed)
    assert (owners(plan, 512, 1280) == 1).all()
    assert plan['smem_bytes'] <= dense.SMEM_BYTES


@pytest.mark.parametrize('batch, states', [
    (8, 1440), (512, 1280), (130, 96), (130, 2048), (3, 97)])
def test_plan_weighs_every_plan(batch, states):
    """dense_plan takes the least cost of every plan that fits, both
    slice modes weighed at each group count"""
    plans = list(dense.dense_plans(batch, states, SMS))
    chosen = dense.dense_plan(batch, states, SMS)
    assert chosen['cost'] == min(plan['cost'] for plan in plans)
    assert chosen in plans
    counts = {plan['groups'] for plan in plans}
    assert any(sum(plan['groups'] == groups for plan in plans) == 2
               for groups in counts)


@pytest.mark.parametrize('batch, states, resident', [
    (8, 1440, True), (1, 2048, True), (3, 97, True), (512, 1280, False),
    (130, 2048, False)])
def test_plan_slice_mode(batch, states, resident):
    """The slice stays resident where it leaves room for whole-row chunks
    (a small batch) and streams where it would leave short chunks (a large
    one), as every plan timed on the card ranked them"""
    plan = dense.dense_plan(batch, states, SMS)
    assert plan['resident'] == resident


def test_plan_takes_shapes_past_one_pass():
    """Outputs past 512 threads x 16 a CTA take passes; slices past the
    shared memory stream"""
    plan = dense.dense_plan(512, 4096, SMS)
    assert plan['bc'] > plan['bp'] and not plan['resident']
    assert (owners(plan, 512, 4096) == 1).all()


def test_dense_timing_runs_the_plain_version_on_cpu():
    """The timing script runs end to end on CPU tensors (the plain
    version), its inputs finite log-probabilities with two short
    sequences"""
    from torbi_tpu_torch.scripts import dense_timing

    rows = dense_timing.main(['--device', 'cpu', '--shapes', '4x9x7',
                              '--iters', '1'])
    assert [row['shape'] for row in rows] == ['4x9x7']
    assert rows[0]['device'] == 'cpu' and not rows[0]['kernel']
    obs, lengths, trans, init = dense_timing.inputs(
        4, 9, 7, dense_timing.torch.device('cpu'))
    assert lengths.tolist() == [9, 9, 4, 7]
    assert bool(obs.isfinite().all()) and bool(trans.isfinite().all())
