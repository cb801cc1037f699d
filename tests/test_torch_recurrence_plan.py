"""K7's launch plan (``ops/constant.py::recurrence_plan``) and its
split-chain form on the CPU.

The constant route's recurrence kernel (csrc/constant.cu) gives each
sequence a lane of a chain warp, several sequences a CTA, and moves the
frame maxima through a ring of tiles in shared memory. It splits each
sequence's chain at L = min(batch_frames, frames): below L only the two
adds, from L on the frozen carry's one gm. The kernel runs only on the
card (chip_smoke.py holds it bitwise against its plain version there);
here the plan is checked against the batch and the SMs, and a mirror of
the split chain over the plan's tiles, in float32 scalars, is bitwise
``recurrence_reference`` on ragged lengths.
"""
import numpy as np
import pytest
import torch

from torbi_tpu_torch.ops import constant

# The H100's SMs
SMS = 132


@pytest.mark.parametrize('batch,frames', [
    (1, 10240), (1, 10240 - 3240), (512, 512), (8192, 512), (132, 40000),
    (200, 513), (3, 17), (1, 2), (5000, 100)])
def test_plan_spreads_the_batch_over_the_sms(batch, frames):
    plan = constant.recurrence_plan(batch, frames, SMS)
    sequences, blocks = plan['sequences'], plan['blocks']
    assert 1 <= sequences <= constant.RECURRENCE_MAX_SEQUENCES == 32
    # Every sequence has one lane, and no CTA is empty
    assert (blocks - 1) * sequences < batch <= blocks * sequences
    if batch <= constant.RECURRENCE_MAX_SEQUENCES * SMS:
        # As few sequences a CTA as fill the SMs: one CTA an SM at most
        assert blocks <= SMS
        assert sequences == 1 or -(-batch // (sequences - 1)) > SMS
    else:
        assert sequences == constant.RECURRENCE_MAX_SEQUENCES
    tile = plan['tile']
    assert tile % constant.RECURRENCE_GROUP == 0
    assert constant.RECURRENCE_GROUP <= tile <= constant.RECURRENCE_MAX_TILE
    assert plan['tiles'] == -(-frames // tile)
    # A short sequence fits the ring whole; a long one gets tiles of the
    # most frames the ring holds
    if frames <= constant.RECURRENCE_STAGES * tile:
        assert plan['tiles'] <= constant.RECURRENCE_STAGES
    # The ring: sequences x (stages x tile + 4) floats, 16-byte rows
    assert plan['smem_bytes'] == 4 * sequences * (
        constant.RECURRENCE_STAGES * tile + 4)
    assert plan['smem_bytes'] <= constant.RECURRENCE_SMEM_BYTES


def split_chain(maxima, g0, lengths, floor, tile):
    """The kernel's split chain in float32 scalars: for each tile of
    ``tile`` frames, the adds on frames max(t0, 1) .. min(t1, L), then the
    frozen carry's gm on the rest of the tile"""
    batch, frames = maxima.shape
    floor = np.float32(floor)
    ms = np.full((batch, frames - 1), np.nan, np.float32)
    for b in range(batch):
        g = np.float32(g0[b])
        last = min(int(lengths[b]), frames)
        for t0 in range(0, frames, tile):
            t1 = min(t0 + tile, frames)
            lo = max(t0, 1)
            hi = max(lo, min(t1, last))
            for t in range(lo, hi):
                gm = g + floor
                ms[b, t - 1] = gm
                g = maxima[b, t] + gm
            ms[b, hi - 1:t1 - 1] = g + floor
    return ms


@pytest.mark.parametrize('frames', [300, 17])
@pytest.mark.parametrize('lengths', [
    'edges', 'ragged', 'all_short', 'all_long'])
def test_split_chain_equals_plain_version(lengths, frames):
    rng = np.random.default_rng(5)
    batch = 6
    lens = {
        'edges': [1, 2, frames, frames + 9, frames - 1, 3],
        'ragged': rng.integers(1, frames + 1, size=batch),
        'all_short': [1] * batch,
        'all_long': [frames + 9] * batch}[lengths]
    lens = np.asarray(lens, np.int32)
    maxima = (rng.normal(size=(batch, frames)) * 5).astype(np.float32)
    g0 = rng.normal(size=batch).astype(np.float32)
    floor = float(np.float32(np.log(1 / 1440)))
    tile = constant.recurrence_plan(batch, frames, SMS)['tile']
    # Several tiles, the chain crossing their edges
    assert frames < 32 or frames > 2 * tile
    got = split_chain(maxima, g0, lens, floor, tile)
    expected = constant.recurrence_reference(
        torch.from_numpy(maxima), torch.from_numpy(g0),
        torch.from_numpy(lens), floor).numpy()
    assert np.array_equal(got.view(np.int32), expected.view(np.int32))
