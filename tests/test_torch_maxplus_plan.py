"""K8's launch plan (``ops/associative.py::maxplus_plan``) on the CPU.

The (max, +) product kernel (csrc/maxplus.cu) runs a persistent grid over
a list of output tiles, each tile's k in slabs through a ring of stages in
shared memory, a broadcast operand held there when one tile holds its
whole product. The kernel itself runs only on the card (chip_smoke.py
holds it bitwise against its plain version there); here the plan is
checked for what the kernel rests on: every output tile of every product
has exactly one CTA, the ring fits the H100's shared memory, the narrow
copies serve rows not on 16 bytes, and a mirror of the kernel's walk over
tiles, slabs and -inf padding, with a NaN-keeping maximum, is bitwise the
plain version.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from torbi_tpu_torch.ops import associative

# The H100's SMs
SMS = 132
INF = float('inf')


def contiguous_plan(batch, m, k, n, a_batch=None, b_batch=None, tile=None):
    """The plan of contiguous (batch, m, k) by (batch, k, n) operands, with
    tile design ``tile`` if given"""
    args = (batch, m, k, n, m * k if a_batch is None else a_batch, k,
            k * n if b_batch is None else b_batch, n)
    if tile is None:
        return associative.maxplus_plan(*args, sms=SMS)
    return associative.maxplus_tile_plan(tile, *args, sms=SMS)


def test_kernel_instantiates_every_design_in_order():
    # csrc/maxplus.cu's with_tile: case i is MAXPLUS_TILES[i]
    source = (Path(associative.__file__).parent.parent / 'csrc'
              / 'maxplus.cu').read_text()
    cases = re.findall(r'case (\d+):\s*return TORBI_TILE\(([\d, ]+)\)',
                       source)
    assert [int(case) for case, _ in cases] == list(
        range(len(associative.MAXPLUS_TILES)))
    assert [tuple(int(x) for x in args.split(',')) for _, args in cases] == (
        list(associative.MAXPLUS_TILES))


@pytest.mark.parametrize('batch,m,k,n', [
    (16383, 64, 64, 64),     # the scan's first level at 1 x 32,768 x 64
    (1, 1440, 1440, 1440),
    (70000, 2, 3, 2),        # a batch past the grid's 65,535
    (66000, 64, 64, 64),
    (3, 130, 130, 130),
    (2, 7, 11, 5),
    (5, 300, 40, 200),
])
def test_grid_covers_every_tile_once(batch, m, k, n):
    plan = contiguous_plan(batch, m, k, n)
    grid, items = plan['grid'], plan['items']
    assert 1 <= grid <= min(items, SMS * plan['ctas_per_sm'])
    assert items == batch * plan['tiles_m'] * plan['tiles_n']
    # The tiles cover the output, none wholly past it
    assert (plan['tiles_m'] - 1) * plan['rows'] < m <= (
        plan['tiles_m'] * plan['rows'])
    assert (plan['tiles_n'] - 1) * plan['cols'] < n <= (
        plan['tiles_n'] * plan['cols'])
    assert (plan['slabs'] - 1) * plan['depth'] < k <= (
        plan['slabs'] * plan['depth'])
    # CTA c takes items c, c + grid, ...: (items - 1 - c) // grid + 1 of
    # them (the kernel's count), each decoded to (z, tile row, tile col)
    ctas = np.arange(grid)
    counts = (items - 1 - ctas) // grid + 1
    assert counts.sum() == items
    owner = np.full(items, -1)
    for c in ctas:
        walked = c + grid * np.arange(counts[c])
        assert (owner[walked] == -1).all()
        owner[walked] = c
    assert (owner >= 0).all()
    item = np.arange(items)
    per_product = plan['tiles_m'] * plan['tiles_n']
    z, rest = np.divmod(item, per_product)
    tile_m, tile_n = np.divmod(rest, plan['tiles_n'])
    cells = (z * plan['tiles_m'] + tile_m) * plan['tiles_n'] + tile_n
    assert np.array_equal(np.sort(cells), item)
    assert z.max() == batch - 1


@pytest.mark.parametrize('resident', [None, 'a', 'b'])
@pytest.mark.parametrize('tile', range(len(associative.MAXPLUS_TILES)))
def test_stage_ring_fits_the_sm(tile, resident):
    # A resident operand of a 64-deep product: all its slabs held
    ty, tx, ri, rj, depth, stages, registers = associative.MAXPLUS_TILES[tile]
    slabs = -(-64 // depth)
    layout = associative.maxplus_layout(tile, resident, slabs)
    assert layout['fits']
    assert layout['smem_bytes'] <= associative.BLOCK_SMEM_BYTES == 232448
    ctas = layout['ctas_per_sm']
    assert ctas >= 1
    assert ctas * (layout['smem_bytes'] + associative.CTA_SMEM_RESERVED) <= (
        associative.SM_SMEM_BYTES)
    assert layout['threads'] == ty * tx
    warps = -(-layout['threads'] // 32)
    assert ctas * warps * 32 <= associative.SM_THREADS
    # The launch bounds' registers: the maxima, four k's of a a row, b's
    # row of the tile, within the SM's file at the CTAs it holds
    assert ri * rj + 4 * ri + rj < registers <= 128
    assert ctas * warps * 32 * registers <= associative.SM_REGISTERS
    # The ring's slabs: 16-byte chunks, a's rows padded by one chunk, the
    # depth in whole steps of four k's (a's 16-byte reads)
    assert stages >= 2 and depth % 4 == 0 and rj % 4 == 0
    rows, cols = ri * ty, rj * tx
    a_floats, b_floats = rows * (depth + 4), depth * cols
    ring = stages * ((resident != 'a') * a_floats
                     + (resident != 'b') * b_floats)
    held = slabs * {'a': a_floats, 'b': b_floats}.get(resident, 0)
    assert layout['smem_bytes'] == 4 * (ring + held)


@pytest.mark.parametrize('states,aligned', [
    (5, False), (33, False), (65, False), (127, False), (64, True),
    (1440, True)])
def test_narrow_copies_for_rows_off_16_bytes(states, aligned):
    plan = contiguous_plan(3, states, states, states)
    assert plan['vec_a'] == plan['vec_b'] == aligned
    # A base address off 16 bytes narrows that operand alone
    shifted = associative.maxplus_plan(
        3, states, states, states, states * states, states, states * states,
        states, a_address=4, b_address=0, sms=SMS)
    assert not shifted['vec_a'] and shifted['vec_b'] == aligned


def test_broadcast_operand_recognised_at_batch_stride_0():
    # The time-sharded decode: maxplus(prefix, pre[None]), then
    # maxplus(suf[None], suf_excl), at 32,768 x 64
    fwd = contiguous_plan(32768, 64, 64, 64, b_batch=0)
    bwd = contiguous_plan(32768, 64, 64, 64, a_batch=0)
    assert fwd['resident'] == 'b' and bwd['resident'] == 'a'
    # The ring holds a alone (2 stages of 64 x 68 floats), b's one slab of
    # 64 x 64 stands before it: 50 KB, three CTAs an SM
    level = contiguous_plan(16383, 64, 64, 64)
    assert level['resident'] is None
    assert fwd['smem_bytes'] == 4 * (2 * 64 * 68 + 64 * 64) == 51200
    assert fwd['ctas_per_sm'] == 3 and fwd['slabs'] == 1
    # Both broadcast: b stays; one product, a product wider than a tile,
    # or one too deep for shared memory: nothing stays; a deeper one keeps
    # every slab
    assert contiguous_plan(8, 64, 64, 64, 0, 0)['resident'] == 'b'
    assert contiguous_plan(1, 64, 64, 64, 0, 0)['resident'] is None
    assert contiguous_plan(8, 64, 64, 200, b_batch=0,
                           tile=0)['resident'] is None
    deep = contiguous_plan(8, 64, 100, 64, b_batch=0, tile=0)
    assert deep['resident'] == 'b' and deep['slabs'] == 2
    assert contiguous_plan(8, 64, 4000, 64, b_batch=0,
                           tile=0)['resident'] is None


@pytest.mark.parametrize('batch,grid', [
    (1, 1), (2, 2), (64, 64), (128, 128), (132, 132), (256, 256),
    (396, 396), (397, 264), (511, 264), (1023, 264), (4095, 264),
    (16383, 396), (32768, 396)])
def test_scan_products_take_the_whole_product_design(batch, grid):
    # Every count of the scan's and the time-sharded decode's 64^3
    # products: 64 x 64 tiles of 256 threads, 4 x 4 maxima each, the whole
    # 64-deep product one stage, up to three CTAs an SM; one tile a product
    plan = contiguous_plan(batch, 64, 64, 64)
    assert associative.MAXPLUS_TILES[plan['tile']] == (
        16, 16, 4, 4, 64, 2, 80)
    assert (plan['rows'], plan['cols'], plan['slabs']) == (64, 64, 1)
    assert plan['threads'] == 256 and plan['ctas_per_sm'] == 3
    assert plan['items'] == batch
    # One round where three CTAs an SM hold every product; past that, two
    # CTAs an SM where their rounds take less of the SM's time (rounds
    # times CTAs an SM: at 511 products two of two against two of three);
    # three again where they take as little
    assert plan['grid'] == grid
    assert plan['rounds'] == -(-batch // grid)
    per_sm = -(-grid // SMS)
    share = associative.FULL_RATE_MAXIMA / (256 * 16)
    for other in range(1, 4):
        option = min(batch, other * SMS)
        assert plan['cost'] <= -(-batch // option) * 64 ** 3 * max(
            -(-option // SMS), share)
    assert plan['cost'] == plan['rounds'] * 64 ** 3 * max(per_sm, share)


def test_plan_fills_one_wave_at_1440():
    plan = contiguous_plan(1, 1440, 1440, 1440)
    ty, tx, ri, rj = associative.MAXPLUS_TILES[plan['tile']][:4]
    # 144 x 112 tiles: 10 x 13 of them, at most one a SM
    assert (ri * ty, rj * tx) == (144, 112)
    assert plan['items'] == plan['grid'] == 130 <= SMS
    # 64 x 64 tiles would take 529 tiles, two rounds of three CTAs an SM
    small = contiguous_plan(1, 1440, 1440, 1440, tile=0)
    assert small['items'] == 529 and small['cost'] > plan['cost']
    assert -(-small['items'] // small['grid']) == 2


def stage(x, r0, r_lim, c0, c_lim, rows, cols):
    """Rows r0 .. r0 + rows, columns c0 .. c0 + cols of the matrix x as
    the kernel stages them: -inf past (r_lim, c_lim)"""
    out = torch.full((rows, cols), -INF)
    r1, c1 = min(r0 + rows, r_lim), min(c0 + cols, c_lim)
    if r1 > r0 and c1 > c0:
        out[:r1 - r0, :c1 - c0] = x[r0:r1, c0:c1]
    return out


def walk(a3, b3, plan):
    """The kernel's walk in torch: every CTA's items in turn, each item's
    slabs staged with -inf padding, a running maximum over them that keeps
    NaN (torch.maximum, torch.amax); every output written exactly once"""
    batch, m, k = a3.shape
    n = b3.shape[2]
    rows, cols, depth = plan['rows'], plan['cols'], plan['depth']
    out = torch.full((batch, m, n), 7.0)
    written = torch.zeros((batch, m, n), dtype=torch.int64)
    per_product = plan['tiles_m'] * plan['tiles_n']
    for cta in range(plan['grid']):
        for item in range(cta, plan['items'], plan['grid']):
            z, rest = divmod(item, per_product)
            tile_m, tile_n = divmod(rest, plan['tiles_n'])
            row0, col0 = tile_m * rows, tile_n * cols
            acc = torch.full((rows, cols), -INF)
            for slab in range(plan['slabs']):
                k0 = slab * depth
                a_s = stage(a3[z], row0, m, k0, k, rows, depth)
                b_s = stage(b3[z], k0, k, col0, n, depth, cols)
                candidates = a_s[:, :, None] + b_s[None, :, :]
                acc = torch.maximum(acc, candidates.amax(dim=1))
            r1, c1 = min(row0 + rows, m), min(col0 + cols, n)
            out[z, row0:r1, col0:c1] = acc[:r1 - row0, :c1 - col0]
            written[z, row0:r1, col0:c1] += 1
    assert (written == 1).all()
    return out


def same_bits(got, expected):
    nan = got.isnan()
    return (got.shape == expected.shape
            and torch.equal(nan, expected.isnan())
            and torch.equal(got.masked_fill(nan, 0.),
                            expected.masked_fill(nan, 0.)))


def operands(layout, seed):
    """(a, b) of a product in one of chip_smoke.py's K8 layouts (at small
    sizes), and the rectangular and multi-tile shapes"""
    generator = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=generator) * 10

    states = 13
    a, b = randn(3, states, states), randn(3, states, states)
    if layout == 'broadcast':
        b = b[1:2]
    elif layout == 'broadcast_a':
        a = a[1:2]
    elif layout == 'strided':
        stack = randn(7, states, states)
        a, b = stack[0:-1:2], stack[1::2]
    elif layout == 'neg_inf':
        a[0, 0, :] = -INF
        a[1, :, states // 2] = -INF
        b[0, :, 0] = -INF
        b[2] = -INF
        b[2].fill_diagonal_(0.)
    elif layout == 'nan':
        a[0, :, 0] = INF
        b[0, 0, :] = -INF
        a[1, 0, 0] = float('nan')
    elif layout == 'rectangular':
        a, b = randn(2, 1, 7, 11), randn(3, 11, 5)
    elif layout == 'tiles':
        # Several tiles of each design a product, several slabs deep
        a, b = randn(2, 150, 70), randn(2, 70, 120)
    elif layout == 'deep':
        # One tile, several slabs of each design, a broadcast b resident
        a, b = randn(4, 9, 150), randn(150, 6)
    elif layout == 'unaligned':
        # Rows off 16 bytes: the kernel's 4-byte copies
        a, b = randn(2, 5, 5), randn(2, 5, 5)
    return a, b


@pytest.mark.parametrize('tile', range(len(associative.MAXPLUS_TILES)))
@pytest.mark.parametrize('layout', [
    'batched', 'broadcast', 'broadcast_a', 'strided', 'neg_inf', 'nan',
    'rectangular', 'tiles', 'deep', 'unaligned'])
def test_walk_mirror_equals_plain_version(layout, tile):
    a, b = operands(layout, 90)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = associative._batched(a, lead, m, k)
    b3 = associative._batched(b, lead, k, n)
    plan = associative.maxplus_tile_plan(
        tile, a3.shape[0], m, k, n, a3.stride(0), a3.stride(1),
        b3.stride(0), b3.stride(1), a3.data_ptr(), b3.data_ptr(), sms=SMS)
    if layout.startswith('broadcast') or layout == 'deep':
        assert plan['resident'] == ('a' if layout == 'broadcast_a' else 'b')
    if layout == 'tiles' and tile == 0:
        assert plan['tiles_m'] > 1 and plan['tiles_n'] > 1
        assert plan['slabs'] == 2
    if layout == 'deep':
        assert plan['slabs'] > 1
    if layout == 'unaligned':
        assert not plan['vec_a'] and not plan['vec_b']
    expected = associative.maxplus_matmul_reference(a, b)
    got = walk(a3, b3, plan).reshape(expected.shape)
    assert same_bits(got, expected)
    if layout == 'nan':
        assert expected.isnan().any()
