"""K9's cluster layout (``ops/sparse.py``) on the CPU.

The cluster size ``forward_plan`` picks from the batch and the card's
resident clusters (a fake residency function standing in for the card's
``cudaOccupancyMaxActiveClusters``), the slices every size gives, the
shared memory of each layout, the heavy in-lists each warp reduces at
madmom's transition, and the one-CTA layout's fields. The kernel itself
runs on the card (``chip_smoke.py --beats``).
"""
import pytest
import torch

from torbi_tpu_torch.models import beats
from torbi_tpu_torch.ops import dense, sparse

MADMOM = 5617


@pytest.fixture(scope='module')
def madmom():
    return sparse.in_lists(torch.from_numpy(beats.transition_matrix()))


def chain_lists(states):
    """In-lists of one source a state (the previous one), built without
    the S x S matrix: only what the layouts read"""
    offsets = torch.arange(states + 1, dtype=torch.int32)
    sources = torch.roll(torch.arange(states), 1).to(torch.int16)
    return sparse.InLists(
        offsets, sources, torch.zeros(states), torch.arange(states), states,
        states, torch.zeros(0, dtype=torch.int32), offsets.clone())


def one_cta_an_sm(layout):
    """An H100's residency at one CTA an SM: its GPCs hold 15 clusters of
    8 and 7 of 16"""
    return {1: 132, 2: 66, 4: 32, 8: 15, 16: 7}[layout['cluster']]


def sixteen_of_eight(layout):
    """A card that holds 16 clusters of 8"""
    return {1: 132, 2: 66, 4: 33, 8: 16, 16: 8}[layout['cluster']]


@pytest.mark.parametrize('batch, resident, cluster', [
    (1, one_cta_an_sm, 16), (16, one_cta_an_sm, 4), (16, sixteen_of_eight, 8),
    (48, one_cta_an_sm, 2), (132, one_cta_an_sm, 1), (512, one_cta_an_sm, 1),
    (7, one_cta_an_sm, 16), (8, one_cta_an_sm, 8), (34, sixteen_of_eight, 2)])
def test_the_cluster_size_follows_the_batch(madmom, batch, resident,
                                            cluster):
    layout = sparse.forward_plan(madmom, batch, resident)
    assert layout['cluster'] == cluster
    assert layout == sparse.forward_layout(
        MADMOM, sparse.slice_pairs(madmom, cluster), cluster)


@pytest.mark.parametrize('states, cluster', [
    # Slices under MIN_SLICE: one CTA, or the largest size above it
    (97, 1), (1202, 2), (2816, 8), (5617, 16),
    # Two posterior buffers fill the shared memory: no room for mbarriers
    (29056, 1)])
def test_the_cluster_size_follows_the_states(states, cluster):
    layout = sparse.forward_plan(chain_lists(states), 1, one_cta_an_sm)
    assert layout['cluster'] == cluster


def test_a_card_holding_no_cluster_gets_one_cta(madmom):
    assert sparse.forward_plan(madmom, 1, lambda layout: 0)['cluster'] == 1


@pytest.mark.parametrize('states', [97, 1202, MADMOM, 11623, 29056])
@pytest.mark.parametrize('cluster', sparse.CLUSTER_SIZES)
def test_the_slices_cover_every_state_once(states, cluster):
    slice_ = sparse.forward_layout(states, 0, cluster)['slice']
    owners = torch.zeros(states, dtype=torch.int64)
    for rank in range(cluster):
        owners[rank * slice_:(rank + 1) * slice_] += 1
    assert bool((owners == 1).all())
    if cluster > 1:
        assert slice_ % 4 == 0 and slice_ >= -(-states // cluster)
        assert slice_ < -(-states // cluster) + 4
    else:
        assert slice_ == states


@pytest.mark.parametrize('cluster', sparse.CLUSTER_SIZES)
def test_the_shared_memory_fits(madmom, cluster):
    layout = sparse.forward_layout(
        MADMOM, sparse.slice_pairs(madmom, cluster), cluster)
    assert layout['fits'] and layout['staged'] and layout['resident']
    assert layout['smem_bytes'] <= dense.SMEM_BYTES == 232448
    # The two posterior buffers, the ring, the slice's in-lists, the
    # mbarriers past the cluster of one
    slice_, pairs = layout['slice'], layout['pairs']
    used = (8 * (MADMOM if cluster == 1 else cluster * slice_)
            + 12 * slice_ + 6 * pairs + 4 * (slice_ + 1))
    assert layout['smem_bytes'] == -(-used // 8) * 8 + (cluster > 1) * 16
    assert -(-slice_ // layout['threads']) == layout['per'] <= 6


@pytest.mark.parametrize('cluster, most', [
    (1, 3), (2, 2), (4, 2), (8, 1), (16, 1)])
def test_no_warp_reduces_more_than_two_heavy_lists(madmom, cluster, most):
    layout = sparse.forward_layout(
        MADMOM, sparse.slice_pairs(madmom, cluster), cluster)
    plan = sparse.warp_lists(madmom, layout)
    assert len(plan) == cluster
    assert all(len(cta) == layout['threads'] // 32 for cta in plan)
    assert max(len(warp) for cta in plan for warp in cta) == most
    dealt = sorted(j for cta in plan for warp in cta for j in warp)
    assert dealt == madmom.heavy.tolist()


def test_the_heavy_lists_are_madmoms_first_states(madmom):
    degrees = madmom.host_offsets[1:] - madmom.host_offsets[:-1]
    assert torch.equal(madmom.heavy.long(),
                       torch.nonzero(degrees > sparse.LIGHT).flatten())
    assert madmom.heavy.numel() == 82 and madmom.heavy.dtype == torch.int32
    assert torch.equal(madmom.host_offsets, madmom.offsets)
    # The slices' largest share of the pairs, every pair at one CTA
    assert sparse.slice_pairs(madmom, 1) == madmom.pairs == 8934
    assert sparse.slice_pairs(madmom, 8) == 1293


def test_one_cta_is_the_old_layout(madmom):
    layout = sparse.forward_layout(MADMOM, madmom.pairs)
    assert {key: layout[key] for key in (
        'threads', 'per', 'staged', 'resident', 'smem_bytes')} == {
            'threads': 1024, 'per': 6, 'staged': True, 'resident': True,
            'smem_bytes': 20 * MADMOM + 6 * 8934 + 4 * 5618}
    assert layout == sparse.forward_layout(
        MADMOM, madmom.pairs, sparse.CLUSTER_SIZES[0])


def test_launches_count_by_cluster_size():
    assert set(sparse.viterbi_forward_sparse.size_launches) == set(
        sparse.CLUSTER_SIZES)
