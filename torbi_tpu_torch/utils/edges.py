"""Edge shapes of the banded forward pass (K1) and the chase (K3).

One list, held two ways: ``tests/test_torch_edges.py`` runs every case
through the plain versions against ``torbi_tpu`` on the CPU, bitwise, and
``chip_smoke.py`` runs the same cases through the kernels on the card
against the plain versions, bitwise (K1 in both designs, at every cluster
size whose layout fits). The cases stress K1's sliced layout and K3's
reduction: states not a multiple of 8, bands above the diagonal (lo > 0)
and below it (lo + width <= 0), a band wider than a CTA's slice, floor and
no floor, ragged lengths including 1, batches that a cluster's sequences do
not divide, and for the chase exact ties and rows of -inf. Inputs are made
with numpy from a seed.
"""
from collections import namedtuple

import numpy as np

TINY = np.finfo(np.float32).tiny

# lengths: batch_frames, None for every frame
BandEdge = namedtuple(
    'BandEdge', 'name batch frames states lo width floor lengths')
BAND_EDGES = (
    BandEdge('S37-floor-ragged', 5, 9, 37, -3, 7, True, (9, 1, 4, 9, 2)),
    BandEdge('S203-above-diagonal', 3, 8, 203, 2, 9, True, (8, 8, 5)),
    BandEdge('S203-below-diagonal', 3, 8, 203, -12, 8, True, (8, 3, 8)),
    BandEdge('S203-below-diagonal-pure', 2, 7, 203, -12, 8, False, None),
    BandEdge('S64-wider-than-a-slice', 4, 10, 64, -10, 21, True,
             (10, 1, 7, 10)),
    BandEdge('S130-pure-ragged', 6, 9, 130, -4, 9, False,
             (9, 9, 1, 3, 9, 6)),
    BandEdge('S203-batch37', 37, 6, 203, -5, 11, True, 'random'),
)

# kind: 'ties' (small integers, many exact ties), 'inf-rows' (whole stream
# rows of -inf)
ChaseEdge = namedtuple('ChaseEdge', 'name batch frames states kind lengths')
CHASE_EDGES = (
    ChaseEdge('S40-ties', 5, 24, 40, 'ties', (24, 24, 13, 2, 1)),
    ChaseEdge('S203-inf-rows', 3, 12, 203, 'inf-rows', (12, 1, 7)),
    ChaseEdge('S37-ties-ragged', 9, 10, 37, 'ties', 'random'),
)


def _lengths(rng, lengths, batch, frames):
    if lengths is None:
        return np.full(batch, frames, dtype=np.int32)
    if lengths == 'random':
        out = rng.integers(1, frames + 1, size=batch).astype(np.int32)
        out[:2] = (frames, 1)
        return out
    return np.asarray(lengths, dtype=np.int32)


def band_edge_inputs(edge, seed=0):
    """(observation, batch_frames, transition, initial) numpy arrays of a
    ``BandEdge``: log-Dirichlet observations, a transition whose band is
    exactly (lo, width) over a log(tiny) floor (or -inf), a uniform
    initial distribution"""
    rng = np.random.default_rng(seed)
    states = edge.states
    obs = np.log(rng.dirichlet(np.ones(states), size=(edge.batch, edge.frames))
                 .astype(np.float32) + TINY).astype(np.float32)
    exterior = np.log(np.float32(TINY)) if edge.floor else -np.inf
    trans = np.full((states, states), exterior, dtype=np.float32)
    for d in range(edge.width):
        rows = np.arange(states)
        cols = rows + edge.lo + d
        keep = (cols >= 0) & (cols < states)
        trans[rows[keep], cols[keep]] = np.log(
            rng.uniform(0.05, 1.0, size=int(keep.sum()))).astype(np.float32)
    init = np.log(np.full(states, 1.0 / states, dtype=np.float32) + TINY)
    return (obs, _lengths(rng, edge.lengths, edge.batch, edge.frames), trans,
            init.astype(np.float32))


def chase_edge_inputs(edge, seed=0):
    """(post_seq, transition, batch_frames) numpy arrays of a
    ``ChaseEdge``; the chase starts from the last frame of post_seq"""
    rng = np.random.default_rng(seed)
    shape = (edge.batch, edge.frames, edge.states)
    if edge.kind == 'ties':
        post_seq = rng.integers(-2, 1, size=shape).astype(np.float32)
        trans = rng.integers(-2, 1, size=(edge.states,) * 2).astype(
            np.float32)
    elif edge.kind == 'inf-rows':
        post_seq = rng.standard_normal(shape).astype(np.float32)
        post_seq[:, 3, :] = -np.inf
        post_seq[1:, edge.frames // 2, :] = -np.inf
        trans = rng.standard_normal((edge.states,) * 2).astype(np.float32)
    else:
        raise ValueError(f'unknown chase edge kind {edge.kind!r}')
    return (post_seq, trans,
            _lengths(rng, edge.lengths, edge.batch, edge.frames))
