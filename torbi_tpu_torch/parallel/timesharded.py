"""Exact frame-sharded Viterbi decode of one sequence.

Counterpart of ``torbi_tpu/parallel/timesharded.py``: the frame axis of
ONE long sequence is split over the ranks of a ``torch.distributed``
process group (parallel/mesh.py), and the decode stays exact. The forward
recursion is a linear recurrence in the (max, +) semiring, so it
parallelizes as (Temporal Parallelization of HMM Inference,
arXiv:2102.05743):

1. each rank builds its local step matrices A_t[j, i] = transition[j, i] +
   observation[t, j] (rank 0 substitutes the max-plus diagonal of the
   initial posterior for A_0) and runs local associative prefix and suffix
   scans of max-plus products (ops/associative.py, products by K8);
2. ONE all_gather of the (S, S) per-rank chunk products, and every rank
   composes its exclusive cross-rank prefix and suffix locally;
3. forward values fwd_t[j] = max_i M_t[j, i] and backward values bwd_t[i]
   = max_j SUF_t[j, i] are local; the decoded state at t is the
   lowest-index argmax of fwd_t + bwd_t. A last all_gather of the int32
   pieces gives every rank the whole path.

Every step is the JAX function's, in its order and with its operand order,
so the path is bitwise the JAX package's on the same number of shards.
Path scores match the sequential recursion up to float32 reassociation:
when the optimal path is unique the decoded path is the serial decoder's,
but exact ties may resolve differently from the backpointer chase.
"""
import torch
import torch.distributed as dist

from . import mesh
from ..ops import associative

NEG_INF = float('-inf')


def _all_gather(tensor, count, group):
    """(count, *tensor.shape): every rank's ``tensor``, by group rank"""
    if group is None:
        return tensor[None]
    pieces = [torch.empty_like(tensor) for _ in range(count)]
    dist.all_gather(pieces, tensor.contiguous(), group=group)
    return torch.stack(pieces)


def decode_time_sharded(observation, transition, initial, group=None):
    """Decode one (frames, states) sequence with its frames sharded over
    the ranks of ``group``.

    observation: (frames, states) float32 log-probs, the whole sequence on
        every rank; frames must be a multiple of the shard count
    transition: (states, states) float32 log-probs (row = destination)
    initial: (states,) float32 log-probs
    group: a torch.distributed process group; None is the default group,
        or one shard without an initialised process group

    Returns (frames,) int32 decoded states, the whole path on every rank.
    """
    count, group = mesh.shards(group)
    frames, states = observation.shape
    if frames % count:
        raise ValueError(
            f'frames={frames} must be a multiple of the shard count {count}')
    rank = 0 if group is None else dist.get_rank(group)
    local = frames // count
    device = observation.device

    post0 = observation[0] + initial  # only meaningful on rank 0
    obs_l = observation[rank * local:(rank + 1) * local]

    # Local step matrices; global A_0 is the max-plus diagonal of the
    # initial posterior (so every prefix column i carries "start in i")
    steps = transition[None, :, :] + obs_l[:, :, None]
    identity = torch.full(
        (states, states), NEG_INF, dtype=torch.float32, device=device)
    identity.fill_diagonal_(0.0)
    if rank == 0:
        eye = torch.eye(states, dtype=torch.bool, device=device)
        steps[0] = torch.where(eye, post0[:, None], NEG_INF)

    # Local inclusive prefix products M_t = A_t x ... x A_(t0)
    prefix = associative.associative_scan(
        lambda a, b: associative.maxplus_matmul(b, a), steps)
    # ... and suffix products SUF_t = A_(t0+T_l-1) x ... x A_t
    suffix = associative.associative_scan(
        lambda a, b: associative.maxplus_matmul(a, b), steps, reverse=True)
    del steps

    # One (S, S) product per rank crosses ranks
    all_chunks = _all_gather(prefix[-1], count, group)  # (D, S, S)

    # Exclusive cross-rank composites, computed redundantly per rank
    pre = [identity]   # pre[e] = P_(e-1) x ... x P_0
    suf = [identity]   # suf[e] = P_(D-1) x ... x P_(D-e)
    for e in range(count - 1):
        pre.append(associative.maxplus_matmul(all_chunks[e], pre[-1]))
        suf.append(associative.maxplus_matmul(
            suf[-1], all_chunks[count - 1 - e]))
    pre = pre[rank]
    suf = suf[count - 1 - rank]

    # fwd_t[j] = best score of any path ending in j at global t
    fwd = associative.maxplus_matmul(prefix, pre[None]).amax(dim=-1)
    del prefix

    # bwd_t[i] = best continuation from state i at t to the end, excluding
    # A_t itself: the local suffix shifted down by one step, composed with
    # the cross-rank suffix
    suf_excl = torch.cat([suffix[1:], identity[None]])
    del suffix
    bwd = associative.maxplus_matmul(suf[None], suf_excl).amax(dim=-2)

    # Lowest-index argmax per frame (torch.argmax takes the first maximum)
    piece = (fwd + bwd).argmax(dim=-1).to(torch.int32)
    return _all_gather(piece, count, group).reshape(frames)
