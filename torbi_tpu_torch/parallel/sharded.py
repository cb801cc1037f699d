"""Batch-sharded decoding over the ranks of a process group.

Counterpart of ``torbi_tpu/parallel/sharded.py``: the batch axis is split
over the ranks of a ``torch.distributed`` process group (parallel/mesh.py),
where the JAX package shards it over the devices of a mesh. Every rank
passes the same whole batch and decodes its contiguous slice of rows on its
own device through ``ops/dispatch.decode`` (on a banded transition K1 then
K3, on a dense one K2 then K3); one ``all_gather`` then gives every rank
the whole path. Rows are independent, so the decode itself needs no
collective, and the path is bitwise the single-process decode's.
"""
import torch
import torch.distributed as dist

from . import mesh
from ..ops import dispatch
from ..utils import timing
from ..utils.convert import to_tensor


def slice_rows(batch, count, rank):
    """(start, stop): the rows of ``rank`` among ``count``, ceil(batch /
    count) a rank in order, so the last ranks' slices are shorter or
    empty"""
    per = -(-batch // count)
    return min(rank * per, batch), min((rank + 1) * per, batch)


@timing.spanned('torbi.gather')
def gather_rows(path, batch, count, group):
    """(batch, frames) int32 on ``path``'s device: every rank's slice of
    decoded rows in rank order, ``path`` this rank's. Each slice is padded
    to ceil(batch / count) rows for the ``all_gather``, which needs equal
    sizes, and the padding is dropped. gloo gathers host tensors only, so
    over gloo a path on the card travels through host memory; over NCCL it
    stays on the card."""
    per = -(-batch // count)
    staged = path
    if dist.get_backend(group) == dist.Backend.GLOO and path.is_cuda:
        staged = path.cpu()
    padded = staged.new_zeros((per, path.shape[1]))
    padded[:staged.shape[0]] = staged
    pieces = [torch.empty_like(padded) for _ in range(count)]
    dist.all_gather(pieces, padded, group=group)
    return torch.cat(pieces)[:batch].to(path.device)


@timing.spanned('torbi.decode_sharded')
def decode_sharded(
        observation,
        batch_frames,
        transition,
        initial,
        group=None,
        backend=None,
        finite_observation=False,
        device=None):
    """Decode with the batch axis split over the ranks of a process group.

    observation: (batch, frames, states) float32 log-probs, the same whole
        batch on every rank (a host array is sliced before any transfer)
    batch_frames: (batch,) int32
    transition: (states, states) float32 log-probs
    initial: (states,) float32 log-probs
    group: a torch.distributed process group; None is the default group.
        Without an initialised process group this is ``dispatch.decode``.
    device: this rank's decode device (``mesh.local_device``: None is the
        card of ``LOCAL_RANK``, else cuda:0; 'cpu' runs the kernels' plain
        versions)

    A rank whose slice is empty (a batch smaller than the group) launches
    no kernel but joins the gather. Each slice routes as the whole batch
    does (``dispatch.rank_share``); ``backend='timesharded'``, which splits
    one sequence's frames over the ranks instead, raises on every rank.

    Returns (batch, frames) int32, the whole path on every rank.
    """
    count, group = mesh.shards(group)
    device = mesh.local_device(device)
    if group is None:
        return dispatch.decode(
            observation, batch_frames, transition, initial, backend=backend,
            finite_observation=finite_observation, device=device)
    observation = to_tensor(observation, torch.float32)
    batch_frames = to_tensor(batch_frames, torch.int32)
    batch = observation.shape[0]
    start, stop = slice_rows(batch, count, dist.get_rank(group))
    with dispatch.rank_share(batch):
        path = dispatch.decode(
            observation[start:stop], batch_frames[start:stop], transition,
            initial, backend=backend, finite_observation=finite_observation,
            device=device)
    return gather_rows(path, batch, count, group)
