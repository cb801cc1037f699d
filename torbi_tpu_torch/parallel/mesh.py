"""Process groups for decoding across ranks.

Counterpart of ``torbi_tpu/parallel/mesh.py``. A shard is a rank of a
``torch.distributed`` process group, where the JAX package shards over the
devices of a mesh: the default group, or a group the caller passes. Without
an initialised process group there is one shard. A rank decodes on its own
card (``local_device``), where a JAX host decodes on its local devices.
"""
import os

import torch
import torch.distributed as dist

from ..utils.convert import resolve_device

# Groups of the leading ranks of a group, made once per (group, count)
_leading_groups = {}


def initialize_distributed():
    """Initialise the default process group from the environment.

    Reads ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
    (``env://``), as ``torchrun`` sets them, with NCCL when CUDA is there
    and gloo otherwise. Safe to call twice; a no-op for a single process
    (``RANK`` or ``WORLD_SIZE`` unset).
    """
    if not dist.is_available() or dist.is_initialized():
        return
    if 'RANK' not in os.environ or 'WORLD_SIZE' not in os.environ:
        return
    dist.init_process_group(
        'nccl' if torch.cuda.is_available() else 'gloo',
        init_method='env://')


def local_device(gpu=None):
    """A rank's decode device: ``gpu`` when given (as ``from_probabilities``
    takes it), else the card of the ``LOCAL_RANK`` that ``torchrun`` sets,
    modulo the cards there are, else cuda:0. Like ``gpu=None`` everywhere,
    it never means the CPU: without CUDA it raises."""
    if gpu is None and 'LOCAL_RANK' in os.environ and (
            torch.cuda.is_available()):
        return torch.device(
            'cuda', int(os.environ['LOCAL_RANK']) % torch.cuda.device_count())
    return resolve_device(gpu)


def shards(group=None):
    """(count, group): the shard count and the process group that holds
    them, ``group`` or the default one; (1, None) without an initialised
    process group"""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, None
    group = dist.group.WORLD if group is None else group
    return dist.get_world_size(group), group


def leading_group(count, group=None):
    """The process group of the first ``count`` ranks of ``group`` (the
    default group when None). ``torch.distributed.new_group`` is
    collective: every rank of the default group makes the same calls in the
    same order, and a rank outside the new group gets
    ``GroupMember.NON_GROUP_MEMBER``."""
    size, group = shards(group)
    if group is None or count == size:
        return group
    key = (id(group), count)
    if key not in _leading_groups:
        ranks = dist.get_process_group_ranks(group)[:count]
        _leading_groups[key] = dist.new_group(ranks=ranks)
    return _leading_groups[key]
