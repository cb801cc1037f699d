"""Decoding across the ranks of a torch.distributed process group.

Counterpart of ``torbi_tpu/parallel``: the process groups (``mesh``) and
the exact frame-sharded decode of one sequence (``decode_time_sharded``).
"""
from . import mesh
from .mesh import initialize_distributed
from .timesharded import decode_time_sharded
