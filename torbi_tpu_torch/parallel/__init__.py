"""Decoding across the ranks of a torch.distributed process group.

Counterpart of ``torbi_tpu/parallel``: the process groups (``mesh``), the
batch split over the ranks (``decode_sharded``), the file lists split over
the ranks (``files``) and the exact frame-sharded decode of one sequence
(``decode_time_sharded``).
"""
from . import files
from . import mesh
from .mesh import initialize_distributed
from .sharded import decode_sharded
from .timesharded import decode_time_sharded
