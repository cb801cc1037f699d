"""torbi_tpu_torch: the PyTorch/CUDA port of torbi_tpu.

Batched Viterbi decoding of time-varying categorical distributions on an
NVIDIA H100, with hand-written CUDA kernels for the banded forward pass,
the dense forward pass and the backtrace, and for one sequence on its own
a batch-1 banded forward pass, two batch-1 chases and the constant
transition's recurrence (``csrc/``, built with nvcc at first use). Long
single sequences decode as entropy-chunk rows (``ops/autochunk.py``), as
in the JAX package. The extra decode modes are the JAX package's too: the
approximate smoothed-max decode (``backend='lse'``, ``ops/lse.py``), the
associative max-plus scan (``ops/associative.py``, its products by a
hand-written kernel) and the exact frame-sharded decode of one sequence
over the ranks of a torch.distributed process group
(``backend='timesharded'``, ``parallel``).

The decoding API is the JAX package's: ``from_probabilities`` and
``decode`` on arrays or tensors, and the file API, ``from_file``,
``from_file_to_file``, ``from_files_to_files`` and ``from_dataloader``
(``.pt`` and ``.npy`` files, decoded in batches by ``data``, whose native
loader, ``csrc/loader.cpp``, builds with g++), with ``save`` and
``save_masked``. ``python -m torbi_tpu_torch`` is the command line of the
file API; ``python3 benchmark/run.py --workload <cell> [--trace 1]`` at
the root of the checkout is the port's benchmark. The pitch evaluation
harness (``evaluate``, ``python -m torbi_tpu_torch.evaluate``) scores
decoded corpora against the reference CPU decoder (``reference``) over the
partitions of ``partition``; the corpora come from ``data.download`` and
``data.preprocess``. Micro-benchmark labs (``scripts/``), with the timers
and the speed-of-light model of ``utils/profile.py``, measure the kernels
on the card.
The JAX package ``torbi_tpu`` is the reference it is held against; this
package imports neither it nor JAX.

Entry points decode on CUDA unless the caller asks for the CPU
(``gpu='cpu'``), where the kernels' plain PyTorch versions run.
"""

###############################################################################
# Configuration
###############################################################################


from .config.defaults import *  # noqa: F401,F403
from .config.static import derive as _derive

_derive()


###############################################################################
# CPU vector math
###############################################################################


def _initialize_vector_math():
    """Run the CPU's float exp and log once, on this thread, before any
    parallel call. PyTorch's CPU builds with MKL compute them with MKL's
    vector math, which sets itself up on its first call; where that first
    call is a parallel one, a worker thread can compute its whole chunk at
    the low-accuracy setting (an exp hundreds of ulps off), so that the
    same input converts differently in that call than in every later one
    (``tests/torch_vml_first_call.py``)."""
    import torch

    torch.exp(torch.zeros(64)).add_(1.0).log_()


_initialize_vector_math()


###############################################################################
# Module imports
###############################################################################


from .viterbi import decode  # noqa: E402
from .core import (  # noqa: E402
    from_probabilities,
    from_file,
    from_file_to_file,
    from_files_to_files,
    from_dataloader,
    save,
    save_masked,
)
from .chunk import chunk  # noqa: E402
from . import data  # noqa: E402
from . import evaluate  # noqa: E402
from . import models  # noqa: E402
from . import ops  # noqa: E402
from . import parallel  # noqa: E402
from . import partition  # noqa: E402
from . import reference  # noqa: E402
from . import utils  # noqa: E402

__version__ = '0.1.0'
