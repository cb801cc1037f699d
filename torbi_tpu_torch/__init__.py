"""torbi_tpu_torch: the PyTorch/CUDA port of torbi_tpu.

Batched Viterbi decoding of time-varying categorical distributions on an
NVIDIA H100, with hand-written CUDA kernels for the banded forward pass,
the dense forward pass and the backtrace, and for one sequence on its own
a batch-1 banded forward pass and two batch-1 chases (``csrc/``, built
with nvcc at first use). Long single sequences decode as entropy-chunk
rows (``ops/autochunk.py``), as in the JAX package. Micro-benchmark labs
(``scripts/``) and a profiler (``utils/profile.py``, ``python -m
torbi_tpu_torch.profile``) measure the kernels on the card. The JAX package
``torbi_tpu`` is the reference it is held against; this package imports
neither it nor JAX.

Entry points decode on CUDA unless the caller asks for the CPU
(``gpu='cpu'``), where the kernels' plain PyTorch versions run.
"""

###############################################################################
# Configuration
###############################################################################


from .config.defaults import *  # noqa: F401,F403


###############################################################################
# Module imports
###############################################################################


from .viterbi import decode  # noqa: E402
from .core import from_probabilities  # noqa: E402
from .chunk import chunk  # noqa: E402
from . import models  # noqa: E402
from . import ops  # noqa: E402
from . import utils  # noqa: E402

__version__ = '0.1.0'
