"""Default configuration values.

The knob names are those of ``torbi_tpu/config/defaults.py``, so a user of
the JAX package finds the same switches here. Only the decoding knobs this
package reads are present; the TPU-only ones (kernel layouts, frame tiles,
frame and batch buckets, sharding and the batch-1 TPU kernel flavours) have
no meaning for kernels that take runtime shapes on one CUDA device. Every
constant is promoted to a ``torbi_tpu_torch.<NAME>`` attribute at import.
"""


###############################################################################
# Decoding
###############################################################################


# Which decode implementation to use: 'auto' and 'kernel' select the
# hand-written CUDA kernels (banded or dense forward, then the backtrace);
# 'scan' forces the plain PyTorch recursion with an int32 backpointer
# trellis (the counterpart of the JAX package's 'xla' backend)
BACKEND = 'auto'

# Automatically use the banded forward kernel when the transition matrix is
# detected to be band-limited (log-probabilities -inf, or one constant
# floor, outside a diagonal band)
USE_BAND_KERNEL = True

# Maximum bandwidth (as a fraction of the number of states) for which the
# banded kernel is preferred over the dense kernel
BAND_MAX_FRACTION = 0.5

# Split a decode batch into independent sub-calls when its estimated
# device footprint exceeds this: (obs_copies * states_in + states) * 4
# bytes per (row, frame) cell, where obs_copies is 2 when the
# probability->log or epsilon conversion writes a converted copy of the
# observation, and the posterior stream term is dropped on the
# constant-transition path (it keeps none). Half of an 80 GB H100: the rest
# is left for the caller's own device-resident batch (which a
# device-resident input keeps alive while its groups decode), the
# transition and band matrices, and the caching allocator's slack.
DECODE_MEMORY_BUDGET = 40_000_000_000
