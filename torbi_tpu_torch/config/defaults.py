"""Default configuration values.

The knob names and defaults are those of ``torbi_tpu/config/defaults.py``,
so a user of the JAX package finds the same switches here. Only the
knobs this package reads are present; the TPU-only ones (kernel layouts,
frame tiles, frame and batch buckets, the loader's bucket split, sharding)
have no meaning for kernels that take runtime shapes on one CUDA device.
The batch-1 knobs pick the same routes as in the JAX package, onto this
package's own kernels: auto-chunking (ops/autochunk.py), the batch-1
banded forward (K4) and the fused (K5) or windowed (K6) batch-1 chase.
Every constant is promoted to a ``torbi_tpu_torch.<NAME>`` attribute at
import, and a ``--config`` file given to an entry point (config/core.py)
may override it. The evaluation harness's directories and constants are
the JAX package's, rooted at this package: its assets (the partitions,
the cached transition) live under ``torbi_tpu_torch/assets``.
"""
from pathlib import Path


###############################################################################
# Metadata
###############################################################################


# Experiment name; the file APIs' progress line names it, and it routes
# the evaluation harness's output directories and results file
CONFIG = 'torbi_tpu_torch'


###############################################################################
# Directories
###############################################################################


# Repository root (output artifacts live below it)
ROOT_DIR = Path(__file__).parent.parent.parent

# Package assets (partitions, cached stats)
ASSETS_DIR = Path(__file__).parent.parent / 'assets'

# Preprocessed posteriorgram cache
CACHE_DIR = ROOT_DIR / 'data' / 'cache'

# Raw downloaded datasets
DATA_DIR = ROOT_DIR / 'data' / 'datasets'

# Evaluation artifacts (decoded outputs, results JSON)
EVAL_DIR = ROOT_DIR / 'eval'


###############################################################################
# Chunking
###############################################################################


# Entropy chunking of long sequences (chunk.py): when set to a positive
# integer, sequences split at adjacent low-entropy frame pairs at least this
# many frames apart. None disables.
MIN_CHUNK_SIZE = None

# Normalized-entropy cutoff for choosing split points
ENTROPY_THRESHOLD = 0.5


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

# Batch-1 banded forward: True sends a single banded sequence (width > 0)
# through K4 (csrc/band_spread.cu), which spreads the one sequence's
# destinations over a cluster of 16 CTAs, its band in registers; False (or
# a band K4's layout does not hold) keeps K1. Same values either way.
BAND_BATCH1_SPREAD = True

# Batch-1 chase over the band window only (K6, csrc/backtrace_batch1.cu):
# each step reduces the `width` sources around the band instead of every
# state. Taken only when BACKTRACE_BATCH1_FUSED is off and the band has no
# floor: with a finite floor a path can leave the window (ROADMAP.md B6),
# so a floor band keeps the full-width chase.
BACKTRACE_BATCH1_WINDOW = False

# Batch-1 full-width chase (K5, csrc/backtrace_batch1.cu): every
# backpointer of the single sequence in parallel on the whole card, then a
# blocked chase of them. Takes precedence over BACKTRACE_BATCH1_WINDOW;
# False (with the window off) keeps K3.
BACKTRACE_BATCH1_FUSED = True

# Batch-1 auto-chunking: a single long banded sequence (width > 0) decodes
# as parallel chunk rows split at adjacent low-entropy frame pairs, the
# reference's chunked mode applied at decode time (ops/autochunk.py). The
# result is bitwise the oracle run per chunk, and equals the full-sequence
# path whenever the split frames are near-deterministic. Diffuse
# observations yield no plan and decode serially; False pins the serial
# full-sequence decode for every input.
BATCH1_AUTO_CHUNK = True

# Single-sequence frame count below which auto-chunking is never considered
BATCH1_AUTO_CHUNK_MIN_FRAMES = 4096

# Target frames per auto-chunk row: a 10,240-frame sequence becomes 8 rows
# of about 1280 frames
BATCH1_CHUNK_FRAMES = 1280

# Split a decode batch into independent sub-calls when its estimated
# device footprint exceeds this: (obs_copies * states_in + states) * 4
# bytes per (row, frame) cell, where obs_copies is 2 when the
# probability->log or epsilon conversion writes a converted copy of the
# observation, and the posterior stream term is dropped on the
# constant-transition path (it keeps none). Half of an 80 GB H100: the rest
# is left for the caller's own device-resident batch (which a
# device-resident input keeps alive while its groups decode), the
# transition and band matrices, and the caching allocator's slack. The
# auto-chunk route declines a sequence whose observation takes more than
# 2/5 of it or of the JAX package's 4.5 GB budget, whichever is smaller, so
# that both packages chunk the same sequences (ops/autochunk.py).
DECODE_MEMORY_BUDGET = 40_000_000_000


###############################################################################
# Data pipeline
###############################################################################


# Sequences (files, or chunk rows of files) decoded per batch by the file
# APIs
BATCH_SIZE = 512

# Threads that load and collate batches ahead of the decode in the Python
# loader (.pt files, chunked decoding); 0 loads inline
NUM_WORKERS = 1

# Load .npy files with the native threaded loader (csrc/loader.cpp) when
# every input is .npy and chunking is off
USE_NATIVE_LOADER = True


###############################################################################
# Evaluation
###############################################################################


# Score against the reference decoder (librosa, or its numpy counterpart
# ops/oracle.py); when False, score chunked decoding against this
# package's own unchunked output instead
COMPARE_WITH_REFERENCE = True

# Decode backend the evaluation harness runs ('kernel', 'scan', or None for
# the configured default)
EVAL_BACKEND = None

# Evaluation corpora
DATASETS = ['daps', 'vctk']

# Cap on randomly-sampled stems per dataset partition
EVALUATION_SAMPLES = 8192

# Raw-pitch-accuracy tolerance levels, in 5-cent pitch bins
PITCH_ERROR_THRESHOLDS = [0, 1, 2]

# On-disk cache of the band-diagonal pitch transition matrix
PITCH_TRANSITION_MATRIX = ASSETS_DIR / 'stats' / 'transition.pt'

# Audio sampling rate of the evaluation corpora
SAMPLE_RATE = 16000

# Seed shared by all random number generators
RANDOM_SEED = 1234
