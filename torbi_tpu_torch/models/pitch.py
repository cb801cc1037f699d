"""Pitch posteriorgram decoding model.

The flagship workload: 1440-state pitch posteriorgrams as produced by penn.
An own copy of ``torbi_tpu/models/pitch.py::transition_matrix`` (with penn's
constants inlined), so this package needs neither penn nor the JAX package:
a band-diagonal matrix ``clip(max_bins_per_frame - |i - j|, 0)``,
row-normalized.
"""
import numpy as np

# penn constants (penn/config/defaults.py of maxrmorrison/penn)
PITCH_BINS = 1440
CENTS_PER_BIN = 5            # cents
OCTAVE = 1200                # cents
MAX_OCTAVES_PER_SECOND = 35.92
HOPSIZE = 80                 # samples
SAMPLE_RATE = 8000           # Hz
HOPSIZE_SECONDS = HOPSIZE / SAMPLE_RATE  # 10 ms


def frames_to_seconds(frames):
    """Convert a frame count to seconds (penn.convert.frames_to_seconds)"""
    return frames * HOPSIZE_SECONDS


def bins_per_octave():
    return OCTAVE / CENTS_PER_BIN


def max_bins_per_frame(hopsize=HOPSIZE):
    """The most bins the pitch moves in one hop of ``hopsize`` samples, plus
    one: 87.2 at penn's 10 ms hop, 173.4 at 20 ms (a band of width 347)"""
    max_octaves_per_frame = MAX_OCTAVES_PER_SECOND * hopsize / SAMPLE_RATE
    return max_octaves_per_frame * bins_per_octave() + 1


def transition_matrix(pitch_bins=PITCH_BINS, dtype=np.float32,
                      hopsize=HOPSIZE):
    """Band-diagonal pitch transition matrix (probability space, numpy)

    transition[i, j] = clip(max_bins_per_frame - |i - j|, 0), row-normalized;
    ``hopsize`` in samples at 8 kHz (penn's 80, 10 ms, by default)
    """
    xx, yy = np.meshgrid(
        np.arange(pitch_bins), np.arange(pitch_bins), indexing='ij')
    transition = np.clip(
        max_bins_per_frame(hopsize) - np.abs(xx - yy), 0, None)
    transition = transition / transition.sum(axis=1, keepdims=True)
    return transition.astype(dtype)


def synthetic_posteriorgrams(batch, frames, states=PITCH_BINS, seed=0):
    """Peaked synthetic pitch posteriorgrams in log space, float32 numpy
    (the generator of the repo's ``bench.py``): a random walk of pitch
    centers, a Gaussian of 3 bins around each, taken to log(p + tiny)"""
    tiny = np.finfo(np.float32).tiny
    rng = np.random.default_rng(seed)
    centers = np.clip(
        np.cumsum(rng.integers(-3, 4, size=(batch, frames)), axis=1)
        + states // 2,
        0, states - 1)
    bins = np.arange(states, dtype=np.float32)[None, None, :]
    out = np.empty((batch, frames, states), dtype=np.float32)
    for start in range(0, batch, 64):
        stop = min(start + 64, batch)
        dist = np.abs(bins - centers[start:stop, :, None].astype(np.float32))
        logits = -0.5 * (dist / 3.0) ** 2
        obs = logits - np.log(
            np.exp(logits).sum(axis=-1, keepdims=True))
        out[start:stop] = np.log(np.exp(obs) + tiny)
    return out
