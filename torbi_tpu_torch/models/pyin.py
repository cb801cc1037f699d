"""pYIN's voiced/unvoiced pitch HMM.

The hidden Markov model of probabilistic YIN (Mauch & Dixon, "pYIN: A
fundamental frequency estimator using probabilistic threshold
distributions", ICASSP 2014) as ``librosa.pyin`` builds it
(``librosa/core/pitch.py``) at its documented defaults, with the
``fmin``/``fmax`` of its docstring example: 22,050 Hz, frames of 2048
samples every 512 (23.22 ms), C2 to C7 in tenths of a semitone, a
transition of at most 35.92 octaves a second and a voicing switch
probability of 0.01. Written here from librosa's
``sequence.transition_local`` (a triangular window centred on each bin,
cut at the edges, each row normalised) and ``sequence.transition_loop``,
so this package needs no librosa.

The HMM has ``STATES`` = 1202 states: the ``PITCH_BINS`` = 601 voiced
pitch bins, then the same 601 bins unvoiced. A decode takes the
probabilities as torbi does by default::

    transition = pyin.transition_matrix()
    initial = pyin.initial()
    indices = torbi_tpu_torch.from_probabilities(
        pyin.observation(voiced), batch_frames, transition, initial)
    frequency, voiced_flag = pyin.states(indices)

Zeros of the transition and of the initial distribution become -inf
there. librosa decodes in float64 with log(p + tiny); this decodes in
float32, and the transition's band (its voiced-unvoiced blocks lie 601
states off the diagonal) is too wide for the banded kernels, so the
decode takes the dense route.
"""
import math

import numpy as np
import torch

# librosa.pyin's defaults (sr, frame_length, hop_length, resolution,
# max_transition_rate, switch_prob) and its example's fmin and fmax
SAMPLE_RATE = 22050          # Hz
FRAME_LENGTH = 2048          # samples
HOP_LENGTH = 512             # samples
HOP_SECONDS = HOP_LENGTH / SAMPLE_RATE
FMIN = 440.0 * 2 ** ((36 - 69) / 12)    # C2, 65.41 Hz (librosa.note_to_hz)
FMAX = 440.0 * 2 ** ((96 - 69) / 12)    # C7, 2093.0 Hz
RESOLUTION = 0.1             # semitones a bin
MAX_TRANSITION_RATE = 35.92  # octaves a second
SWITCH_PROB = 0.01

BINS_PER_SEMITONE = int(math.ceil(1.0 / RESOLUTION))
# floor(120 log2(32)) + 1 = 601
PITCH_BINS = int(math.floor(
    12 * BINS_PER_SEMITONE * math.log2(FMAX / FMIN))) + 1
# round(35.92 * 12 * 512 / 22050) = 10 semitones a frame: 101 bins
MAX_SEMITONES_PER_FRAME = round(
    MAX_TRANSITION_RATE * 12 * HOP_LENGTH / SAMPLE_RATE)
TRANSITION_WIDTH = MAX_SEMITONES_PER_FRAME * BINS_PER_SEMITONE + 1
STATES = 2 * PITCH_BINS


def frames_to_seconds(frames):
    """The time of a frame count, at the 512-sample hop"""
    return frames * HOP_SECONDS


def seconds_to_frames(seconds):
    """The frames in ``seconds``, rounded down"""
    return int(seconds * SAMPLE_RATE) // HOP_LENGTH


def frequencies(pitch_bins=PITCH_BINS):
    """Each pitch bin's frequency in Hz: fmin * 2 ** (bin / 120)"""
    return FMIN * 2 ** (
        np.arange(pitch_bins) / (12 * BINS_PER_SEMITONE))


def triangle(width):
    """scipy.signal.windows.triang(width) for an odd width: 2 n / (width +
    1) rising to 1 at the centre, then falling"""
    rising = 2 * np.arange(1, (width + 1) // 2 + 1) / (width + 1.0)
    return np.concatenate([rising, rising[-2::-1]])


def transition_local(pitch_bins=PITCH_BINS, width=TRANSITION_WIDTH):
    """librosa's ``transition_local(pitch_bins, width, window='triangle',
    wrap=False)``, float64, row = source: row i the triangle centred on
    bin i, the part past either edge cut off, normalised to sum 1"""
    window = triangle(width)
    half = width // 2
    local = np.zeros((pitch_bins, pitch_bins))
    for source in range(pitch_bins):
        low, high = max(0, source - half), min(pitch_bins, source + half + 1)
        local[source, low:high] = window[low - source + half:
                                         high - source + half]
    return local / local.sum(axis=1, keepdims=True)


def transition_matrix(pitch_bins=PITCH_BINS, width=TRANSITION_WIDTH,
                      switch_prob=SWITCH_PROB, dtype=np.float32):
    """The (2 pitch_bins, 2 pitch_bins) transition probabilities, numpy,
    in this package's orientation: row = destination (librosa's row is the
    source, so this is its matrix transposed). librosa's is
    ``kron(transition_loop(2, 1 - switch_prob), transition_local(...))``:
    the local pitch move within the voiced and within the unvoiced half,
    scaled by 1 - switch_prob, and between them by switch_prob. Near the
    edges the rows are normalised over fewer bins, so the matrix is not
    symmetric"""
    switch = np.array([[1 - switch_prob, switch_prob],
                       [switch_prob, 1 - switch_prob]])
    by_source = np.kron(switch, transition_local(pitch_bins, width))
    return np.ascontiguousarray(by_source.T).astype(dtype)


def initial(pitch_bins=PITCH_BINS, dtype=np.float32):
    """The initial probabilities, numpy: 0 on each voiced state, 1 /
    pitch_bins on each unvoiced one"""
    probabilities = np.zeros(2 * pitch_bins)
    probabilities[pitch_bins:] = 1.0 / pitch_bins
    return probabilities.astype(dtype)


def observation(voiced):
    """pYIN's observation probabilities from the voiced half: ``voiced``
    (..., pitch_bins) holds each frame's probability of each voiced bin
    (the YIN troughs' probabilities that land on it); each unvoiced state
    gets (1 - voiced probability) / pitch_bins, the voiced probability
    being the voiced half's sum clipped to [0, 1]. A numpy array or a
    tensor, returned as the same kind, (..., 2 pitch_bins)"""
    pitch_bins = voiced.shape[-1]
    if isinstance(voiced, torch.Tensor):
        voiced_prob = voiced.sum(dim=-1, keepdim=True).clamp(0, 1)
        return torch.cat([voiced, ((1 - voiced_prob) / pitch_bins).expand(
            voiced.shape)], dim=-1)
    voiced = np.asarray(voiced)
    voiced_prob = np.clip(voiced.sum(axis=-1, keepdims=True), 0, 1)
    return np.concatenate([voiced, np.broadcast_to(
        (1 - voiced_prob) / pitch_bins, voiced.shape).astype(
            voiced.dtype)], axis=-1)


def states(indices, pitch_bins=PITCH_BINS):
    """(frequency in Hz, voiced) of decoded state indices, as librosa.pyin
    reads its path: the frequency of the index's pitch bin, voiced where
    the index lies in the first half. Numpy arrays, from an array or a
    tensor anywhere"""
    if isinstance(indices, torch.Tensor):
        indices = indices.cpu().numpy()
    indices = np.asarray(indices)
    return frequencies(pitch_bins)[indices % pitch_bins], indices < pitch_bins
