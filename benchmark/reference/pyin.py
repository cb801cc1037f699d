"""pYIN's HMM and its conversion to log space: the reference side of the
``pyin1202-default`` configuration.

Written from ``librosa.pyin`` (``librosa/core/pitch.py``) and
``librosa.sequence``'s ``transition_local`` and ``transition_loop`` as
librosa writes them (a window padded to the states and rolled onto each
row, then cut at the edges), in librosa's orientation, row = source,
independently of the program: it imports neither the program nor JAX.
The one place where the matrix is turned to the orientation the program
and ``reference/viterbi.py`` take, row = destination, is marked below.

The configuration's ``pyin`` group holds librosa's parameters; from them:
``ceil(1 / resolution)`` bins a semitone, ``floor(12 bins_per_semitone
log2(fmax / fmin)) + 1`` pitch bins, a triangular window of
``round(max_transition_rate 12 hop_length / sample_rate) bins_per_semitone
+ 1`` bins, and twice the pitch bins in states (voiced, then unvoiced).
The initial distribution is 1 / pitch_bins on each unvoiced state and 0
on each voiced one.

The guarantees state the conversion: the observation as log(p), then
log(exp(x) + tiny), in float32; the transition and the initial
distribution as log(p), so that their zeros are -inf. librosa's own
decode works in float64 with log(p + tiny64); the configuration states
float32, as torbi decodes.
"""
import math

import numpy as np
import torch

TINY = float(np.finfo(np.float32).tiny)


def sizes(pyin):
    """(pitch bins, window width) of the configuration's ``pyin`` group"""
    per_semitone = int(math.ceil(1.0 / pyin['resolution']))
    bins = int(math.floor(
        12 * per_semitone * math.log2(pyin['fmax'] / pyin['fmin']))) + 1
    semitones = round(pyin['max_transition_rate'] * 12 * pyin['hop_length']
                      / pyin['sample_rate'])
    return bins, semitones * per_semitone + 1


def triang(width):
    """``scipy.signal.windows.triang`` (symmetric) for an odd width"""
    n = np.arange(1, (width + 1) // 2 + 1)
    rising = 2 * n / (width + 1.0)
    return np.r_[rising, rising[-2::-1]]


def transition_local(bins, width):
    """librosa's ``transition_local(bins, width, window='triangle',
    wrap=False)``: float64, row = source"""
    transition = np.zeros((bins, bins))
    window = np.zeros(bins)
    start = (bins - width) // 2
    window[start:start + width] = triang(width)
    for i in range(bins):
        row = np.roll(window, bins // 2 + i + 1)
        row[min(bins, i + width // 2 + 1):] = 0
        row[:max(0, i - width // 2)] = 0
        transition[i] = row
    return transition / transition.sum(axis=1, keepdims=True)


def transition_by_source(pyin):
    """librosa's pYIN transition, ``kron(transition_loop(2, 1 -
    switch_prob), transition_local(bins, width))``: float64, row =
    source"""
    switch = pyin['switch_prob']
    loop = np.array([[1 - switch, switch], [switch, 1 - switch]])
    return np.kron(loop, transition_local(*sizes(pyin)))


def hmm(pyin, device=None):
    """(transition, initial) probabilities in float32 on ``device``, the
    transition with row = destination"""
    bins, _ = sizes(pyin)
    # The one transposition: librosa's row is the source, the program's
    # and reference/viterbi.py's the destination
    by_destination = transition_by_source(pyin).T
    initial = np.zeros(2 * bins)
    initial[bins:] = 1.0 / bins
    return (torch.from_numpy(np.ascontiguousarray(by_destination))
            .to(torch.float32).to(device),
            torch.from_numpy(initial).to(torch.float32).to(device))


def log_hmm(transition, initial):
    """The transition and the initial distribution as log(p), float32:
    zeros are -inf"""
    return torch.log(transition), torch.log(initial)


def log_observation(probabilities):
    """The observation as log(p), then log(exp(x) + tiny), float32"""
    return torch.log(torch.exp(torch.log(probabilities)) + TINY)
