"""madmom's DBN beat tracker: the bar-pointer HMM of its
``DBNBeatTrackingProcessor``.

The hidden Markov model of Krebs, Böck & Widmer ("An Efficient State-Space
Model for Joint Tempo and Meter Tracking", ISMIR 2015) as madmom builds it
(``madmom/features/beats.py``, ``madmom/features/beats_hmm.py``:
``BeatStateSpace``, ``BeatTransitionModel``,
``RNNBeatTrackingObservationModel``) at the processor's defaults: 55-215
bpm at 100 frames a second, ``transition_lambda`` 100 and
``observation_lambda`` 16. Written here from madmom's formulas, so this
package needs no madmom.

Each beat interval of ``intervals()`` frames (28-109 at the defaults: 82
tempi) holds that many states, its positions ``linspace(0, 1, interval,
endpoint=False)`` within the beat: ``STATES`` = 5617 states. A state moves
to the next position of its interval with probability 1; the last state of
an interval moves to the first state of every interval, with probability
``exp(-lambda |to / from - 1|)``, set to 0 at or below ``np.spacing(1)``
and each source's row normalised. So 8,934 of the 31.55M pairs are
positive, and a decode takes the in-list route (``ops/sparse.py``). The
observation is the beat network's activation ``p`` a frame: ``log(p)`` on
the beat states (positions below 1 / observation_lambda, 389 states) and
``log((1 - p) / (observation_lambda - 1))`` on the others. A decode takes
the log densities as torbi does::

    transition = beats.transition_matrix()
    indices = torbi_tpu_torch.from_probabilities(
        beats.observation(activations), batch_frames, transition,
        beats.initial(), log_probs=True)

madmom decodes in float64 and applies the transition to the initial
distribution before the first frame; torbi decodes in float32 and adds
the initial distribution to the first frame.
"""
import collections

import numpy as np
import torch

# DBNBeatTrackingProcessor's defaults
MIN_BPM = 55.0
MAX_BPM = 215.0
FPS = 100
TRANSITION_LAMBDA = 100.0
OBSERVATION_LAMBDA = 16

StateSpace = collections.namedtuple(
    'StateSpace', 'intervals first_states last_states positions '
    'state_intervals states')


def intervals(min_bpm=MIN_BPM, max_bpm=MAX_BPM, fps=FPS):
    """The beat intervals in frames: round(60 fps / max_bpm) to
    round(60 fps / min_bpm), each once"""
    return np.arange(int(np.round(60.0 * fps / max_bpm)),
                     int(np.round(60.0 * fps / min_bpm)) + 1)


def state_space(min_bpm=MIN_BPM, max_bpm=MAX_BPM, fps=FPS):
    """madmom's ``BeatStateSpace``: the intervals, each interval's first
    and last state, every state's position within its beat (float64) and
    interval, and the number of states"""
    spans = intervals(min_bpm, max_bpm, fps)
    positions = np.concatenate(
        [np.linspace(0, 1, interval, endpoint=False) for interval in spans])
    return StateSpace(
        intervals=spans,
        first_states=np.cumsum(np.r_[0, spans[:-1]]),
        last_states=np.cumsum(spans) - 1,
        positions=positions,
        state_intervals=np.repeat(spans, spans),
        states=int(spans.sum()))


STATES = state_space().states


def tempo_change(spans, transition_lambda=TRANSITION_LAMBDA):
    """madmom's ``exponential_transition``: (from, to) float64
    probabilities between the intervals, exp(-lambda |to / from - 1|),
    0 at or below np.spacing(1), each row (a source) normalised"""
    ratio = spans[None, :].astype(np.float64) / spans[:, None]
    probabilities = np.exp(-transition_lambda * np.abs(ratio - 1.0))
    probabilities[probabilities <= np.spacing(1)] = 0
    return probabilities / probabilities.sum(axis=1, keepdims=True)


def transition_matrix(min_bpm=MIN_BPM, max_bpm=MAX_BPM, fps=FPS,
                      transition_lambda=TRANSITION_LAMBDA):
    """The (states, states) log transition, float32 numpy, row =
    destination (madmom's CSR rows are the destinations too), computed in
    float64 and rounded once; zeros are -inf"""
    space = state_space(min_bpm, max_bpm, fps)
    probabilities = np.zeros((space.states, space.states))
    # Along each beat: the next position, with probability 1
    others = np.setdiff1d(np.arange(space.states), space.first_states)
    probabilities[others, others - 1] = 1.0
    # At the beat: the last state of every interval to the first of every
    # interval (sources are rows of tempo_change, destinations columns)
    change = tempo_change(space.intervals, transition_lambda)
    probabilities[np.ix_(space.first_states, space.last_states)] = change.T
    with np.errstate(divide='ignore'):
        return np.log(probabilities).astype(np.float32)


def initial(states=STATES):
    """The uniform initial distribution, log(1 / states), float32 numpy"""
    return np.full(states, np.log(1.0 / states), dtype=np.float32)


def beat_states(min_bpm=MIN_BPM, max_bpm=MAX_BPM, fps=FPS,
                observation_lambda=OBSERVATION_LAMBDA):
    """Which states are beat states: position below 1 /
    observation_lambda (madmom's observation pointers)"""
    return state_space(min_bpm, max_bpm, fps).positions < (
        1.0 / observation_lambda)


def observation(activations, observation_lambda=OBSERVATION_LAMBDA,
                min_bpm=MIN_BPM, max_bpm=MAX_BPM, fps=FPS):
    """The log densities of the beat network's activations (..., frames),
    in (0, 1): log(p) on each beat state, log((1 - p) / (observation_lambda
    - 1)) on the others, (..., frames, states) float32. A numpy array or a
    tensor (on its device), returned as the same kind"""
    beat = beat_states(min_bpm, max_bpm, fps, observation_lambda)
    if isinstance(activations, torch.Tensor):
        p = activations.to(torch.float32)
        mask = torch.from_numpy(beat).to(p.device)
        return torch.where(mask, torch.log(p)[..., None],
                           torch.log((1 - p) / (observation_lambda - 1))[
                               ..., None])
    p = np.asarray(activations, dtype=np.float32)
    return np.where(beat, np.log(p)[..., None],
                    np.log((1 - p) / np.float32(observation_lambda - 1))[
                        ..., None]).astype(np.float32)


def positions(indices, min_bpm=MIN_BPM, max_bpm=MAX_BPM, fps=FPS):
    """(position within the beat, interval in frames) of decoded state
    indices, numpy, from an array or a tensor anywhere: madmom reads its
    beats where the position starts a beat"""
    if isinstance(indices, torch.Tensor):
        indices = indices.cpu().numpy()
    space = state_space(min_bpm, max_bpm, fps)
    indices = np.asarray(indices)
    return space.positions[indices], space.state_intervals[indices]
