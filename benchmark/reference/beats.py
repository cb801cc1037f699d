"""madmom's DBN beat tracker and its sparse Viterbi decode, written
plainly: the reference side of the ``dbnbeat5617-default`` configuration.

Written from madmom's ``BeatStateSpace``, ``BeatTransitionModel``
(``exponential_transition``) and ``RNNBeatTrackingObservationModel``
(``madmom/features/beats_hmm.py``) and its ``HiddenMarkovModel.viterbi``
(``madmom/ml/hmm.pyx``), independently of the program: it imports neither
the program nor JAX. The construction runs in float64 and is rounded to
float32 once.

The decode is madmom's: per frame, every in-edge's candidate (the source's
value plus the edge's log probability), a segment max per destination,
and the lowest source among the maxima kept as an explicit backpointer;
then the path from the last frame's first best state back along the
pointers. It departs from madmom where the configuration's guarantees
state torbi's contract:

- it decodes in float32 (madmom: float64), TF32 off;
- the first frame adds the initial distribution to the frame's density
  (madmom applies the transition to the initial distribution first);
- the densities are taken through log(exp(x) + tiny), as
  ``from_probabilities`` always applies that step;
- a destination whose every candidate is -inf points to state 0;
- madmom's beat placement after the path (``correct=True``: each beat
  moved to the activation's peak around it) is not part of the decode and
  is not done here.
"""
import numpy as np
import torch

TINY = float(np.finfo(np.float32).tiny)


def state_space(dbn):
    """(intervals, first states, last states, positions) of the
    configuration's ``dbn`` group, numpy, positions in float64"""
    fps = dbn['fps']
    intervals = np.arange(int(np.round(60.0 * fps / dbn['max_bpm'])),
                          int(np.round(60.0 * fps / dbn['min_bpm'])) + 1)
    first = np.cumsum(np.r_[0, intervals[:-1]])
    last = np.cumsum(intervals) - 1
    positions = np.concatenate([np.linspace(0, 1, i, endpoint=False)
                                for i in intervals])
    return intervals, first, last, positions


def edges(dbn):
    """madmom's transition model as edges: (destinations, sources, log
    probabilities), float64, ordered by destination then source"""
    intervals, first, last, _ = state_space(dbn)
    states = int(intervals.sum())
    # Within a beat: state s - 1 to s, with probability 1
    inside = np.setdiff1d(np.arange(states), first)
    destinations = [inside]
    sources = [inside - 1]
    probabilities = [np.ones(len(inside))]
    # At the beat: exponential_transition between the intervals
    ratio = intervals[None, :].astype(np.float64) / intervals[:, None]
    change = np.exp(-dbn['transition_lambda'] * np.abs(ratio - 1.0))
    change[change <= np.spacing(1)] = 0
    change /= change.sum(axis=1, keepdims=True)
    from_index, to_index = np.nonzero(change)
    destinations.append(first[to_index])
    sources.append(last[from_index])
    probabilities.append(change[from_index, to_index])
    destinations = np.concatenate(destinations)
    sources = np.concatenate(sources)
    order = np.lexsort((sources, destinations))
    with np.errstate(divide='ignore'):
        logs = np.log(np.concatenate(probabilities))
    return destinations[order], sources[order], logs[order]


def states(dbn):
    """The number of states"""
    return int(state_space(dbn)[0].sum())


def beat_states(dbn):
    """Which states are beat states: position below 1 / observation_lambda"""
    return state_space(dbn)[3] < 1.0 / dbn['observation_lambda']


def hmm(dbn, device=None):
    """(edges on ``device``: destinations int64, sources int64, log values
    float32; the dense (states, states) float32 log transition, row =
    destination, zeros -inf; the uniform log initial distribution,
    float32)"""
    destinations, sources, logs = edges(dbn)
    count = states(dbn)
    dense = np.full((count, count), -np.inf, dtype=np.float32)
    dense[destinations, sources] = logs.astype(np.float32)
    initial = np.full(count, np.log(1.0 / count)).astype(np.float32)
    return ((torch.from_numpy(destinations).to(device),
             torch.from_numpy(sources).to(device),
             torch.from_numpy(logs.astype(np.float32)).to(device)),
            torch.from_numpy(dense).to(device),
            torch.from_numpy(initial).to(device))


def log_densities(activations, dbn):
    """(..., frames, states) float32 log densities of activations in (0,
    1), float32: log(p) on the beat states, log((1 - p) /
    (observation_lambda - 1)) on the others"""
    p = activations.to(torch.float32)
    beat = torch.from_numpy(beat_states(dbn)).to(p.device)
    other = torch.log((1 - p) / (dbn['observation_lambda'] - 1))
    return torch.where(beat, torch.log(p)[..., None], other[..., None])


def stabilised(observation):
    """log(exp(x) + tiny), as ``from_probabilities(..., log_probs=True)``
    takes its observation"""
    return torch.log(torch.exp(observation) + TINY)


def decode(observation, row_lengths, edges_, initial):
    """Paths of (rows, frames, states) float32 log densities (already
    stabilised) by madmom's sparse Viterbi with explicit backpointers.
    ``edges_`` as ``hmm`` gives them. Returns (rows, frames) int64, -1 past
    each row's length."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    destinations, sources, logs = edges_
    rows, frames, count = observation.shape
    device = observation.device
    lengths = torch.as_tensor(row_lengths, device=device)
    longest = int(lengths.max())
    targets = destinations[None].expand(rows, -1)
    pointers = torch.zeros((rows, longest, count), dtype=torch.int32,
                           device=device)
    viterbi = observation[:, 0] + initial
    for t in range(1, longest):
        candidates = viterbi[:, sources] + logs
        best = torch.full_like(viterbi, float('-inf')).scatter_reduce(
            1, targets, candidates, 'amax')
        first = torch.where(candidates == best.gather(1, targets),
                            sources[None], count)
        pointer = torch.full((rows, count), count, dtype=torch.int64,
                             device=device).scatter_reduce(
                                 1, targets, first, 'amin')
        pointers[:, t] = torch.where(best == float('-inf'), 0, pointer)
        viterbi = torch.where((t < lengths)[:, None],
                              observation[:, t] + best, viterbi)
    state = viterbi.argmax(dim=1)
    path = torch.full((rows, frames), -1, dtype=torch.int64, device=device)
    every = torch.arange(rows, device=device)
    for t in range(longest - 1, -1, -1):
        live = t < lengths
        path[:, t] = torch.where(live, state, -1)
        if t:
            state = torch.where(
                live, pointers[every, t, state].to(torch.int64), state)
    return path
