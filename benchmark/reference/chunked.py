"""Plain chunked Viterbi decoding in PyTorch: the reference that decides
``correct`` for long recordings decoded one a call.

The contract of the long-recording configuration: the recording is split
at low-entropy frames and each chunk's exact Viterbi path is the answer
there. Written out from the contract alone, with nothing of the program:

1. each frame's normalised entropy, -sum(exp(x) x) / log(states) over
   the observation as the caller passes it, in float64;
2. the split points, a greedy walk: ``n_target = max(8, ceil(valid /
   chunk_frames))``, ``min_chunk = valid // n_target``; the first split is
   the first frame t >= min_chunk whose own entropy and its predecessor's
   are both below the threshold, each next one the first such frame at
   least ``min_chunk`` after the one before;
3. fewer than 3 split points, or fewer valid frames than ``min_frames``,
   and the recording is one chunk: the full sequence's exact path;
4. each chunk decoded by ``viterbi.decode_blocks`` in float32 with the
   default initial distribution and the observation as
   ``log_probs=True`` converts it, and the chunks' paths joined.

Departures from torbi's ``chunk.py`` (torbi splits where
``MIN_CHUNK_SIZE`` says and decodes every chunk, whatever their number):
the row target ``max(8, ceil(valid / chunk_frames))`` and the rule of at
least 3 split points are the port's batch-1 auto-chunking. Two more rules
of the port are left out, because the recordings of the configuration
never reach them: it declines a recording of more than 2/5 of its memory
budget (312,500 frames at 1440 states; the recordings stop at 180,000),
and one whose 8-row tiles times its longest chunk's frame bucket exceed
half the whole recording's bucket (with unvoiced runs of at most 300
frames the longest chunk stays below ``min_chunk`` + 302 frames, and from
10,240 frames to 180,000 the tiles' side of that rule comes to at most
4/5 of the other at 1280 frames a chunk).

``decode`` sets TF32 off, as a float32 reference must on this card: no
matrix product runs there, and none may run in a lower precision unasked.
"""
import math

import torch

from benchmark.reference import viterbi


def entropy(observation):
    """Normalised entropy of each frame of a (frames, states) log-space
    observation, in float64: (frames,) float64 on its device"""
    values = observation.to(torch.float64)
    return -(torch.exp(values) * values).sum(dim=1) / math.log(
        observation.shape[1])


def split_points(entropy_values, valid, chunk_frames, threshold):
    """The greedy walk's split points in the first ``valid`` frames, from
    each frame's normalised entropy (a sequence of floats)"""
    n_target = max(8, -(-valid // chunk_frames))
    min_chunk = valid // n_target
    below = [value < threshold for value in entropy_values[:valid]]
    points, position = [], min_chunk
    for frame in range(max(1, position), valid):
        if frame >= position and below[frame] and below[frame - 1]:
            points.append(frame)
            position = frame + min_chunk
    return points


def plan(entropy_values, valid, chunk_frames, threshold, min_frames):
    """[(start, length)] of the chunks of the first ``valid`` frames: one
    chunk where the contract decodes the whole sequence"""
    points = []
    if valid >= min_frames:
        points = split_points(entropy_values, valid, chunk_frames, threshold)
    if len(points) < 3:
        return [(0, valid)]
    edges = [0] + points + [valid]
    return [(start, stop - start) for start, stop in zip(edges, edges[1:])]


def chunks(observation, chunk_plan):
    """The chunks of a (frames, states) observation, as
    ``from_probabilities(..., log_probs=True)`` converts them: a list of
    (length, states) float32 tensors"""
    return [viterbi.stabilised(observation[start:start + length])
            for start, length in chunk_plan]


def decode(observations, chunk_plans, transition, initial,
           dtype=torch.float32):
    """The path of each (frames, states) observation under its plan:
    every recording's chunks decoded together in blocks of rows of like
    length (``viterbi.decode_blocks``), then joined; a list of int64
    paths"""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, lengths = [], []
    for observation, chunk_plan in zip(observations, chunk_plans):
        rows += chunks(observation, chunk_plan)
        lengths += [length for _, length in chunk_plan]
    paths = viterbi.decode_blocks(rows, lengths, transition, initial, dtype)
    joined = []
    for chunk_plan in chunk_plans:
        joined.append(torch.cat(paths[:len(chunk_plan)]))
        paths = paths[len(chunk_plan):]
    return joined
