"""Plain Viterbi decoding in PyTorch: the reference that decides
``correct``.

The literal dense recursion: at each frame every destination takes the
best of all sources, ``post[s] + transition[d, s]`` (the transition's row
is the destination), the first source on a tie, then adds the frame's
observation; a row's values freeze past its length; the path starts from
the first best state of its last frame and follows the stored choices
back. It uses neither the band nor any table of the program, and runs in
the precision asked for (float32, as the configurations state; a lower
one is the control that the comparison must fail).

The entry points convert their inputs as torbi documents: with
``log_probs`` the observation is stabilised as log(exp(x) + tiny), the
default initial distribution is log(1/S + tiny).
"""
import math

import numpy as np
import torch

TINY = float(np.finfo(np.float32).tiny)


def default_initial(states, device=None):
    """The uniform initial distribution, log(1/S + tiny), in float32"""
    return torch.full((states,), math.log(1.0 / states + TINY),
                      dtype=torch.float32, device=device)


def stabilised(observation):
    """log(exp(x) + tiny), as ``from_probabilities(..., log_probs=True)``
    takes its observation"""
    return torch.log(torch.exp(observation) + TINY)


def decode(observation, row_lengths, transition, initial,
           dtype=torch.float32):
    """Paths of (rows, frames, states) log-probabilities.

    observation, transition (states, states) and initial (states,) are
    log-probabilities on one device; ``row_lengths`` holds each row's
    frames. Returns (rows, frames) int64, -1 past each row's length.
    """
    obs = observation.to(dtype)
    trans = transition.to(dtype)
    rows, frames, states = obs.shape
    device = obs.device
    lengths = torch.as_tensor(row_lengths, device=device)
    longest = int(lengths.max())
    choices = torch.zeros((rows, longest, states), dtype=torch.int32,
                          device=device)
    post = obs[:, 0] + initial.to(dtype)
    for t in range(1, longest):
        best, choice = (post[:, None, :] + trans[None]).max(dim=2)
        choices[:, t] = choice
        post = torch.where((t < lengths)[:, None], obs[:, t] + best, post)
    state = post.argmax(dim=1)
    path = torch.full((rows, frames), -1, dtype=torch.int64, device=device)
    every = torch.arange(rows, device=device)
    for t in range(longest - 1, -1, -1):
        live = t < lengths
        path[:, t] = torch.where(live, state, -1)
        if t:
            state = torch.where(
                live, choices[every, t, state].to(torch.int64), state)
    return path


def decode_blocks(observations, row_lengths, transition, initial,
                  dtype=torch.float32, block=64):
    """``decode`` over rows given one by one, in blocks of ``block`` rows
    of similar length, so that it fits beside little memory.

    observations: a list of (frames_i, states) tensors (at least each
    row's length); returns a list of int64 paths of each row's length.
    """
    order = sorted(range(len(row_lengths)), key=lambda i: row_lengths[i])
    paths = [None] * len(order)
    for start in range(0, len(order), block):
        members = order[start:start + block]
        lengths = [row_lengths[i] for i in members]
        longest = max(lengths)
        batch = torch.zeros(
            (len(members), longest, observations[members[0]].shape[-1]),
            dtype=torch.float32, device=transition.device)
        for row, i in enumerate(members):
            batch[row, :lengths[row]] = observations[i][:lengths[row]]
        decoded = decode(batch, lengths, transition, initial, dtype)
        for row, i in enumerate(members):
            paths[i] = decoded[row, :lengths[row]]
        del batch, decoded
    return paths
