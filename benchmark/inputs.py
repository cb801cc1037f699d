"""Inputs made from the seed: utterance lengths, pitch posteriorgrams and
the pitch transition.

Rewritten in torch from ``torbi_tpu_torch/models/pitch.py`` (penn's
transition matrix and the synthetic posteriorgrams of the repo's
benchmarks), so that the inputs are made on the card, in a few large
calls, and so that the yardstick does not move with the program.

Every seed decodes the same work: the lengths are one fixed set, the
quantiles of a log-normal law, and the seed only orders them and draws the
posteriorgrams' pitch walks.
"""
import math
import statistics

import torch

TINY = torch.finfo(torch.float32).tiny


def lengths(count, median, sigma, low, high):
    """The fixed set of ``count`` utterance lengths in frames, ascending:
    the quantiles (i + 1/2) / count of a log-normal law of ``median`` and
    ``sigma`` (natural log), rounded and clipped to [low, high]"""
    normal = statistics.NormalDist()
    return sorted(
        min(high, max(low, round(
            median * math.exp(sigma * normal.inv_cdf((i + 0.5) / count)))))
        for i in range(count))


def host_generator(seed):
    """A CPU generator of ``seed`` (any whole number up to 2**64 - 1), for
    the choices made on the host: orders and samples"""
    return torch.Generator().manual_seed(seed % 2 ** 64)


def device_generator(seed, device):
    """A generator of ``seed`` on ``device``, for the inputs' contents"""
    return torch.Generator(device=device).manual_seed(seed % 2 ** 64)


def max_bins_per_frame(transition):
    """The most pitch bins a hop moves, plus one (penn's constants)"""
    octaves_per_frame = (transition['max_octaves_per_second']
                         * transition['hopsize'] / transition['sample_rate'])
    bins_per_octave = transition['octave'] / transition['cents_per_bin']
    return octaves_per_frame * bins_per_octave + 1


def transition_probabilities(config, device):
    """penn's pitch transition, (states, states) float32 probabilities:
    clip(max_bins_per_frame - |i - j|, 0), each row normalised"""
    states = int(config['states'])
    bins = torch.arange(states, dtype=torch.float64, device=device)
    matrix = (max_bins_per_frame(config['transition'])
              - (bins[:, None] - bins[None, :]).abs()).clamp(min=0)
    return (matrix / matrix.sum(dim=1, keepdim=True)).to(torch.float32)


def log_transition(probabilities):
    """log(p + tiny) in float32, the transition as it is decoded"""
    return torch.log(probabilities + TINY)


def posteriorgrams(row_lengths, states, generator, device, slab=32):
    """(rows, longest, states) float32 log-probabilities: for each row a
    random walk of pitch centres (steps of -3 to 3 bins, clipped to the
    bins), a Gaussian of 3 bins around each centre, normalised and taken
    to log(p + tiny); the frames past a row's length are zero, as a batch
    collated from files pads them"""
    rows, frames = len(row_lengths), max(row_lengths)
    steps = torch.randint(
        -3, 4, (rows, frames), generator=generator, device=device)
    centres = (steps.cumsum(dim=1) + states // 2).clamp(0, states - 1)
    centres = centres.to(torch.float32)
    bins = torch.arange(states, dtype=torch.float32, device=device)
    out = torch.empty((rows, frames, states), dtype=torch.float32,
                      device=device)
    for start in range(0, rows, slab):
        logits = -0.5 * ((bins - centres[start:start + slab, :, None])
                         / 3.0) ** 2
        logits -= torch.logsumexp(logits, dim=-1, keepdim=True)
        out[start:start + slab] = torch.log(torch.exp(logits) + TINY)
    lengths_ = torch.as_tensor(row_lengths, device=device)
    padding = (torch.arange(frames, device=device)[None, :]
               >= lengths_[:, None])
    return out.masked_fill_(padding[..., None], 0.0)


def permuted(values, generator):
    """``values`` in the order of a seeded permutation"""
    order = torch.randperm(len(values), generator=generator).tolist()
    return [values[i] for i in order]


def sample(count, size, generator, always=()):
    """Sorted indices of ``size`` of ``count`` items drawn from the
    generator, with the items of ``always`` among them"""
    chosen = list(dict.fromkeys(always))
    for index in torch.randperm(count, generator=generator).tolist():
        if len(chosen) >= min(size, count):
            break
        if index not in chosen:
            chosen.append(index)
    return sorted(chosen)
