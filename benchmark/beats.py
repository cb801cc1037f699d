"""A beat network's activations made from the seed, and the log densities
of madmom's DBN beat tracker over them, on the device.

Each track's activation (one value a frame in (0, 1), what madmom's
``RNNBeatProcessor`` hands its ``DBNBeatTrackingProcessor``) is drawn on
the host from the seed, by the mix's ``activations`` parameters: a start
tempo from a log-normal law (``tempo``: median bpm, sigma, clipped to
[low, high]) that drifts by a factor in [1 - drift, 1 + drift] a beat;
with the chance ``change_chance`` one tempo change by a factor drawn in
``change``, at a beat drawn at random; every tempo clipped to ``bpm``.
The first beat falls within the first interval. On each beat's frame a
peak drawn in ``beat`` (missed with the chance ``miss_chance``), on its
two neighbours a share drawn in ``neighbour`` of it; with the chance
``offbeat_chance`` a peak drawn in ``offbeat`` half-way to the next beat;
elsewhere a background drawn in ``background``; everything clipped to
[clip, 1 - clip].

The log densities (``reference/beats.py``: log(p) on the beat states,
log((1 - p) / 15) on the others) of a batch are made on the device in one
pass, (rows, longest, states) float32, zero past each row's length as a
batch collated from files pads it.
"""
import math

import torch

from benchmark.reference import beats as reference


def uniform(count, bounds, generator):
    """``count`` float64 draws uniform in ``bounds`` (low, high)"""
    low, high = bounds
    return low + (high - low) * torch.rand(count, generator=generator,
                                           dtype=torch.float64)


def activation(frames, law, fps, generator):
    """One track's (frames,) float32 activation on the host"""
    tempo = law['tempo']
    start = tempo['median'] * math.exp(tempo['sigma'] * float(torch.randn(
        1, generator=generator, dtype=torch.float64)))
    start = min(tempo['high'], max(tempo['low'], start))
    # Enough beats for the fastest tempo
    beats = int(frames * law['bpm'][1] / (60.0 * fps)) + 2
    drift = uniform(beats, (1 - law['drift'], 1 + law['drift']), generator)
    bpm = start * torch.cumprod(drift, 0)
    if float(torch.rand(1, generator=generator)) < law['change_chance']:
        at = int(torch.randint(1, beats, (1,), generator=generator))
        bpm[at:] *= float(uniform(1, law['change'], generator))
    bpm = bpm.clamp(*law['bpm'])
    intervals = 60.0 * fps / bpm
    times = float(torch.rand(1, generator=generator,
                             dtype=torch.float64)) * intervals[0] + torch.cat(
        [torch.zeros(1, dtype=torch.float64), intervals.cumsum(0)[:-1]])
    peak = uniform(beats, law['beat'], generator)
    kept = torch.rand(beats, generator=generator) >= law['miss_chance']
    left = peak * uniform(beats, law['neighbour'], generator)
    right = peak * uniform(beats, law['neighbour'], generator)
    offbeat = torch.rand(beats, generator=generator) < law['offbeat_chance']
    offbeat_peak = uniform(beats, law['offbeat'], generator)
    middles = torch.cat([(times[:-1] + times[1:]) / 2, times[-1:] + 1e9])

    values = uniform(frames, law['background'], generator)

    def place(at, value, where):
        at = at.round().to(torch.int64)
        where = where & (at >= 0) & (at < frames)
        values.scatter_reduce_(0, at[where], value[where], 'amax')

    place(times, peak, kept)
    place(times - 1, left, kept)
    place(times + 1, right, kept)
    place(middles, offbeat_peak, offbeat)
    return values.clamp(law['clip'], 1 - law['clip']).to(torch.float32)


def activations(row_lengths, law, fps, generator):
    """Every track's activation, in the order of ``row_lengths``"""
    return [activation(frames, law, fps, generator)
            for frames in row_lengths]


def log_densities(rows, dbn, device):
    """(len(rows), longest, states) float32 log densities on ``device`` of
    the activations ``rows`` (host tensors), zero past each row's length"""
    longest = max(len(row) for row in rows)
    padded = torch.full((len(rows), longest), 0.5, dtype=torch.float32)
    for index, row in enumerate(rows):
        padded[index, :len(row)] = row
    out = reference.log_densities(padded.to(device), dbn)
    for index, row in enumerate(rows):
        out[index, len(row):] = 0
    return out
