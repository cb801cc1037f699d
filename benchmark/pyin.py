"""pYIN's observations made from the seed, on the device: a batch of
utterances of voiced and unvoiced runs, as probabilities.

Each frame is what ``librosa.pyin`` hands its decode
(``observation_probs``): the voiced half, one value a pitch bin (the
probabilities of the YIN troughs that land on it), and the unvoiced half,
``(1 - voiced_prob) / bins`` on every state, ``voiced_prob`` the voiced
half's sum clipped to [0, 1]. So every frame sums to 1 and its unvoiced
half holds ``bins`` equal values.

The frames of a batch are drawn as one stream, its rows taken one after
another (``row_lengths``). Voiced and unvoiced runs alternate
(``recordings.voicing``, the first run's kind drawn from the seed), their
lengths drawn from the mix's ``voicing`` laws. On a voiced frame the
pitch bin of a walk (steps of ``-step`` to ``step`` bins, clipped to the
bins, restarted at a centre drawn at each run's and each row's first
frame) holds a mass drawn in ``peak``; with the chance ``octave_chance``
the bin ``octave_bins`` above or below it (the side drawn, the other
where the drawn one lies off the bins) holds a mass drawn in
``octave_mass``, at most 1 less the peak's. An unvoiced frame puts a mass
drawn in ``stray_mass`` on one bin drawn at random, with the chance
``stray_chance``, and nothing elsewhere in its voiced half. A batch's
frames past a row's length are zero, as a batch collated from files pads
them.
"""
import torch

from benchmark import recordings


def uniform(count, bounds, generator, device):
    """``count`` float32 draws uniform in ``bounds`` (low, high)"""
    low, high = bounds
    return low + (high - low) * torch.rand(
        count, generator=generator, device=device)


def observations(row_lengths, bins, mix, generator, device):
    """(rows, longest, 2 bins) float32 probabilities of rows of
    ``row_lengths`` frames, by the mix's ``voicing`` and ``frames``
    parameters"""
    frames = mix['frames']
    rows, longest, total = len(row_lengths), max(row_lengths), sum(
        row_lengths)
    voiced, run = recordings.voicing(total, mix['voicing'], generator, device)
    lengths = torch.as_tensor(row_lengths, device=device)
    row = torch.repeat_interleave(torch.arange(rows, device=device), lengths)
    starts = lengths.cumsum(0) - lengths
    # Where each frame lies in the (rows x longest) batch
    at = row * longest + torch.arange(total, device=device) - starts[row]
    # The walk restarts at each run's first frame and at each row's
    first = torch.ones(total, dtype=torch.bool, device=device)
    first[1:] = (run[1:] != run[:-1]) | (row[1:] != row[:-1])
    segment = first.cumsum(0) - 1
    centres = torch.randint(bins, (int(segment[-1]) + 1,),
                            generator=generator, device=device)
    walk = torch.randint(-frames['step'], frames['step'] + 1, (total,),
                         generator=generator, device=device).cumsum(0)
    walk = walk - walk[first][segment]
    pitch = (centres[segment] + walk).clamp(0, bins - 1)

    peak = uniform(total, frames['peak'], generator, device)
    octave = voiced & (torch.rand(total, generator=generator, device=device)
                       < frames['octave_chance'])
    octave_mass = torch.minimum(
        uniform(total, frames['octave_mass'], generator, device), 1 - peak)
    side = torch.randint(2, (total,), generator=generator, device=device)
    above = pitch + frames['octave_bins']
    below = pitch - frames['octave_bins']
    octave_bin = torch.where((side == 1) & (above < bins) | (below < 0),
                             above, below)
    stray = ~voiced & (torch.rand(total, generator=generator, device=device)
                       < frames['stray_chance'])
    stray_mass = uniform(total, frames['stray_mass'], generator, device)
    stray_bin = torch.randint(bins, (total,), generator=generator,
                              device=device)

    out = torch.zeros((rows * longest, 2 * bins), dtype=torch.float32,
                      device=device)
    out[at[voiced], pitch[voiced]] = peak[voiced]
    out[at[octave], octave_bin[octave]] = octave_mass[octave]
    out[at[stray], stray_bin[stray]] = stray_mass[stray]
    voiced_prob = out[at, :bins].sum(dim=1).clamp(0, 1)
    out[at, bins:] = ((1 - voiced_prob) / bins)[:, None]
    return out.view(rows, longest, 2 * bins)
