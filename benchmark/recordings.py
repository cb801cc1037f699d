"""Long recordings made from the seed: pitch posteriorgrams of voiced and
unvoiced stretches, one recording a call.

Voiced and unvoiced runs alternate, the first run's kind drawn from the
seed, each run's length drawn from a log-normal law of its kind (median,
sigma in natural log, rounded and clipped to [low, high]). A voiced frame
is the Gaussian of ``inputs.posteriorgrams`` (``bins`` 3) around a pitch
walk (steps of -3 to 3 bins, clipped to the bins) that starts at a centre
drawn at each voiced onset; an unvoiced frame a wide Gaussian (``bins``
200) around a centre drawn for its run. Each frame is normalised and taken
to log(p + tiny) in float32, on the device, in slabs of frames.

A frame's normalised entropy decides whether a split may land there: the
program computes it in float32, the reference (``reference/chunked.py``)
in float64, so a frame at the threshold would be a tie that the two sums
may break either way, and the comparison would be ill-posed. The
generator raises unless every frame lies at least ``MARGIN`` from the
threshold (voiced frames lie near 0.35 at 1440 states, unvoiced near
0.92).
"""
import collections

import torch

from benchmark import inputs
from benchmark.reference import chunked

MARGIN = 0.1

# One recording: ``observation`` (frames, states) float32 log
# probabilities, ``entropy`` (frames,) float64 (the reference's), and
# ``voiced`` (frames,) bool, on the device it was made on
Recording = collections.namedtuple(
    'Recording', ('observation', 'entropy', 'voiced'))


def run_lengths(count, law, generator, device):
    """``count`` run lengths of ``law`` ({median, sigma, low, high}), drawn
    from the generator: (count,) int64"""
    normal = torch.randn(count, generator=generator, device=device,
                         dtype=torch.float64)
    lengths = (law['median'] * torch.exp(law['sigma'] * normal)).round()
    return lengths.clamp(law['low'], law['high']).to(torch.int64)


def voicing(frames, laws, generator, device):
    """(voiced, run) of ``frames`` frames: whether each frame is voiced,
    (frames,) bool, and the index of its run, (frames,) int64"""
    voiced_first = bool(torch.randint(
        2, (1,), generator=generator, device=device))
    # Enough pairs of runs to cover the frames at the shortest lengths
    pairs = frames // (laws['voiced']['low'] + laws['unvoiced']['low']) + 1
    voiced = run_lengths(pairs, laws['voiced'], generator, device)
    unvoiced = run_lengths(pairs, laws['unvoiced'], generator, device)
    order = (voiced, unvoiced) if voiced_first else (unvoiced, voiced)
    ends = torch.stack(order, dim=1).flatten().cumsum(0)
    run = torch.searchsorted(
        ends, torch.arange(frames, device=device), right=True)
    return (run % 2 == 0) == voiced_first, run


def recording(frames, states, laws, threshold, generator, device,
              slab=8192):
    """One recording of ``frames`` frames (``Recording``), its voicing
    drawn by ``laws`` ({'voiced': law, 'unvoiced': law}, each law with the
    Gaussian's ``bins``); raises ValueError where a frame lies nearer the
    entropy ``threshold`` than ``MARGIN``"""
    voiced, run = voicing(frames, laws, generator, device)
    runs = int(run[-1]) + 1
    centres = torch.randint(
        states, (runs,), generator=generator, device=device)
    steps = torch.randint(
        -3, 4, (frames,), generator=generator, device=device)
    # The walk restarts at each run's centre: the steps summed since the
    # run's first frame
    walk = steps.cumsum(0)
    first = torch.searchsorted(run, torch.arange(runs, device=device))
    walk = walk - walk[first][run]
    centre = torch.where(voiced, (centres[run] + walk).clamp(0, states - 1),
                         centres[run]).to(torch.float32)
    width = torch.where(voiced, float(laws['voiced']['bins']),
                        float(laws['unvoiced']['bins']))
    bins = torch.arange(states, dtype=torch.float32, device=device)
    observation = torch.empty((frames, states), dtype=torch.float32,
                              device=device)
    entropy = torch.empty(frames, dtype=torch.float64, device=device)
    for start in range(0, frames, slab):
        part = slice(start, start + slab)
        logits = -0.5 * ((bins - centre[part, None])
                         / width[part, None]) ** 2
        logits -= torch.logsumexp(logits, dim=-1, keepdim=True)
        observation[part] = torch.log(torch.exp(logits) + inputs.TINY)
        entropy[part] = chunked.entropy(observation[part])
    nearest = float((entropy - threshold).abs().min())
    if nearest < MARGIN:
        raise ValueError(
            f'a frame lies {nearest:.3f} from the entropy threshold '
            f'{threshold}, nearer than {MARGIN}: the float32 and float64 '
            'entropies could split it differently')
    return Recording(observation, entropy, voiced)
