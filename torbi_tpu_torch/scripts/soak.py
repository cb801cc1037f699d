"""Randomized cross-route soak: every decode route against the oracle.

The port's counterpart of the repo's ``scripts/soak.py``. It decodes a few
hundred random configurations through ``ops/dispatch.decode`` on the
kernel backend and holds every path bitwise against this package's own
numpy oracle (``ops/oracle.py::viterbi_numpy``):

- transitions: dense, banded with a -inf or a finite floor outside the
  band (shifted bands too), constant (the closed form), bands wide enough
  for K1's wide-band design, and tie-heavy integer inputs;
- batch 1-11, ragged lengths, and ``batch_frames`` past ``frames``, held
  against the oracle at ``min(batch_frames, frames)`` (the decoders clamp
  the chase's start there);
- the epsilon step, probability-space input (``log_probs=False``) and
  observations pre-padded to a multiple of 128 states;
- the batch-1 switches ``BAND_BATCH1_SPREAD`` (K4), ``BACKTRACE_BATCH1_FUSED``
  (K5) and ``BACKTRACE_BATCH1_WINDOW`` (K6).

The oracle's input is the observation after the conversion as the decode
device's torch ops compute it (``dispatch.convert``), so a card is held to
its own ``log`` and ``exp``. On the CPU the decode runs the kernels' plain
versions; on the card, the kernels.

    python -m torbi_tpu_torch.scripts.soak [--cases 200] [--seed N] \\
        [--gpu 0|cpu]

Prints each failing case's configuration and exits non-zero on any.
"""
import argparse
import sys

import numpy as np

TINY = np.finfo(np.float32).tiny
SWITCHES = (
    'BAND_BATCH1_SPREAD', 'BACKTRACE_BATCH1_FUSED', 'BACKTRACE_BATCH1_WINDOW')


def _band(rng, states, halfwidth, floor):
    """A row-normalized band transition around a shifted diagonal, taken to
    log(p) (-inf outside) or log(p + tiny) (a finite floor)"""
    rows, cols = np.meshgrid(
        np.arange(states), np.arange(states), indexing='ij')
    shift = int(rng.integers(-2, 3))
    band = np.clip(halfwidth + 1.0 - np.abs(rows - cols + shift), 0, None)
    # A shifted band can leave edge rows empty; rows stay distributions
    band[band.sum(axis=1) == 0, 0] = 1.0
    band = (band / band.sum(axis=1, keepdims=True)).astype(np.float32)
    if floor:
        return np.log(band + TINY)
    with np.errstate(divide='ignore'):
        return np.log(band)


def make_case(rng):
    """One random configuration: a dict of its settings and inputs"""
    kind = str(rng.choice(
        ['dense', 'band', 'bandfloor', 'const', 'ties', 'wide'],
        p=[0.2, 0.22, 0.22, 0.12, 0.16, 0.08]))
    batch = int(rng.choice([1, 1, 2, 3, 5, 8, 11]))
    frames = int(rng.integers(2, 90))
    states = int(rng.choice([5, 17, 40, 129, 200, 256, 384]))
    eps = bool(rng.integers(0, 2))
    log_probs = bool(rng.integers(0, 4))
    if kind == 'wide':
        # Bands no cluster layout of K1 holds: its wide-band design
        batch, frames, states = min(batch, 3), min(frames, 24), 1024
    obs = np.log(rng.dirichlet(
        np.ones(states), size=(batch, frames)).astype(np.float32) + TINY)
    if kind == 'dense':
        trans = np.log(rng.dirichlet(
            np.ones(states), size=states).astype(np.float32) + TINY)
    elif kind == 'const':
        trans = np.full(
            (states, states), np.float32(np.log(1.0 / states)), np.float32)
    elif kind == 'ties':
        # Small integers: equal candidates everywhere, so every reduction
        # must take the lowest source index
        obs = rng.integers(-2, 1, size=obs.shape).astype(np.float32)
        if rng.integers(0, 2):
            trans = -rng.integers(0, 3, size=(states, states)).astype(
                np.float32)
        else:
            trans = np.where(
                _band(rng, states, int(rng.integers(1, 4)), False) > -np.inf,
                -rng.integers(0, 2, size=(states, states)), -8).astype(
                    np.float32)
        eps, log_probs = False, True
    elif kind == 'wide':
        trans = _band(rng, states, int(rng.integers(211, 256)), True)
    else:
        trans = _band(rng, states, int(rng.integers(1, max(2, states // 6))),
                      kind == 'bandfloor')
    init = np.log(rng.dirichlet(np.ones(states)).astype(np.float32) + TINY)
    bf = rng.integers(1, frames + 1, size=batch).astype(np.int32)
    bf[rng.integers(0, batch)] = frames
    if rng.integers(0, 6) == 0:
        # Past the end of the stream: decodes as frames
        bf[rng.integers(0, batch)] = frames + int(rng.integers(1, 9))
    if not log_probs:
        obs = np.exp(obs)
    padded = bool(rng.integers(0, 5) == 0)
    if padded:
        wide_states = -(-states // 128) * 128
        pad = np.full((batch, frames, wide_states),
                      -np.inf if log_probs else 0.0, np.float32)
        pad[..., :states] = obs
        obs = pad
    switches = {name: bool(rng.integers(0, 2)) for name in SWITCHES}
    return dict(kind=kind, batch=batch, frames=frames, states=states,
                eps=eps, log_probs=log_probs, padded=padded,
                switches=switches, obs=obs, trans=trans, init=init, bf=bf)


def describe(case):
    """The settings of a case, without its arrays"""
    return {key: (value.tolist() if key == 'bf' else value)
            for key, value in case.items()
            if key not in ('obs', 'trans', 'init')}


def run_case(case, device):
    """Decode one case on ``device``; returns (path, oracle's path)"""
    import torch

    import torbi_tpu_torch
    from ..ops import dispatch, oracle

    for name, value in case['switches'].items():
        setattr(torbi_tpu_torch, name, value)
    states = case['states']
    obs = torch.from_numpy(case['obs']).to(device)
    got = dispatch.decode(
        obs, case['bf'], case['trans'], case['init'], backend='kernel',
        log_input=case['log_probs'], apply_epsilon=case['eps'],
        device=device)
    converted = dispatch.convert(
        obs[..., :states].contiguous(), case['log_probs'], case['eps'])
    expected = oracle.viterbi_numpy(
        converted.cpu().numpy(), np.minimum(case['bf'], case['frames']),
        case['trans'], case['init'])
    return got.cpu().numpy(), expected


def run(cases=200, seed=20261017, device='cuda', verbose=True):
    """Run ``cases`` seeded configurations on ``device`` ('cuda', 'cpu' or
    a torch.device). Returns {'cases': n, 'kinds': {kind: n}, 'failures':
    [settings of each failing case]}. The batch-1 switches are restored
    afterwards."""
    import torch

    import torbi_tpu_torch

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    saved = {name: getattr(torbi_tpu_torch, name) for name in SWITCHES}
    failures = []
    kinds = {}
    try:
        for index in range(cases):
            case = make_case(rng)
            kinds[case['kind']] = kinds.get(case['kind'], 0) + 1
            got, expected = run_case(case, device)
            if not np.array_equal(got, expected):
                settings = dict(describe(case), case=index)
                failures.append(settings)
                if verbose:
                    print(f'FAIL {settings}', flush=True)
            if verbose and index % 50 == 49:
                print(f'{index + 1} cases done', flush=True)
    finally:
        for name, value in saved.items():
            setattr(torbi_tpu_torch, name, value)
    return {'cases': cases, 'kinds': kinds, 'failures': failures}


def main(argv=None):
    from ..utils.convert import device_argument, resolve_device

    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--cases', type=int, default=200)
    parser.add_argument('--seed', type=int, default=20261017)
    parser.add_argument(
        '--gpu', type=device_argument, default=None,
        help='CUDA index to decode on, or cpu; cuda:0 when omitted')
    args = parser.parse_args(argv)
    device = resolve_device(args.gpu)
    result = run(args.cases, args.seed, device)
    print(f'soak complete: {result["cases"] - len(result["failures"])}/'
          f'{result["cases"]} configurations exact '
          f'(fails={len(result["failures"])}; kinds {result["kinds"]})',
          flush=True)
    return 1 if result['failures'] else 0


if __name__ == '__main__':
    sys.exit(main())
