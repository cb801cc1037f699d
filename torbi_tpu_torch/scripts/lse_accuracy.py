"""Accuracy of the smoothed-max decode (``backend='lse'``) against exact
Viterbi.

The port's counterpart of the repo's ``scripts/lse_accuracy.py``. Decodes
synthetic peaked pitch posteriorgrams (``models/pitch.py::
synthetic_posteriorgrams``, the benchmark's generator) under a
band-diagonal transition scaled to the state count, with the exact kernel
route and with ``ops/lse.py::decode_lse`` at several temperatures, and
prints one JSON line per temperature: the raw pitch accuracy (RPA) of the
approximate path against the exact one at 0, 1 and 2 bins, and the largest
difference in bins.

    python -m torbi_tpu_torch.scripts.lse_accuracy [--batch 64] \\
        [--frames 256] [--states 360] [--betas 2,4,8,16,32,64] [--seed 0] \\
        [--gpu 0|cpu]
"""
import argparse
import json

import numpy as np


def transition(states):
    """The band-diagonal pitch-style transition of the JAX script,
    log(p + tiny)"""
    tiny = np.finfo(np.float32).tiny
    xx, yy = np.meshgrid(
        np.arange(states), np.arange(states), indexing='ij')
    halfwidth = max(states // 16, 4)
    trans = np.clip(halfwidth + 1.0 - np.abs(xx - yy), 0, None)
    trans = trans / trans.sum(axis=1, keepdims=True)
    return np.log(trans.astype(np.float32) + tiny)


def run(batch, frames, states, betas, seed, device):
    """One dict per temperature in ``betas``: beta, rpa0, rpa1, rpa2 and
    max_abs_err_bins of the smoothed-max path against the exact one"""
    import torch

    from ..models.pitch import synthetic_posteriorgrams
    from ..ops import dispatch
    from ..ops.lse import decode_lse

    tiny = np.finfo(np.float32).tiny
    obs = torch.from_numpy(synthetic_posteriorgrams(
        batch, frames, states, seed=seed)).to(device)
    trans = torch.from_numpy(transition(states)).to(device)
    init = torch.from_numpy(np.log(
        np.full(states, 1.0 / states, dtype=np.float32) + tiny)).to(device)
    bf = torch.full((batch,), frames, dtype=torch.int32, device=device)

    exact = dispatch.decode(
        obs, bf, trans, init, finite_observation=True, device=device)
    rows = []
    for beta in betas:
        approx = decode_lse(obs, bf, trans, init, beta=beta)
        err = (approx.long() - exact.long()).abs()
        rows.append({
            'beta': beta,
            'rpa0': round(float((err == 0).double().mean()), 6),
            'rpa1': round(float((err <= 1).double().mean()), 6),
            'rpa2': round(float((err <= 2).double().mean()), 6),
            'max_abs_err_bins': int(err.max()),
        })
    return rows


def main(argv=None):
    from ..utils.convert import device_argument, resolve_device

    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--batch', type=int, default=64)
    parser.add_argument('--frames', type=int, default=256)
    parser.add_argument('--states', type=int, default=360)
    parser.add_argument('--betas', default='2,4,8,16,32,64')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument(
        '--gpu', type=device_argument, default=None,
        help='CUDA index to decode on, or cpu; cuda:0 when omitted')
    args = parser.parse_args(argv)
    rows = run(args.batch, args.frames, args.states,
               [float(beta) for beta in args.betas.split(',')], args.seed,
               resolve_device(args.gpu))
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == '__main__':
    main()
