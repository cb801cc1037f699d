"""Approximate Viterbi via log-sum-exp (smoothed max-plus).

Counterpart of ``torbi_tpu/ops/lse.py``. The exact max-plus recursion has
no matrix-product structure, but its temperature-beta smoothing

    score[j] = (1/beta) * logsumexp_i( beta * (post[i] + T[j, i]) )
             = (1/beta) * log( sum_i exp(beta*post[i]) * exp(beta*T[j,i]) )

is a plain matrix product of exp(beta*post) with exp(beta*T)^T. As beta ->
inf it converges to exact Viterbi; each step's error is at most
log(S)/beta, and on peaked posteriorgrams the decoded path is almost
always the exact one. Per step (float32, per-sequence and per-row
normalization against exp underflow):

    c = max(post);  u = exp(beta * (post - c))          # u in (0, 1]
    E[i, j] = exp(beta * (T[j, i] - r[j])), r = rowmax  # E in (0, 1]
    v = u @ E
    post'[j] = obs[j] + c + r[j] + log(max(v, tiny)) / beta

The product is ``torch.matmul`` in full float32: the JAX package computes
it with ``jnp.dot`` outside any kernel. It runs at 'highest' float32
matmul precision whatever the caller set (TF32 would change the result).
Backpointers are not tracked; the chase recovers one exact argmax per step
from the stored posteriors, which is the backtrace kernel K3
(``ops/backtrace.py::backtrace_posteriors``) on the card, bitwise the JAX
chase on the same posteriors. The posteriors themselves agree with the JAX
package's within rounding only: the CPU's or the card's matrix product and
exp/log round otherwise than XLA's.
"""
import contextlib

import numpy as np
import torch

from .backtrace import backtrace_posteriors

FP32_TINY = float(np.finfo(np.float32).tiny)


@contextlib.contextmanager
def _highest_precision():
    """Full float32 matrix products inside, the caller's setting after"""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('highest')
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def forward_lse(observation, batch_frames, transition, initial, beta=8.0):
    """The smoothed-max forward pass. Arguments as in ``decode_lse``.

    Returns (posts, posterior): every frame's posterior, (batch, frames,
    states) float32, and the final (frozen) posterior, (batch, states).
    """
    batch, frames, states = observation.shape
    # Per-destination-row normalization keeps exp(beta * T) in (0, 1]. An
    # all--inf row (unreachable destination) normalizes by 0, or
    # (transition - rowmax) would be NaN and poison the whole decode; its
    # exp column is then all zeros and the log floor keeps the state at
    # effectively -inf, as in the exact backends
    rowmax = transition.amax(dim=1)
    rowmax = torch.where(torch.isfinite(rowmax), rowmax, 0.0)
    exp_t = torch.exp(beta * (transition - rowmax[:, None])).T
    posts = torch.empty(
        (batch, frames, states), dtype=torch.float32,
        device=observation.device)
    post = observation[:, 0, :] + initial[None, :]
    posts[:, 0] = post
    with _highest_precision():
        for t in range(1, frames):
            c = post.amax(dim=-1, keepdim=True)
            # The same guard for a sequence whose whole posterior hit the
            # log floor (c = -inf would make post - c NaN)
            c = torch.where(torch.isfinite(c), c, 0.0)
            u = torch.exp(beta * (post - c))
            v = torch.matmul(u, exp_t)
            new_post = (observation[:, t, :] + c + rowmax[None, :]
                        + torch.log(torch.clamp_min(v, FP32_TINY)) / beta)
            valid = (t < batch_frames)[:, None]
            post = torch.where(valid, new_post, post)
            posts[:, t] = post
    return posts, post


def decode_lse(observation, batch_frames, transition, initial, beta=8.0):
    """Approximate Viterbi decode with the smoothed-max forward pass.

    observation: (batch, frames, states) float32 log-probs
    batch_frames: (batch,) int32
    transition: (states, states) float32 log-probs (row = destination)
    initial: (states,) float32 log-probs
    beta: smoothing temperature (higher is closer to the exact max; too
        high underflows exp: candidates more than ~80/beta nats below the
        per-sequence max are dropped, which is also what max would do)

    Returns (batch, frames) int32: the lowest-index argmax chase over the
    stored posteriors, positions at or past ``batch_frames[b] - 1`` holding
    the seed.
    """
    posts, posterior = forward_lse(
        observation, batch_frames, transition, initial, beta)
    return backtrace_posteriors(
        posts, transition.contiguous(), posterior,
        batch_frames.contiguous())
