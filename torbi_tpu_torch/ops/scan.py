"""Plain PyTorch Viterbi decode with an int32 backpointer trellis.

Counterpart of ``torbi_tpu/ops/scan.py``: the ``'scan'`` backend, and the
straightforward form of the contract the kernels are held to:

- forward max-sum recursion ``score[j] = max_i(posterior[i] + transition[j, i])``
  with ``posterior'[j] = observation[t, j] + score[j]``
- int32 backpointers, zero in frame 0; argmax ties resolve to the lowest
  source index (``torch.argmax`` returns the first maximal index)
- the recursion only advances for ``t < batch_frames[b]``; decoded indices
  at or beyond ``batch_frames[b] - 1`` hold the ``argmax(posterior)`` seed
- the backtrace walks ``index = trellis[t, index]`` for ``t = frames-1 .. 1``
  writing ``indices[t-1]``
"""
import torch


def viterbi_forward(observation, batch_frames, transition, initial):
    """Forward max-sum recursion.

    Arguments
        observation: (batch, frames, states) float32 log-probabilities
        batch_frames: (batch,) int32 valid frame counts
        transition: (states, states) float32 log-probabilities; row j is the
            destination, column i the source
        initial: (states,) float32 log-probabilities

    Returns
        trellis: (batch, frames, states) int32 backpointers (frame 0 zeros)
        posterior: (batch, states) float32 path scores at the last valid frame
    """
    batch, frames, states = observation.shape
    post = observation[:, 0, :] + initial[None, :]
    trellis = torch.zeros(
        (batch, frames, states), dtype=torch.int32, device=observation.device)
    for t in range(1, frames):
        # scores[n, j, i] = post[n, i] + transition[j, i]
        scores = post[:, None, :] + transition[None, :, :]
        best = scores.amax(dim=-1)
        backpointer = scores.argmax(dim=-1).to(torch.int32)
        valid = (t < batch_frames)[:, None]
        post = torch.where(valid, observation[:, t, :] + best, post)
        trellis[:, t, :] = torch.where(valid, backpointer, 0)
    return trellis, post


def viterbi_backtrace(trellis, batch_frames, posterior):
    """Backtrace the trellis from the argmax of the final posterior.

    Returns (batch, frames) int32 decoded states; positions at or beyond
    ``batch_frames[b] - 1`` hold the seed ``argmax(posterior[b])``.
    """
    batch, frames, _ = trellis.shape
    index = posterior.argmax(dim=-1).to(torch.int32)
    indices = torch.empty(
        (batch, frames), dtype=torch.int32, device=trellis.device)
    indices[:, frames - 1] = index
    for t in range(frames - 1, 0, -1):
        nxt = trellis[:, t, :].gather(1, index[:, None].long())[:, 0]
        index = torch.where(t <= batch_frames - 1, nxt, index)
        indices[:, t - 1] = index
    return indices


def decode_scan(observation, batch_frames, transition, initial):
    """Full Viterbi decode: forward + backtrace. Returns (batch, frames)
    int32."""
    trellis, posterior = viterbi_forward(
        observation, batch_frames, transition, initial)
    return viterbi_backtrace(trellis, batch_frames, posterior)
