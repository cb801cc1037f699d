"""Dense Viterbi forward pass.

Counterpart of ``torbi_tpu/ops/pallas.py``: the forward recursion for any
transition the banded kernel does not take,

    score[j] = max_i(posterior[i] + transition[j, i])
    posterior'[j] = observation[t, j] + score[j]   (frozen for t >= batch_frames)

computing values only. Like the banded pass it streams the posterior of
every frame, and ops/backtrace.py recovers the backpointers along the
chosen path, lowest source index first on ties.
"""
import ctypes

import torch

from ..csrc import build


def dense_forward_reference(observation, batch_frames, transition, initial):
    """Plain PyTorch version of the dense forward kernel (K2).

    observation: (batch, frames, states) float32 log-probabilities
    batch_frames: (batch,) int32
    transition: (states, states) float32, row = destination
    initial: (states,) float32

    Returns (post_seq, posterior) as ops/band.py::band_forward_reference.
    """
    frames = observation.shape[1]
    post = observation[:, 0, :] + initial[None, :]
    post_seq = torch.empty_like(observation)
    post_seq[:, 0] = post
    for t in range(1, frames):
        score = (post[:, None, :] + transition[None, :, :]).amax(dim=-1)
        valid = (t < batch_frames)[:, None]
        post = torch.where(valid, observation[:, t, :] + score, post)
        post_seq[:, t] = post
    return post_seq, post_seq[:, -1]


def viterbi_forward_dense(observation, batch_frames, transition, initial):
    """Dense forward pass: the K2 kernel (csrc/dense_forward.cu) on CUDA
    tensors, its plain version on CPU tensors. Arguments and results as in
    ``dense_forward_reference``; all tensors contiguous on one device."""
    device = observation.device
    if device.type == 'cpu':
        return dense_forward_reference(
            observation, batch_frames, transition, initial)
    batch, frames, states = observation.shape
    build.check('observation', observation, (batch, frames, states),
                torch.float32, device)
    build.check('batch_frames', batch_frames, (batch,), torch.int32, device)
    build.check('transition', transition, (states, states), torch.float32,
                device)
    build.check('initial', initial, (states,), torch.float32, device)
    post_seq = torch.empty_like(observation)
    if batch and frames:
        lib = _library()
        with torch.cuda.device(device):
            code = lib.dense_forward(
                build.pointer(observation), build.pointer(batch_frames),
                build.pointer(initial), build.pointer(transition),
                build.pointer(post_seq), batch, frames, states,
                build.stream(device))
        build.raise_on_error(lib, 'dense_forward', code)
        viterbi_forward_dense.launches += 1
    return post_seq, post_seq[:, -1]


viterbi_forward_dense.launches = 0


def _library():
    lib = build.library('dense_forward')
    lib.dense_forward.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.dense_forward.restype = ctypes.c_int
    return lib
