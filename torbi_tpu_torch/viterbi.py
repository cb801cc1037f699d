"""Low-level decode entry point.

Counterpart of ``torbi_tpu/viterbi.py::decode``, with the same contract. The
one addition is ``gpu``, the decode device: the JAX package decodes where
its arrays live, this package decodes on CUDA unless asked for the CPU.
"""
from typing import Optional, Union

import torch

from .ops import dispatch
from .utils.convert import resolve_device, to_tensor


def decode(
        observation,
        batch_frames,
        transition,
        initial,
        num_threads: int = 0,
        backend: Optional[str] = None,
        finite_observation: bool = False,
        log_input: bool = True,
        apply_epsilon: bool = False,
        gpu: Optional[Union[int, str, torch.device]] = None):
    """Maximum-likelihood state decoding of log-space inputs.

    All inputs are log-probabilities, as tensors or arrays. ``observation``
    is (batch, frames, states) -- a single (frames, states) sequence is
    auto-promoted -- ``batch_frames`` is (batch,) valid frame counts,
    ``transition`` is (states, states) with row = destination and column =
    source, and ``initial`` is (states,). ``num_threads`` exists only for
    reference API compatibility. ``backend`` optionally forces 'kernel',
    'scan', 'lse' (approximate smoothed max) or 'timesharded' (one
    sequence, frames sharded over the process group's ranks) instead of
    the configured default; ``finite_observation=True``
    asserts that no observation entry is -inf/NaN, which lets the band
    dispatcher skip a full data scan. ``gpu`` is the decode device: None is
    cuda:0, an integer a CUDA index, 'cpu' the CPU (the kernels' plain
    versions).

    Returns (batch, frames) int32 decoded state indices on the decode
    device.
    """
    del num_threads
    device = resolve_device(gpu)
    # Host observations stay on the host: the dispatcher's memory guard
    # slices oversized batches before any transfer
    observation = to_tensor(observation, torch.float32)
    if observation.ndim == 2:
        observation = observation[None]
    return dispatch.decode(
        observation,
        to_tensor(batch_frames, torch.int32, device),
        to_tensor(transition, torch.float32, device),
        to_tensor(initial, torch.float32, device),
        backend=backend,
        finite_observation=finite_observation,
        log_input=log_input,
        apply_epsilon=apply_epsilon,
        device=device)
