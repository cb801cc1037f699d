"""Decoding API.

Counterpart of ``torbi_tpu/core.py::from_probabilities``, with the same
numerics contract: the uniform initial distribution defaults to
``log(1/S + tiny)``, the uniform transition to ``log(1/S)``, probability
inputs are ``log``-ed, and the observation is stabilized as
``log(exp(observation) + tiny)`` in float32. ``gpu`` selects the decode
device: None is cuda:0, an integer a CUDA index, 'cpu' the CPU.
"""
import functools
import math
from typing import Optional, Union

import numpy as np
import torch

from . import viterbi
from .utils import timing
from .utils.cache import identity_cached as _identity_cached
from .utils.convert import resolve_device, to_tensor

FP32_TINY = float(np.finfo(np.float32).tiny)

# Converted transition/initial tensors cached per live, unmodified input
# tensor, so repeated calls reuse one device tensor and the band detection
# and band matrix caches downstream (which key on tensor identity) hit.
# Arrays that are not tensors are converted afresh on every call.
_prepare_cache = {}


def _prepare_log(array, log_probs, device):
    """Convert a transition/initial array to a log-space float32 tensor on
    ``device``"""
    def convert():
        converted = to_tensor(array, torch.float32, device)
        if not log_probs:
            converted = torch.log(converted)
        return converted

    return _identity_cached(
        _prepare_cache, array, convert, extra_key=(bool(log_probs), device))


@functools.lru_cache(maxsize=8)
def _default_initial(states, device):
    """Uniform initial distribution, log(1/S + tiny). Cached so repeated
    calls reuse one tensor (and the identity caches downstream hit)."""
    return torch.full(
        (states,), math.log((1. / states) + FP32_TINY), dtype=torch.float32,
        device=device)


@functools.lru_cache(maxsize=8)
def _default_transition(states, device):
    """Uniform transition, log(1/S). Cached: the constant matrix routes to
    the closed-form constant path, and caching keeps its detection from
    copying the matrix to the host on every call."""
    return torch.full(
        (states, states), math.log(1. / states), dtype=torch.float32,
        device=device)


def from_probabilities(
    observation,
    batch_frames=None,
    transition=None,
    initial=None,
    log_probs: bool = False,
    gpu: Optional[Union[int, str, torch.device]] = None,
    num_threads: Optional[int] = 1,
    backend: Optional[str] = None,
):
    """Decode a time-varying categorical distribution

    Arguments
        observation
            Time-varying categorical distribution
            shape=(batch, frames, states)
        batch_frames
            Number of frames in each batch item; defaults to all
            shape=(batch,)
        transition
            Categorical transition matrix; defaults to uniform
            shape=(states, states)
        initial
            Categorical initial distribution; defaults to uniform
            shape=(states,)
        log_probs
            Whether inputs are in (natural) log space
        gpu
            Decode device: None is cuda:0, an integer a CUDA index, a string
            a device ('cpu', 'cuda', 'cuda:1'). Without CUDA only 'cpu'
            works; nothing falls back to the CPU unasked.
        num_threads
            Accepted for reference API compatibility; unused
        backend
            Optional decode backend override ('kernel', 'scan')

    Returns
        indices
            The decoded bin indices, int32 on the decode device
            shape=(batch, frames)
    """
    device = resolve_device(gpu)
    with timing.context('torbi', device):
        indices = _dispatch_decode(
            observation, batch_frames, transition, initial, log_probs,
            device, num_threads, backend)
    return indices


def _dispatch_decode(observation, batch_frames, transition, initial,
                     log_probs, device, num_threads, backend):
    """Prepare inputs and dispatch the decode"""
    # Host observations stay on the host here: the dispatcher's memory
    # guard slices oversized batches before any transfer
    observation = to_tensor(observation, torch.float32)
    batch, frames, states_in = observation.shape

    if batch_frames is None:
        batch_frames = torch.full(
            (batch,), frames, dtype=torch.int32, device=device)
    batch_frames = to_tensor(batch_frames, torch.int32, device)

    # The true state count comes from the transition/initial when given:
    # the observation's state dimension may be pre-padded
    if transition is not None:
        states = int(transition.shape[0])
    elif initial is not None:
        states = int(initial.shape[-1])
    else:
        states = states_in

    # Default to uniform initial probabilities (tiny inside the log for the
    # initial distribution but not the transition)
    if initial is None:
        initial = _default_initial(states, device)
    else:
        initial = _prepare_log(initial, log_probs, device)

    # Default to uniform transition probabilities
    if transition is None:
        transition = _default_transition(states, device)
    else:
        transition = _prepare_log(transition, log_probs, device)

    return viterbi.decode(
        observation,
        batch_frames,
        transition,
        initial,
        num_threads=num_threads,
        backend=backend,
        log_input=bool(log_probs),
        apply_epsilon=True,
        gpu=device)
