"""Decoding API.

Counterpart of ``torbi_tpu/core.py``, with its seven public symbols:
``from_probabilities``, ``from_file``, ``from_file_to_file``,
``from_files_to_files``, ``from_dataloader``, ``save`` and ``save_masked``.
The numerics contract is the same: the uniform initial distribution
defaults to ``log(1/S + tiny)``, the uniform transition to ``log(1/S)``,
probability inputs are ``log``-ed, and the observation is stabilized as
``log(exp(observation) + tiny)`` in float32. So are the two transition
conventions of the reference's file APIs: ``from_file`` takes ``log(x)``
of a transition file when ``log_probs`` is set, ``from_files_to_files``
takes ``log(x + tiny)``. ``gpu`` selects the decode device: None is
cuda:0, an integer a CUDA index, 'cpu' the CPU.
"""
import functools
import math
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

import torbi_tpu_torch
from . import viterbi
from .utils import io, progress, timing
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
    """Prepare inputs and queue the decode, without waiting for it"""
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


def from_file(
    input_file: Union[str, os.PathLike],
    transition_file: Optional[Union[str, os.PathLike]] = None,
    initial_file: Optional[Union[str, os.PathLike]] = None,
    log_probs: bool = False,
    gpu: Optional[Union[int, str, torch.device]] = None,
    num_threads: Optional[int] = 1,
):
    """Decode a time-varying categorical distribution file

    Arguments
        input_file
            Time-varying categorical distribution file (.pt or .npy)
            shape=(frames, states)
        transition_file
            Categorical transition matrix file; defaults to uniform. It
            holds probabilities: with ``log_probs`` its log is taken
        initial_file
            Categorical initial distribution file; defaults to uniform
            shape=(states,)
        log_probs
            Whether the observation is in (natural) log space
        gpu
            Decode device, as in from_probabilities
        num_threads
            Accepted for reference API compatibility; unused

    Returns
        indices
            The decoded bin indices, int32 on the decode device
            shape=(frames,)
    """
    observation = io.load(input_file)[None]

    # Transition files hold probabilities: with log-space observations the
    # log is taken here, so that every input reaches the decode in log space
    if transition_file:
        transition = io.load(transition_file)
        if log_probs:
            with np.errstate(divide='ignore'):
                transition = np.log(transition)
    else:
        transition = None

    if initial_file:
        initial = io.load(initial_file)
    else:
        initial = None

    indices = from_probabilities(
        observation=observation,
        transition=transition,
        initial=initial,
        log_probs=log_probs,
        gpu=gpu,
        num_threads=num_threads)
    return indices[0]


def from_file_to_file(
    input_file: Union[str, os.PathLike],
    output_file: Union[str, os.PathLike],
    transition_file: Optional[Union[str, os.PathLike]] = None,
    initial_file: Optional[Union[str, os.PathLike]] = None,
    log_probs: bool = False,
    gpu: Optional[Union[int, str, torch.device]] = None,
    num_threads: Optional[int] = None,
) -> None:
    """Decode a time-varying categorical distribution file and save"""
    indices = from_file(
        input_file,
        transition_file,
        initial_file,
        log_probs,
        gpu=gpu,
        num_threads=num_threads)
    save(indices, output_file)


def from_files_to_files(
    input_files: List[Union[str, os.PathLike]],
    output_files: List[Union[str, os.PathLike]],
    transition_file: Optional[Union[str, os.PathLike]] = None,
    initial_file: Optional[Union[str, os.PathLike]] = None,
    log_probs: bool = False,
    gpu: Optional[Union[int, str, torch.device]] = None,
    num_threads: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Decode time-varying categorical distribution files and save

    Arguments as in from_file, with one output file per input file. The
    files are decoded in batches of ``BATCH_SIZE`` (``data.loader``); each
    output is cut to its file's frame count, or joined from its chunks when
    ``MIN_CHUNK_SIZE`` is set. With ``log_probs`` the transition file's
    ``log(x + tiny)`` is taken.
    """
    device = resolve_device(gpu)

    # Transition files hold probabilities; one tensor on the decode device
    # serves every batch, so that the caches keyed on it (the converted
    # transition, the band and its matrix) hit
    if transition_file:
        transition = io.load(transition_file)
        if log_probs:
            transition = np.log(
                transition + np.finfo(transition.dtype).tiny)
        transition = to_tensor(transition, torch.float32, device)
    else:
        transition = None

    if initial_file:
        initial = to_tensor(io.load(initial_file), torch.float32, device)
    else:
        initial = None

    # Preserve file mapping
    mapping = {
        str(input_file): output_file
        for input_file, output_file in zip(input_files, output_files)}

    from_dataloader(
        dataloader=torbi_tpu_torch.data.loader(
            input_files, pin_memory=device.type == 'cuda'),
        output_files=mapping,
        transition=transition,
        initial=initial,
        log_probs=log_probs,
        gpu=device,
        num_threads=num_threads,
        backend=backend)


def from_dataloader(
    dataloader,
    output_files: Dict,
    transition=None,
    initial=None,
    log_probs: bool = False,
    gpu: Optional[Union[int, str, torch.device]] = None,
    num_threads: Optional[int] = 1,
    backend: Optional[str] = None,
) -> None:
    """Decode time-varying categorical distributions from a dataloader

    Arguments
        dataloader
            A data loader (``data.loader``) yielding
            (observation, batch_frames, batch_chunks, input_filenames)
        output_files
            A dictionary mapping input filenames (str or Path) to output
            filenames
        transition, initial, log_probs, gpu, num_threads, backend
            As in from_probabilities

    The host writes one batch's files while the card decodes the next: each
    batch's decode is queued without a wait, then the copy of its indices
    into pinned host memory, then an event; the host waits on the previous
    batch's event only after queuing the next decode. The 'torbi' timing
    context brackets the queuing and that wait, not the file writes.
    """
    output_files = {str(key): value for key, value in output_files.items()}
    device = resolve_device(gpu)
    bar = progress.ProgressBar(
        torbi_tpu_torch.CONFIG, len(dataloader.dataset))

    def write(fetched, batch_frames, batch_chunks, filenames):
        """Save one batch's per-file outputs"""
        indices = fetched[0].numpy()
        if torbi_tpu_torch.MIN_CHUNK_SIZE is not None:
            # Re-join chunk rows into per-file sequences
            separated = torbi_tpu_torch.data.separate(
                indices=indices,
                batch_chunks=batch_chunks,
                batch_frames=batch_frames)
            for sequence, filename in zip(separated, filenames):
                save(sequence, filename)
        else:
            for row, filename, frames in zip(
                    indices, filenames, np.asarray(batch_frames)):
                save_masked(row, filename, int(frames))
        bar.update(len(filenames))

    pending = None
    for (
        observation,
        batch_frames,
        batch_chunks,
        input_filenames,
    ) in dataloader:

        with timing.context('torbi'):
            indices = _dispatch_decode(
                observation, batch_frames, transition, initial, log_probs,
                device, num_threads, backend)
            fetched = _to_host(indices)
            if pending is not None:
                _wait(pending[0])

        if pending is not None:
            write(*pending)
        pending = (
            fetched,
            batch_frames,
            batch_chunks,
            [output_files[str(file)] for file in input_filenames])

    if pending is not None:
        with timing.context('torbi'):
            _wait(pending[0])
        write(*pending)
    bar.close()


def _to_host(indices):
    """Queue the copy of decoded indices to the host: (host tensor, event),
    the event None for indices on the host already. The copy goes into
    pinned memory without a wait, behind the decode on the stream"""
    if indices.device.type != 'cuda':
        return indices, None
    host = torch.empty(indices.shape, dtype=indices.dtype, pin_memory=True)
    host.copy_(indices, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(indices.device))
    return host, event


def _wait(fetched):
    """Wait until a queued copy of ``_to_host`` has run"""
    if fetched[1] is not None:
        fetched[1].synchronize()


def save(tensor, file):
    """Save tensor"""
    io.save(tensor, file)


def save_masked(tensor, file, length):
    """Save masked tensor"""
    if isinstance(tensor, torch.Tensor):
        tensor = tensor.detach().cpu().numpy()
    io.save(np.asarray(tensor)[..., :length], file)
