"""Reference CPU decoder, the evaluation harness's accuracy oracle.

Counterpart of ``torbi_tpu/reference/core.py``: ``librosa.sequence.viterbi``
in probability space, one file per call, over a process pool. When librosa
is not installed, the numpy float64 version of the same algorithm runs
(``ops/oracle.py::viterbi_librosa_style``). The pool starts its workers
with ``spawn``: a forked child of a process that holds a CUDA context is
unsafe, and no worker touches CUDA. Arrays only: nothing here decodes on a
device.
"""
import functools
import multiprocessing as mp
from typing import Dict

import numpy as np

import torbi_tpu_torch
from ..core import save
from ..utils import io, progress, timing


# Single-slot identity cache of the log->probability conversion of the
# transition: every per-file decode of a batch takes ONE transition object,
# and a fresh np.exp copy per file would both cost ~5 ms and defeat the
# oracle's per-transition analysis cache (ops/oracle._transition_analysis,
# keyed on object identity)
_exp_transition_cache = None


def _exp_transition(transition):
    global _exp_transition_cache
    if (_exp_transition_cache is not None
            and _exp_transition_cache[0] is transition):
        return _exp_transition_cache[1]
    result = np.exp(transition)
    _exp_transition_cache = (transition, result)
    return result


def _decode_probability_space(observation, transition, initial):
    """Decode one (frames, states) probability-space observation"""
    try:
        import librosa
        return librosa.sequence.viterbi(
            observation.T, transition, p_init=initial).astype(np.int32)
    except ImportError:
        from ..ops.oracle import viterbi_librosa_style
        return viterbi_librosa_style(
            observation, transition, initial).astype(np.int32)


def from_probabilities(
    observation,
    transition=None,
    initial=None,
    log_probs: bool = False,
):
    """Reference Viterbi decoding of one (frames, states) observation;
    returns (frames,) int32"""
    observation = np.asarray(observation, dtype=np.float32)
    frames, states = observation.shape

    # Setup initial probabilities
    if initial is None:
        initial = np.full((states,), 1. / states, dtype=np.float32)
    else:
        initial = np.asarray(initial, dtype=np.float32)
        if log_probs:
            initial = np.exp(initial)

    # Setup transition probabilities
    if transition is None:
        transition = np.full(
            (states, states), 1. / states, dtype=np.float32)
    else:
        transition = np.asarray(transition, dtype=np.float32)
        if log_probs:
            transition = _exp_transition(transition)

    # Setup observation probabilities
    if log_probs:
        observation = np.exp(observation)

    return _decode_probability_space(observation, transition, initial)


def from_dataloader(
    dataloader,
    output_files: Dict,
    transition=None,
    initial=None,
    log_probs: bool = False,
    num_threads: int = 1,
) -> None:
    """Decode the batches of a dataloader that yields (observations,
    input_files) tuples, one process per file with ``num_threads`` > 1,
    and save each output file"""
    from_probs = functools.partial(
        from_probabilities,
        transition=transition,
        initial=initial,
        log_probs=log_probs)

    bar = progress.ProgressBar('reference', len(dataloader.dataset))

    if num_threads > 1:
        pool = mp.get_context('spawn').Pool(num_threads)
        mapper = pool.map
    else:
        pool = None
        mapper = lambda fn, items: [fn(item) for item in items]

    try:
        for observations, input_filenames in dataloader:
            with timing.context('librosa'):
                indices = mapper(from_probs, list(observations))

            filenames = [
                output_files[str(file)] for file in input_filenames]
            for index, filename in zip(indices, filenames):
                save(np.asarray(index), filename)

            bar.update(len(list(input_filenames)))
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    bar.close()


def _transition(transition_file, log_probs):
    """A transition file's probabilities, or their log with ``log_probs``"""
    if not transition_file:
        return None
    transition = io.load(transition_file)
    if log_probs:
        with np.errstate(divide='ignore'):
            transition = np.log(transition)
    return transition


def from_file(
    input_file,
    transition_file=None,
    initial_file=None,
    log_probs=False,
):
    """Reference Viterbi decoding of a file; transition files hold
    probabilities"""
    observation = io.load(input_file)
    initial = io.load(initial_file) if initial_file else None
    return from_probabilities(
        observation, _transition(transition_file, log_probs), initial,
        log_probs)


def from_file_to_file(
    input_file,
    output_file,
    transition_file=None,
    initial_file=None,
    log_probs=False,
) -> None:
    """Reference Viterbi decoding of a file, saved"""
    indices = from_file(input_file, transition_file, initial_file, log_probs)
    io.save(indices, output_file)


def from_files_to_files(
    input_files,
    output_files,
    transition_file=None,
    initial_file=None,
    log_probs=False,
    num_threads=1,
) -> None:
    """Reference Viterbi decoding of many files, saved; batches of
    ``BATCH_SIZE`` files from ``data.loader``"""
    mapping = {
        str(input_file): output_file
        for input_file, output_file in zip(input_files, output_files)}
    dataloader = torbi_tpu_torch.data.loader(
        input_files,
        collate_fn=lambda item: tuple(zip(*item)))
    initial = io.load(initial_file) if initial_file else None
    from_dataloader(
        dataloader=dataloader,
        output_files=mapping,
        transition=_transition(transition_file, log_probs),
        initial=initial,
        log_probs=log_probs,
        num_threads=num_threads)
