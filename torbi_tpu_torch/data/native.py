"""ctypes bindings of the native batch loader (csrc/loader.cpp).

Counterpart of ``torbi_tpu/data/native.py``, natural layout only. The
library builds with g++ at first use (``csrc/build.py::host_library``);
where it does not build, ``available()`` is False and the file APIs use
the Python loader.

``counts`` records, for this process, the batches ``load_batch`` filled
(``'filled'``) and the batches it could not fill (``'fallback'``: a file
changed between probe and load, or failed to parse), which the loader then
loads through the Python path. ``chip_smoke.py`` requires the first and
none of the second.
"""
import ctypes
import threading

import torch

from ..csrc.build import host_library

counts = {'filled': 0, 'fallback': 0}

_lib = None
_lib_lock = threading.Lock()


def _load_library():
    global _lib
    with _lib_lock:
        if _lib is None:
            path = host_library('loader')
            if path is None:
                _lib = False
                return _lib
            lib = ctypes.CDLL(str(path))
            lib.probe_npy.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.probe_npy.restype = ctypes.c_int
            lib.load_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int64,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_int,
            ]
            lib.load_batch.restype = ctypes.c_int
            _lib = lib
        return _lib


def available():
    """Whether the native loader built"""
    return _load_library() is not False


def probe(path):
    """(frames, states) of a two-dimensional float32 .npy file, or None"""
    lib = _load_library()
    if lib is False:
        return None
    frames = ctypes.c_int64()
    states = ctypes.c_int64()
    status = lib.probe_npy(
        str(path).encode(), ctypes.byref(frames), ctypes.byref(states))
    if status != 0:
        return None
    return frames.value, states.value


def load_batch(paths, max_frames, states, num_threads=8, pin_memory=False):
    """Load .npy files into a zero-padded (n, max_frames, states) batch.

    Returns (observation float32, batch_frames int32) CPU tensors, in pinned
    memory when ``pin_memory`` is set (so that the copy to the card needs
    no staging copy and does not wait), or None when a file does not match
    its probe or does not parse (the caller falls back to the Python
    loader).
    """
    lib = _load_library()
    if lib is False:
        return None
    n = len(paths)
    observation = torch.empty(
        (n, max_frames, states), dtype=torch.float32, pin_memory=pin_memory)
    frames = torch.empty((n,), dtype=torch.int32, pin_memory=pin_memory)
    encoded = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    status = lib.load_batch(
        encoded, n, observation.data_ptr(), frames.data_ptr(), max_frames,
        states, num_threads)
    if status != 0:
        counts['fallback'] += 1
        return None
    counts['filled'] += 1
    return observation, frames
