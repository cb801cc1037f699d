"""Identity-keyed caching for torch tensors.

Torch tensors are mutable, so identity alone does not identify content. A
cache entry is keyed on the tensor's ``id``, shape, storage pointer and
version counter (``tensor._version``, which every in-place operation bumps),
and stores a weakref that proves the id was not recycled by another object.
An in-place edit therefore misses the cache and recomputes. Anything that is
not a tensor, and inference-mode tensors (which keep no version counter),
bypass the cache.
"""
import weakref

import torch

from . import timing


def identity_cached(cache, tensor, compute, extra_key=()):
    """Cache ``compute()`` per live, unmodified tensor; each call of
    ``compute`` runs inside the span ``torbi.build``"""
    if not isinstance(tensor, torch.Tensor) or tensor.is_inference():
        with timing.span('torbi.build'):
            return compute()
    cache_key = (
        id(tensor), tuple(tensor.shape), tensor.data_ptr(), tensor._version,
        extra_key)
    if cache_key in cache:
        result, ref = cache[cache_key]
        if ref() is tensor:
            return result
        del cache[cache_key]
    with timing.span('torbi.build'):
        result = compute()
    if len(cache) > 64:
        cache.clear()
    cache[cache_key] = (result, weakref.ref(tensor))
    return result
