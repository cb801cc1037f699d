"""Wall-clock timing aggregation.

Counterpart of ``torbi_tpu/utils/timing.py``: named timing contexts whose
totals accumulate until reset. CUDA work is asynchronous, so a context
around a CUDA decode fences with ``torch.cuda.synchronize()`` on entry and
exit; otherwise it would time the enqueue, not the work.
"""
import contextlib
import time as _time

import torch

_totals = {}


@contextlib.contextmanager
def context(name, device=None):
    cuda = device is not None and torch.device(device).type == 'cuda'
    if cuda:
        torch.cuda.synchronize(device)
    start = _time.perf_counter()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        _totals[name] = _totals.get(name, 0.0) + _time.perf_counter() - start


def reset():
    _totals.clear()


def results():
    return dict(_totals)
