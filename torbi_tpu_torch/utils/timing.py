"""Wall-clock timing aggregation and the program's profiler spans.

Counterpart of ``torbi_tpu/utils/timing.py``: named timing contexts whose
totals accumulate until reset. A context reads the host clock only; CUDA
work is asynchronous, so a context that should time the device's work
ends at a wait for it (the file path's contexts end at ``core._wait``).

``span`` marks a stretch of the program in any ``torch.profiler`` trace
that is recording: a ``record_function`` range on the profiler's own
clock, which also holds the device's events, so a trace puts the device's
idle gaps and kernels inside the program's spans. With no profiler
recording a span costs one check and does nothing else. The spans, by
name:

- ``torbi.from_probabilities``, ``torbi.decode_sharded``: the whole call;
- ``torbi.decode``: ``ops/dispatch.decode``, nested on the memory guard's
  row groups;
- ``torbi.forward.<kernel>``, ``torbi.chase.<kernel>``: one forward or
  chase kernel call, ``<kernel>`` the name of its launch counter
  (``dispatch.kernel_route``'s names);
- ``torbi.gather``: ``parallel/sharded.gather_rows``;
- ``torbi.build``: a cached table rebuilt (``utils/cache.py``), so the
  count of these spans is the caches' miss count;
- ``torbi.autochunk.entropy``, ``torbi.autochunk.plan``: batch-1
  auto-chunking's entropy pass with its copy to the host, and its host
  plan with its one copy to the device and the launches that build the
  plan's arrays there (``ops/autochunk.py``; inside ``torbi.decode``);
  ``torbi.autochunk.stitch``: the chunk rows' paths gathered back into the
  sequence;
- ``torbi.convert``: the observation's conversion as a pass of its own
  (``ops/dispatch.py``: the dense, constant, ``'scan'``, ``'lse'`` and
  time-sharded routes; inside ``torbi.decode``).

Counters are attributes of the function that counts: each kernel
wrapper's ``.launches``, and the auto-chunk route's
``decode_chunked.plans`` (plans computed), ``.rows`` (chunk rows
decoded), ``.plan_bytes`` (bytes the plans copied to the device) and
``.declines`` (calls handed to the serial route, by reason: ``memory``,
``frames``, ``plan``); ``dispatch.convert.values`` (the observation's
elements the conversion pass converted); ``dispatch.decode.dense_reasons``
(decodes that launched the dense kernel K2, by why the banded kernels
declined: ``width``, ``floor``, ``observation``, ``backend``).
"""
import contextlib
import functools
import time as _time

import torch

_totals = {}
_recording = torch.autograd._profiler_enabled


@contextlib.contextmanager
def context(name):
    start = _time.perf_counter()
    try:
        yield
    finally:
        _totals[name] = _totals.get(name, 0.0) + _time.perf_counter() - start


def reset():
    _totals.clear()


def results():
    return dict(_totals)


class span:
    """``with span(name):`` a ``torch.profiler.record_function(name)``
    range while a profiler records, else nothing"""

    __slots__ = ('name', 'range')

    def __init__(self, name):
        self.name = name
        self.range = None

    def __enter__(self):
        if _recording():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exception):
        if self.range is not None:
            self.range.__exit__(*exception)
            self.range = None


def spanned(name):
    """Decorator: the function's every call inside ``span(name)``"""
    def decorate(function):
        @functools.wraps(function)
        def call(*args, **kwargs):
            with span(name):
                return function(*args, **kwargs)
        return call
    return decorate
