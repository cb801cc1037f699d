"""The measured window: one caller in a closed loop over a cycle of calls.

A call starts when the one before has returned its result to the host.
The window starts after set-up and ends at the end of the first whole
cycle that finishes ``seconds`` or more after its start (or after a fixed
number of cycles, which the ranks of a world agree on beforehand), so
every run of a cell decodes whole cycles of the same work. A traced run
profiles whole cycles inside its window, after the first.

The outputs of a few whole cycles, drawn from the seed over the window
(a reservoir), are kept for the check; the loop only keeps references,
so the check adds no work to a call.
"""
import os
import sys
import tempfile
import time
import traceback

import torch

from . import inputs, program, trace


class Stretch:
    """The profiled cycles of a traced window"""

    def __init__(self, ctx, cycles):
        self.ctx = ctx
        self.first = 1
        self.stop = 1 + cycles
        self.profile = None
        self.counts = {}
        self.calls = 0
        self.summary = None

    def begin(self):
        self.ctx.synchronize()
        self.profile = trace.profiled(self.ctx.device.type)
        self.profile.__enter__()

    def end(self):
        self.ctx.synchronize()
        self.profile.__exit__(None, None, None)
        with tempfile.TemporaryDirectory(prefix='torbi-trace-') as folder:
            path = os.path.join(folder, 'trace.json')
            self.profile.export_chrome_trace(path)
            self.ctx.log(f'trace of {self.calls} calls: '
                         f'{os.path.getsize(path)} bytes')
            events = trace.complete_events(path)
        self.profile = None
        self.summary = trace.summarize(events) or {}
        self.summary['program'] = program.summarize(events)
        self.summary.update(self.counts, calls=self.calls)


def run(ctx, cycle, call, counts, cycles=None, kept_cycles=3):
    """Run the window.

    cycle: the items of one cycle, called in order; call(item) returns the
    call's output on the host; counts(item) gives the call's additive
    counts ({'frames': ...}). ``cycles`` fixes the number of cycles (a
    world's ranks agree on it); else the window runs for ``ctx.seconds``.

    Returns the window's record: window_start (epoch seconds), window_s,
    attempted, failed, frames, latencies_s, the outputs of up to
    ``kept_cycles`` cycles (``kept``: a list of outputs a cycle, in the
    cycle's order, None for a call that raised), and with ``ctx.trace``
    the traced stretch's summary (``stretch``).
    """
    draw = inputs.host_generator(ctx.seed + 1)
    kept = []
    stretch = Stretch(ctx, int(ctx.traffic.get('trace_cycles', 1))) \
        if ctx.trace else None
    latencies, totals = [], {}
    failed = 0
    ctx.synchronize()
    ctx.barrier()
    window_start = time.time()
    start = time.perf_counter()
    done = 0
    while True:
        if stretch is not None and done == stretch.first:
            stretch.begin()
        outputs = []
        for item in cycle:
            begun = time.perf_counter()
            try:
                output = call(item)
            except Exception:
                failed += 1
                output = None
                if failed == 1:
                    traceback.print_exc(file=sys.stderr)
            finished = time.perf_counter()
            latencies.append(finished - begun)
            outputs.append(output)
            traced = stretch is not None and stretch.profile is not None
            if traced:
                stretch.calls += 1
            if output is None:
                continue
            for key, value in counts(item).items():
                totals[key] = totals.get(key, 0) + value
                if traced:
                    stretch.counts[key] = stretch.counts.get(key, 0) + value
        # Reservoir: each cycle is kept with the same chance
        if len(kept) < kept_cycles:
            kept.append(outputs)
        else:
            slot = int(torch.randint(done + 1, (1,), generator=draw))
            if slot < kept_cycles:
                kept[slot] = outputs
        del outputs
        done += 1
        elapsed = finished - start
        if stretch is not None and done == stretch.stop:
            stretch.end()
        enough = done >= cycles if cycles else elapsed >= ctx.seconds
        if enough and (stretch is None or done >= stretch.stop):
            break
    return {
        'window_start': window_start,
        'window_s': elapsed,
        'cycles': done,
        'attempted': len(latencies),
        'failed': failed,
        'latencies_s': latencies,
        'kept': kept,
        **totals,
        'stretch': stretch.summary if stretch is not None else None,
    }
