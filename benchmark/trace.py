"""What a ``torch.profiler`` Chrome trace says about the device.

The only copy of the trace arithmetic, here under the benchmark so that
the yardstick does not move with the program (``chip_smoke.py`` reads its
traces through it too): device events are Kineto's kernel, memcpy and
memset events; the device's busy time is the union of their intervals;
the traced span runs from the first complete event of any kind to the
last. It also gives the idle gaps between the device's busy intervals,
each named by the innermost host event around its middle, which says what
the host was doing while the device waited; and the busy time of the
compute kernels alone, without copies, fills and the collectives (NCCL's kernels,
whose time is mostly waiting for the other ranks).
"""
import gzip
import json

import numpy as np

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
COLLECTIVE_PREFIX = 'nccl'
HOST_CATEGORIES = ('cpu_op', 'user_annotation', 'cuda_runtime',
                   'cuda_driver', 'python_function')
# The gaps named, longest first; the rest are summed as one
NAMED_GAPS = 400


def complete_events(path):
    """(name, category, start us, duration us) of every complete event of
    the Chrome trace at ``path``"""
    opener = gzip.open if str(path).endswith('.gz') else open
    with opener(path, 'rt') as file:
        data = json.load(file)
    events = data.get('traceEvents', []) if isinstance(data, dict) else data
    return [(str(event.get('name', '?')), str(event.get('cat', '')).lower(),
             float(event.get('ts', 0.0)), float(event.get('dur', 0.0)))
            for event in events if event.get('ph') == 'X']


def busy_intervals(intervals):
    """The union of (start, end) intervals, as sorted disjoint intervals"""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(events, top=10):
    """A traced stretch's device record, in seconds:

    - span_s: first complete event to the last;
    - busy_s: the union of the device events' intervals;
    - compute_busy_s: the union of the kernels' intervals, collectives
      left out;
    - device_events: how many device events there were;
    - device_ops: {name: [seconds, count]} of the device events;
    - idle_gaps: the time the device sat idle, by what the host was doing
      ([name, seconds], longest first, at most ``top``).
    """
    if not events:
        return None
    device = [(start, start + duration)
              for _, category, start, duration in events
              if category in DEVICE_CATEGORIES]
    span_start = min(start for _, _, start, _ in events)
    span_end = max(start + duration for _, _, start, duration in events)
    merged = busy_intervals(device)
    busy = sum(end - start for start, end in merged)
    compute = sum(end - start for start, end in busy_intervals(
        (start, start + duration) for name, category, start, duration
        in events if category == 'kernel'
        and not name.lower().startswith(COLLECTIVE_PREFIX)))
    ops = {}
    for name, category, _, duration in events:
        if category in DEVICE_CATEGORIES:
            seconds, count = ops.get(name, (0.0, 0))
            ops[name] = (seconds + duration / 1e6, count + 1)
    edges = [span_start] + [x for pair in merged for x in pair] + [span_end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return {
        'span_s': (span_end - span_start) / 1e6,
        'busy_s': busy / 1e6,
        'compute_busy_s': compute / 1e6,
        'device_events': len(device),
        'device_ops': {name: [seconds, count]
                       for name, (seconds, count) in sorted(
                           ops.items(), key=lambda item: -item[1][0])},
        'idle_gaps': name_gaps(gaps, events)[:top],
    }


def name_gaps(gaps, events):
    """[name, seconds] of the idle gaps, summed by the innermost host event
    that holds each gap's middle ('host outside any traced op' where none
    does), longest first"""
    host = [(name, start, start + duration)
            for name, category, start, duration in events
            if category in HOST_CATEGORIES]
    starts = np.array([start for _, start, _ in host])
    ends = np.array([end for _, _, end in host])
    lengths = ends - starts
    totals = {}
    gaps = sorted(gaps, key=lambda gap: gap[0] - gap[1])
    for index, (start, end) in enumerate(gaps):
        name = 'shorter gaps'
        if index < NAMED_GAPS:
            name = 'host outside any traced op'
            middle = (start + end) / 2
            if len(host):
                holding = np.flatnonzero((starts <= middle)
                                         & (ends >= middle))
                if len(holding):
                    name = host[holding[np.argmin(lengths[holding])]][0]
        totals[name] = totals.get(name, 0.0) + (end - start) / 1e6
    return [[name, seconds] for name, seconds in sorted(
        totals.items(), key=lambda item: -item[1])]


def profiled(device_type):
    """A ``torch.profiler.profile`` of the host and, on a card, the
    device"""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device_type == 'cuda':
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)
