"""What the program's own spans say in a ``torch.profiler`` Chrome trace.

torbi_tpu_torch marks its stretches with ``record_function`` ranges named
``torbi.*`` (``torbi_tpu_torch/utils/timing.py``): the entry point,
``torbi.decode``, ``torbi.forward.<kernel>``, ``torbi.chase.<kernel>``,
``torbi.gather``, ``torbi.build``. Kineto writes each range as a host
``user_annotation`` event and, where kernels were launched inside it, a
``gpu_user_annotation`` event of the same name on the stream, from the
start of the first of those kernels to the end of the last, each kernel
tied to the innermost range around its launch. So the device time of a
range with no range inside it, as a forward or chase span, is the stretch
of its own kernels, the gaps between them included; a range that launches
kernels both before and after a range inside it covers that one's too.

This reads the events of ``trace.complete_events``; nothing here changes
what ``trace.summarize`` reads. ``loop.Stretch.end`` keeps its record as
the traced stretch's ``program``, on every rank. A trace of a program
without such spans gives None.
"""
from benchmark import trace
from benchmark.metrics import traced

PREFIX = 'torbi.'
FORWARD = 'torbi.forward.'
CHASE = 'torbi.chase.'


def summarize(events):
    """The program's record of a traced stretch, in seconds, or None
    where it holds no ``torbi.*`` span:

    - spans: {name: [host_s, count, device_s]}: the host ranges' summed
      durations and count, and the summed durations of the device ranges
      of the same name;
    - self_s: {name: host_s} of each span's self time: its host ranges
      less the union of the ``torbi.*`` host ranges nested inside them,
      one of its own name too (``torbi.decode`` on the memory guard's row
      groups), so that no host time counts under two names;
    - idle_in_program_s: the part of the device's idle gaps (as
      ``trace.summarize`` finds them) that lies inside the union of the
      ``torbi.*`` host ranges.
    """
    host = [(name, start, start + duration)
            for name, category, start, duration in events
            if category == 'user_annotation' and name.startswith(PREFIX)]
    if not host:
        return None
    spans = {}
    for name, start, end in host:
        seconds, count, device = spans.get(name, (0.0, 0, 0.0))
        spans[name] = (seconds + (end - start) / 1e6, count + 1, device)
    for name, category, _, duration in events:
        if category == 'gpu_user_annotation' and name in spans:
            seconds, count, device = spans[name]
            spans[name] = (seconds, count, device + duration / 1e6)
    span_start = min(start for _, _, start, _ in events)
    span_end = max(start + duration for _, _, start, duration in events)
    busy = trace.busy_intervals(
        (start, start + duration) for _, category, start, duration in events
        if category in trace.DEVICE_CATEGORIES)
    edges = [span_start] + [x for pair in busy for x in pair] + [span_end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    program = trace.busy_intervals((start, end) for _, start, end in host)
    return {
        'spans': {name: list(value) for name, value in sorted(spans.items())},
        'self_s': self_seconds(host),
        'idle_in_program_s': overlap(gaps, program) / 1e6,
    }


def self_seconds(host):
    """{name: seconds} of the (name, start us, end us) ranges' self time.
    A range opened inside another (a later start, or the same start and
    no later end) is nested in it, clipped to its end; a range's self
    time is its length less the union of the ranges nested directly
    inside it, which hold the deeper ones"""
    totals = {}
    stack = []

    def close(name, start, end, nested):
        covered = sum(b - a for a, b in trace.busy_intervals(nested))
        totals[name] = totals.get(name, 0.0) + (end - start - covered) / 1e6

    for name, start, end in sorted(host, key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][2] <= start:
            close(*stack.pop())
        if stack:
            stack[-1][3].append((start, min(end, stack[-1][2])))
        stack.append((name, start, end, []))
    while stack:
        close(*stack.pop())
    return dict(sorted(totals.items()))


def overlap(first, second):
    """The length of the intersection of two sorted lists of disjoint
    (start, end) intervals"""
    total, i, j = 0.0, 0, 0
    while i < len(first) and j < len(second):
        start = max(first[i][0], second[j][0])
        end = min(first[i][1], second[j][1])
        total += max(0.0, end - start)
        if first[i][1] < second[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_s(stretch, *prefixes):
    """The device seconds of a stretch's spans whose names begin with one
    of ``prefixes``, or None where the stretch holds no program record"""
    program = stretch.get('program')
    if not program:
        return None
    return sum(device for name, (_, _, device) in program['spans'].items()
               if name.startswith(prefixes))


def self_ms_per_call(record, *names):
    """Rank 0's host self time of the spans ``names`` (``self_s``), a
    call of its traced stretch, in milliseconds; None where it has none
    of them"""
    stretches = traced(record)
    if not stretches or not stretches[0].get('calls') \
            or not stretches[0].get('program'):
        return None
    own = stretches[0]['program']['self_s']
    found = [own[name] for name in names if name in own]
    return sum(found) * 1e3 / stretches[0]['calls'] if found else None


def ms_per_call(record, *prefixes):
    """Rank 0's device time of the spans whose names begin with one of
    ``prefixes``, a call of its traced stretch, in milliseconds; None
    where it has none"""
    stretches = traced(record)
    if not stretches or not stretches[0].get('calls'):
        return None
    seconds = device_s(stretches[0], *prefixes)
    if not seconds:
        return None
    return seconds * 1e3 / stretches[0]['calls']
