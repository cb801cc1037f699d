"""One reader a metric: ``<metric>.py`` holds ``read(record)``, which
returns the metric's value from a run's record, or None where there is
nothing to read.

A record holds the window's counts and clock (``window_start``,
``window_s``, ``frames``, ``attempted``, ``latencies_s``), the process's
start (``started``), and for a traced run ``stretches``: each rank's
summary of its profiled stretch (``trace.summarize``: ``span_s``,
``busy_s``, ``compute_busy_s``, ``device_events``, ``device_ops``,
``idle_gaps``; the program's own spans, ``program``
(``program.summarize``: ``spans``, ``self_s``, ``idle_in_program_s``;
None where the trace holds none); and the stretch's ``calls`` and work
counts, such as ``operations`` and ``bytes``).
"""


def traced(record):
    """The ranks' summaries of a traced stretch that holds device work"""
    return [stretch for stretch in record.get('stretches') or []
            if stretch and stretch.get('device_events')]
