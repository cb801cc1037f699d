"""The device's idle time that ``trace.summarize`` names after a
``torbi.autochunk.*`` span (the entropy pass's copy to the host, the host
plan and its copies, the stitch), summed over the traced stretch's named
idle gaps, over its span, averaged over the ranks: the cost of the
auto-chunk route's host round trip and plan. None where no gap is named
after such a span, as in a program without them"""
import statistics

from benchmark.metrics import traced

PREFIX = 'torbi.autochunk.'


def read(record):
    shares = []
    for stretch in traced(record):
        named = [seconds for name, seconds in stretch['idle_gaps']
                 if name.startswith(PREFIX)]
        if named:
            shares.append(sum(named) / stretch['span_s'])
    return statistics.fmean(shares) if shares else None
