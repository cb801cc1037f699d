"""1 - the union of the device events' intervals (kernels, copies, fills)
over the traced stretch's span, averaged over the ranks"""
import statistics

from benchmark.metrics import traced


def read(record):
    stretches = traced(record)
    if not stretches:
        return None
    return statistics.fmean(1.0 - s['busy_s'] / s['span_s']
                            for s in stretches)
