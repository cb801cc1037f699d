"""The device's idle time inside the program's ``torbi.*`` spans over the
traced stretch's span, averaged over the ranks: the part of
``device_idle_share`` that the program's own host work holds (the rest is
the caller's)"""
import statistics

from benchmark.metrics import traced


def read(record):
    stretches = [s for s in traced(record) if s.get('program')]
    if not stretches:
        return None
    return statistics.fmean(s['program']['idle_in_program_s'] / s['span_s']
                            for s in stretches)
