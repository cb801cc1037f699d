"""The sparse forward kernel's (K9's) share of its roofline, in percent:
the least time of its work over the traced calls (``sparse_work.py``: two
operations a positive pair a step, the observation and the pairs' values
read once, at the H100's published peaks) over K9's own device seconds in
the trace, on rank 0. None where the trace holds no K9, as on a program
without the in-list route"""
from benchmark import roofline, sparse_work
from benchmark.metrics import traced


def read(record):
    stretches = traced(record)
    if not stretches or not stretches[0].get('sparse_forward_bytes'):
        return None
    stretch = stretches[0]
    seconds = sparse_work.kernel_seconds(stretch, sparse_work.FORWARD_KERNEL)
    if not seconds:
        return None
    return 100.0 * roofline.least_seconds(
        stretch['sparse_forward_operations'],
        stretch['sparse_forward_bytes']) / seconds
