"""The sparse chase's (K10's) share of its roofline, in percent: the least
time of its bytes over the traced calls (``sparse_work.py``: one in-list
entry of the path a step, one index written a frame, at the H100's
published bandwidth) over K10's own device seconds in the trace, on rank
0. None where the trace holds no K10, as on a program without the in-list
route"""
from benchmark import roofline, sparse_work
from benchmark.metrics import traced


def read(record):
    stretches = traced(record)
    if not stretches or not stretches[0].get('sparse_chase_bytes'):
        return None
    stretch = stretches[0]
    seconds = sparse_work.kernel_seconds(stretch, sparse_work.CHASE_KERNEL)
    if not seconds:
        return None
    return 100.0 * roofline.least_seconds(
        0, stretch['sparse_chase_bytes']) / seconds
