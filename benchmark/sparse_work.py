"""The least work of the in-list route's two kernels, counted from the
inputs' shapes, and their device time in a traced stretch.

The sparse forward kernel (K9) computes, for every real frame after a
row's first, each positive pair's candidate (an add) and its destination's
max (a max): two operations a pair. It reads the observation once and the
pairs' values once a call (4 bytes each). The chase (K10) needs, for every
real step, one entry of the chosen state's in-list (its source, 2 bytes)
and writes one index a real frame (4 bytes); it computes nothing a
roofline counts. ``roofline.least_seconds`` turns either into the least
time at the H100's published peaks. The padding of a batch is no work.

A kernel's device time is the sum of the traced device operations whose
name holds the kernel's (``FORWARD_KERNEL``, ``CHASE_KERNEL``: the CUDA
functions of ``csrc/sparse_forward.cu`` and ``csrc/sparse_backtrace.cu``);
a program without them has none.
"""
from benchmark.roofline import BYTES_PER_VALUE, OPERATIONS_PER_CANDIDATE

FORWARD_KERNEL = 'sparse_forward_kernel'
CHASE_KERNEL = 'sparse_backtrace_kernel'
# The bytes of one in-list entry's source (int16) and of one index written
SOURCE_BYTES = 2
INDEX_BYTES = 4


def forward_work(row_lengths, states, pairs):
    """(operations, bytes) of K9 over rows of ``row_lengths`` real frames
    of ``states`` states, ``pairs`` positive pairs"""
    frames = sum(row_lengths)
    steps = sum(max(length - 1, 0) for length in row_lengths)
    return (OPERATIONS_PER_CANDIDATE * steps * pairs,
            BYTES_PER_VALUE * (frames * states + pairs))


def chase_work(row_lengths):
    """(operations, bytes) of K10 over rows of ``row_lengths`` real
    frames"""
    frames = sum(row_lengths)
    steps = sum(max(length - 1, 0) for length in row_lengths)
    return 0, SOURCE_BYTES * steps + INDEX_BYTES * frames


def kernel_seconds(stretch, kernel):
    """Device seconds of the traced operations whose name holds
    ``kernel``, in a stretch's summary (``trace.summarize``)"""
    return sum(seconds for name, (seconds, _) in
               stretch.get('device_ops', {}).items() if kernel in name)
