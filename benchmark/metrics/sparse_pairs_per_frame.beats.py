"""The pairs the program's sparse forward pass visited
(``viterbi_forward_sparse.pairs`` in ``ops/sparse.py``: pairs x batch x
frames a call, from the shapes, the deltas the caller counts) over the
real frames of the traced calls, on rank 0: the positive pairs times the
padded over the real frames. None where the program has no such
counter"""
from benchmark.metrics import traced


def read(record):
    stretches = traced(record)
    if not stretches or not stretches[0].get('frames'):
        return None
    pairs = stretches[0].get('sparse_pairs')
    if pairs is None:
        return None
    return pairs / stretches[0]['frames']
