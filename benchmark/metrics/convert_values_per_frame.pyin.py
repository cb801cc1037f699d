"""The observation's values that the program's conversion pass converted
(``convert.values`` in ``ops/dispatch.py``, the deltas the caller counts)
over the real frames of the traced calls, on rank 0: the states times the
padded frames over the real ones where the decode converts before its
forward pass, 0 where its forward kernel converts as it loads. None
where the program has no such counter"""
from benchmark.metrics import traced


def read(record):
    stretches = traced(record)
    if not stretches or not stretches[0].get('frames'):
        return None
    values = stretches[0].get('convert_values')
    if values is None:
        return None
    return values / stretches[0]['frames']
