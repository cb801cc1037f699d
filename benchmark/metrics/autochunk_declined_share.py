"""The auto-chunk route's declines (``decode_chunked.declines``, every
reason) over the traced calls, on rank 0: the share of calls handed to
the serial K4 chain. None where the program has no such counter"""
from benchmark.metrics import traced


def read(record):
    stretches = traced(record)
    if not stretches or not stretches[0].get('calls'):
        return None
    declines = stretches[0].get('autochunk_declines')
    if declines is None:
        return None
    return declines / stretches[0]['calls']
