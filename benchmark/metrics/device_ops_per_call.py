"""Device events (kernels, copies, fills) of the traced stretch over its
calls, on rank 0"""
from benchmark.metrics import traced


def read(record):
    stretches = traced(record)
    if not stretches or not stretches[0].get('calls'):
        return None
    return stretches[0]['device_events'] / stretches[0]['calls']
