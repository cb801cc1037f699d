"""Device time of the NCCL kernels (names beginning 'nccl') a call, on
rank 0, in milliseconds"""
from benchmark import trace
from benchmark.metrics import traced


def read(record):
    stretches = traced(record)
    if not stretches or not stretches[0].get('calls'):
        return None
    seconds = sum(total for name, (total, _) in
                  stretches[0]['device_ops'].items()
                  if name.lower().startswith(trace.COLLECTIVE_PREFIX))
    if not seconds:
        return None
    return seconds * 1e3 / stretches[0]['calls']
