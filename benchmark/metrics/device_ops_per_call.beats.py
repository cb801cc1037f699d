"""``device_ops_per_call`` in the beat-tracking cell: the same reading
(there K9, K10 and the fetch), a metric of its own so that it lists that
cell alone"""
from benchmark.metrics.device_ops_per_call import read  # noqa: F401
