"""``device_ops_per_call`` in the pYIN cell: the same reading (there the
conversion's elementwise kernels, K2, K3 and the fetch), a metric of its
own so that it lists that cell alone"""
from benchmark.metrics.device_ops_per_call import read  # noqa: F401
