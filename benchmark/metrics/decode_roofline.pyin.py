"""``decode_roofline`` in the pYIN cell: the same reading (there the
share of the dense route's kernels, K2 and K3, and the conversion's), a
metric of its own so that it lists that cell alone"""
from benchmark.metrics.decode_roofline import read  # noqa: F401
