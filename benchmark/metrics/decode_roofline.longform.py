"""``decode_roofline`` in the long-recording cell: the same reading, its
work counted over the reference plan's chunk rows, so that the entropy
pass and the gather of the rows, compute kernels outside that work, lower
it"""
from benchmark.metrics.decode_roofline import read  # noqa: F401
