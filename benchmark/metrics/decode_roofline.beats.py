"""``decode_roofline`` in the beat-tracking cell: the same reading (there
the share of the in-list route's kernels, K9 and K10; of K2, K3 and the
conversion on a program without that route), a metric of its own so that
it lists that cell alone"""
from benchmark.metrics.decode_roofline import read  # noqa: F401
