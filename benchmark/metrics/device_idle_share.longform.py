"""``device_idle_share`` in the long-recording cell: the same reading,
a metric of its own so that it lists that cell alone"""
from benchmark.metrics.device_idle_share import read  # noqa: F401
