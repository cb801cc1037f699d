"""``dispatch_idle_share`` in the batch-1 cells, which report
``call_ms_p95`` and not ``timesteps_per_s``: the same reading,
moving that metric"""
from benchmark.metrics.dispatch_idle_share import read  # noqa: F401
