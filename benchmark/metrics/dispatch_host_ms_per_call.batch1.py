"""``dispatch_host_ms_per_call`` in the batch-1 cells, which report
``call_ms_p95`` and not ``timesteps_per_s``: the same reading,
moving that metric"""
from benchmark.metrics.dispatch_host_ms_per_call import read  # noqa: F401
