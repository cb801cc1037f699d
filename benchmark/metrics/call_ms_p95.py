"""The 95th percentile of every call's latency in the window, from the
entry point's call to its indices on the host, in milliseconds"""
import statistics


def read(record):
    latencies = record.get('latencies_s') or []
    if len(latencies) < 20:
        return None
    return statistics.quantiles(latencies, n=20)[18] * 1e3
