"""The least time the traced calls' decode work needs on the H100
(``roofline.py``: operations and bytes counted from the inputs' shapes,
at the published peaks), over the time the devices' compute kernels were
busy with them (copies, fills and collectives left out), in percent;
summed over the ranks, each counting its own rows"""
from benchmark import roofline
from benchmark.metrics import traced


def read(record):
    stretches = [s for s in traced(record)
                 if s.get('operations') and s.get('compute_busy_s')]
    if not stretches:
        return None
    least = sum(roofline.least_seconds(s['operations'], s['bytes'])
                for s in stretches)
    return 100.0 * least / sum(s['compute_busy_s'] for s in stretches)
