"""How unequal the ranks' own decodes are: the largest less the smallest
device time of a rank's forward and chase kernels (its ``torbi.forward.*``
and ``torbi.chase.*`` spans), over rank 0's calls, in milliseconds; None
for one rank"""
from benchmark import program
from benchmark.metrics import traced


def read(record):
    stretches = traced(record)
    if len(stretches) < 2 or not stretches[0].get('calls'):
        return None
    seconds = [program.device_s(s, program.FORWARD, program.CHASE)
               for s in stretches]
    if None in seconds:
        return None
    return (max(seconds) - min(seconds)) * 1e3 / stretches[0]['calls']
