"""The comparison that decides ``correct``.

The program's paths, as the timed calls returned them, against the plain
reference's (``reference/viterbi.py``) on the same inputs. The decode is
exact: a path that differs from the reference's in one frame is wrong, so
the limit on the frames that differ is 0. A call that raised, or an
output that never came, counts against its own limit of 0: an output
missing from the check counts all its frames as differing.
"""
import sys

import torch

# Limits, each between the sound runs' largest reading and the control's
# smallest (PERF.md gives the readings)
LIMITS = {'mismatched_frames': 0, 'failed_calls': 0}


def differing(output, path):
    """Frames of one row where ``output`` (the program's indices, at least
    as long as ``path``) differs from the reference ``path``; all of them
    where the output is missing or too short"""
    length = int(path.shape[0])
    if output is None or output.ndim != 1 or output.shape[0] < length:
        return length
    return int((output[:length].to(torch.int64).cpu() != path.cpu()).sum())


def readings(mismatched_frames, failed_calls):
    """{name: [value, limit]} of the numbers compared"""
    values = {'mismatched_frames': int(mismatched_frames),
              'failed_calls': int(failed_calls)}
    return {name: [value, LIMITS[name]] for name, value in values.items()}


def passed(checks):
    """Whether every number is within its limit"""
    return all(value <= limit for value, limit in checks.values())


def report(checks, stream=sys.stderr):
    """Each number compared beside its limit, one line each"""
    for name, (value, limit) in checks.items():
        print(f'check {name} {value} limit {limit}', file=stream, flush=True)
