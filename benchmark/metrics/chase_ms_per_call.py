"""Device time of the chase kernels (the ``torbi.chase.*`` spans) a call,
on rank 0, in milliseconds"""
from benchmark import program


def read(record):
    return program.ms_per_call(record, program.CHASE)
