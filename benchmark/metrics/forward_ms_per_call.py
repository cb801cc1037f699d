"""Device time of the forward kernels (the ``torbi.forward.*`` spans) a
call, on rank 0, in milliseconds"""
from benchmark import program


def read(record):
    return program.ms_per_call(record, program.FORWARD)
