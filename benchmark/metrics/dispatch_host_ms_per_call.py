"""Rank 0's host self time of the entry and dispatch spans
(``torbi.from_probabilities``, ``torbi.decode``, ``torbi.decode_sharded``:
each less the ``torbi.*`` spans inside it) a call of the traced stretch,
in milliseconds: the checks, the band and in-list gates, the routing, the
memory guard and the input moves, which no forward, chase, convert,
build, gather or autochunk span holds"""
from benchmark import program

SPANS = ('torbi.from_probabilities', 'torbi.decode', 'torbi.decode_sharded')


def read(record):
    return program.self_ms_per_call(record, *SPANS)
