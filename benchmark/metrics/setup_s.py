"""Process start to the window's start: imports, the kernels' build on a
checkout's first run, the inputs, the warm-up calls"""


def read(record):
    return record['window_start'] - record['started']
