"""Minimal progress reporting.

The port's own copy of ``torbi_tpu/utils/progress.py``: a progress line on
standard error, rewritten at most once a second and at the end.
"""
import sys
import time as _time


class ProgressBar:

    def __init__(self, message, total):
        self.message = message
        self.total = total
        self.count = 0
        self.start = _time.perf_counter()
        self._last_print = 0.0

    def update(self, n=1):
        self.count += n
        now = _time.perf_counter()
        if now - self._last_print > 1.0 or self.count >= self.total:
            elapsed = now - self.start
            rate = self.count / elapsed if elapsed > 0 else 0.0
            sys.stderr.write(
                f'\r{self.message}: {self.count}/{self.total} '
                f'({rate:.1f}/s)')
            sys.stderr.flush()
            self._last_print = now

    def close(self):
        sys.stderr.write('\n')
        sys.stderr.flush()


def iterator(iterable, message, total=None):
    """Progress-reporting iterator"""
    if total is None:
        total = len(iterable)
    bar = ProgressBar(message, total)
    for item in iterable:
        yield item
        bar.update()
    bar.close()
