"""Evaluation metrics.

The port's own copy of ``torbi_tpu/evaluate/metrics.py``: RPA(threshold)
is the fraction of frames where |predicted - target| is within the
threshold in 5-cent pitch bins; threshold 0 is exact-path agreement.
"""
import numpy as np

import torbi_tpu_torch


class Average:
    """Streaming average"""

    def __init__(self):
        self.reset()

    def __call__(self):
        return float(self.total / max(self.count, 1))

    def update(self, values, count):
        self.total += float(np.sum(values))
        self.count += int(count)

    def reset(self):
        self.total = 0.0
        self.count = 0


class RPA(Average):

    def __init__(self, threshold):
        super().__init__()
        self.threshold = threshold

    def update(self, predicted, target):
        predicted = np.asarray(predicted).astype(np.int64)
        target = np.asarray(target).astype(np.int64)
        super().update(
            np.abs(predicted - target) <= self.threshold, predicted.size)


class Metrics:

    def __init__(self):
        self.rpas = [
            RPA(k) for k in torbi_tpu_torch.PITCH_ERROR_THRESHOLDS]

    def __call__(self):
        return {'rpa': {str(rpa.threshold): rpa() for rpa in self.rpas}}

    def update(self, predicted, target):
        for rpa in self.rpas:
            rpa.update(predicted, target)

    def reset(self):
        for rpa in self.rpas:
            rpa.reset()
