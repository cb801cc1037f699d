"""Experiment: batch size 1, one file per decode call. Apply with
``--config torbi_tpu_torch/config/nobatch.py``."""
MODULE = 'torbi_tpu_torch'

CONFIG = 'nobatch'

BATCH_SIZE = 1
