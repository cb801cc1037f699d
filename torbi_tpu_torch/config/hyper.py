"""Experiment: a self-incrementing hyperparameter sweep over batch size,
chunk size and entropy threshold. Each application advances a progress
file beside this one (``.hyper_progress``, not kept in git), so repeated
runs of the evaluation with ``--config torbi_tpu_torch/config/hyper.py``
cover the grid; the harness reuses reference outputs, so the sweep
resumes.
"""
from pathlib import Path

MODULE = 'torbi_tpu_torch'

# Sweep grid
BATCH_SIZES = [1, 64, 256, 512]
MIN_CHUNK_SIZES = [None, 64, 256]
ENTROPY_THRESHOLDS = [0.5]

_grid = [
    (batch, chunk, entropy)
    for batch in BATCH_SIZES
    for chunk in MIN_CHUNK_SIZES
    for entropy in ENTROPY_THRESHOLDS]

_progress_file = Path(__file__).parent / '.hyper_progress'
_index = (
    int(_progress_file.read_text()) if _progress_file.exists() else 0)
if _index >= len(_grid):
    _index = 0
_progress_file.write_text(str(_index + 1))

BATCH_SIZE, MIN_CHUNK_SIZE, ENTROPY_THRESHOLD = _grid[_index]

CONFIG = (
    f'hyper-batch{BATCH_SIZE}'
    f'-chunk{MIN_CHUNK_SIZE}'
    f'-entropy{ENTROPY_THRESHOLD}')
