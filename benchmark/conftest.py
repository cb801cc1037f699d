"""Tests of the benchmark (``benchmark/tests``), run with
``python -m pytest benchmark/tests -q`` from the root of the checkout.

The ``cuda`` marker tags the tests that need a CUDA card; the
``cuda_device`` fixture decides, when such a test runs, whether there is
one, and skips it where there is none.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs a CUDA card; skipped where there is none')


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)
