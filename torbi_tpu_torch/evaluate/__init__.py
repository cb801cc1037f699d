from .core import datasets
from .metrics import Metrics, RPA
