from . import download
from . import preprocess
from .collate import collate, separate
from .dataset import Dataset
from .loader import DataLoader, loader
