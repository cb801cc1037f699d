from . import pitch
from . import pyin
