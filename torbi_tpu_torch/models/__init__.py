from . import beats
from . import pitch
from . import pyin
