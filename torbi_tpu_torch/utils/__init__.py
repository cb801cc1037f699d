from . import cache
from . import convert
from . import timing
