from . import cache
from . import convert
from . import io
from . import progress
from . import timing
