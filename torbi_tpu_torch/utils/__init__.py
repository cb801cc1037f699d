from . import cache
from . import convert
from . import io
from . import notify
from . import progress
from . import timing
