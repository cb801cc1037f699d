from . import backtrace
from . import band
from . import dense
from . import dispatch
from . import scan
