from . import backtrace
from . import band
from . import constant
from . import dense
from . import dispatch
from . import oracle
from . import scan
