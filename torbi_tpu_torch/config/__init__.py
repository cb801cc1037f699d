from . import defaults
