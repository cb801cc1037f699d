from . import defaults
from .core import ArgumentParser, configure
