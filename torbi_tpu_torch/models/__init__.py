from . import pitch
