"""Configuration overrides from ``--config`` files.

Counterpart of ``torbi_tpu/config/core.py``, with the reference's yapecs
semantics: a ``--config`` file is a Python file, and every uppercase name
it defines replaces the package constant of that name. Files apply in the
order given, so later ones override earlier ones; the derived values
(``config/static.py``) are derived again after them. While a file runs,
``torbi_tpu_torch.CONFIGURING`` is True, so that a file can tell it is
being applied.

The JAX package applies the files named on the command line when it is
imported. This package applies them when an entry point parses its
arguments through ``ArgumentParser`` (the CLI, ``__main__.py``), so that
importing it reads no arguments; every module reads the constants as
``torbi_tpu_torch.<NAME>`` when it runs, so they take effect before the
decode.
"""
import argparse
import importlib.util
import sys
from pathlib import Path


def _load_module_from_path(path):
    path = Path(path)
    name = f'_torbi_tpu_torch_config_{path.stem}'
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None or not path.is_file():
        # --config takes a path to a .py override file (yapecs semantics),
        # not a bare configuration name
        raise FileNotFoundError(
            f'--config expects a Python override file, got {str(path)!r} '
            '(not a loadable .py path)')
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def configure(files):
    """Apply the override files, in order, onto the package's constants"""
    import torbi_tpu_torch

    for file in files:
        torbi_tpu_torch.CONFIGURING = True
        try:
            override = _load_module_from_path(file)
        finally:
            torbi_tpu_torch.CONFIGURING = None
        for key in dir(override):
            if not key.startswith('_') and key.isupper():
                setattr(torbi_tpu_torch, key, getattr(override, key))
    if files:
        from .static import derive

        derive()


class ArgumentParser(argparse.ArgumentParser):
    """``argparse.ArgumentParser`` with a ``--config`` option: parsing
    applies the named override files (``configure``) and leaves ``config``
    out of the returned namespace"""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.add_argument(
            '--config', type=Path, nargs='*', default=[],
            help='Configuration override files (.py), applied in order')

    def parse_known_args(self, args=None, namespace=None):
        namespace, rest = super().parse_known_args(args, namespace)
        configure(namespace.config)
        del namespace.config
        return namespace, rest
