"""Build the CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, under ``build/torbi_tpu_torch/`` at the root of the
checkout. A library's file name carries a digest of its source, the shared
header and the flags, so an edited source rebuilds and an unchanged one is
reused. ``build()`` starts one ``nvcc`` per missing library, all at once,
and raises if any of them fails. The host code of the native file loader,
``csrc/loader.cpp``, builds the same way with ``g++`` (``host_library``).
Each build writes a file whose name holds the process id and renames it
into place, so processes that build at once do not race; ptxas's report of
the build (``-Xptxas -v``: registers, spills) is kept beside the library
(``report``). Nothing here runs at import.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = CSRC_DIR.parent.parent / 'build' / 'torbi_tpu_torch'
# The decode kernels' sources, then the labs'
DECODE_SOURCES = (
    'band_forward', 'band_wide', 'band_spread', 'dense_forward', 'backtrace',
    'backtrace_batch1', 'constant', 'maxplus', 'sparse_forward',
    'sparse_backtrace')
SOURCES = DECODE_SOURCES + (
    'lab_forward', 'lab_pipe', 'lab_mxu', 'lab_mod', 'lab_spread',
    'lab_chase')
FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
HOST_FLAGS = ('-O3', '-shared', '-fPIC', '-pthread', '-std=c++17')

_libraries = {}
_host_lock = threading.Lock()


def nvcc():
    """Path of the CUDA compiler"""
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.access(path, os.X_OK):
        raise RuntimeError(
            'nvcc not found (neither on PATH nor at /usr/local/cuda/bin); '
            'the CUDA kernels of torbi_tpu_torch cannot be built')
    return path


def target(name):
    """Path of the shared library built from ``csrc/<name>.cu``"""
    digest = hashlib.sha256()
    for path in [CSRC_DIR / f'{name}.cu', *sorted(CSRC_DIR.glob('*.cuh'))]:
        digest.update(path.read_bytes())
    digest.update(' '.join(FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def report(name):
    """The compiler's output (ptxas's register and spill report) of the
    build of ``csrc/<name>.cu`` that ``target(name)`` holds, kept beside
    it; None where there is none"""
    path = target(name).with_suffix('.ptxas')
    return path.read_text() if path.exists() else None


def build(names=SOURCES):
    """Compile every library of ``names`` that is not built yet, one nvcc
    process per source, all started together. Returns {name: path}."""
    targets = {name: target(name) for name in names}
    missing = {name: path for name, path in targets.items()
               if not path.exists()}
    if not missing:
        return targets
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in missing.items():
        partial = path.with_name(f'{path.name}.{os.getpid()}.partial')
        command = [
            compiler, *FLAGS, '-o', str(partial), str(CSRC_DIR / f'{name}.cu')]
        procs[name] = (partial, subprocess.Popen(
            command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (partial, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode:
            failed.append(f'{name}.cu (exit {proc.returncode}):\n{output}')
            partial.unlink(missing_ok=True)
        else:
            # The report first, so that a library never stands without it
            log = partial.with_suffix('.ptxas')
            log.write_text(output)
            os.replace(log, missing[name].with_suffix('.ptxas'))
            os.replace(partial, missing[name])
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return targets


def host_library(name):
    """Path of the shared library built with g++ from ``csrc/<name>.cpp``
    (built on first use), or None when it does not build"""
    source = CSRC_DIR / f'{name}.cpp'
    digest = hashlib.sha256(source.read_bytes())
    digest.update(' '.join(HOST_FLAGS).encode())
    path = BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'
    with _host_lock:
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = path.with_name(f'{path.name}.{os.getpid()}.partial')
        try:
            subprocess.run(
                ['g++', *HOST_FLAGS, str(source), '-o', str(partial)],
                check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            partial.unlink(missing_ok=True)
            return None
        os.replace(partial, path)
        return path


def library(name):
    """The loaded library of ``csrc/<name>.cu``, built on first use"""
    if name not in _libraries:
        lib = ctypes.CDLL(str(build((name,))[name]))
        lib.torbi_error_string.argtypes = [ctypes.c_int]
        lib.torbi_error_string.restype = ctypes.c_char_p
        _libraries[name] = lib
    return _libraries[name]


def pointer(tensor, offset=0):
    """The address of ``tensor``'s element ``offset`` (in elements), as a
    ctypes pointer"""
    return ctypes.c_void_p(tensor.data_ptr() + offset * tensor.element_size())


def stream(device):
    """PyTorch's current stream on ``device``, as a ctypes pointer"""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(name, tensor, shape, dtype, device):
    """Raise unless ``tensor`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device``"""
    if tensor.device != device:
        raise ValueError(f'{name} is on {tensor.device}, expected {device}')
    if tensor.dtype != dtype:
        raise ValueError(f'{name} is {tensor.dtype}, expected {dtype}')
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(
            f'{name} has shape {tuple(tensor.shape)}, expected {tuple(shape)}')
    if not tensor.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def raise_on_error(lib, kernel, code):
    """Raise if a C entry point returned a CUDA error"""
    if code:
        message = lib.torbi_error_string(code).decode()
        raise RuntimeError(f'{kernel} kernel failed: CUDA error {code} '
                           f'({message})')
