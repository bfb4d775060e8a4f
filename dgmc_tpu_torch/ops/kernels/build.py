"""Build the CUDA sources under ``dgmc_tpu_torch/csrc/`` at first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface and loaded with ``ctypes``; no
PyTorch header is compiled, so a build takes seconds. Libraries land in
``dgmc_tpu_torch/_build/`` (gitignored) under a name that carries the
hash of the source, the shared headers and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as built.
Nothing here runs at import time.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ['CSRC_DIR', 'BUILD_DIR', 'NVCC_FLAGS', 'load_library', 'sm_count']

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-lineinfo', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas=-v')

_lock = threading.Lock()      # guards the two tables below
_loaded = {}                  # source file name -> ctypes.CDLL
_building = {}                # source file name -> its own build lock


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, 'bin', 'nvcc')] if CUDA_HOME else []
    cands.append(shutil.which('nvcc'))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError('nvcc not found: the CUDA kernels of dgmc_tpu_torch '
                       'are compiled from source at first use and need the '
                       'CUDA toolkit (set CUDA_HOME)')


def _digest(src):
    """Hash of the source, every shared header of ``csrc/`` (a ``.cu``
    may include any of them) and the flags: an edited header rebuilds
    every library instead of loading a stale one."""
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith('.cuh'))
    for path in [src] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, 'rb') as f:
            h.update(os.path.basename(path).encode() + b'\0' + f.read())
    return h.hexdigest()[:16]


def load_library(source):
    """Compile ``csrc/<source>`` (once per content hash) and return the
    loaded ``ctypes.CDLL``. The library object carries ``build_seconds``
    (0.0 when an earlier build was reused) and ``build_log`` (nvcc's
    ``-Xptxas=-v`` report of registers, shared memory and spills). A
    build is a compile event of the run plane
    (:func:`~dgmc_tpu_torch.obs.registry.record_compile`). Each source
    has its own lock, so that threads building different sources run
    their ``nvcc`` processes side by side."""
    with _lock:
        lib = _loaded.get(source)
        if lib is not None:
            return lib
        source_lock = _building.setdefault(source, threading.Lock())
    with source_lock:
        lib = _loaded.get(source)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, source)
        digest = _digest(src)
        stem = os.path.splitext(source)[0]
        out = os.path.join(BUILD_DIR, f'lib{stem}_{digest}.so')
        seconds, log = 0.0, ''
        if not os.path.isfile(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f'{out}.tmp.{os.getpid()}'
            cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, src]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed on {source} '
                                   f'(rc {proc.returncode}):\n{log}')
            os.replace(tmp, out)
            from dgmc_tpu_torch.obs.registry import record_compile
            record_compile('nvcc', seconds)
        lib = ctypes.CDLL(out)
        lib.build_seconds = seconds
        lib.build_log = log
        with _lock:
            _loaded[source] = lib
        return lib


@functools.lru_cache(maxsize=None)
def sm_count(index):
    """SMs of CUDA device ``index``: what the kernels' launch plans size
    their grids by."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count
