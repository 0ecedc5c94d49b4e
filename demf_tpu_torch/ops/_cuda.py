"""Build, load and launch the hand-written Hopper kernels in ``csrc/``.

Every ``csrc/*.cu`` file exports plain C functions that take raw device
pointers and a ``cudaStream_t`` and return ``cudaGetLastError()``.  They are
compiled with ``nvcc`` for ``sm_90a`` at first use, one ``nvcc`` process per
source, all started together, then linked into one shared library and
loaded with ``ctypes``.  Nothing is compiled when a module is imported,
so the package imports on hosts without ``nvcc`` or a card.

The library lands in ``build/kernels/`` at the repository root under a name
keyed on a hash of the sources and flags, so an unchanged tree reuses it.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build', 'kernels')
ARCH_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = ARCH_FLAGS + ('-std=c++17', '-O3', '-Xcompiler', '-fPIC',
                           '-Xptxas', '-v')

# one H100: what a block may use of an SM's shared memory, and the SMs
SMEM_PER_BLOCK = 232448
SM_COUNT = 132

# dtype codes of the kernels that take float32 or bfloat16 operands
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib = None
_build_info = {}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, '*.cu')) +
                  glob.glob(os.path.join(CSRC_DIR, '*.cuh')))


def _nvcc():
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                           'are built from demf_tpu_torch/csrc at first use')
    return found


def library_path():
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, 'rb') as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f'libdemf_kernels-{h.hexdigest()[:16]}.so')


def build():
    """Compile the kernels if needed and return (path, seconds, built)."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0, False
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [s for s in _sources() if s.endswith('.cu')]
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    t0 = time.perf_counter()
    try:
        objs = [os.path.join(work, os.path.basename(s)[:-3] + '.o')
                for s in cu]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, '-c', '-o', o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for s, o in zip(cu, objs)]
        outs = [p.communicate() for p in procs]
        log = ''.join(out + err for out, err in outs)
        failed = [f'{os.path.basename(s)} ({p.returncode}):\n{err[-4000:]}'
                  for s, p, (_, err) in zip(cu, procs, outs) if p.returncode]
        if not failed:
            tmp = os.path.join(work, 'lib.so')
            link = subprocess.run([_nvcc(), *ARCH_FLAGS, '-shared', '-o', tmp,
                                   *objs], capture_output=True, text=True)
            log += link.stdout + link.stderr
            if link.returncode:
                failed.append(f'link ({link.returncode}):\n'
                              f'{link.stderr[-4000:]}')
        with open(path[:-3] + '.log', 'w') as f:
            f.write(log)
        if failed:
            raise RuntimeError('nvcc failed: ' + '\n'.join(failed))
        os.replace(tmp, path)   # atomic: a concurrent build sees all or none
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return path, time.perf_counter() - t0, True


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path, seconds, built = build()
            _build_info.update(path=path, seconds=seconds, built=built)
            _lib = ctypes.CDLL(path)
        return _lib


def build_info():
    """Where the library came from and how long its build took."""
    library()
    return dict(_build_info)


def current_stream_handle():
    """PyTorch's current ``cudaStream_t`` as an int.  The raw getter skips
    building a ``torch.cuda.Stream``, about 2 us of the ~20 a small launch
    costs the host; without it the public route gives the same handle."""
    raw = getattr(torch._C, '_cuda_getCurrentRawStream', None)
    if raw is None:
        return torch.cuda.current_stream().cuda_stream
    return raw(torch.cuda.current_device())


class CudaKernel:
    """One C entry point of the kernel library, with a launch counter.

    ``argtypes`` lists the C arguments before the trailing stream; pointers
    are ``ctypes.c_void_p`` (pass ``tensor.data_ptr()``), sizes
    ``ctypes.c_int``.  ``launches`` counts successful launches only.
    """

    def __init__(self, symbol, argtypes):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args, current_stream_handle())
        if err != 0:
            raise RuntimeError(f'{self.symbol}: CUDA error {err} at launch')
        self.launches += 1


def check_cuda(name, t, dtype, ndim):
    """Raise unless ``t`` is a contiguous CUDA tensor of dtype and rank."""
    if not t.is_cuda:
        raise ValueError(f'{name} must be a CUDA tensor, got {t.device}')
    if t.dtype != dtype:
        raise TypeError(f'{name} must be {dtype}, got {t.dtype}')
    if t.dim() != ndim:
        raise ValueError(f'{name} must have {ndim} dims, got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
