"""Build the port's CUDA kernels with one ``nvcc`` call and load them with ctypes.

Every ``csrc/*.cu`` file exposes a plain C interface, so the build needs no
PyTorch headers and takes seconds. The shared library goes to ``build/`` at
the repository root, named by a hash of the sources and flags, and is built at
first use: a process that finds a library for the current sources loads it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ['BuildResult', 'build', 'library', 'NVCC_FLAGS']

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int

#: C signatures of the exported functions (all return a cudaError_t).
_SIGNATURES = {
    'tssep_blstm_fullfused_fwd': [_P, _LL, _LL, _I, _P, _P, _P, _P, _P, _LL,
                                  _LL, _I, _I, _I, _I, _I, _P],
    'tssep_blstm_bidi_fwd': [_P, _LL, _LL, _P, _P, _P, _LL, _LL, _I, _I, _I,
                             _I, _I, _P],
}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float
    log: str          # nvcc's output, including ``-Xptxas -v``'s report


def _sources():
    return sorted(CSRC.glob('*.cu'))


def _library_path():
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f'libtssep_kernels_{digest.hexdigest()[:16]}.so'


def _nvcc():
    nvcc = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not Path(nvcc).exists():
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                           'toolkit to build')
    return nvcc


def build() -> BuildResult:
    """Compile every ``csrc/*.cu`` in one ``nvcc`` call into ``build/``."""
    out = _library_path()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed with exit code {proc.returncode}:\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, out)
    return BuildResult(out, seconds, proc.stdout + proc.stderr)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built first if this source has none."""
    path = _library_path()
    if not path.exists():
        build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
