"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` file exposes a plain C interface, so the build needs no
PyTorch headers and takes seconds. Each source compiles in its own ``nvcc``
process, all started together, and one more call links the objects. The
shared library goes to ``build/`` at the repository root, named by a hash of
the sources and flags, and is built at first use: a process that finds a
library for the current sources loads it. Processes that start together
(the ranks of a data-parallel run) build it once: the first takes a file
lock in ``build/`` and builds, the others wait for it and load.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import fcntl
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
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int

#: C signatures of the exported functions (all return a cudaError_t).
_SIGNATURES = {
    'tssep_blstm_fullfused_fwd': [_P, _LL, _LL, _I, _P, _P, _P, _P, _P, _LL,
                                  _LL, _I, _I, _I, _I, _I, _P],
    'tssep_blstm_fullfused_fwd_cluster': [_P, _LL, _LL, _I, _P, _P, _P, _P,
                                          _P, _LL, _LL, _I, _I, _I, _I, _I,
                                          _I, _I, _I, _I, _P],
    'tssep_cluster_fwd_slots': [_I, _I, _I, _I, _I, _P],
    'tssep_cluster_walk_slots': [_I, _I, _I, _I, _P],
    'tssep_blstm_bidi_fwd': [_P, _LL, _LL, _P, _P, _P, _LL, _LL, _I, _I, _I,
                             _I, _I, _P],
    'tssep_blstm_bidi_fwd_cluster': [_P, _LL, _LL, _P, _P, _P, _P, _LL, _LL,
                                     _I, _I, _I, _I, _I, _I, _I, _I, _P],
    'tssep_bidi_fwd_slots': [_I, _I, _I, _I, _I, _P],
    'tssep_bidi_walk_slots': [_I, _I, _I, _I, _P],
    'tssep_blstm_fullfused_bwd': [_P, _LL, _LL, _I, _P, _P, _P, _P, _P, _P,
                                  _P, _LL, _LL, _P, _LL, _LL, _P, _P, _P, _I,
                                  _I, _I, _I, _I, _P],
    'tssep_blstm_fullfused_bwd_cluster': [_P, _LL, _LL, _I, _P, _P, _P, _P,
                                          _P, _P, _LL, _LL, _P, _LL, _LL, _P,
                                          _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                          _I, _I, _I, _P],
    'tssep_blstm_bidi_bwd': [_P, _LL, _LL, _P, _P, _P, _P, _LL, _LL, _P, _LL,
                             _LL, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    'tssep_blstm_bidi_bwd_cluster': [_P, _LL, _LL, _P, _P, _P, _P, _LL, _LL,
                                     _P, _LL, _LL, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _I, _I, _I, _I, _I, _P],
    'tssep_blstm_fullfused_cond_fwd': [_P, _LL, _LL, _I, _P, _I, _P, _P, _P,
                                       _P, _P, _LL, _LL, _I, _I, _I, _I, _I,
                                       _P],
    'tssep_blstm_fullfused_cond_bwd': [_P, _LL, _LL, _I, _P, _I, _P, _P, _P,
                                       _P, _P, _P, _P, _LL, _LL, _P, _LL, _LL,
                                       _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _P],
    'tssep_blstm_fullfused_cond_fwd_cluster': [_P, _LL, _LL, _I, _P, _I, _P,
                                               _P, _P, _P, _P, _LL, _LL, _I,
                                               _I, _I, _I, _I, _I, _I, _I, _I,
                                               _P],
    'tssep_cond_fwd_slots': [_I, _I, _I, _I, _I, _P],
    'tssep_blstm_fullfused_cond_bwd_cluster': [_P, _LL, _LL, _I, _P, _I, _P,
                                               _P, _P, _P, _P, _P, _LL, _LL,
                                               _P, _LL, _LL, _P, _P, _P, _P,
                                               _P, _I, _I, _I, _I, _I, _I,
                                               _I, _I, _I, _I, _P],
    'tssep_blstm_fullfused_spill_fwd': [_P, _LL, _LL, _I, _P, _P, _P, _P, _P,
                                        _LL, _LL, _I, _I, _I, _I, _I, _I, _P],
    'tssep_blstm_fullfused_spill_bwd': [_P, _LL, _LL, _I, _P, _P, _P, _P, _P,
                                        _P, _LL, _LL, _P, _P, _LL, _LL, _P, _P,
                                        _P, _P, _I, _I, _I, _I, _I, _I, _P],
    'tssep_blstm_fullfused_spill_fwd_cluster': [_P, _LL, _LL, _I, _P, _P,
                                                _P, _P, _P, _LL, _LL, _I, _I,
                                                _I, _I, _I, _I, _I, _I, _I,
                                                _I, _P],
    'tssep_blstm_fullfused_spill_bwd_cluster': [_P, _LL, _LL, _I, _P, _P,
                                                _P, _P, _P, _LL, _LL, _P, _P,
                                                _LL, _LL, _P, _P, _P, _I, _I,
                                                _I, _I, _I, _I, _I, _I, _I,
                                                _I, _I, _P],
    'tssep_spill_walk_slots': [_I, _I, _I, _I, _P],
    'tssep_lstm_fwd': [_P, _LL, _LL, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I,
                       _I, _P, _P, _P],
    'tssep_lstm_bwd': [_P, _LL, _LL, _P, _P, _P, _P, _LL, _LL, _P, _LL, _LL, _P,
                       _P, _P, _I, _I, _I, _I, _I, _I, _P],
    'tssep_lstm_fwd_cluster': [_P, _LL, _LL, _P, _P, _P, _P, _LL, _LL, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    'tssep_lstm_fwd_slots': [_I, _I, _I, _I, _I, _P],
    'tssep_lstm_bwd_cluster': [_P, _LL, _LL, _P, _P, _P, _P, _LL, _LL, _P, _LL,
                               _LL, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _P],
    'tssep_lstm_walk_slots': [_I, _I, _I, _I, _P],
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


def _run_all(cmds):
    """Runs the commands side by side; raises if any fails. Returns their
    combined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed with exit code {proc.returncode}'
                               f' on {cmd[-1]}:\n{log}')
    return ''.join(logs)


def build() -> BuildResult:
    """Compile every ``csrc/*.cu`` in parallel and link them into ``build/``."""
    out = _library_path()
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f'{out.stem}.{os.getpid()}'
    objects = [BUILD_DIR / f'{tag}.{src.stem}.o' for src in _sources()]
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(src)]
                        for src, obj in zip(_sources(), objects)])
        log += _run_all([[nvcc, *NVCC_FLAGS, '-shared', '-o', str(tmp),
                          *map(str, objects)]])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    return BuildResult(out, seconds, log)


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on ``build/build.lock`` (released when the
    process ends, however it ends)."""
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / 'build.lock', 'w') as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built first if this source has none
    (by one process at a time)."""
    path = _library_path()
    if not path.exists():
        with _build_lock():
            if not path.exists():
                build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
