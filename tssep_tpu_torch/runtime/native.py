"""ctypes bindings for the native runtime (WAV codec, shard store, interval
kernels): port of ``tssep_tpu/runtime/native.py``.

The shared library is built on demand with g++ from the port's own copy of
the sources (``runtime/src/*.cc``) into ``build/`` at the repository root,
named by a hash of the sources (no pybind11 dependency). ``available()``
reports whether the native path is usable; callers pick their pure-python
implementations only when it is not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ['available', 'lib', 'lib_path', 'wav_read', 'wav_write', 'wav_info',
           'ShardWriter', 'ShardReader', 'der_counts', 'overlap_matrix',
           'intervals_from_array']

_SRC_DIR = Path(__file__).resolve().parent / 'src'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
_lock = threading.Lock()
_lib = None
_build_error = None

_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64,
           4: np.uint8, 5: np.complex64}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def lib_path() -> Path:
    """Where the library of the current sources lives: ``build/``, named
    by a hash of the sources."""
    digest = hashlib.sha256()
    for src in sorted(_SRC_DIR.glob('*.cc')):
        digest.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f'libtssep_runtime_{digest.hexdigest()[:16]}.so'


def _build(path):
    """g++ into a temporary name, then an atomic rename: processes that
    build at the same time each leave a whole library."""
    BUILD_DIR.mkdir(exist_ok=True)
    sources = sorted(_SRC_DIR.glob('*.cc'))
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ['g++', '-O3', '-shared', '-fPIC', '-std=c++17',
               '-o', tmp] + [str(s) for s in sources]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class _WavInfo(ctypes.Structure):
    _fields_ = [('channels', ctypes.c_int32),
                ('sample_rate', ctypes.c_int32),
                ('num_frames', ctypes.c_int64),
                ('bits', ctypes.c_int32),
                ('is_float', ctypes.c_int32)]


def lib():
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise _build_error
        try:
            path = lib_path()
            if not path.exists():
                _build(path)
            _lib = ctypes.CDLL(str(path))
            _configure(_lib)
        except Exception as e:  # noqa: BLE001
            _build_error = RuntimeError(f'native runtime unavailable: {e}')
            raise _build_error
        return _lib


def _configure(l):
    l.wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(_WavInfo)]
    l.wav_read.argtypes = [ctypes.c_char_p,
                           ctypes.POINTER(ctypes.c_float),
                           ctypes.c_int64, ctypes.c_int64]
    l.wav_write.argtypes = [ctypes.c_char_p,
                            ctypes.POINTER(ctypes.c_float),
                            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                            ctypes.c_int32]
    l.shard_writer_open.restype = ctypes.c_void_p
    l.shard_writer_open.argtypes = [ctypes.c_char_p]
    l.shard_writer_add.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_void_p, ctypes.c_uint64]
    l.shard_writer_close.argtypes = [ctypes.c_void_p]
    l.shard_count.restype = ctypes.c_int64
    l.shard_count.argtypes = [ctypes.c_char_p]
    l.shard_offsets.argtypes = [ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_uint64),
                                ctypes.c_int64]
    l.shard_record_header.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64)]
    l.shard_read_payload.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                     ctypes.c_void_p, ctypes.c_uint64]
    l.intervals_from_array.restype = ctypes.c_int64
    l.intervals_from_array.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    l.der_counts.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    l.overlap_matrix.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]


def available() -> bool:
    try:
        lib()
        return True
    except RuntimeError:
        return False


def _fptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


# ---------------------------------------------------------------------------
# WAV
# ---------------------------------------------------------------------------

def wav_info(path):
    info = _WavInfo()
    rc = lib().wav_info(str(path).encode(), ctypes.byref(info))
    if rc:
        raise IOError(f'wav_info({path}) failed: {rc}')
    return {'channels': info.channels, 'sample_rate': info.sample_rate,
            'num_frames': info.num_frames, 'bits': info.bits,
            'is_float': bool(info.is_float)}


def wav_read(path, start=0, count=-1, channels_first=True):
    info = wav_info(path)
    if count < 0:
        count = info['num_frames'] - start
    out = np.empty((count, info['channels']), dtype=np.float32)
    rc = lib().wav_read(str(path).encode(), _fptr(out), start, count)
    if rc:
        raise IOError(f'wav_read({path}) failed: {rc}')
    return (out.T.copy() if channels_first else out), info['sample_rate']


def wav_write(path, data, sample_rate, as_float=False):
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[None]
    # (channels, frames) -> interleaved
    interleaved = np.ascontiguousarray(data.T)
    rc = lib().wav_write(str(path).encode(), _fptr(interleaved),
                         interleaved.shape[0], interleaved.shape[1],
                         int(sample_rate), int(as_float))
    if rc:
        raise IOError(f'wav_write({path}) failed: {rc}')


# ---------------------------------------------------------------------------
# Shard store
# ---------------------------------------------------------------------------

class ShardWriter:
    """Write {key: array} example dicts into one shard file."""

    def __init__(self, path):
        self.path = str(path)
        self._h = lib().shard_writer_open(self.path.encode())
        if not self._h:
            raise IOError(f'cannot open {path}')

    def add(self, key: str, array):
        array = np.ascontiguousarray(array)
        if array.dtype == np.bool_:
            array = array.astype(np.uint8)
        code = _DTYPE_CODES.get(array.dtype)
        if code is None:
            raise TypeError(f'unsupported dtype {array.dtype}')
        shape = (ctypes.c_uint64 * array.ndim)(*array.shape)
        rc = lib().shard_writer_add(
            self._h, key.encode(), code, array.ndim, shape,
            array.ctypes.data_as(ctypes.c_void_p), array.nbytes)
        if rc:
            raise IOError(f'shard add failed: {rc}')

    def add_example(self, example_id: str, arrays: dict):
        for k, v in arrays.items():
            self.add(f'{example_id}/{k}', v)

    def close(self):
        if self._h:
            lib().shard_writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class ShardReader:
    """Random access reader over a shard file."""

    def __init__(self, path):
        self.path = str(path)
        n = lib().shard_count(self.path.encode())
        if n < 0:
            raise IOError(f'bad shard {path}: {n}')
        self._offsets = np.empty(n, dtype=np.uint64)
        rc = lib().shard_offsets(
            self.path.encode(),
            self._offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n)
        if rc:
            raise IOError(f'shard_offsets failed: {rc}')
        self._index = {}
        for i, off in enumerate(self._offsets):
            key, *_ = self._header(off)
            self._index[key] = off

    def _header(self, offset):
        key = ctypes.create_string_buffer(4096)
        dtype = ctypes.c_int32()
        ndim = ctypes.c_int32()
        shape = (ctypes.c_uint64 * 8)()
        nbytes = ctypes.c_uint64()
        payload_off = ctypes.c_uint64()
        rc = lib().shard_record_header(
            self.path.encode(), int(offset), key, 4096,
            ctypes.byref(dtype), ctypes.byref(ndim), shape,
            ctypes.byref(nbytes), ctypes.byref(payload_off))
        if rc:
            raise IOError(f'shard header failed: {rc}')
        shp = tuple(shape[i] for i in range(ndim.value))
        return (key.value.decode(), dtype.value, shp, nbytes.value,
                payload_off.value)

    def keys(self):
        return list(self._index)

    def __len__(self):
        return len(self._index)

    def __getitem__(self, key):
        off = self._index[key]
        _, dtype_code, shape, nbytes, payload_off = self._header(off)
        out = np.empty(shape, dtype=_DTYPES[dtype_code])
        rc = lib().shard_read_payload(self.path.encode(), payload_off,
                                      out.ctypes.data_as(ctypes.c_void_p),
                                      nbytes)
        if rc:
            raise IOError(f'shard payload failed: {rc}')
        return out


# ---------------------------------------------------------------------------
# Interval / DER kernels
# ---------------------------------------------------------------------------

def intervals_from_array(arr):
    arr = np.ascontiguousarray(np.asarray(arr, dtype=bool), dtype=np.uint8)
    cap = 1024
    while True:
        out = np.empty(2 * cap, dtype=np.int64)
        n = lib().intervals_from_array(_u8ptr(arr), len(arr), _i64ptr(out),
                                       cap)
        if n <= cap:
            return out[:2 * n].reshape(-1, 2)
        cap = int(n)


def overlap_matrix(ref, hyp):
    ref = np.ascontiguousarray(np.asarray(ref, dtype=bool), dtype=np.uint8)
    hyp = np.ascontiguousarray(np.asarray(hyp, dtype=bool), dtype=np.uint8)
    frames = min(ref.shape[1], hyp.shape[1])
    ref, hyp = ref[:, :frames].copy(), hyp[:, :frames].copy()
    out = np.empty((ref.shape[0], hyp.shape[0]), dtype=np.int64)
    lib().overlap_matrix(_u8ptr(ref), ref.shape[0], _u8ptr(hyp), hyp.shape[0],
                         frames, _i64ptr(out))
    return out


def der_counts(ref, hyp, mapping):
    ref = np.ascontiguousarray(np.asarray(ref, dtype=bool), dtype=np.uint8)
    hyp = np.ascontiguousarray(np.asarray(hyp, dtype=bool), dtype=np.uint8)
    frames = min(ref.shape[1], hyp.shape[1])
    ref, hyp = ref[:, :frames].copy(), hyp[:, :frames].copy()
    mapping = np.ascontiguousarray(mapping, dtype=np.int64)
    counts = np.zeros(4, dtype=np.int64)
    lib().der_counts(_u8ptr(ref), ref.shape[0], _u8ptr(hyp), hyp.shape[0],
                     _i64ptr(mapping), frames, _i64ptr(counts))
    return {'total': int(counts[0]), 'miss': int(counts[1]),
            'falarm': int(counts[2]), 'confusion': int(counts[3])}
