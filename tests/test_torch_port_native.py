"""The port's native runtime (``runtime/native.py`` and its own copy of the
C++ sources), built with g++ into ``build/``: WAV and shard round trips,
the interval kernel, and ``der_counts`` against the port's ``der``; the
eval driver's WAV writer is the native one.

On import, this file also makes sure the JAX package's native library
(``tssep_tpu/runtime/libtssep_runtime.so``, which the JAX tests and the port
tests that hold the port's shards against JAX's call) is whole and loaded in
this process before any test runs: ``tssep_tpu.runtime.native.lib`` has g++
write the library in place, so pytest workers that build it at the same time
can load a half-written file and keep that error for every later call. Under
an exclusive lock on a file in the temporary directory, one process at a
time clears such an error and loads the library, building it first into a
temporary file that then replaces it where the one on disk does not load.
xdist workers import every test file before the first test is scheduled.
"""

import fcntl
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import scipy.optimize

from tssep_tpu.runtime import native as jax_native
from tssep_tpu_torch.eval import driver
from tssep_tpu_torch.eval.metrics import der
from tssep_tpu_torch.runtime import native


def _jax_native_loaded():
    """Loads the JAX package's native library under an exclusive lock (see
    the module docstring); a host without g++ still collects."""
    lock = Path(tempfile.gettempdir()) / 'tssep_tpu_runtime_build.lock'
    with open(lock, 'w') as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            if jax_native._lib is not None:
                return
            jax_native._build_error = None
            try:
                jax_native.lib()
                return
            except RuntimeError:
                jax_native._build_error = None
            tmp = jax_native._LIB_PATH.with_name(
                f'{jax_native._LIB_PATH.name}.{os.getpid()}.tmp')
            try:
                subprocess.run(
                    ['g++', '-O3', '-shared', '-fPIC', '-std=c++17', '-o',
                     str(tmp), *map(str, sorted(
                         jax_native._SRC_DIR.glob('*.cc')))],
                    check=True, capture_output=True)
                tmp.replace(jax_native._LIB_PATH)
                jax_native.lib()
            except (OSError, subprocess.CalledProcessError, RuntimeError):
                pass
            finally:
                tmp.unlink(missing_ok=True)
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


_jax_native_loaded()


def test_library_builds_into_build_dir():
    assert native.available()
    path = native.lib_path()
    assert path.parent == native.BUILD_DIR and path.parent.name == 'build'
    assert path.is_file()
    assert driver.wav_writer() == ('native', native.wav_write)


@pytest.mark.parametrize('channels,as_float', [(2, False), (1, True)])
def test_wav_round_trip(tmp_path, channels, as_float):
    rng = np.random.RandomState(channels)
    x = (rng.rand(channels, 4000).astype(np.float32) - 0.5)
    p = tmp_path / 'a.wav'
    native.wav_write(p, x, 16000, as_float=as_float)
    assert native.wav_info(p) == {
        'channels': channels, 'sample_rate': 16000, 'num_frames': 4000,
        'bits': 32 if as_float else 16, 'is_float': as_float}
    y, sr = native.wav_read(p)
    assert sr == 16000 and y.shape == x.shape
    if as_float:
        np.testing.assert_array_equal(y, x)
    else:
        np.testing.assert_allclose(y, x, atol=1 / 32000)
    part, _ = native.wav_read(p, start=100, count=50)
    np.testing.assert_array_equal(part, y[:, 100:150])


def test_save_wavs_reads_back(tmp_path):
    est = 0.1 * np.random.default_rng(0).standard_normal((3, 1000))
    paths = driver.save_wavs({'time_estimate': est}, tmp_path, 8000, 'rec')
    assert [p.name for p in paths] == [f'rec_spk{i}.wav' for i in range(3)]
    for p, sig in zip(paths, est):
        y, sr = native.wav_read(p)
        assert sr == 8000
        np.testing.assert_allclose(y[0], sig, atol=1 / 32000)


def test_shard_round_trip(tmp_path):
    p = tmp_path / 'data.shard'
    rng = np.random.RandomState(0)
    arrays = {
        'ex0/observation': rng.randn(2, 100).astype(np.float32),
        'ex0/vad': (rng.rand(8, 100) > 0.5),
        'ex0/ids': rng.randint(0, 9, (3,)).astype(np.int64),
        'ex1/stft': (rng.randn(10, 5) + 1j * rng.randn(10, 5)
                     ).astype(np.complex64),
    }
    with native.ShardWriter(p) as w:
        for k, v in arrays.items():
            w.add(k, v)
    r = native.ShardReader(p)
    assert set(r.keys()) == set(arrays) and len(r) == len(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(r[k].astype(v.dtype), v)


def test_interval_kernel():
    arr = np.zeros(100, dtype=bool)
    arr[5:20] = arr[50:60] = arr[99] = True
    np.testing.assert_array_equal(native.intervals_from_array(arr),
                                  [[5, 20], [50, 60], [99, 100]])


@pytest.mark.parametrize('seed', range(2))
def test_der_counts_match_der(seed):
    rng = np.random.RandomState(seed)
    ref = rng.rand(3, 500) > 0.6
    hyp = rng.rand(4, 480) > 0.6
    ov = native.overlap_matrix(ref, hyp)
    np.testing.assert_array_equal(
        ov, (ref[:, None, :480] & hyp[None]).sum(-1))
    ri, hi = scipy.optimize.linear_sum_assignment(-ov)
    mapping = np.full(4, -1, dtype=np.int64)
    mapping[hi] = ri
    counts = native.der_counts(ref, hyp, mapping)
    want = der(ref, hyp)
    assert counts['total'] == want['total']
    assert (counts['miss'], counts['falarm'], counts['confusion']) == (
        want['miss'], want['falarm'], want['confusion'])
