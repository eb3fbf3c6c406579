"""The port's Kaldi MFCC (``tssep_tpu_torch/features/kaldi.py``) and the
waveform-feature input of its ``Model.forward`` against ``tssep_tpu`` on
the CPU, after ``tests/test_kaldi.py``.

Signals are made with numpy from a seed. The numpy path is a copy of JAX's
float64 arithmetic and must match it to float32 rounding (1e-5 relative);
the torch path computes the same in float64 (``torch.fft.rfft``) and is held
to the same tolerance. The golden values are ``tests/test_kaldi.py``'s, at
its 2e-3. The Kaldi-input TS-VAD model's logits, through the MFCC, a
three-layer BLSTM stack and the head, are compared at 1e-4 (float32, the
two packages summing in other orders).
"""

import math

import jax
import numpy as np
import pytest
import torch

from tssep_tpu.features import kaldi as jax_kaldi
from tssep_tpu.nn import rnnp as jax_rnnp
from tssep_tpu.tasks.model import Model as JaxModel
from tssep_tpu.train.checkpoint import params_to_named
from tssep_tpu_torch.compat.from_jax import load_named
from tssep_tpu_torch.config.configurable import from_config, import_class
from tssep_tpu_torch.features import extractor as fe
from tssep_tpu_torch.features.kaldi import (
    EPSILON, FuncFeature, KaldiMFCC, kaldi_mel_banks, kaldi_mfcc_np,
    povey_window)
from tssep_tpu_torch.tasks.model import Model

RTOL = 1e-5
MODEL_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _scan_unroll_1(monkeypatch):
    """JAX's scans unrolled once: the model compiles in a fraction of the
    time, to the same values."""
    monkeypatch.setattr(jax_rnnp, 'DEFAULT_UNROLL', 1)


KALDI_MODEL = {
    'fe': {'factory': 'tssep_tpu.features.kaldi.KaldiMFCC',
           'sample_frequency': 8000.0, 'num_ceps': 13, 'num_mel_bins': 23},
    'reader': {'sample_rate': 8000, 'aux_size': 33},
    'loss': {'factory': 'tssep_tpu.tasks.losses.VADSigmoidBCE'},
    'mask_estimator': {
        'idim': 13, 'odim': 1, 'units': 2, 'projs': 3,
        'aux_net_output_size': 33, 'num_averaged_permutations': 1,
        'output_resolution': 't',
    },
}


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_frame_count_and_shapes():
    ours = KaldiMFCC()
    assert (ours.window_size, ours.window_shift,
            ours.padded_window_size) == (400, 160, 512)
    assert ours.num_frames(16000) == 98
    x = np.random.RandomState(0).randn(16000)
    feats = ours(x)
    assert feats.shape == (98, 13) and feats.dtype == np.float32
    two = ours(np.stack([x, x]))
    assert two.shape == (2, 98, 13)
    _close(two[0], feats)
    t = ours(torch.from_numpy(np.stack([x, x])))
    assert t.shape == (2, 98, 13) and t.dtype == torch.float32
    assert ours(np.zeros(399)).shape == (0, 13)
    assert ours(torch.zeros(2, 399)).shape == (2, 0, 13)


def test_povey_window_and_mel_banks_equal_jax():
    w = povey_window(400)
    assert w[0] == 0 and w[-1] < 1e-10
    hann = 0.5 - 0.5 * np.cos(2 * math.pi * np.arange(400) / 399)
    np.testing.assert_allclose(w, hann ** 0.85, atol=1e-12)
    for kind in ('povey', 'hanning', 'hamming', 'rectangular', 'blackman'):
        np.testing.assert_array_equal(povey_window(400, window_type=kind),
                                      jax_kaldi.povey_window(400,
                                                             window_type=kind))
    for bins in (23, 40):
        banks = kaldi_mel_banks(bins, 512, 16000.0)
        assert banks.shape == (bins, 256)
        np.testing.assert_array_equal(
            banks, jax_kaldi.kaldi_mel_banks(bins, 512, 16000.0))
    cover = kaldi_mel_banks(23, 512, 16000.0).sum(0)
    hz = np.arange(256) * 16000 / 512
    interior = cover[(hz > 300) & (hz < 7000)]
    assert interior.min() > 0.5 and interior.max() <= 1.0 + 1e-6


@pytest.mark.parametrize('kwargs', [
    {}, {'use_energy': True}, {'use_energy': True, 'raw_energy': False},
    {'subtract_mean': True}, {'num_ceps': 40, 'num_mel_bins': 40},
    {'sample_frequency': 8000.0, 'window_type': 'hamming'}])
def test_numpy_and_torch_paths_match_jax(kwargs):
    """Both paths against JAX's numpy path (its reference arithmetic)."""
    x = np.random.RandomState(7).randn(2, 4000).astype(np.float32)
    want = jax_kaldi.KaldiMFCC(**kwargs)(x)
    ours = KaldiMFCC(**kwargs)
    _close(ours(x), want)
    _close(ours(torch.from_numpy(x)).numpy(), want)
    _close(kaldi_mfcc_np(x, **kwargs), want)


def test_constant_signal_closed_form():
    """DC removal zeroes a constant frame: every mel energy is floored at
    eps, so c0 = log(eps) sqrt(num_mel_bins) and the rest are 0."""
    for x in (np.full(800, 3.25), torch.full((800,), 3.25)):
        feats = np.asarray(KaldiMFCC()(x))
        np.testing.assert_allclose(feats[:, 0],
                                   math.log(EPSILON) * math.sqrt(23),
                                   rtol=1e-5)
        np.testing.assert_allclose(feats[:, 1:], 0.0, atol=1e-4)


def test_golden_values():
    """``tests/test_kaldi.py``'s pinned values, both paths."""
    t = np.arange(1600) / 16000.0
    x = np.sin(2 * np.pi * 440 * t) + 0.1 * np.cos(2 * np.pi * 1330 * t)
    golden = np.array([
        -40.87226, 76.98644, -12.94643, -61.39536, -1.79407,
        9.7329, -83.59234, -134.92647, -57.87252, 51.15292,
        73.48902, 20.61532, -13.81434,
    ])
    for feats in (KaldiMFCC()(x), KaldiMFCC()(torch.from_numpy(x)).numpy()):
        assert feats.shape == (8, 13)
        np.testing.assert_allclose(feats.mean(0), golden, atol=2e-3)


def test_use_energy_and_subtract_mean():
    x = np.random.RandomState(1).randn(2000)
    feats, raw = KaldiMFCC(use_energy=True)(x), KaldiMFCC()(x)
    assert not np.allclose(feats[:, 0], raw[:, 0])
    np.testing.assert_allclose(feats[:, 1:], raw[:, 1:], rtol=1e-5)
    np.testing.assert_allclose(KaldiMFCC(subtract_mean=True)(x).mean(0), 0.0,
                               atol=1e-4)


def test_sample_vad_to_frame_vad_matches_jax():
    vad = np.zeros((3, 8000), bool)
    vad[0, 1000:3000] = True
    vad[2, 7990:] = True
    ours = KaldiMFCC(sample_frequency=8000.0)
    want = jax_kaldi.KaldiMFCC(sample_frequency=8000.0)
    np.testing.assert_array_equal(ours.sample_vad_to_frame_vad(vad),
                                  want.sample_vad_to_frame_vad(vad))


def test_func_feature_wrapper():
    wrapped = FuncFeature(lambda x: 2.0 * x, KaldiMFCC())
    x = np.random.RandomState(3).randn(1200)
    np.testing.assert_allclose(wrapped(x), 2.0 * KaldiMFCC()(x), rtol=1e-6)
    assert wrapped.output_size == 13
    assert wrapped.window_shift == 160        # the inner extractor's
    assert not hasattr(wrapped, 'stft')
    built = FuncFeature({'factory': 'tssep_tpu.features.extractor.AbsSTFT',
                         'size': 64, 'shift': 32}, KaldiMFCC())
    assert isinstance(built.func, fe.AbsSTFT)


@pytest.mark.parametrize('factory', [
    'tssep.train.feature_extractor.KaldiTorchMFCC',
    'tssep_tpu.features.kaldi.KaldiMFCC', 'KaldiMFCC'])
def test_reference_config_alias(factory):
    """A reference, JAX or bare factory name resolves to the port's class,
    through ``from_config`` and ``fe_from_config``."""
    built = from_config({'factory': factory, 'num_ceps': 40,
                         'num_mel_bins': 40, 'snip_edges': True})
    assert isinstance(built, KaldiMFCC) and built.output_size == 40
    if not factory.startswith('tssep.'):      # by class name, not alias
        assert isinstance(fe.fe_from_config({'factory': factory}), KaldiMFCC)
    assert import_class('tssep.train.feature_extractor.KaldiTorch') is \
        FuncFeature


def test_unsupported_options_raise():
    for kwargs in ({'snip_edges': False}, {'dither': 1.0},
                   {'vtln_warp': 0.9}, {'htk_compat': True}):
        with pytest.raises(NotImplementedError):
            KaldiMFCC(**kwargs)


def test_model_forward_with_kaldi_fe_matches_jax():
    """The Kaldi-input TS-VAD model (``tests/test_kaldi.py``'s config): the
    port's ``Model.forward`` makes ``Input`` from the reference channel's
    samples and gives JAX's logits; ``host_prepare`` frames a sample VAD the
    Kaldi way."""
    jm = JaxModel.new(KALDI_MODEL)
    rng = np.random.default_rng(0)
    params = jax.tree.map(    # numpy values on eval_shape's tree: no jit
        lambda leaf: rng.uniform(-0.5, 0.5, leaf.shape).astype(np.float32),
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)))
    ours = Model.from_config(KALDI_MODEL, storage_dtype=torch.float32,
                             device='cpu')
    assert isinstance(ours.fe, KaldiMFCC) and not hasattr(ours.fe, 'stft')
    load_named(ours, params_to_named(params))
    ex = {'observation': rng.standard_normal((2, 2, 8000 * 2)).astype(
              np.float32),
          'auxInput': rng.standard_normal((2, 4, 33)).astype(np.float32),
          'reference_channel': 1}
    want = jm.forward(params, dict(ex), rng=None)
    got = ours(dict(ex))
    frames = ours.fe.num_frames(8000 * 2)
    assert got.logit.shape == tuple(want.logit.shape)
    assert got.logit.shape[-2] == frames
    assert got.stft_estimate is None and got.time_estimate is None
    np.testing.assert_allclose(got.logit.numpy(), np.asarray(want.logit),
                               atol=MODEL_ATOL, rtol=0)
    vad = np.zeros((4, 8000 * 2), bool)
    vad[1, 4000:9000] = True
    prepared = ours.host_prepare({'vad': vad})
    np.testing.assert_array_equal(prepared['Vad'],
                                  jm.host_prepare({'vad': vad})['Vad'])
    loss, _ = ours.loss_fn(dict(ex, Vad=prepared['Vad'][None].repeat(2, 0)),
                           training=False)
    assert torch.isfinite(loss)
