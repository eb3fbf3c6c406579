"""The port's feature extractors (``tssep_tpu_torch/features/extractor.py``,
``signal/mel.py``) against ``tssep_tpu``'s on the CPU.

Signals are made with numpy from a seed and handed to both packages. The
mel filterbank and the DCT are the same numpy float64 arithmetic and must be
equal; every feature is compared at 1e-4 of its peak (float32: an FFT
against a DFT product, then the feature's transform; MFCC's dB values pass
through a 40 x 40 DCT).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tssep_tpu.config.configurable import from_config, get_config
from tssep_tpu.features import extractor as jax_fe
from tssep_tpu.signal import mel as jax_mel
from tssep_tpu_torch.features import extractor as fe
from tssep_tpu_torch.features.kaldi import KaldiMFCC
from tssep_tpu_torch.signal import mel

RTOL = 1e-4
RECIPE = Path(__file__).resolve().parents[1] / 'tssep_tpu/exp'


def _close_to_peak(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= rtol * peak, (
        np.abs(got - want).max(), peak)


def _signal(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).uniform(-1, 1, shape)).astype(
        np.float32)


# -- signal/mel.py -------------------------------------------------------------

@pytest.mark.parametrize('mel_scale,norm', [('htk', None), ('slaney',
                                                            'slaney')])
def test_mel_constants_equal_jax(mel_scale, norm):
    args = dict(n_freqs=513, f_min=40, f_max=15600, n_mels=40,
                sample_rate=16000, norm=norm, mel_scale=mel_scale)
    np.testing.assert_array_equal(mel.mel_filterbank(**args),
                                  jax_mel.mel_filterbank(**args))
    for dct_norm in ('ortho', None):
        np.testing.assert_array_equal(mel.create_dct(40, 40, dct_norm),
                                      jax_mel.create_dct(40, 40, dct_norm))


@pytest.mark.parametrize('shape', [(2, 7, 5), (2, 3, 7, 5)])
def test_amplitude_to_db_clamps_as_jax(shape):
    """At most 3 dims: one maximum for the whole tensor; more: one per
    leading element."""
    x = 10.0 ** np.random.default_rng(1).uniform(-12, 2, shape)
    x = x.astype(np.float32)
    got = mel.amplitude_to_db(torch.from_numpy(x), top_db=80.0)
    _close_to_peak(got, jax_mel.amplitude_to_db(jnp.asarray(x), top_db=80.0,
                                                xp=jnp))


# -- the extractors ------------------------------------------------------------

STFT_ARGS = dict(size=64, shift=16, window='hann')

#: (class name, extra arguments) of each single-channel extractor.
SINGLE = [('STFTFeatures', {}), ('AbsSTFT', {}), ('Log1pAbsSTFT', {}),
          ('MVNLog1pAbsSTFT', {}), ('NoFeatureSTFT', {}),
          ('Log1pMaxNormAbsSTFT', {'statistics_axis': 't'}),
          ('MFCC', {'size': 256, 'shift': 64, 'n_mfcc': 13, 'n_mels': 20}),
          ('MFCC', {'size': 256, 'shift': 64, 'log_mels': True}),
          ('TorchMFCC', {'size': 256, 'shift': 64, 'mel_scale': 'slaney',
                         'mel_norm': 'slaney', 'f_max': 7000})]


def _both(name, **kwargs):
    args = dict(STFT_ARGS, **kwargs)
    return getattr(fe, name)(**args), getattr(jax_fe, name)(**args)


def _compare(ours, ref, sig):
    assert ours.output_size == ref.output_size
    got = ours(torch.from_numpy(sig))
    want = np.asarray(ref(jnp.asarray(sig)))
    if not want.size:
        assert tuple(got.shape) == want.shape
    elif np.iscomplexobj(want):
        _close_to_peak(got.real, want.real)
        _close_to_peak(got.imag, want.imag)
    else:
        _close_to_peak(got, want)


@pytest.mark.parametrize('name,kwargs', SINGLE,
                         ids=[f'{n}-{i}' for i, (n, _) in enumerate(SINGLE)])
def test_feature_matches_jax(name, kwargs):
    ours, ref = _both(name, **kwargs)
    _compare(ours, ref, _signal((2, 1500)))


def test_mfcc_clamps_by_the_batch_maximum():
    """Two examples 10^4 apart in level: the quiet one is clamped at the
    loud one's maximum less 80 dB, as in the JAX package (and torchaudio),
    so its features differ from those it has alone."""
    sig = np.stack([_signal(3000, 2), _signal(3000, 3, scale=1e-4)])
    ours, ref = _both('MFCC', size=256, shift=64)
    _compare(ours, ref, sig)
    batch = ours(torch.from_numpy(sig))[1]
    alone = ours(torch.from_numpy(sig[1]))
    assert (batch - alone).abs().max() > 1.0


@pytest.mark.parametrize('name', ['AbsIPDSTFT', 'Log1pAbsIPDSTFT',
                                  'Log1pMaxNormAbsIPDSTFT'])
def test_ipd_features_match_jax(name):
    """The channel pairing drawn from a seeded generator, in the JAX
    package from its module generator seeded alike (two calls: two draws),
    or given as ``second_channel``."""
    sig = _signal((2, 4, 900), 4)
    spec = jnp.asarray(jax_fe.STFTFeatures(**STFT_ARGS).stft(
        jnp.asarray(sig)))
    spec_t = torch.from_numpy(np.array(spec))
    ours = getattr(fe, name)(**STFT_ARGS, seed=7)
    ref = getattr(jax_fe, name)(**STFT_ARGS)
    assert ours.output_size == ref.output_size == 3 * 33
    jax_fe.seed_ipd_rng(7)
    try:
        for _ in range(2):
            _close_to_peak(ours.stft_to_feature(spec_t),
                           ref.stft_to_feature(spec))
    finally:
        jax_fe.seed_ipd_rng(None)
    pairing = np.array([3, 0, 1, 2])
    got = fe.interchannel_phase_differences(spec_t, pairing,
                                            concatenate=True)
    _close_to_peak(got, jax_fe.interchannel_phase_differences(
        spec, pairing, concatenate=True))
    with pytest.raises(ValueError):
        fe.interchannel_phase_differences(spec_t)


def _recipe_fe():
    with open(RECIPE / 'init_cfg_common.yaml') as f:
        return yaml.safe_load(f)['eg']['trainer']['model']['fe']


def test_recipe_concatenation_matches_jax():
    """The toy recipe's MFCC40 ⊕ Log1pMaxNorm, built from the YAML's own
    configuration (dotted factories): 553 wide, on a batch of 2."""
    cfg = _recipe_fe()
    ours = fe.fe_from_config(cfg)
    ref = from_config(get_config(cfg['factory'], {
        k: v for k, v in cfg.items() if k != 'factory'}))
    assert isinstance(ours, fe.ConcatenatedSTFTFeatures)
    assert ours.output_size == ref.output_size == 553
    assert (ours.fe1.f_max, ours.fe1.window) == (15600, 'hann')
    _compare(ours, ref, _signal((2, 6000), 5))


def test_concatenation_settings_reach_the_parts_as_in_jax():
    """fe1 and fe2 take the concatenation's STFT settings that they do not
    set (window_length: the concatenation's, else its size); the
    misspelled alias builds the same class."""
    cfg = {'factory': 'ConcaternatedSTFTFeatures', 'size': 128, 'shift': 32,
           'window': 'hann',
           'fe1': {'factory': 'MFCC', 'n_mfcc': 12, 'shift': 64},
           'fe2': {'factory': 'Log1pMaxNormAbsSTFT'}}
    ours = fe.fe_from_config(cfg)
    jax_cfg = {k: v for k, v in cfg.items() if k != 'factory'}
    for part in ('fe1', 'fe2'):      # the JAX package imports dotted paths
        jax_cfg[part] = dict(cfg[part], factory=getattr(
            jax_fe, cfg[part]['factory']))
    ref = from_config(get_config(jax_fe.ConcaternatedSTFTFeatures, jax_cfg))
    for part in ('fe1', 'fe2'):
        for key in ('size', 'shift', 'window', 'window_length', 'pad',
                    'fading', 'output_size'):
            assert getattr(getattr(ours, part), key) == getattr(
                getattr(ref, part), key), (part, key)
    assert ours.output_size == ref.output_size == 12 + 65


def test_fe_from_config_names():
    assert isinstance(fe.fe_from_config(
        {'factory': 'tssep_tpu.features.extractor.TorchMFCC'}), fe.MFCC)
    kaldi = fe.fe_from_config({'factory': 'KaldiMFCC', 'num_ceps': 20})
    assert isinstance(kaldi, KaldiMFCC) and kaldi.output_size == 20
    with pytest.raises(ValueError):
        fe.fe_from_config({'factory': 'NoSuchFeature'})
    with pytest.raises(ValueError):
        fe.AbsSTFT(size=64, output_size=40)
