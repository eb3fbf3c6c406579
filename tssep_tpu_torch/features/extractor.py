"""STFT-based feature extractors: port of ``tssep_tpu/features/extractor.py``.

- ``STFTFeatures`` (base; the complex STFT as the "feature")
- ``AbsSTFT`` / ``Log1pAbsSTFT`` / ``MVNLog1pAbsSTFT``
- ``Log1pMaxNormAbsSTFT`` (the flagship's and the toy recipe's magnitude
  feature)
- ``NoFeatureSTFT``
- the IPD family (``AbsIPDSTFT``, ``Log1pAbsIPDSTFT``,
  ``Log1pMaxNormAbsIPDSTFT``)
- ``MFCC`` (alias ``TorchMFCC``): power spectrogram -> mel filterbank ->
  AmplitudeToDB('power', 80) (or log) -> DCT-II
- ``ConcatenatedSTFTFeatures`` (alias ``ConcaternatedSTFTFeatures``): fe1 ⊕
  fe2 on one STFT, the toy recipe's MFCC40 ⊕ Log1pMaxNorm (553 wide)

``fe_from_config`` builds one from the JAX configuration's form. The data
path runs on torch tensors; the constants are numpy, as in the JAX package.
The streaming forms (``streaming_feature``) are not ported here.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from tssep_tpu_torch.config.configurable import from_config, get_config
from tssep_tpu_torch.signal.mel import amplitude_to_db, create_dct, mel_filterbank
from tssep_tpu_torch.signal.stft import STFT
from tssep_tpu_torch.utils.factory import factory_name

__all__ = ['STFTFeatures', 'AbsSTFT', 'Log1pAbsSTFT', 'MVNLog1pAbsSTFT',
           'Log1pMaxNormAbsSTFT', 'NoFeatureSTFT', 'AbsIPDSTFT',
           'Log1pAbsIPDSTFT', 'Log1pMaxNormAbsIPDSTFT', 'MFCC', 'TorchMFCC',
           'ConcatenatedSTFTFeatures', 'ConcaternatedSTFTFeatures',
           'interchannel_phase_differences', 'fe_from_config']


class STFTFeatures:
    """Base feature extractor: an STFT plus a ``stft_to_feature`` transform."""

    @classmethod
    def finalize_dogmatic_config(cls, config):
        if config.get('window_length') is None:
            config['window_length'] = config.get('size', 1024)

    def __init__(self, size=1024, shift=256, window_length=None, pad=True,
                 fading=True, output_size=None, window='blackman'):
        self.size = size
        self.shift = shift
        self.window_length = window_length if window_length is not None else size
        self.pad = pad
        self.fading = fading
        self.window = window
        self._stft = STFT(size=size, shift=shift,
                          window_length=self.window_length, pad=pad,
                          fading=fading, window=window)
        self.output_size = self._get_output_size(output_size)

    @property
    def frequencies(self):
        return self.size // 2 + 1

    def _get_output_size(self, output_size):
        return _checked_size(output_size, self.frequencies)

    def num_frames(self, num_samples):
        return self._stft.num_frames(num_samples)

    def stft(self, signal):
        return self._stft.stft(signal)

    def istft(self, stft_signal, num_samples=None):
        return self._stft.istft(stft_signal, num_samples=num_samples)

    def stft_to_feature(self, stft_signals):
        return stft_signals

    def __call__(self, signal):
        return self.stft_to_feature(self.stft(signal))


def _checked_size(output_size, expected):
    if output_size is not None and output_size != expected:
        raise ValueError(f'output_size {output_size}, expected {expected}')
    return expected


class AbsSTFT(STFTFeatures):
    def stft_to_feature(self, stft_signals):
        return stft_signals.abs()


class Log1pAbsSTFT(STFTFeatures):
    def stft_to_feature(self, stft_signals):
        return torch.log1p(stft_signals.abs())


class MVNLog1pAbsSTFT(Log1pAbsSTFT):
    """Utterance-mean normalized log1p magnitude (the variance is not
    normalized, as in the JAX package)."""

    def __init__(self, size=1024, shift=256, window_length=None, pad=True,
                 fading=True, output_size=None, window='blackman',
                 norm_means=True, norm_vars=False, eps=1.0e-20):
        super().__init__(size=size, shift=shift, window_length=window_length,
                         pad=pad, fading=fading, output_size=output_size,
                         window=window)
        self.norm_means = norm_means
        self.norm_vars = norm_vars
        self.eps = eps

    def stft_to_feature(self, stft_signals):
        if not self.norm_means:
            raise NotImplementedError('norm_means=False')
        if self.norm_vars:
            raise NotImplementedError('norm_vars=True')
        feature = super().stft_to_feature(stft_signals)
        return feature - feature.mean(dim=-2, keepdim=True)


class Log1pMaxNormAbsSTFT(STFTFeatures):
    """``log1p(|X| * (e-1) / max|X|)`` in [0, 1]."""

    def __init__(self, size=1024, shift=256, window_length=None, pad=True,
                 fading=True, output_size=None, window='blackman',
                 statistics_axis='tf'):
        super().__init__(size=size, shift=shift, window_length=window_length,
                         pad=pad, fading=fading, output_size=output_size,
                         window=window)
        self.statistics_axis = statistics_axis

    def stft_to_feature(self, stft_signals):
        s = stft_signals.abs()
        dims = {'tf': (-2, -1), 't': (-2,), 'f': (-1,)}[self.statistics_axis]
        norm = torch.amax(s, dim=dims, keepdim=True)
        return torch.log1p(s * ((math.e - 1) / norm))


class NoFeatureSTFT(STFTFeatures):
    def stft_to_feature(self, stft_signals):
        return stft_signals[..., :0]

    def _get_output_size(self, output_size):
        return _checked_size(output_size, 0)


def interchannel_phase_differences(signal, second_channel=None,
                                   concatenate=False, rng=None):
    """cos and sin of the inter-channel phase differences.

    ``signal``: (..., channels, frames, frequencies) complex. The channel
    each channel is paired with is ``second_channel``, or, where that is
    not given, drawn from ``rng``, a ``numpy.random.Generator``, as the JAX
    package draws it: the shuffled list of ordered channel pairs, the last
    pair of each first channel. One of the two must be given."""
    if second_channel is None:
        if rng is None:
            raise ValueError('interchannel_phase_differences needs '
                             'second_channel or rng')
        D = signal.shape[-3]
        if D < 2:
            raise ValueError(f'IPD features need 2 or more channels, got '
                             f'{tuple(signal.shape)}')
        pairs = list(itertools.permutations(range(D), 2))
        rng.shuffle(pairs)
        second_channel = np.array(sorted(dict(pairs).items()))[:, 1]
    index = torch.as_tensor(np.asarray(second_channel), device=signal.device)
    product = signal * signal.index_select(-3, index).conj()
    denom = product.abs()
    sincos = product / torch.where(denom == 0, torch.ones_like(denom), denom)
    if concatenate:
        return torch.cat([signal.abs(), sincos.real, sincos.imag], dim=-1)
    return sincos.real, sincos.imag


class _IPDPairing:
    """The channel pairing of the IPD extractors: ``second_channel`` where
    given, else a new draw for every call from a generator seeded with
    ``seed``."""

    def _init_pairing(self, second_channel, seed):
        self.second_channel = second_channel
        self.rng = np.random.default_rng(seed)

    def _ipd(self, stft_signals, concatenate=False):
        return interchannel_phase_differences(
            stft_signals, self.second_channel, concatenate, rng=self.rng)


class AbsIPDSTFT(_IPDPairing, STFTFeatures):
    def __init__(self, size=1024, shift=256, window_length=None, pad=True,
                 fading=True, output_size=None, window='blackman',
                 second_channel=None, seed=0):
        super().__init__(size=size, shift=shift, window_length=window_length,
                         pad=pad, fading=fading, output_size=output_size,
                         window=window)
        self._init_pairing(second_channel, seed)

    def _get_output_size(self, output_size):
        return _checked_size(output_size, 3 * self.frequencies)

    def stft_to_feature(self, stft_signals):
        return self._ipd(stft_signals, concatenate=True)


class Log1pAbsIPDSTFT(AbsIPDSTFT):
    def stft_to_feature(self, stft_signals):
        cos, sin = self._ipd(stft_signals)
        return torch.cat([torch.log1p(stft_signals.abs()), cos, sin], dim=-1)


class Log1pMaxNormAbsIPDSTFT(_IPDPairing, Log1pMaxNormAbsSTFT):
    def __init__(self, size=1024, shift=256, window_length=None, pad=True,
                 fading=True, output_size=None, window='blackman',
                 statistics_axis='tf', second_channel=None, seed=0):
        super().__init__(size=size, shift=shift, window_length=window_length,
                         pad=pad, fading=fading, output_size=output_size,
                         window=window, statistics_axis=statistics_axis)
        self._init_pairing(second_channel, seed)

    def _get_output_size(self, output_size):
        return _checked_size(output_size, 3 * self.frequencies)

    def stft_to_feature(self, stft_signals):
        feat = super().stft_to_feature(stft_signals)
        cos, sin = self._ipd(stft_signals)
        return torch.cat([feat, cos, sin], dim=-1)


class MFCC(STFTFeatures):
    """MFCC on the shared STFT (the reference's torchaudio ``TorchMFCC``):
    power spectrogram -> mel filterbank -> AmplitudeToDB('power', 80), or
    the log with ``log_mels`` -> DCT-II. A negative ``f_max`` counts down
    from ``sample_rate`` (not from Nyquist): the recipe's -400 at 16 kHz is
    15,600 Hz."""

    def __init__(self, size=400, shift=200, window_length=None, pad=True,
                 fading=True, output_size=None, window='hann',
                 sample_rate=16000, n_mfcc=40, dct_norm='ortho',
                 log_mels=False, f_min=40, f_max=-400, n_mels=40,
                 mel_norm=None, mel_scale='htk'):
        self.n_mfcc = n_mfcc
        super().__init__(size=size, shift=shift, window_length=window_length,
                         pad=pad, fading=fading, output_size=output_size,
                         window=window)
        self.sample_rate = sample_rate
        self.f_min = f_min
        if f_max and f_max < 0:
            f_max = sample_rate + f_max
        self.f_max = f_max
        self.n_mels = n_mels
        self.dct_norm = dct_norm
        self.mel_norm = mel_norm
        self.mel_scale = mel_scale
        self.top_db = 80
        self.log_mels = log_mels
        self.fbank = mel_filterbank(
            n_freqs=size // 2 + 1, f_min=self.f_min, f_max=self.f_max,
            n_mels=n_mels, sample_rate=sample_rate, norm=mel_norm,
            mel_scale=mel_scale).astype(np.float32)
        self.dct_mat = create_dct(n_mfcc, n_mels, dct_norm).astype(np.float32)

    def _get_output_size(self, output_size):
        return self.n_mfcc if output_size is None else output_size

    def _constants(self, device):
        """The filterbank and the DCT matrix on ``device``, copied there
        once."""
        cache = self.__dict__.setdefault('_on_device', {})
        if device not in cache:
            cache[device] = (torch.from_numpy(self.fbank).to(device),
                             torch.from_numpy(self.dct_mat).to(device))
        return cache[device]

    def stft_to_feature(self, stft_signals):
        power = stft_signals.abs().float() ** 2
        fbank, dct = self._constants(power.device)
        mel = power @ fbank
        if self.log_mels:
            mel = torch.log(mel + 1e-6)
        else:
            mel = amplitude_to_db(mel, top_db=self.top_db)
        return mel @ dct


#: Name used by the reference's configs.
TorchMFCC = MFCC


class ConcatenatedSTFTFeatures(STFTFeatures):
    """fe1 ⊕ fe2 on a shared STFT. ``finalize_dogmatic_config`` gives fe1
    and fe2 the STFT settings of the concatenation, as the JAX class's
    does (``tssep_tpu/features/extractor.py:427-439``)."""

    def __init__(self, fe1, fe2, output_size=None, size=1024, shift=256,
                 window='blackman', window_length=None, pad=True,
                 fading=True):
        self.fe1, self.fe2 = fe1, fe2
        super().__init__(size=size, shift=shift, window_length=window_length,
                         pad=pad, fading=fading, output_size=output_size,
                         window=window)

    @classmethod
    def finalize_dogmatic_config(cls, config):
        for fe in ['fe1', 'fe2']:
            if fe not in config:
                continue
            for key in ['size', 'shift', 'pad', 'fading', 'window']:
                if key in config:
                    config[fe][key] = config[key]
            if config.get('window_length') is not None:
                config[fe]['window_length'] = config['window_length']
        super().finalize_dogmatic_config(config)
        for fe in ['fe1', 'fe2']:
            if fe in config:
                config[fe]['window_length'] = config['window_length']

    def _get_output_size(self, output_size):
        if output_size is None:
            return self.fe1.output_size + self.fe2.output_size
        return output_size

    def stft_to_feature(self, stft_signals):
        return torch.cat([self.fe1.stft_to_feature(stft_signals),
                          self.fe2.stft_to_feature(stft_signals)], dim=-1)


#: Alias with the reference's (misspelled) class name so its configs load.
ConcaternatedSTFTFeatures = ConcatenatedSTFTFeatures


_CLASSES = {cls.__name__: cls for cls in (
    STFTFeatures, AbsSTFT, Log1pAbsSTFT, MVNLog1pAbsSTFT,
    Log1pMaxNormAbsSTFT, NoFeatureSTFT, AbsIPDSTFT, Log1pAbsIPDSTFT,
    Log1pMaxNormAbsIPDSTFT, MFCC, ConcatenatedSTFTFeatures)}
_CLASSES.update(TorchMFCC=MFCC,
                ConcaternatedSTFTFeatures=ConcatenatedSTFTFeatures)

#: Waveform feature extractors of the JAX package that are not ported yet.
_NOT_PORTED = {'KaldiMFCC': 'features/kaldi.py, ROADMAP Queue 1 item 5c'}


def fe_from_config(config: dict) -> STFTFeatures:
    """A feature extractor from the JAX configuration's form, ``{'factory':
    name, **kwargs}``, the factory mapped by its class name, completed by
    ``get_config`` (nested ``fe1``/``fe2`` configurations too) and built by
    ``from_config``."""
    config = dict(config)
    name = factory_name(config.pop('factory'))
    if name in _NOT_PORTED:
        raise NotImplementedError(f'feature extractor {name} is not ported '
                                  f'yet ({_NOT_PORTED[name]})')
    if name not in _CLASSES:
        raise ValueError(f'unknown feature extractor {name!r}')
    return from_config(get_config(_CLASSES[name], config))
