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

The streaming protocol (``init_streaming_state`` / ``streaming_feature``,
``eval/streaming.py``) runs on the host in numpy, as the JAX package's
does: frame-local extractors are exact block by block; utterance statistics
(the max norm's max, the MVN mean, the MFCC's top-dB reference) become
running statistics over the frames seen so far; the IPD extractors and any
other with no causal form raise.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from tssep_tpu_torch.config.configurable import from_config, get_config
from tssep_tpu_torch.features.kaldi import KaldiMFCC
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

    def istft(self, stft_signal, num_samples=None, segment_dtype=None):
        return self._stft.istft(stft_signal, num_samples=num_samples,
                                segment_dtype=segment_dtype)

    def stft_to_feature(self, stft_signals):
        return stft_signals

    def __call__(self, signal):
        return self.stft_to_feature(self.stft(signal))

    # -- streaming (JAX ``features/extractor.py:92-116``) ------------------
    #: True when ``stft_to_feature`` is frame-local (no statistics across
    #: frames): block by block, streaming then equals offline.
    frame_local = False

    def init_streaming_state(self):
        """Initial state for ``streaming_feature`` (None: stateless)."""
        return None

    def streaming_feature(self, block, state):
        """Features of a block of STFT frames (numpy, (..., T, F)) with
        causal statistics: utterance statistics become running statistics
        over every frame seen so far; frame-local extractors are exact.
        Returns ``(features, state)``. Extractors whose statistics have no
        causal form raise rather than change what the features mean."""
        if self.frame_local:
            return _np_feature(self, block), state
        raise NotImplementedError(
            f'{type(self).__name__} has cross-frame feature statistics '
            f'with no causal streaming equivalent implemented; streaming '
            f'inference would silently change semantics. Use a frame-local '
            f'or running-stats extractor, or implement streaming_feature.')


def _np_feature(fe, block):
    """``fe.stft_to_feature`` of a numpy block, as numpy."""
    return fe.stft_to_feature(torch.from_numpy(np.asarray(block))).numpy()


def _checked_size(output_size, expected):
    if output_size is not None and output_size != expected:
        raise ValueError(f'output_size {output_size}, expected {expected}')
    return expected


class AbsSTFT(STFTFeatures):
    frame_local = True

    def stft_to_feature(self, stft_signals):
        return stft_signals.abs()


class Log1pAbsSTFT(STFTFeatures):
    frame_local = True

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

    frame_local = False

    def init_streaming_state(self):
        return {'count': 0, 'sum': None}

    def streaming_feature(self, block, state):
        """Causal MVN: the running mean over every frame so far takes the
        place of the utterance mean."""
        feature = np.log1p(np.abs(block))
        s = feature.sum(axis=-2)
        state = {'count': state['count'] + feature.shape[-2],
                 'sum': s if state['sum'] is None else state['sum'] + s}
        mean = state['sum'] / max(state['count'], 1)
        return feature - mean[..., None, :], state


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

    # statistics_axis 'f' (each frame's max over frequency) is frame-local;
    # 'tf' and 't' keep a running max over every frame so far.
    def init_streaming_state(self):
        return {'max': None}

    def streaming_feature(self, block, state):
        s = np.abs(block)
        if self.statistics_axis == 'f':
            return _np_feature(self, block), state
        if self.statistics_axis == 'tf':
            cur = float(s.max()) if s.size else 0.0
            prev = state['max'] if state['max'] is not None else 1e-30
            norm = max(prev, cur, 1e-30)
        elif self.statistics_axis == 't':
            cur = (s.max(axis=-2) if s.shape[-2]
                   else np.zeros(s.shape[-1]))
            prev = (state['max'] if state['max'] is not None
                    else np.full(s.shape[-1], 1e-30))
            norm = np.maximum(np.maximum(prev, cur), 1e-30)
        else:
            raise ValueError(self.statistics_axis)
        return np.log1p(s * ((np.e - 1) / norm)), {'max': norm}


class NoFeatureSTFT(STFTFeatures):
    frame_local = True

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

    def streaming_feature(self, block, state):
        # not the max norm's streaming form: it would drop the IPD part,
        # and the channel pairing may be drawn anew for every call
        raise NotImplementedError(
            'IPD extractors sample a random channel pairing per call and '
            'are not supported in streaming inference.')


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

    def init_streaming_state(self):
        return {'max_db': None}

    def streaming_feature(self, block, state):
        """Causal MFCC: the reference of AmplitudeToDB's top-dB clamp is a
        running max over every frame so far (``log_mels`` is frame-local
        and exact)."""
        power = np.abs(block).astype(np.float32) ** 2
        mel = power @ self.fbank
        if self.log_mels:
            return (np.log(mel + 1e-6) @ self.dct_mat), state
        x_db = 10.0 * np.log10(np.clip(mel, 1e-10, None))
        cur = float(x_db.max()) if x_db.size else -np.inf
        prev = state['max_db'] if state['max_db'] is not None else -np.inf
        mx = max(prev, cur)
        if np.isfinite(mx):
            x_db = np.maximum(x_db, mx - self.top_db)
        return (x_db @ self.dct_mat), {'max_db': mx}


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

    def init_streaming_state(self):
        return (self.fe1.init_streaming_state(),
                self.fe2.init_streaming_state())

    def streaming_feature(self, block, state):
        f1, s1 = self.fe1.streaming_feature(block, state[0])
        f2, s2 = self.fe2.streaming_feature(block, state[1])
        return np.concatenate([np.asarray(f1), np.asarray(f2)], axis=-1), \
            (s1, s2)


#: Alias with the reference's (misspelled) class name so its configs load.
ConcaternatedSTFTFeatures = ConcatenatedSTFTFeatures


_CLASSES = {cls.__name__: cls for cls in (
    STFTFeatures, AbsSTFT, Log1pAbsSTFT, MVNLog1pAbsSTFT,
    Log1pMaxNormAbsSTFT, NoFeatureSTFT, AbsIPDSTFT, Log1pAbsIPDSTFT,
    Log1pMaxNormAbsIPDSTFT, MFCC, ConcatenatedSTFTFeatures)}
_CLASSES.update(TorchMFCC=MFCC,
                ConcaternatedSTFTFeatures=ConcatenatedSTFTFeatures,
                KaldiMFCC=KaldiMFCC)


def fe_from_config(config: dict) -> STFTFeatures:
    """A feature extractor from the JAX configuration's form, ``{'factory':
    name, **kwargs}``, the factory mapped by its class name (the waveform
    extractors of ``features/kaldi.py`` too), completed by ``get_config``
    (nested ``fe1``/``fe2`` configurations too) and built by
    ``from_config``."""
    config = dict(config)
    name = factory_name(config.pop('factory'))
    if name not in _CLASSES:
        raise ValueError(f'unknown feature extractor {name!r}')
    return from_config(get_config(_CLASSES[name], config))
