"""STFT-based feature extractors: the two of ``tssep_tpu/features/extractor.py``
that the serving path uses, ``STFTFeatures`` and ``Log1pMaxNormAbsSTFT``."""

from __future__ import annotations

import math

import torch

from tssep_tpu_torch.signal.stft import STFT

__all__ = ['STFTFeatures', 'Log1pMaxNormAbsSTFT']


class STFTFeatures:
    """Base feature extractor: an STFT plus a ``stft_to_feature`` transform."""

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
        if output_size is not None and output_size != self.frequencies:
            raise ValueError((output_size, self.frequencies))
        self.output_size = self.frequencies

    @property
    def frequencies(self):
        return self.size // 2 + 1

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
