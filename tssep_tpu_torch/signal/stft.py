"""STFT / ISTFT with paderbox frame semantics, on torch tensors.

Port of ``tssep_tpu/signal/stft.py``: periodic analysis windows, ``fading``
(zero padding of ``window_length - shift`` samples on both sides), ``pad`` (the
last partial frame is zero-padded), synthesis with the biorthogonal window and
overlap-add. The JAX package computes the DFT as a matrix product for the TPU;
here ``torch.fft`` does it, as XLA did it outside any Pallas kernel.

Frame count (reference golden: 10_000 samples, size 1024, shift 256,
fading=True -> 43 frames):
``frames = max(1, ceil((T_padded - window_length) / shift) + 1)``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ['STFT', 'stft_windows', 'samples_to_frames']


def stft_windows(name: str, length: int, sym: bool = False) -> np.ndarray:
    n = np.arange(length)
    denom = length if not sym else max(length - 1, 1)
    if name in ('hann', 'hanning'):
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / denom)
    elif name == 'blackman':
        w = (0.42 - 0.5 * np.cos(2 * np.pi * n / denom)
             + 0.08 * np.cos(4 * np.pi * n / denom))
    elif name in ('boxcar', 'rect', 'rectangular', 'ones'):
        w = np.ones(length)
    else:
        import scipy.signal
        w = scipy.signal.get_window(name, length, fftbins=not sym)
    return w.astype(np.float64)


def _biorthogonal_window(window: np.ndarray, shift: int) -> np.ndarray:
    """Synthesis window for exact reconstruction: w / (shift-periodic sum w^2)."""
    length = len(window)
    denom = np.zeros(shift)
    for i in range(shift):
        denom[i] = np.sum(window[i::shift] ** 2)
    denom = np.where(denom == 0, 1.0, denom)
    idx = np.arange(length) % shift
    return window / denom[idx]


def _fading_pad_width(window_length, shift, fading):
    if fading in (None, False):
        return 0
    if fading in (True, 'full'):
        return window_length - shift
    if fading == 'half':
        return (window_length - shift) // 2
    raise ValueError(f'Unknown fading: {fading!r}')


def samples_to_frames(samples, *, size, shift, pad=True, fading=True):
    """Number of STFT frames for a ``samples``-long signal (``size`` is the
    window length)."""
    samples = samples + 2 * _fading_pad_width(size, shift, fading)
    if samples < size:
        return 1 if pad else 0
    if pad:
        return (samples - size + shift - 1) // shift + 1
    return (samples - size) // shift + 1


@dataclasses.dataclass(frozen=True)
class STFT:
    """Short-time Fourier transform (analysis + synthesis) on torch tensors."""

    size: int = 1024
    shift: int = 256
    window_length: int | None = None
    pad: bool = True
    fading: bool | str = True
    window: str = 'blackman'
    symmetric_window: bool = False

    def __post_init__(self):
        if self.window_length is None:
            object.__setattr__(self, 'window_length', self.size)
        if self.window_length > self.size:
            raise ValueError((self.window_length, self.size))

    @property
    def frequencies(self) -> int:
        return self.size // 2 + 1

    @property
    def fading_pad(self) -> int:
        return _fading_pad_width(self.window_length, self.shift, self.fading)

    @functools.cached_property
    def analysis_window(self) -> np.ndarray:
        return stft_windows(self.window, self.window_length,
                            self.symmetric_window)

    @functools.cached_property
    def synthesis_window(self) -> np.ndarray:
        return _biorthogonal_window(self.analysis_window, self.shift)

    def num_frames(self, num_samples: int) -> int:
        return samples_to_frames(
            num_samples, size=self.window_length, shift=self.shift,
            pad=self.pad, fading=self.fading)

    def __call__(self, signal):
        return self.stft(signal)

    def stft(self, signal: torch.Tensor) -> torch.Tensor:
        """(..., samples) real -> (..., frames, size // 2 + 1) complex."""
        pad = self.fading_pad
        frames = self.num_frames(signal.shape[-1])
        padded_len = max(signal.shape[-1] + 2 * pad,
                         (frames - 1) * self.shift + self.window_length)
        x = F.pad(signal, (pad, padded_len - signal.shape[-1] - pad))
        segs = x.unfold(-1, self.window_length, self.shift)
        w = torch.as_tensor(self.analysis_window, dtype=segs.dtype,
                            device=segs.device)
        return torch.fft.rfft(segs * w, n=self.size, dim=-1)

    def istft(self, stft_signal, num_samples: int | None = None):
        """Inverse of :meth:`stft`. ``stft_signal`` is a complex tensor or a
        ``(re, im)`` pair of real ones (``Masking.re_im``)."""
        if isinstance(stft_signal, tuple):
            re, im = stft_signal
            stft_signal = torch.complex(re.float(), im.float())
        frames = stft_signal.shape[-2]
        segs = torch.fft.irfft(stft_signal, n=self.size,
                               dim=-1)[..., :self.window_length]
        segs = segs * torch.as_tensor(self.synthesis_window, dtype=segs.dtype,
                                      device=segs.device)
        total = (frames - 1) * self.shift + self.window_length
        lead = segs.shape[:-2]
        out = F.fold(segs.reshape(-1, frames, self.window_length)
                     .transpose(1, 2),
                     output_size=(1, total), kernel_size=(1, self.window_length),
                     stride=(1, self.shift))
        out = out.reshape(lead + (total,))
        start = self.fading_pad
        if num_samples is not None:
            return out[..., start:start + num_samples]
        return out[..., start:total - start]
