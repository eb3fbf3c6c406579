"""Kaldi-compliance MFCC: port of ``tssep_tpu/features/kaldi.py``.

The capability of the reference's ``KaldiTorchMFCC`` / ``KaldiTorch``
(reference ``tssep/train/feature_extractor.py:370-427``, which wraps
``torchaudio.compliance.kaldi.mfcc``): the Kaldi 40-dim MFCC input of the
real recipe's TS-VAD evaluation, a waveform feature extractor (no ``stft``)
that ``Model.forward`` calls on the reference channel's samples.

From the Kaldi feature definition:

- snip-edges framing (frames wholly inside the signal, ``shift`` apart),
- per-frame DC removal, the raw log energy before the window,
- preemphasis with the first sample repeated,
- the 'povey' window (non-periodic Hann ** 0.85),
- zero padding to the next power of two, the power spectrum,
- Kaldi's mel banks (1127 ln(1 + f/700), the Nyquist bin left out of the
  triangles and padded with zero to the rfft width),
- the log with a float-eps floor, the orthonormal DCT-II, cepstral
  liftering.

Two paths of the same function: numpy arrays take the JAX package's numpy
path (float64, a copy of it); torch tensors are computed on their device,
in float64 with ``torch.fft.rfft`` (the JAX package's device path is a
float32 matmul rDFT, because ``jnp.fft`` is missing on some TPU runtimes).
Both return float32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tssep_tpu_torch.config.configurable import from_config
from tssep_tpu_torch.signal.mel import create_dct

__all__ = ['KaldiMFCC', 'kaldi_mfcc_np', 'povey_window', 'kaldi_mel_banks',
           'FuncFeature']

EPSILON = 1.1920928955078125e-07  # torch.finfo(float32).eps


def _next_power_of_2(x: int) -> int:
    return 1 if x == 0 else 2 ** (x - 1).bit_length()


def povey_window(window_size: int, blackman_coeff: float = 0.42,
                 window_type: str = 'povey') -> np.ndarray:
    """Kaldi frame windows ('povey' = non-periodic Hann ** 0.85)."""
    n = np.arange(window_size, dtype=np.float64)
    a = 2 * math.pi / (window_size - 1)
    if window_type == 'povey':
        return (0.5 - 0.5 * np.cos(a * n)) ** 0.85
    if window_type == 'hanning':
        return 0.5 - 0.5 * np.cos(a * n)
    if window_type == 'hamming':
        return 0.54 - 0.46 * np.cos(a * n)
    if window_type == 'rectangular':
        return np.ones(window_size)
    if window_type == 'blackman':
        return (blackman_coeff - 0.5 * np.cos(a * n)
                + (0.5 - blackman_coeff) * np.cos(2 * a * n))
    raise ValueError(window_type)


def _mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def kaldi_mel_banks(num_bins: int, window_length_padded: int,
                    sample_freq: float, low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """Kaldi's triangular mel banks, (num_bins, padded // 2): triangles on
    the mel axis over ``padded // 2`` FFT bins (the Nyquist bin left out;
    callers pad to the rfft width)."""
    if window_length_padded % 2:
        raise ValueError(f'odd padded window {window_length_padded}')
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_freq
    if high_freq <= 0.0:
        high_freq += nyquist
    if not (0.0 <= low_freq < nyquist and low_freq < high_freq <= nyquist):
        raise ValueError(f'mel band {low_freq}..{high_freq} Hz at Nyquist '
                         f'{nyquist} Hz')
    fft_bin_width = sample_freq / window_length_padded
    mel_low = _mel_scale(low_freq)
    mel_delta = (_mel_scale(high_freq) - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = mel_low + (bin_idx + 1) * mel_delta
    right_mel = mel_low + (bin_idx + 2) * mel_delta

    mel = _mel_scale(fft_bin_width * np.arange(num_fft_bins,
                                               dtype=np.float64))[None]
    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    return np.maximum(0.0, np.minimum(up_slope, down_slope))


def _lifter_coeffs(num_ceps: int, cepstral_lifter: float) -> np.ndarray:
    i = np.arange(num_ceps, dtype=np.float64)
    return 1.0 + 0.5 * cepstral_lifter * np.sin(math.pi * i / cepstral_lifter)


@dataclasses.dataclass
class KaldiMFCC:
    """``torchaudio.compliance.kaldi.mfcc``'s function, a waveform feature
    extractor: it has no ``stft``, so ``Model.forward`` calls it on the
    reference channel's samples (the reference's fourth input branch,
    ``model.py:510-513``)."""

    blackman_coeff: float = 0.42
    cepstral_lifter: float = 22.0
    dither: float = 0.0
    energy_floor: float = 1.0
    frame_length: float = 25.0      # ms
    frame_shift: float = 10.0       # ms
    high_freq: float = 0.0
    htk_compat: bool = False
    low_freq: float = 20.0
    num_ceps: int = 13
    num_mel_bins: int = 23
    preemphasis_coefficient: float = 0.97
    raw_energy: bool = True
    remove_dc_offset: bool = True
    round_to_power_of_two: bool = True
    sample_frequency: float = 16000.0
    snip_edges: bool = True
    subtract_mean: bool = False
    use_energy: bool = False
    window_type: str = 'povey'
    # Taken for the reference configurations' sake; inert at the defaults.
    channel: int = -1
    min_duration: float = 0.0
    vtln_high: float = -500.0
    vtln_low: float = 100.0
    vtln_warp: float = 1.0

    def __post_init__(self):
        for ok, what in ((self.snip_edges, 'only snip_edges=True'),
                         (self.dither == 0.0, 'no dither (host RNG)'),
                         (self.vtln_warp == 1.0, 'no VTLN warping'),
                         (not self.htk_compat, 'no htk_compat')):
            if not ok:
                raise NotImplementedError(f'KaldiMFCC: {what} is implemented')
        self.window_size = int(self.sample_frequency * self.frame_length
                               / 1000)
        self.window_shift = int(self.sample_frequency * self.frame_shift
                                / 1000)
        self.padded_window_size = (
            _next_power_of_2(self.window_size)
            if self.round_to_power_of_two else self.window_size)
        self._window = povey_window(
            self.window_size, self.blackman_coeff, self.window_type)
        mel = kaldi_mel_banks(
            self.num_mel_bins, self.padded_window_size,
            self.sample_frequency, self.low_freq, self.high_freq)
        self._mel = np.pad(mel, [(0, 0), (0, 1)])   # + the Nyquist bin
        self._dct = create_dct(self.num_ceps, self.num_mel_bins,
                               norm='ortho')          # (n_mels, n_ceps)
        self._lifter = (_lifter_coeffs(self.num_ceps, self.cepstral_lifter)
                        if self.cepstral_lifter != 0.0 else None)

    @property
    def output_size(self) -> int:
        return self.num_ceps

    @property
    def frequencies(self) -> int:
        """Stands in for an STFT extractor's bin count where a configuration
        derives the estimator's dimensions (a Kaldi-input model is a TS-VAD
        model of 't' resolution)."""
        return self.num_ceps

    def num_frames(self, num_samples: int) -> int:
        if num_samples < self.window_size:
            return 0
        return 1 + (num_samples - self.window_size) // self.window_shift

    def sample_vad_to_frame_vad(self, vad: np.ndarray) -> np.ndarray:
        """Sample activity -> frame activity under snip-edges framing (a
        frame is active where any sample of its window is)."""
        frames = self._frames(np.asarray(vad).astype(np.float32))
        return frames.max(axis=-1) > 0.5

    def _frame_index(self, num_samples):
        m = self.num_frames(num_samples)
        return (np.arange(m)[:, None] * self.window_shift
                + np.arange(self.window_size)[None, :])

    def _frames(self, signal):
        """(..., n) -> (..., m, window_size) frames (snip edges)."""
        idx = self._frame_index(signal.shape[-1])
        if isinstance(signal, torch.Tensor):
            idx = torch.from_numpy(idx).to(signal.device)
        return signal[..., idx]

    def _process(self, frames, xp):
        """Frame processing; returns (windowed and padded frames, log energy
        or None)."""
        if self.remove_dc_offset:
            frames = frames - frames.mean(axis=-1, keepdims=True)
        log_energy = None
        if self.raw_energy and self.use_energy:
            log_energy = xp.log(_floor((frames * frames).sum(axis=-1), xp))
        if self.preemphasis_coefficient != 0.0:
            prev = xp.concatenate([frames[..., :1], frames[..., :-1]],
                                  axis=-1)
            frames = frames - self.preemphasis_coefficient * prev
        frames = frames * _const(self._window, frames, xp)
        if not self.raw_energy and self.use_energy:
            log_energy = xp.log(_floor((frames * frames).sum(axis=-1), xp))
        pad = self.padded_window_size - self.window_size
        if pad:
            frames = xp.concatenate(
                [frames, xp.zeros(frames.shape[:-1] + (pad,),
                                  dtype=frames.dtype,
                                  **_like(frames, xp))], axis=-1)
        return frames, log_energy

    def _finish(self, power_spec, log_energy, xp):
        mel_e = power_spec @ _const(self._mel.T, power_spec, xp)
        mel_e = xp.log(_floor(mel_e, xp))
        feat = mel_e @ _const(self._dct, mel_e, xp)
        if self._lifter is not None:
            feat = feat * _const(self._lifter, feat, xp)
        if self.use_energy:
            # Kaldi puts the (floored) log energy in place of c0
            e = log_energy
            if self.energy_floor != 0.0:
                e = xp.maximum(e, xp.full_like(
                    e, math.log(self.energy_floor)))
            feat = xp.concatenate([e[..., None], feat[..., 1:]], axis=-1)
        if self.subtract_mean:
            feat = feat - feat.mean(axis=-2, keepdims=True)
        return feat

    def _call_np(self, signal):
        signal = np.asarray(signal, dtype=np.float64)
        if self.num_frames(signal.shape[-1]) == 0:
            return np.zeros(signal.shape[:-1] + (0, self.output_size),
                            dtype=np.float32)
        f, log_energy = self._process(self._frames(signal), np)
        spec = np.abs(np.fft.rfft(f, axis=-1)) ** 2
        return self._finish(spec, log_energy, np).astype(np.float32)

    def _call_torch(self, signal):
        signal = signal.to(torch.float64)
        if self.num_frames(signal.shape[-1]) == 0:
            return torch.zeros(signal.shape[:-1] + (0, self.output_size),
                               device=signal.device)
        f, log_energy = self._process(self._frames(signal), _TorchNp)
        spec = torch.fft.rfft(f, dim=-1).abs() ** 2
        return self._finish(spec, log_energy, _TorchNp).float()

    def __call__(self, signal):
        """(..., num_samples) waveform -> (..., frames, output_size)
        float32: a tensor on its device, a numpy array on the host."""
        if isinstance(signal, torch.Tensor):
            return self._call_torch(signal)
        return self._call_np(signal)


def kaldi_mfcc_np(signal, **kwargs) -> np.ndarray:
    """``KaldiMFCC(**kwargs)`` of a numpy waveform."""
    return KaldiMFCC(**kwargs)._call_np(signal)


class _TorchNp:
    """The few numpy functions ``KaldiMFCC`` uses, on torch tensors."""

    log = staticmethod(torch.log)
    maximum = staticmethod(torch.maximum)
    full_like = staticmethod(torch.full_like)
    zeros = staticmethod(torch.zeros)

    @staticmethod
    def concatenate(tensors, axis):
        return torch.cat(tensors, dim=axis)


def _like(x, xp):
    return {'device': x.device} if xp is _TorchNp else {}


def _const(value, like, xp):
    """A numpy constant in ``like``'s type, on its device."""
    if xp is np:
        return value.astype(like.dtype)
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def _floor(x, xp):
    return xp.maximum(x, xp.full_like(x, EPSILON))


class FuncFeature:
    """``func`` applied to an inner feature extractor's output (the
    reference's ``KaldiTorch`` wrapper, ``feature_extractor.py:370-390``:
    for example a CMVN over Kaldi features). Either may be given as a
    factory configuration."""

    def __init__(self, func, fe):
        if isinstance(func, dict):
            func = from_config(func)
        if isinstance(fe, dict):
            fe = from_config(fe)
        self.func = func
        self.fe = fe

    @property
    def output_size(self):
        return self.fe.output_size

    def __getattr__(self, name):
        if name in ('func', 'fe'):
            raise AttributeError(name)
        return getattr(self.fe, name)

    def stft_to_feature(self, stft_signals):
        return self.func(self.fe.stft_to_feature(stft_signals))

    def __call__(self, signal):
        return self.func(self.fe(signal))
