"""Mel filterbank, DCT and amplitude-to-dB: port of ``tssep_tpu/signal/mel.py``.

The constants (``mel_filterbank``, ``create_dct``) are built in numpy, float64,
exactly as the JAX package builds them; ``amplitude_to_db`` runs on torch
tensors. The semantics are torchaudio's ``MelScale``, ``create_dct`` and
``AmplitudeToDB('power', 80)``, which the reference's MFCC front end wraps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ['mel_filterbank', 'create_dct', 'amplitude_to_db', 'hz_to_mel',
           'mel_to_hz']


def hz_to_mel(freq, mel_scale: str = 'htk'):
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == 'htk':
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    # slaney
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz)
        / logstep,
        mels)


def mel_to_hz(mels, mel_scale: str = 'htk'):
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == 'htk':
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (mels - min_log_mel)),
        freqs)


def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int, norm: str | None = None,
                   mel_scale: str = 'htk') -> np.ndarray:
    """Triangular mel filterbank, shape ``(n_freqs, n_mels)``."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_min = hz_to_mel(f_min, mel_scale)
    m_max = hz_to_mel(f_max, mel_scale)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = mel_to_hz(m_pts, mel_scale)

    f_diff = f_pts[1:] - f_pts[:-1]                       # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]          # (n_freqs, n_mels + 2)
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))

    if norm == 'slaney':
        enorm = 2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb


def create_dct(n_mfcc: int, n_mels: int,
               norm: str | None = 'ortho') -> np.ndarray:
    """DCT-II basis matrix, shape ``(n_mels, n_mfcc)``."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[:, None]
    dct = np.cos(math.pi / n_mels * (n + 0.5) * k)        # (n_mfcc, n_mels)
    if norm is None:
        dct = dct * 2.0
    else:
        if norm != 'ortho':
            raise ValueError(f"norm must be None or 'ortho', got {norm!r}")
        dct[0] *= 1.0 / math.sqrt(2.0)
        dct = dct * math.sqrt(2.0 / n_mels)
    return dct.T


def amplitude_to_db(x: torch.Tensor, *, multiplier: float = 10.0,
                    amin: float = 1e-10, db_multiplier: float = 0.0,
                    top_db: float | None = 80.0) -> torch.Tensor:
    """Power (or amplitude) to dB with the optional dynamic-range clamp.

    The ``top_db`` clamp's maximum is taken over the whole tensor when it has
    at most three dims, and over the last three dims per leading element
    otherwise, as torchaudio's ``amplitude_to_DB`` packs its input. So the
    features of a batch (B, T, F) are clamped by the batch's maximum."""
    x_db = multiplier * torch.log10(torch.clamp(x, min=amin))
    x_db = x_db - multiplier * db_multiplier
    if top_db is None:
        return x_db
    if x_db.dim() <= 3:
        ref = x_db.amax()
    else:
        ref = x_db.flatten(-3).amax(-1)[..., None, None, None]
    return torch.maximum(x_db, ref - top_db)
