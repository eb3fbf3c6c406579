"""Sample-domain to STFT-frame-domain activity: ``stft_vad``, a numpy copy of
``tssep_tpu/signal/vad.py:42`` for arrays.

Activity converts run by run (not sample by sample): a run of active
samples [s, e) becomes the frames [frame(s), frame(e)), where ``frame`` is
the frame in which a sample sits most centrally.
"""

from __future__ import annotations

import numpy as np

from tssep_tpu_torch.signal.stft import _fading_pad_width, samples_to_frames

__all__ = ['stft_vad', 'sample_index_to_frame_index']


def sample_index_to_frame_index(sample_index, *, window_length, shift,
                                fading=True):
    """The center-most frame covering a sample (after the fading offset),
    clipped at 0 (``tssep_tpu/signal/stft.py:114``)."""
    s = np.asarray(sample_index) + _fading_pad_width(window_length, shift,
                                                     fading)
    return np.maximum(0, s // shift - (window_length // shift - 1) // 2)


def _runs(active):
    """[start, end) of each run of True in a 1-D bool array."""
    edges = np.diff(np.concatenate([[0], active.astype(np.int8), [0]]))
    return zip(np.flatnonzero(edges == 1), np.flatnonzero(edges == -1))


def stft_vad(vad, window_length, shift, fading):
    """(..., samples) activity -> (..., frames) bool."""
    vad = np.asarray(vad, dtype=bool)
    frames = samples_to_frames(vad.shape[-1], size=window_length, shift=shift,
                               pad=True, fading=fading)
    flat = vad.reshape(-1, vad.shape[-1])
    out = np.zeros((flat.shape[0], frames), dtype=bool)
    for row, active in zip(out, flat):
        for s, e in _runs(active):
            fs, fe = (int(sample_index_to_frame_index(
                i, window_length=window_length, shift=shift, fading=fading))
                for i in (s, e))
            row[fs:min(fe, frames)] = True
    return out.reshape(vad.shape[:-1] + (frames,))
