"""Sample-domain <-> STFT-frame-domain activity: port of
``tssep_tpu/signal/vad.py`` (numpy, and the port's own ``ArrayInterval``).

Activity converts run by run (not sample by sample): a run of active
samples [s, e) becomes the frames [frame(s), frame(e)), where ``frame`` is
the frame in which a sample sits most centrally; a run of active frames
[fs, fe) becomes the samples from the first one of frame fs to one past the
last one of frame fe - 1.

``stft_vad`` of an array returns a bool array of frames (also for a 1-D
array), of an ``ArrayInterval`` an ``ArrayInterval`` and of a list a list;
``istft_vad`` returns ``ArrayInterval``s (``tssep_tpu/signal/vad.py:22-91``).
"""

from __future__ import annotations

import numpy as np

from tssep_tpu_torch.signal.intervals import ArrayInterval
from tssep_tpu_torch.signal.stft import _fading_pad_width, samples_to_frames

__all__ = ['stft_vad', 'istft_vad', 'sample_index_to_frame_index',
           'frame_index_to_sample_index']


def sample_index_to_frame_index(sample_index, *, window_length, shift,
                                fading=True):
    """The center-most frame covering a sample (after the fading offset),
    clipped at 0 (``tssep_tpu/signal/stft.py:114``)."""
    s = np.asarray(sample_index) + _fading_pad_width(window_length, shift,
                                                     fading)
    return np.maximum(0, s // shift - (window_length // shift - 1) // 2)


def frame_index_to_sample_index(frame_index, *, window_length, shift,
                                fading=True, mode='center', num_samples=None):
    """A frame index back to a sample index (``tssep_tpu/signal/stft.py:
    129-159``): ``'first'`` the first sample of the frame, ``'last'`` one
    past the last sample of frame ``frame_index - 1`` (an exclusive end),
    ``'center'`` its center sample."""
    frame_index = np.asarray(frame_index)
    pad = _fading_pad_width(window_length, shift, fading)
    if mode == 'first':
        s = frame_index * shift - pad
    elif mode == 'last':
        s = (frame_index - 1) * shift + window_length - pad
    elif mode == 'center':
        s = frame_index * shift + window_length // 2 - pad
    else:
        raise ValueError(mode)
    s = np.maximum(0, s)
    if num_samples is not None:
        s = np.minimum(s, num_samples)
    return s


def _runs(active):
    """[start, end) of each run of True in a 1-D bool array."""
    edges = np.diff(np.concatenate([[0], active.astype(np.int8), [0]]))
    return zip(np.flatnonzero(edges == 1), np.flatnonzero(edges == -1))


def _frame_runs(runs, window_length, shift, fading):
    for s, e in runs:
        yield tuple(int(sample_index_to_frame_index(
            i, window_length=window_length, shift=shift, fading=fading))
            for i in (s, e))


def _single_stft_vad(a, window_length, shift, fading) -> ArrayInterval:
    """One speaker's sample activity (array or ``ArrayInterval``) -> its
    frame activity as an ``ArrayInterval``."""
    if not isinstance(a, ArrayInterval):
        a = ArrayInterval(np.asarray(a, dtype=bool))
    frames = samples_to_frames(len(a), size=window_length, shift=shift,
                               pad=True, fading=fading)
    out = ArrayInterval([], shape=frames)
    for fs, fe in _frame_runs(a.normalized_intervals, window_length, shift,
                              fading):
        out[fs:min(fe, frames)] = True
    return out


def stft_vad(vad, window_length, shift, fading):
    """(..., samples) activity -> (..., frames) bool; an ``ArrayInterval``
    -> an ``ArrayInterval``; a list or tuple -> a list."""
    if isinstance(vad, ArrayInterval):
        return _single_stft_vad(vad, window_length, shift, fading)
    if isinstance(vad, (tuple, list)):
        return [stft_vad(v, window_length, shift, fading) for v in vad]
    vad = np.asarray(vad, dtype=bool)
    frames = samples_to_frames(vad.shape[-1], size=window_length, shift=shift,
                               pad=True, fading=fading)
    flat = vad.reshape(-1, vad.shape[-1])
    out = np.zeros((flat.shape[0], frames), dtype=bool)
    for row, active in zip(out, flat):
        for fs, fe in _frame_runs(_runs(active), window_length, shift,
                                  fading):
            row[fs:min(fe, frames)] = True
    return out.reshape(vad.shape[:-1] + (frames,))


def _single_istft_vad(a, window_length, shift, fading) -> ArrayInterval:
    """One speaker's frame activity -> its sample activity."""
    if not isinstance(a, ArrayInterval):
        a = ArrayInterval(np.asarray(a, dtype=bool))
    out = ArrayInterval([])
    for fs, fe in a.normalized_intervals:
        s = int(frame_index_to_sample_index(
            fs, window_length=window_length, shift=shift, fading=fading,
            mode='first'))
        e = int(frame_index_to_sample_index(
            fe, window_length=window_length, shift=shift, fading=fading,
            mode='last'))
        out[s:e] = True
    return out


def istft_vad(vad, window_length, shift, fading):
    """Frame activity -> sample activity: an ``ArrayInterval`` per speaker
    (nested lists for leading axes)."""
    if isinstance(vad, ArrayInterval):
        return _single_istft_vad(vad, window_length, shift, fading)
    if isinstance(vad, np.ndarray):
        if vad.ndim == 1:
            return _single_istft_vad(vad, window_length, shift, fading)
        data = np.empty(vad.shape[:-1], dtype=object)
        for idx in np.ndindex(vad.shape[:-1]):
            data[idx] = _single_istft_vad(vad[idx], window_length, shift,
                                          fading)
        return data.tolist()
    if isinstance(vad, (tuple, list)):
        return [istft_vad(v, window_length, shift, fading) for v in vad]
    raise TypeError(type(vad))
