"""Run-length-encoded boolean activity intervals: a copy of
``tssep_tpu/signal/intervals.py`` (numpy only; the port imports nothing of
the JAX package).

Equivalent of ``paderbox.array.interval.ArrayInterval`` as used by the
reference for VAD bookkeeping and segment-wise beamforming
(``tssep/util/utils.py:30-74``, ``tssep/train/enhancer.py:515-519``).

Stored as a sorted list of half-open ``(start, end)`` intervals plus an
optional known length, so hour-long recordings cost O(#segments), not
O(#samples).
"""

from __future__ import annotations

import numpy as np

__all__ = ['ArrayInterval', 'zeros', 'ones', 'from_str', 'from_array']


class ArrayInterval:
    """Boolean 1-D array, run-length encoded as half-open intervals."""

    def __init__(self, array_or_intervals=None, shape=None, inverse_mode=False):
        if array_or_intervals is None:
            self.intervals: list[tuple[int, int]] = []
        elif isinstance(array_or_intervals, ArrayInterval):
            self.intervals = list(array_or_intervals.intervals)
            if shape is None:
                shape = array_or_intervals.shape
        elif isinstance(array_or_intervals, (list, tuple)) and (
            len(array_or_intervals) == 0
            or isinstance(array_or_intervals[0], (list, tuple))
        ):
            self.intervals = _normalize(list(map(tuple, array_or_intervals)))
        else:
            arr = np.asarray(array_or_intervals, dtype=bool)
            assert arr.ndim == 1, arr.shape
            self.intervals = _intervals_from_array(arr)
            if shape is None:
                shape = arr.shape[-1]
        if isinstance(shape, tuple):
            assert len(shape) == 1, shape
            shape = shape[0]
        self.length = shape  # may be None (open-ended)
        if inverse_mode:
            self.intervals = _invert(self.intervals, self.length)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_str(cls, s: str, shape=None) -> 'ArrayInterval':
        """Parse ``"0:55,60:70"`` (paderbox string syntax)."""
        ivls = []
        s = s.strip()
        if s:
            for part in s.split(','):
                start, _, end = part.strip().partition(':')
                ivls.append((int(start), int(end)))
        out = cls(ivls, shape=shape)
        return out

    # -- protocol ----------------------------------------------------------
    @property
    def shape(self):
        return (self.length,) if self.length is not None else (None,)

    def __len__(self):
        if self.length is None:
            raise TypeError('ArrayInterval has unknown length')
        return self.length

    @property
    def normalized_intervals(self) -> tuple[tuple[int, int], ...]:
        return tuple(self.intervals)

    def to_array(self, length=None) -> np.ndarray:
        if length is None:
            length = self.length
        if length is None:
            length = self.intervals[-1][1] if self.intervals else 0
        out = np.zeros(length, dtype=bool)
        for s, e in self.intervals:
            out[s:min(e, length)] = True
        return out

    def __array__(self, dtype=None, copy=None):
        arr = self.to_array()
        if dtype is not None:
            arr = arr.astype(dtype)
        return arr

    def __getitem__(self, item):
        if isinstance(item, slice):
            start, stop, step = item.indices(
                self.length if self.length is not None else
                (self.intervals[-1][1] if self.intervals else 0)
            )
            assert step == 1, item
            sub = []
            for s, e in self.intervals:
                s2, e2 = max(s, start), min(e, stop)
                if s2 < e2:
                    sub.append((s2 - start, e2 - start))
            return ArrayInterval(sub, shape=stop - start)
        if isinstance(item, (int, np.integer)):
            if item < 0:
                item += len(self)
            return any(s <= item < e for s, e in self.intervals)
        raise TypeError(item)

    def __setitem__(self, item, value):
        assert isinstance(item, slice) and item.step in (None, 1), item
        start = item.start if item.start is not None else 0
        stop = item.stop if item.stop is not None else self.length
        assert stop is not None, 'open-ended assignment needs known length'
        if start < 0 or stop < 0:
            assert self.length is not None
            if start < 0:
                start += self.length
            if stop < 0:
                stop += self.length
        if value:
            self.intervals = _normalize(self.intervals + [(start, stop)])
        else:
            out = []
            for s, e in self.intervals:
                if e <= start or s >= stop:
                    out.append((s, e))
                else:
                    if s < start:
                        out.append((s, start))
                    if e > stop:
                        out.append((stop, e))
            self.intervals = out

    def __invert__(self):
        return ArrayInterval(_invert(self.intervals, self.length), shape=self.length)

    def sum(self):
        return sum(e - s for s, e in self.intervals)

    def __eq__(self, other):
        if isinstance(other, ArrayInterval):
            return (self.intervals == other.intervals
                    and self.length == other.length)
        return NotImplemented

    def __repr__(self):
        body = ', '.join(f'{s}:{e}' for s, e in self.intervals)
        if self.length is None:
            return f'ArrayInterval("{body}")'
        return f'ArrayInterval("{body}", shape={(self.length,)})'


def _normalize(intervals):
    """Sort and merge overlapping/adjacent half-open intervals."""
    ivls = sorted((int(s), int(e)) for s, e in intervals if e > s)
    out = []
    for s, e in ivls:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _intervals_from_array(arr: np.ndarray):
    if arr.size == 0:
        return []
    diff = np.diff(arr.astype(np.int8))
    starts = list(np.where(diff == 1)[0] + 1)
    ends = list(np.where(diff == -1)[0] + 1)
    if arr[0]:
        starts = [0] + starts
    if arr[-1]:
        ends = ends + [len(arr)]
    return list(zip(map(int, starts), map(int, ends)))


def _invert(intervals, length):
    out = []
    prev = 0
    for s, e in intervals:
        if s > prev:
            out.append((prev, s))
        prev = e
    if length is not None and prev < length:
        out.append((prev, length))
    return out


def zeros(shape=None) -> ArrayInterval:
    return ArrayInterval([], shape=shape)


def ones(shape) -> ArrayInterval:
    length = shape[0] if isinstance(shape, tuple) else shape
    return ArrayInterval([(0, length)], shape=length)


def from_str(s, shape=None) -> ArrayInterval:
    return ArrayInterval.from_str(s, shape=shape)


def from_array(arr) -> ArrayInterval:
    return ArrayInterval(arr)
