"""Deterministic synthetic layouts: ``staircase_vad``, the part of
``tssep_tpu/data/dummy.py`` that the on-device simulator uses (a copy in
numpy: the port imports nothing of the JAX package)."""

from __future__ import annotations

import numpy as np

__all__ = ['staircase_vad']


def staircase_vad(num_samples: int, num_speakers: int) -> np.ndarray:
    """(speakers, samples) bool: staircase activity with ~50% pairwise
    overlap (``tssep_tpu/data/dummy.py:27``)."""
    vad = np.zeros((num_speakers, num_samples), dtype=bool)
    start = 0
    for i in range(num_speakers):
        end = num_samples * (i + 2) // (num_speakers + 1)
        vad[i, start:end] = True
        start = end - (end - start) // 2
    return vad
