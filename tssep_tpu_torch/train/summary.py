"""Review summaries and their writers: port of ``tssep_tpu/train/summary.py``
(numpy only, a copy with the same semantics).

The reference's ``ReviewSummary`` -> tensorboardX flow (``model.py:
657-752``): accumulate loss/scalars/histograms/audio/images per summary
interval, flush to a plain ``metrics.jsonl`` (always; greppable
observability without TensorBoard) and to tfevents where tensorboardX
imports, as the JAX writer does.
"""

from __future__ import annotations

import collections
import json
import time
from pathlib import Path

import numpy as np

__all__ = ['ReviewSummary', 'SummaryWriter']


class ReviewSummary:
    """Accumulates review payloads between flushes."""

    def __init__(self, prefix=''):
        self.prefix = prefix
        self.loss = 0.0
        self.loss_count = 0
        self.scalars = collections.defaultdict(list)
        self.histograms = collections.defaultdict(list)
        self.audios = {}
        self.images = {}

    def add_to_loss(self, value):
        self.loss += float(value)
        self.loss_count += 1

    def add_scalar(self, name, value):
        self.scalars[self.prefix + name].append(float(value))

    def add_histogram(self, name, value):
        self.histograms[self.prefix + name].append(np.asarray(value))

    def add_audio(self, name, signal, sampling_rate=16000):
        self.audios[self.prefix + name] = (np.asarray(signal), sampling_rate)

    def add_image(self, name, image):
        self.images[self.prefix + name] = np.asarray(image)

    def add_stft_image(self, name, stft_signal, batch_first=None):
        x = np.abs(np.asarray(stft_signal))
        x = np.log10(np.maximum(x, 1e-10))
        self.add_image(name, _colorize(x))

    def add_mask_image(self, name, mask, batch_first=None):
        self.add_image(name, _colorize(np.asarray(mask), vmin=0, vmax=1))

    def merge(self, other: 'ReviewSummary'):
        self.loss += other.loss
        self.loss_count += other.loss_count
        for k, v in other.scalars.items():
            self.scalars[k].extend(v)
        for k, v in other.histograms.items():
            self.histograms[k].extend(v)
        self.audios.update(other.audios)
        self.images.update(other.images)


def _colorize(x, vmin=None, vmax=None):
    """2-D array -> (H, W) grayscale image in [0, 1], time on the x-axis."""
    x = np.asarray(x, dtype=np.float64)
    while x.ndim > 2:
        x = x.reshape((-1,) + x.shape[2:]) if x.shape[0] == 1 else x[0]
    if vmin is None:
        vmin = x.min()
    if vmax is None:
        vmax = x.max()
    denom = (vmax - vmin) or 1.0
    return np.clip((x.T[::-1] - vmin) / denom, 0, 1)


class SummaryWriter:
    """Flushes ReviewSummary payloads to metrics.jsonl + tfevents.
    ``write=False`` (the data ranks other than 0) opens nothing and writes
    nothing; ``flush`` still returns the record."""

    def __init__(self, storage_dir, use_tensorboard=True, write=True):
        self.storage_dir = Path(storage_dir)
        self.jsonl = self.tb = None
        if not write:
            return
        self.storage_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl = open(self.storage_dir / 'metrics.jsonl', 'a')
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter as TBWriter
                self.tb = TBWriter(logdir=str(self.storage_dir))
            except Exception:  # noqa: BLE001
                self.tb = None

    def flush(self, summary: ReviewSummary, step: int, prefix=''):
        record = {'step': int(step), 'time': time.time()}
        if summary.loss_count:
            record[prefix + 'loss'] = summary.loss / summary.loss_count
        for name, values in summary.scalars.items():
            record[prefix + name] = float(np.mean(values))
        # Payload names only (the payloads go to tfevents): greppable
        # evidence that snapshots were emitted.
        if summary.audios:
            record[prefix + 'audio_keys'] = sorted(
                prefix + k for k in summary.audios)
        if summary.images:
            record[prefix + 'image_keys'] = sorted(
                prefix + k for k in summary.images)
        if self.jsonl is None:
            return record
        self.jsonl.write(json.dumps(record) + '\n')
        self.jsonl.flush()

        if self.tb is not None:
            for k, v in record.items():
                if k in ('step', 'time') or not isinstance(v, (int, float)):
                    continue
                self.tb.add_scalar(k, v, step)
            for name, values in summary.histograms.items():
                try:
                    self.tb.add_histogram(prefix + name,
                                          np.concatenate(
                                              [np.atleast_1d(v) for v in values]),
                                          step)
                except Exception:  # noqa: BLE001
                    pass
            for name, (signal, sr) in summary.audios.items():
                try:
                    sig = np.asarray(signal, dtype=np.float32)
                    sig = sig / max(np.abs(sig).max(), 1e-6)
                    while sig.ndim > 1:
                        sig = sig[0]
                    self.tb.add_audio(prefix + name, sig[:, None], step,
                                      sample_rate=sr)
                except Exception:  # noqa: BLE001
                    pass
            for name, image in summary.images.items():
                try:
                    self.tb.add_image(prefix + name, image[None, :, :], step)
                except Exception:  # noqa: BLE001
                    pass
            self.tb.flush()
        return record

    def scalar(self, name, value, step):
        if self.jsonl is None:
            return
        self.jsonl.write(json.dumps(
            {'step': int(step), name: float(value), 'time': time.time()}) + '\n')
        self.jsonl.flush()
        if self.tb is not None:
            self.tb.add_scalar(name, float(value), step)

    def close(self):
        if self.jsonl is not None:
            self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
