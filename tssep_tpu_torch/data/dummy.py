"""Deterministic synthetic data: port of ``tssep_tpu/data/dummy.py`` (a copy
in numpy: the port imports nothing of the JAX package).

``DummyReader`` (:39-117) mirrors the reference's reader protocol
(``tssep/data.py:12-152``): ``reader(dataset_name, pre_load_apply,
load_keys)`` returns a ``data.pipeline`` dataset of dicts with
``audio_data.observation`` (channels, samples), ``audio_data.vad``
(speakers, samples), ``auxInput`` (speakers, aux_size), ``example_id``,
``dataset``. Examples are seeded per index: sinusoid mixtures whose
speaker frequencies are encoded into the aux embedding, so conditioning is
learnable. ``staircase_vad`` is also what the on-device simulator uses.

``simple_toy_example``, ``sample_cacg`` and ``wiener_like_mask`` (:119-182)
make the beamformer tests' spatial fixture: a 6-channel, 2-speaker CACG
STFT mixture with its VAD and wiener-like masks.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tssep_tpu_torch.data import pipeline
from tssep_tpu_torch.signal.intervals import ArrayInterval

__all__ = ['DummyReader', 'dummy_example', 'staircase_vad', 'sample_cacg', 'wiener_like_mask',
           'simple_toy_example']


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


def dummy_example(seed, num_samples, num_speakers, num_channels,
                  sample_rate=16000, aux_size=100, dataset_name='eval',
                  load_keys=(), get_vad=staircase_vad):
    """``DummyReader``'s example of index ``seed`` (``tssep_tpu/data/
    dummy.py:63-101``), at any length: sinusoid speakers under the
    staircase VAD, uniform noise per channel, the speakers' frequencies
    encoded in the aux embedding."""
    rng = np.random.RandomState(seed)
    max_frequency = 7000
    min_frequency = 100
    num_frequencies = 3
    frequency = rng.randint(
        min_frequency, max_frequency,
        size=(num_frequencies, num_speakers))
    time = np.arange(num_samples) / sample_rate
    speaker_signal = (
        np.sin(2 * np.pi * frequency[..., None] * time)
        .sum(axis=0).astype(np.float32)
    )[:, None, :]  # (spk, ch, samples)
    vad = get_vad(num_samples, num_speakers)
    speaker_signal = speaker_signal * vad[:, None, :]

    noise = rng.rand(num_channels, num_samples).astype(np.float32)
    observation = speaker_signal.sum(axis=0) + noise

    aux = np.zeros((num_speakers, aux_size), dtype=np.float32)
    scale = max_frequency + 1
    for spk, fs in enumerate(frequency.T):
        for f in fs:
            f = (f * aux.shape[1]) // scale
            aux[spk, f:f + 2] = 1

    ex = {
        'example_id': f'dummy_id_{seed}',
        'num_samples': num_samples,
        'audio_data': {
            'observation': observation,
            'vad': vad,
        },
        'auxInput': aux,
        'dataset': dataset_name,
    }
    if 'speaker_reverberation_early_ch0' in load_keys:
        ex['audio_data']['speaker_reverberation_early_ch0'] = (
            speaker_signal[:, 0])
    return ex


@dataclasses.dataclass
class DummyReader:
    train_dataset_name: str = 'train'
    validate_dataset_name: str = 'validate'
    domain_adaptation_src_dataset_name: str = 'validate'
    eval_dataset_name: str = 'eval'
    sample_rate: int = 16000
    aux_size: int = 100
    train_examples: int = 10
    validate_examples: int = 4

    num_speakers: int = 8
    num_channels: int = 1

    def _get_vad(self, num_samples, num_speakers):
        return staircase_vad(num_samples, num_speakers)

    def __call__(self, dataset_name, pre_load_apply=None, load_keys=()):
        if 'train' in dataset_name:
            num_examples = self.train_examples
        else:
            num_examples = self.validate_examples
        start_seed = 0
        examples = [dummy_example(
            start_seed + i, self.sample_rate * 5, self.num_speakers,
            self.num_channels, self.sample_rate, self.aux_size,
            dataset_name, load_keys, self._get_vad)
            for i in range(num_examples)]
        ds = pipeline.new(examples)
        if pre_load_apply is not None:
            ds = pre_load_apply(ds)
        return ds

    class data_hooks:
        @staticmethod
        def pre_net(ex):
            return ex


def sample_cacg(size, covariance, rng=None):
    """Complex angular central Gaussian samples: CN(0, cov) normalized to the
    unit sphere.  Shape: (*size, D)."""
    if rng is None:
        rng = np.random
    d = covariance.shape[-1]
    l = np.linalg.cholesky(covariance)
    w = (rng.standard_normal(tuple(np.atleast_1d(size)) + (d,))
         + 1j * rng.standard_normal(tuple(np.atleast_1d(size)) + (d,))) / np.sqrt(2)
    z = w @ l.conj().T
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def wiener_like_mask(signals, sensor_axis=None, eps=1e-18):
    """Power-ratio masks over sources (pb_bss ``wiener_like_mask`` semantics)."""
    signals = np.asarray(signals)
    power = np.abs(signals) ** 2
    if sensor_axis is not None:
        power = power.sum(axis=sensor_axis)
    return power / np.maximum(power.sum(axis=0, keepdims=True), eps)


def simple_toy_example(seed=0, frequency_bins=5):
    """6-channel, 2-speaker CACG STFT mixture with VAD + wiener-like masks."""
    rng = np.random.RandomState(seed)

    num_channels = 6
    time_frames = 79

    doa1 = np.exp(1j * np.array([0, 0, 0, 0, 0, 0][:num_channels]))
    doa2 = np.exp(1j * np.pi * np.array([0, 1, 0.5, 0.25, 0.75, 0][:num_channels]))
    cov1 = doa1[:, None] * doa1[None, :].conj() + 0.01 * np.eye(num_channels)
    cov2 = doa2[:, None] * doa2[None, :].conj() + 0.01 * np.eye(num_channels)

    s1 = sample_cacg((time_frames * frequency_bins,), cov1,
                     np.random.RandomState(seed + 1))
    s2 = sample_cacg((time_frames * frequency_bins,), cov2,
                     np.random.RandomState(seed + 2))

    def to_tf(s):
        # (time*freq, ch) -> (ch, time, freq)
        return np.transpose(
            s.reshape(time_frames, frequency_bins, num_channels), (2, 0, 1))

    s1, s2 = to_tf(s1), to_tf(s2)

    dia = [
        ArrayInterval.from_str('0:55', shape=time_frames),
        ArrayInterval.from_str('45:79', shape=time_frames),
    ]
    for i, s in enumerate([s1, s2]):
        s[:, ~np.asarray(dia[i]), :] = 0

    noise = 0.01 * rng.randn(num_channels, time_frames, frequency_bins)
    observation = s1 + s2 + noise

    mask = wiener_like_mask(np.array([s1, s2, noise]), sensor_axis=1)

    return {
        'Observation': observation,
        'Speech_reverberation_early': np.array([s1, s2]),
        'Vad': dia,
        'mask': mask,
    }
