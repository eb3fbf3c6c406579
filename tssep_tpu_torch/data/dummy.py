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

``simple_toy_example``, ``sample_cacg`` and ``wiener_like_mask`` (the
beamformer tests' spatial fixture) need ``signal/intervals.py`` and wait
for it (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tssep_tpu_torch.data import pipeline

__all__ = ['DummyReader', 'staircase_vad']


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
        num_speakers = self.num_speakers
        num_channels = self.num_channels
        num_samples = self.sample_rate * 5

        if 'train' in dataset_name:
            num_examples = self.train_examples
        else:
            num_examples = self.validate_examples
        start_seed = 0

        def get_example(seed):
            rng = np.random.RandomState(seed)
            max_frequency = 7000
            min_frequency = 100
            num_frequencies = 3
            frequency = rng.randint(
                min_frequency, max_frequency,
                size=(num_frequencies, num_speakers))
            time = np.arange(num_samples) / self.sample_rate
            speaker_signal = (
                np.sin(2 * np.pi * frequency[..., None] * time)
                .sum(axis=0).astype(np.float32)
            )[:, None, :]  # (spk, ch, samples)
            vad = self._get_vad(num_samples, num_speakers)
            speaker_signal = speaker_signal * vad[:, None, :]

            noise = rng.rand(num_channels, num_samples).astype(np.float32)
            observation = speaker_signal.sum(axis=0) + noise

            aux = np.zeros((num_speakers, self.aux_size), dtype=np.float32)
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

        examples = [get_example(start_seed + i) for i in range(num_examples)]
        ds = pipeline.new(examples)
        if pre_load_apply is not None:
            ds = pre_load_apply(ds)
        return ds

    class data_hooks:
        @staticmethod
        def pre_net(ex):
            return ex
