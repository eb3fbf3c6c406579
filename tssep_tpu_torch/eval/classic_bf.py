"""Offline eval enhancer: segment-wise beamforming over VAD intervals; port
of ``tssep_tpu/eval/classic_bf.py``, on the host in numpy as there.

Native equivalent of the reference's ``ClassicBF_np``
(``tssep/train/enhancer.py:370-590``) + distortion masks
(``enhancer_distortion_mask.py``): per speaker, per estimated-activity
segment, estimate masked PSDs, solve for the beamformer, apply, and stitch
into a (K, T, F) output.  numpy float64/complex128 throughout.

The segment axis is embarrassingly parallel; ``segment_jobs``/``run_segment``
expose it for the segment-parallel long-recording driver
(``tssep_tpu_torch.eval.driver``).
"""

from __future__ import annotations

import numpy as np

from tssep_tpu_torch.config.configurable import Configurable, from_config
from tssep_tpu_torch.eval import beamformer as bf_lib
from tssep_tpu_torch.eval.wpe import WPE
from tssep_tpu_torch.signal.intervals import ArrayInterval

__all__ = ['OneMinus', 'SumCrossTalker', 'ClassicBF', 'ClassicBF_np']


class OneMinus(Configurable):
    """Distortion mask = 1 - target mask (``enhancer_distortion_mask.py:9``)."""

    def __call__(self, masks):
        assert masks.shape[0] == 1, masks.shape
        noise_mask = np.maximum(1 - masks, 0)
        return np.concatenate([masks, noise_mask], axis=0)


class SumCrossTalker(Configurable):
    """Distortion mask = sum of the other speakers' masks, eps-floored
    (``enhancer_distortion_mask.py:24``).  masks: (1, spk, freq, time)."""

    def __init__(self, eps=0.0001):
        self.eps = eps

    def __call__(self, masks):
        assert masks.shape[0] == 1, masks.shape
        total = masks.sum(axis=1, keepdims=True)
        noise_mask = total - masks  # sum of all others
        noise_mask = np.maximum(noise_mask, self.eps)
        return np.concatenate([masks, noise_mask], axis=0)


class ClassicBF(Configurable):
    """Eval beamformer (masks + Observation + diarization -> per-speaker STFT)."""

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['distortion_mask'] = {'factory': SumCrossTalker}

    def __init__(self, bf='mvdr_souden', masking=False, masking_eps=0,
                 distortion_mask=None, pre_wpe: WPE = None,
                 segment_wpe: WPE = None, mask_power=1,
                 psd_symmetrize='real', *, device='cuda'):
        """``device``: where a WPE of ``backend='torch'`` given as a
        configuration runs (the model's device; a port-only option)."""
        self.psd_symmetrize = psd_symmetrize
        self.bf = bf
        self.masking = masking
        self.masking_eps = masking_eps
        if isinstance(distortion_mask, dict):
            distortion_mask = from_config(distortion_mask)
        if distortion_mask is None:
            distortion_mask = SumCrossTalker()
        self.distortion_mask = distortion_mask
        if isinstance(pre_wpe, dict):
            pre_wpe = from_config(pre_wpe, device=device)
        if isinstance(segment_wpe, dict):
            segment_wpe = from_config(segment_wpe, device=device)
        self.pre_wpe = pre_wpe
        self.segment_wpe = segment_wpe
        self.mask_power = mask_power

    @property
    def name(self):
        return type(self).__name__

    def _bf_kwargs(self):
        return {
            'mvdr_souden': dict(ref_channel=0),
            'scaled_gev_atf+mvdr': dict(ref_channel=0),
            'rank1_gev+mvdr_souden': dict(ref_channel=0),
            'wmwf': dict(reference_channel=0),
            'ch0': dict(),
            'ch1': dict(),
        }[self.bf]

    # -- segment-level work unit (parallelizable axis) ---------------------
    def run_segment(self, masks, observation, target_idx, s, e):
        """Beamform one (speaker, interval) segment.

        masks: (nmask, spk, freq, time) [full-length];
        observation: (freq, mic, time) [full-length].
        Returns (time_segment, freq) complex.
        """
        obs_local = observation[:, :, s:e]
        if self.segment_wpe:
            obs_local = np.transpose(
                self.segment_wpe(np.transpose(obs_local, (1, 2, 0))),
                (2, 0, 1))
        psd_target, psd_distortion = bf_lib.get_psd(
            masks[:, target_idx, :, s:e], obs_local,
            mask_power=self.mask_power, symmetrize=self.psd_symmetrize)
        vec = bf_lib.get_bf_vector(self.bf, psd_target, psd_distortion,
                                   **self._bf_kwargs())
        enh = bf_lib.apply_beamforming_vector(vec, obs_local).T  # (t, f)
        if self.masking:
            enh = enh * np.maximum(masks[0, target_idx, :, s:e].T,
                                   self.masking_eps)
        return enh

    def segment_jobs(self, dia):
        """Flatten (speaker x VAD-interval) into a job list."""
        jobs = []
        for target_idx, ai in enumerate(dia):
            assert isinstance(ai, ArrayInterval), type(ai)
            for s, e in ai.normalized_intervals:
                jobs.append((target_idx, int(s), int(e)))
        return jobs

    def __call__(self, masks, observation, dia, segment_bf=True,
                 numpy_out=True):
        """masks: (spk, nmask, time, freq); observation: (mic, time, freq);
        dia: list of per-speaker ArrayIntervals (frame domain).
        Returns (spk, time, freq) complex (active segments filled)."""
        masks = np.asarray(masks, dtype=np.float64)
        observation = np.asarray(observation)
        mics = observation.shape[0]
        assert mics >= 6 or self.bf in ('ch0', 'ch1'), observation.shape

        if self.pre_wpe:
            observation = self.pre_wpe(observation)

        observation = np.transpose(observation, (2, 0, 1))  # f, mic, t
        masks = np.transpose(masks, (1, 0, 3, 2))           # nmask, spk, f, t

        _, k, f, t = masks.shape
        if masks.shape[0] == 1 or self.bf == 'ch0':
            if self.bf == 'ch0':
                masks = masks[:1]
            masks = self.distortion_mask(masks)
        else:
            assert masks.shape[0] == 2, masks.shape

        if dia is None:
            assert segment_bf is False
            dia_jobs = [(idx, 0, t) for idx in range(k)]
        elif segment_bf:
            dia_jobs = self.segment_jobs(dia)
        else:
            raise NotImplementedError('full-recording BF with dia stitching')

        out = np.zeros((k, t, f), dtype=observation.dtype)
        for target_idx, s, e in dia_jobs:
            out[target_idx, s:e, :] = self.run_segment(
                masks, observation, target_idx, s, e)
        return out


#: Reference-compatible alias.
ClassicBF_np = ClassicBF
