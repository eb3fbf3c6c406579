"""Model assembly for serving: port of ``tssep_tpu/tasks/model.py``.

``Model.forward`` runs observation -> STFT -> Log1pMaxNorm features -> mask
estimator -> Masking, and synthesises the separated waveforms with the ISTFT
of the masked STFT. A served request is one batch in the layout of the JAX
package's ``DeviceMeetingSimulator.generate``: ``observation`` (B, C, samples),
``auxInput`` (B, S, A) and ``reference_channel``.
"""

from __future__ import annotations

import dataclasses
import typing

import torch
from torch import nn

from tssep_tpu_torch.features.extractor import Log1pMaxNormAbsSTFT
from tssep_tpu_torch.nn.estimator import MaskEstimator
from tssep_tpu_torch.tasks.enhancer import Masking
from tssep_tpu_torch.utils.device import resolve_device

__all__ = ['Model', 'ForwardOutput']


@dataclasses.dataclass
class ForwardOutput:
    mask: typing.Any
    logit: typing.Any
    embedding: typing.Any = None
    stft_estimate: typing.Any = None
    time_estimate: typing.Any = None
    vad_mask: typing.Any = None
    vad_logit: typing.Any = None


class Model(nn.Module):
    """Feature extractor + mask estimator + Masking enhancer."""

    def __init__(self, fe: Log1pMaxNormAbsSTFT, mask_estimator: MaskEstimator,
                 *, device='cuda'):
        super().__init__()
        self.device = resolve_device(device)
        self.fe = fe
        self.mask_estimator = mask_estimator.to(self.device)
        self.enhancer = Masking()

    @classmethod
    def from_config(cls, config: dict, *, storage_dtype=torch.bfloat16,
                    device='cuda'):
        """Build from a config dict of the JAX package's form, e.g. the
        flagship of ``bench.py:98-106``. ``fe`` holds the STFT settings and
        ``mask_estimator`` the estimator's keyword arguments; ``idim``,
        ``odim`` and ``nmask`` follow from the feature extractor and the
        Masking enhancer, as the JAX config derives them. ``reader``
        configures the data source, which is not part of the model."""
        unknown = set(config) - {'fe', 'reader', 'mask_estimator'}
        if unknown:
            raise NotImplementedError(f'config keys {sorted(unknown)}')
        device = resolve_device(device)
        fe = Log1pMaxNormAbsSTFT(**config.get('fe', {}))
        me_cfg = dict(idim=fe.output_size, odim=fe.frequencies, nmask=1)
        me_cfg.update(config.get('mask_estimator', {}))
        estimator = MaskEstimator(**me_cfg, storage_dtype=storage_dtype,
                                  device=device)
        return cls(fe, estimator, device=device)

    def init_params(self, generator: torch.Generator):
        self.mask_estimator.init_params(generator)
        return self

    def num_params(self):
        return self.mask_estimator.num_params()

    @torch.no_grad()
    def forward(self, ex: dict, generator: torch.Generator | None = None
                ) -> ForwardOutput:
        """Masks and separated waveforms for one batch ``ex``; ``generator``
        draws the random speaker order (none: the input's order)."""
        ref = ex['reference_channel']
        observation = torch.as_tensor(ex['observation'], dtype=torch.float32,
                                      device=self.device)
        aux = torch.as_tensor(ex['auxInput'], dtype=torch.float32,
                              device=self.device)
        stft = self.fe.stft(observation)                  # (B, C, T, F)
        features = self.fe.stft_to_feature(stft[..., ref, :, :]).float()
        me_out = self.mask_estimator(features, aux, generator)
        ex = dict(ex, Observation=stft)
        time_estimate = self.fe.istft(self.enhancer.re_im(me_out.mask, ex),
                                      num_samples=observation.shape[-1])
        return ForwardOutput(
            mask=me_out.mask, logit=me_out.logit,
            embedding=me_out.embedding,
            stft_estimate=self.enhancer(me_out.mask, ex),
            time_estimate=time_estimate, vad_mask=me_out.vad_mask,
            vad_logit=me_out.vad_logit)
