"""Model assembly for serving and training: port of ``tssep_tpu/tasks/model.py``.

``Model.forward`` runs observation -> STFT -> Log1pMaxNorm features -> mask
estimator -> Masking, and synthesises the separated waveforms with the ISTFT
of the masked STFT. A batch has the layout of ``DeviceMeetingSimulator``'s:
``observation`` (B, C, samples), ``auxInput`` (B, S, A) and
``reference_channel``, and for training the loss's target
(``speaker_reverberation_early_ch0``, (B, S, samples)).

Serving (``training=False``) runs without autograd. ``loss_fn`` is what the
trainer differentiates: the forward with ``training=True`` keeps the graph,
and ``review_loss`` applies the loss (``LogMAE`` by default) to the
synthesised waveforms.
"""

from __future__ import annotations

import contextlib
import dataclasses
import typing

import torch
from torch import nn

from tssep_tpu_torch.features.extractor import Log1pMaxNormAbsSTFT
from tssep_tpu_torch.nn.estimator import MaskEstimator
from tssep_tpu_torch.tasks.enhancer import Masking
from tssep_tpu_torch.tasks.losses import Loss, LogMAE, loss_from_config
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
    """Feature extractor + mask estimator + Masking enhancer + loss."""

    def __init__(self, fe: Log1pMaxNormAbsSTFT, mask_estimator: MaskEstimator,
                 loss: Loss | None = None, *, device='cuda'):
        super().__init__()
        self.device = resolve_device(device)
        self.fe = fe
        self.mask_estimator = mask_estimator.to(self.device)
        self.enhancer = Masking()
        self.loss = LogMAE() if loss is None else loss

    @classmethod
    def from_config(cls, config: dict, *, storage_dtype=torch.bfloat16,
                    device='cuda', cond_fuse=False, fullfuse=True,
                    spill=False, bidi=True):
        """Build from a config dict of the JAX package's form, e.g. the
        flagship of ``bench.py:98-106``. ``fe`` holds the STFT settings and
        ``mask_estimator`` the estimator's keyword arguments; ``idim``,
        ``odim`` and ``nmask`` follow from the feature extractor and the
        Masking enhancer, as the JAX config derives them. ``loss`` is
        ``{'factory': 'LogMAE', ...}`` (the default). ``reader`` configures
        the data source, which is not part of the model.

        ``cond_fuse``, ``fullfuse``, ``spill`` and ``bidi`` choose kernels,
        as the JAX package's ``TSSEP_PALLAS_CONDFUSE``,
        ``TSSEP_PALLAS_FULLFUSE``, ``TSSEP_PALLAS_SPILL`` and
        ``TSSEP_PALLAS_BIDI`` do (``MaskEstimator``): ``cond_fuse=True``
        forms the 'mul' conditioning inside the first post-net layer's
        kernels; ``fullfuse=False`` runs every BLSTM layer from gate inputs
        computed outside; ``spill=True`` runs every fully fused layer
        through the spill pair, which keeps the c carry of every 8th step
        for the backward instead of the c sequence; ``bidi=False`` runs
        each direction of a layer that takes gate inputs on its own. None
        changes the parameters, so the same named arrays load
        (``compat/from_jax.py``) whatever the switches."""
        unknown = set(config) - {'fe', 'reader', 'mask_estimator', 'loss'}
        if unknown:
            raise NotImplementedError(f'config keys {sorted(unknown)}')
        device = resolve_device(device)
        fe = Log1pMaxNormAbsSTFT(**config.get('fe', {}))
        me_cfg = dict(idim=fe.output_size, odim=fe.frequencies, nmask=1)
        me_cfg.update(config.get('mask_estimator', {}))
        if me_cfg.get('aux_net') is None:
            # the JAX MaskEstimator.finalize_dogmatic_config's i-vector size
            me_cfg.setdefault('aux_net_output_size', 100)
        estimator = MaskEstimator(**me_cfg, storage_dtype=storage_dtype,
                                  cond_fuse=cond_fuse, fullfuse=fullfuse,
                                  spill=spill, bidi=bidi, device=device)
        return cls(fe, estimator, loss_from_config(config.get('loss')),
                   device=device)

    def init_params(self, generator: torch.Generator):
        self.mask_estimator.init_params(generator)
        return self

    def num_params(self):
        return self.mask_estimator.num_params()

    def forward(self, ex: dict, generator: torch.Generator | None = None,
                training=False) -> ForwardOutput:
        """Masks and separated waveforms for one batch ``ex``. ``generator``
        draws the random speaker order (none: the input's order) and, when
        ``training``, the dropout. Serving (``training=False``) records no
        graph; training keeps it and skips the complex STFT estimate, which
        the loss does not read."""
        with contextlib.nullcontext() if training else torch.no_grad():
            ref = ex['reference_channel']
            observation = torch.as_tensor(ex['observation'],
                                          dtype=torch.float32,
                                          device=self.device)
            aux = torch.as_tensor(ex['auxInput'], dtype=torch.float32,
                                  device=self.device)
            stft = self.fe.stft(observation)              # (B, C, T, F)
            features = self.fe.stft_to_feature(stft[..., ref, :, :]).float()
            me_out = self.mask_estimator(features, aux, generator, training)
            ex = dict(ex, Observation=stft)
            time_estimate = self.fe.istft(
                self.enhancer.re_im(me_out.mask, ex),
                num_samples=observation.shape[-1])
            return ForwardOutput(
                mask=me_out.mask, logit=me_out.logit,
                embedding=me_out.embedding,
                stft_estimate=(None if training
                               else self.enhancer(me_out.mask, ex)),
                time_estimate=time_estimate, vad_mask=me_out.vad_mask,
                vad_logit=me_out.vad_logit)

    def review_loss(self, ex: dict, out: ForwardOutput):
        """The loss of a forward's output; returns (loss summed over the
        batch, per-example loss)."""
        loss_value = self.loss.from_ex_out(ex, out)
        return loss_value.sum(), loss_value

    def loss_fn(self, ex: dict, generator: torch.Generator | None = None,
                training=True):
        """The function the trainer differentiates: (scalar loss,
        ``{'per_example_loss': ...}``)."""
        out = self.forward(ex, generator, training=training)
        loss_sum, loss_value = self.review_loss(ex, out)
        return loss_sum, {'per_example_loss': loss_value}
