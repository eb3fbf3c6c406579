"""Model assembly for serving and training: port of ``tssep_tpu/tasks/model.py``.

``Model.forward`` runs observation -> STFT -> features -> mask estimator ->
enhancer, and synthesises the separated waveforms with the ISTFT of the
enhanced STFT. A batch has the layout of ``DeviceMeetingSimulator``'s:
``observation`` (B, C, samples), ``auxInput`` (B, S, A) and
``reference_channel``, and for training the loss's target (for example
``speaker_reverberation_early_ch0``, (B, S, samples), or the frame activity
``Vad``, (B, S, frames)). A batch may instead bring its ``Observation`` (the
STFT) or its ``Input`` (the features); without an ``Observation`` there is
no estimate, and only ``VADSigmoidBCE`` can train it.

``from_config`` builds both stages of the toy recipe
(``tssep_tpu/exp/init_cfg_common.yaml`` with ``init_cfg_tsvad.yaml`` or
``init_cfg_tssep.yaml``) and the flagship of ``bench.py:98-106`` from the
JAX configuration's form.

Serving (``training=False``) runs without autograd and returns every
output. ``loss_fn`` is what the trainer differentiates: the forward with
``training=True`` keeps the graph and computes only the outputs the loss
reads (``Loss.reads``), and ``review_loss`` applies the loss.
"""

from __future__ import annotations

import contextlib
import dataclasses
import typing

import numpy as np
import torch
from torch import nn

from tssep_tpu_torch.features.extractor import STFTFeatures, fe_from_config
from tssep_tpu_torch.nn.estimator import MaskEstimator
from tssep_tpu_torch.signal.vad import stft_vad
from tssep_tpu_torch.tasks.enhancer import (Enhancer, Masking,
                                            enhancer_from_config)
from tssep_tpu_torch.tasks.losses import (Loss, LogMAE, VADSigmoidBCE,
                                          loss_from_config)
from tssep_tpu_torch.utils.device import resolve_device
from tssep_tpu_torch.utils.factory import factory_name

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


#: The JAX ``Model``'s default feature extractor (``tssep_tpu/tasks/model.py:
#: 63-66``); a configuration's ``fe`` without another factory overrides its
#: settings.
DEFAULT_FE = {'factory': 'Log1pMaxNormAbsSTFT', 'size': 1024, 'shift': 256,
              'window': 'hann'}

_CONFIG_KEYS = {'factory', 'fe', 'reader', 'mask_estimator', 'enhancer',
                'loss'}


def _identity(ex):
    return ex


def estimator_config(config: dict, fe: STFTFeatures,
                     enhancer: Enhancer) -> dict:
    """The mask estimator's arguments as the JAX configuration derives
    them: ``idim`` the features' width, ``odim`` the STFT's bins, ``nmask``
    1 for ``Masking`` and 2 otherwise (``Model.finalize_dogmatic_config``,
    ``tssep_tpu/tasks/model.py:64-86``), then the estimator's own rules
    (``MaskEstimator.finalize_dogmatic_config``): without an aux net an
    i-vector size of 100, with one its ``idim`` the estimator's ``odim``
    and, for 'cat', the aux net's ``odim`` as the embedding size. Values
    the configuration sets win."""
    me_cfg = dict(idim=fe.output_size, odim=fe.frequencies,
                  nmask=1 if isinstance(enhancer, Masking) else 2)
    me_cfg.update(config)
    me_cfg.pop('factory', None)
    aux_net = me_cfg.get('aux_net')
    if aux_net is None:
        me_cfg.setdefault('aux_net_output_size', 100)
    elif isinstance(aux_net, dict):
        aux_net = dict(aux_net)
        aux_net.setdefault('idim', me_cfg.get('odim') or me_cfg['idim'])
        if (me_cfg.get('combination', 'cat') == 'cat'
                and 'odim' in config['aux_net']):
            me_cfg.setdefault('aux_net_output_size', aux_net['odim'])
        me_cfg['aux_net'] = aux_net
    return me_cfg


class Model(nn.Module):
    """Feature extractor + mask estimator + enhancer + loss."""

    def __init__(self, fe: STFTFeatures, mask_estimator: MaskEstimator,
                 loss: Loss | None = None, enhancer: Enhancer | None = None,
                 *, pre_net_hook=None, device='cuda'):
        super().__init__()
        self.device = resolve_device(device)
        self.fe = fe
        self.mask_estimator = mask_estimator.to(self.device)
        self.enhancer = Masking() if enhancer is None else enhancer
        self.loss = LogMAE() if loss is None else loss
        #: The reader's ``data_hooks.pre_net``: a function of the example
        #: after its features are made (``tssep_tpu/data/dummy.py:113-116``
        #: is the identity).
        self.pre_net_hook = _identity if pre_net_hook is None else pre_net_hook

    @classmethod
    def from_config(cls, config: dict, *, storage_dtype=torch.bfloat16,
                    device='cuda', cond_fuse=False, fullfuse=True,
                    spill=False, bidi=True):
        """Build from a config dict of the JAX package's form: the flagship
        of ``bench.py:98-106``, or a recipe's ``eg.trainer.model``. ``fe``
        is a feature extractor's configuration (``fe_from_config``; without
        a ``factory`` it sets ``DEFAULT_FE``'s), ``mask_estimator`` the
        estimator's keyword arguments (:func:`estimator_config`),
        ``enhancer`` and ``loss`` ``{'factory': name, ...}`` (default
        ``Masking`` and ``LogMAE``). ``reader`` configures the data source,
        which is not part of the model; ``factory`` names the model.

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
        unknown = set(config) - _CONFIG_KEYS
        if unknown:
            raise ValueError(f'unknown config keys {sorted(unknown)}')
        if factory_name(config.get('factory', 'Model')) != 'Model':
            raise ValueError(f"factory {config['factory']!r} is not a Model")
        device = resolve_device(device)
        fe_cfg = dict(config.get('fe', {}))
        if factory_name(fe_cfg.get('factory', DEFAULT_FE['factory'])) == \
                DEFAULT_FE['factory']:
            fe_cfg = {**DEFAULT_FE, **fe_cfg}
        fe = fe_from_config(fe_cfg)
        enhancer = enhancer_from_config(config.get('enhancer'))
        me_cfg = estimator_config(config.get('mask_estimator', {}), fe,
                                  enhancer)
        estimator = MaskEstimator(**me_cfg, storage_dtype=storage_dtype,
                                  cond_fuse=cond_fuse, fullfuse=fullfuse,
                                  spill=spill, bidi=bidi, device=device)
        return cls(fe, estimator, loss_from_config(config.get('loss')),
                   enhancer, device=device)

    def init_params(self, generator: torch.Generator):
        self.mask_estimator.init_params(generator)
        return self

    def num_params(self):
        return self.mask_estimator.num_params()

    def host_prepare(self, ex: dict) -> dict:
        """Host-side target preparation: a sample-domain ``vad`` (S,
        samples) becomes the frame activity ``Vad`` that ``VADSigmoidBCE``
        reads, where the loss wants it and ``ex`` lacks it
        (``tssep_tpu/tasks/model.py:122-134``)."""
        if 'Vad' in self.loss.targets() and 'Vad' not in ex and 'vad' in ex:
            frames = stft_vad(np.asarray(ex['vad']), self.fe.window_length,
                              self.fe.shift, self.fe.fading)
            ex['Vad'] = np.asarray(frames, dtype=np.float32)
        return ex

    def _tensor(self, value, dtype=torch.float32):
        return torch.as_tensor(value, dtype=dtype, device=self.device)

    def _features(self, ex: dict) -> dict:
        """``ex`` with ``Input``, the features, made from what it brings:
        ``Input`` as it is, else from ``Observation``, else from
        ``observation``'s STFT (``tssep_tpu/tasks/model.py:343-358``)."""
        ref = ex['reference_channel']
        if 'Input' in ex:
            ex['Input'] = self._tensor(ex['Input'])
            if 'Observation' in ex:
                ex['Observation'] = self._tensor(ex['Observation'],
                                                 torch.complex64)
            return ex
        if 'Observation' not in ex:
            if not hasattr(self.fe, 'stft'):
                raise NotImplementedError(
                    'waveform feature extractors (KaldiMFCC, '
                    'features/kaldi.py) are not ported yet: ROADMAP Queue 1 '
                    'item 5')
            ex['Observation'] = self.fe.stft(self._tensor(ex['observation']))
        else:
            ex['Observation'] = self._tensor(ex['Observation'],
                                             torch.complex64)
        ex['Input'] = self.fe.stft_to_feature(
            ex['Observation'][..., ref, :, :]).float()
        return ex

    def forward(self, ex: dict, generator: torch.Generator | None = None,
                training=False) -> ForwardOutput:
        """Masks, the enhanced STFT and the separated waveforms of one batch
        ``ex``. ``generator`` draws the random speaker order (none: the
        input's order) and, when ``training``, the dropout. Serving
        (``training=False``) records no graph and returns every output;
        training keeps the graph and makes only the estimates that the
        loss reads."""
        with contextlib.nullcontext() if training else torch.no_grad():
            ex = self.pre_net_hook(self._features(dict(ex)))
            me_out = self.mask_estimator(
                ex['Input'], self._tensor(ex['auxInput']), generator,
                training)
            out = ForwardOutput(
                mask=me_out.mask, logit=me_out.logit,
                embedding=me_out.embedding, vad_mask=me_out.vad_mask,
                vad_logit=me_out.vad_logit)
            if 'Observation' not in ex:
                if not isinstance(self.loss, VADSigmoidBCE):
                    raise ValueError(
                        f'a batch without Observation has no estimate to '
                        f'train {self.loss.name} on; only VADSigmoidBCE '
                        f'trains from Input alone')
                return out
            wanted = self.loss.reads if training else {'stft_estimate',
                                                       'time_estimate'}
            re_im = getattr(self.enhancer, 're_im', None)
            if 'stft_estimate' in wanted or (
                    'time_estimate' in wanted and re_im is None):
                out.stft_estimate = self.enhancer(me_out.mask, ex)
            if 'time_estimate' in wanted and 'observation' in ex:
                estimate = (out.stft_estimate if re_im is None
                            else re_im(me_out.mask, ex))
                if estimate is not None:
                    out.time_estimate = self.fe.istft(
                        estimate, num_samples=ex['observation'].shape[-1])
            return out

    def review_loss(self, ex: dict, out: ForwardOutput):
        """The loss of a forward's output; returns (loss summed over the
        batch, per-example loss)."""
        loss_value = self.loss.from_ex_out(ex, out, self)
        return loss_value.sum(), loss_value

    def loss_fn(self, ex: dict, generator: torch.Generator | None = None,
                training=True):
        """The function the trainer differentiates: (scalar loss,
        ``{'per_example_loss': ...}``)."""
        out = self.forward(ex, generator, training=training)
        loss_sum, loss_value = self.review_loss(ex, out)
        return loss_sum, {'per_example_loss': loss_value}
