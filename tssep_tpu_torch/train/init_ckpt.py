"""Warm-start initialization, including the VAD->SEP head broadcast: port of
``tssep_tpu/train/init_ckpt.py``, on named tensors.

``InitCheckPoint`` loads a checkpoint's named model parameters (either
package's ``ckpt_*.npz``); ``InitCheckPointVAD2Sep`` first broadcasts the
listed parameters along their mismatched dims with ``repeat``
(``np.repeat`` / ``torch.repeat_interleave``) semantics: the per-frame
TS-VAD activity head becomes a per-(frame, freq) TS-SEP mask head, each
activity neuron tiled over its frequency bins (reference
``init_ckpt.py:40-89``)."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from tssep_tpu_torch.config.configurable import Configurable
from tssep_tpu_torch.train import checkpoint as ckpt_lib

__all__ = ['InitCheckPoint', 'InitCheckPointVAD2Sep', 'broadcast_param']


def broadcast_param(p: np.ndarray, desired_shape, mode='repeat') -> np.ndarray:
    """Grow ``p`` to ``desired_shape`` along mismatched dims.

    mode 'repeat': [0, 1, 2] -> [0, 0, 1, 1, 2, 2]  (np.repeat)
    mode 'tile':   [0, 1, 2] -> [0, 1, 2, 0, 1, 2]  (np.tile)
    """
    assert len(p.shape) == len(desired_shape), (p.shape, desired_shape)
    for i, (actual, desired) in enumerate(zip(p.shape, desired_shape)):
        if actual == desired:
            continue
        assert actual < desired and desired % actual == 0, \
            (p.shape, desired_shape, i)
        reps = desired // actual
        if mode == 'repeat':
            p = np.repeat(p, reps, axis=i)
        elif mode == 'tile':
            p = np.concatenate([p] * reps, axis=i)
        else:
            raise ValueError(mode)
    return p


@dataclasses.dataclass
class InitCheckPoint(Configurable):
    init_ckpt: str = None
    strict: bool = True

    def _transform(self, named: dict, template_named: dict) -> dict:
        return named

    def load_model_state_dict(self, eg, ckpt):
        """Loads ``ckpt``'s parameters into ``eg.trainer.model``; returns
        the model."""
        ckpt = Path(ckpt)
        assert ckpt.exists(), ckpt
        trainer = eg.trainer
        trainer.ensure_init()
        named, _, _ = ckpt_lib.load_checkpoint(ckpt)
        template_named = ckpt_lib.params_to_named(trainer.model)
        named = self._transform(dict(named), template_named)
        ckpt_lib.named_to_params(named, trainer.model, strict=self.strict)
        return trainer.model

    def __call__(self, eg):
        if self.init_ckpt is not None:
            self.load_model_state_dict(eg, self.init_ckpt)


@dataclasses.dataclass
class InitCheckPointVAD2Sep(InitCheckPoint):
    bcast: tuple = (
        'mask_estimator.post_net.linear2.weight',
        'mask_estimator.post_net.linear2.bias',
    )
    mode: str = 'repeat'

    def _transform(self, named, template_named):
        for k in self.bcast:
            if k not in template_named:
                raise KeyError(
                    f'bcast key {k!r} not in model params: '
                    f'{sorted(template_named)[:10]}...')
            desired = template_named[k].shape
            named[k] = broadcast_param(np.asarray(named[k]), desired,
                                       mode=self.mode)
        return named
