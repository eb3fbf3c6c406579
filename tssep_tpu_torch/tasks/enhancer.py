"""Masking enhancer: port of ``Masking`` in ``tssep_tpu/tasks/enhancer.py``."""

from __future__ import annotations

__all__ = ['Masking']


def _ref_channel_obs(masks, ex):
    """The reference channel of ``ex['Observation']`` (B?, C, T, F)."""
    reference_channel = ex['reference_channel']
    observation = ex['Observation']
    batched = {4: False, 5: True}[masks.dim()]
    if reference_channel is None:
        if observation.dim() != (3 if batched else 2):
            raise ValueError(tuple(observation.shape))
        return observation
    if observation.dim() != (4 if batched else 3):
        raise ValueError(tuple(observation.shape))
    return observation[..., reference_channel, :, :]


class Masking:
    """``Observation[ref] * mask``; masks are (B?, S, 1, T, F)."""

    @property
    def name(self):
        return type(self).__name__

    def __call__(self, masks, ex):
        obs = _ref_channel_obs(masks, ex)
        return obs[..., None, :, :] * masks.squeeze(-3)

    def re_im(self, masks, ex):
        """(re, im) of the masked STFT without forming the complex product:
        the mask is real, so ``real(obs * m) == real(obs) * m``."""
        obs = _ref_channel_obs(masks, ex)
        m = masks.squeeze(-3)
        re = obs.real[..., None, :, :].to(m.dtype)
        im = obs.imag[..., None, :, :].to(m.dtype)
        return re * m, im * m
