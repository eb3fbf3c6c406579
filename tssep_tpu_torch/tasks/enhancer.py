"""Training-time enhancers, mask -> STFT estimate: port of
``tssep_tpu/tasks/enhancer.py``.

``Masking`` multiplies the reference channel's observation by the mask;
``SoudenMVDR`` (alias ``TorchBF``) is the differentiable MVDR of the masked
PSDs: a complex linear solve and a trace normalization in complex64, plain
torch as the JAX package's is plain ``jnp``. ``Nothing`` passes the
reference channel through, ``Dummy`` gives no estimate.
"""

from __future__ import annotations

import numpy as np
import torch

from tssep_tpu_torch.utils.factory import factory_name

__all__ = ['Enhancer', 'Dummy', 'Nothing', 'Masking', 'SoudenMVDR', 'TorchBF',
           'enhancer_from_config']


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


class Enhancer:
    @property
    def name(self):
        return type(self).__name__

    def __call__(self, masks, ex):
        raise NotImplementedError


class Dummy(Enhancer):
    def __call__(self, masks, ex):
        return None


class Nothing(Enhancer):
    """The reference channel's observation, the mask ignored."""

    def __call__(self, masks, ex):
        return _ref_channel_obs(masks, ex)[..., None, :, :]


class Masking(Enhancer):
    """``Observation[ref] * mask``; masks are (B?, S, 1, T, F)."""

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


def _trace(a):
    return a.diagonal(dim1=-2, dim2=-1).sum(dim=-1)


class SoudenMVDR(Enhancer):
    """Differentiable MVDR (Souden) beamformer from estimated masks.

    masks: (..., spk, nmask, time, freq), nmask 1 (the interference mask is
    1 - target) or 2 (an explicit interference mask); Observation: (...,
    mic, time, freq) complex. Returns (..., spk, time, freq)."""

    def __init__(self, bf='mvdr_souden', masking=False, masking_eps=0.0,
                 eps=None, diagonal_loading=0.0):
        if bf != 'mvdr_souden':
            raise ValueError(f"bf must be 'mvdr_souden', got {bf!r}")
        self.bf = bf
        self.masking = masking
        self.masking_eps = masking_eps
        self.eps = eps
        self.diagonal_loading = diagonal_loading

    def __call__(self, masks, ex):
        observation = ex['Observation']
        reference_channel = ex['reference_channel']
        cdtype = observation.dtype
        conj = observation.conj()

        def psd(m):                               # (..., k, f, d, D)
            return torch.einsum('...ktf,...dtf,...Dtf->...kfdD', m,
                                observation, conj)

        if masks.shape[-3] == 2:
            m = masks.to(cdtype)
            target_psd, interference_psd = psd(m[..., 0, :, :]), psd(
                m[..., 1, :, :])
        elif masks.shape[-3] == 1:
            m = masks.squeeze(-3).to(cdtype)
            target_psd, interference_psd = psd(m), psd(1 - m)
        else:
            raise ValueError(tuple(masks.shape))

        if self.diagonal_loading:
            d = observation.shape[-3]
            tr = _trace(interference_psd).real
            eye = torch.eye(d, dtype=cdtype, device=observation.device)
            interference_psd = interference_psd + (
                self.diagonal_loading * tr[..., None, None] / d) * eye

        phi = torch.linalg.solve(interference_psd, target_psd)
        lambda_ = _trace(phi)[..., None, None]
        eps = np.finfo(np.float32).tiny if self.eps is None else self.eps
        mat = phi / lambda_.real.clamp(min=eps)
        beamformer = mat[..., reference_channel]
        enh = torch.einsum('...kfd,...dtf->...ktf', beamformer.conj(),
                           observation)
        if self.masking:
            enh = enh * masks[..., :, 0, :, :].clamp(min=self.masking_eps)
        return enh


#: Name used by the reference's configs.
TorchBF = SoudenMVDR

_ENHANCERS = {'Dummy': Dummy, 'Nothing': Nothing, 'Masking': Masking,
              'SoudenMVDR': SoudenMVDR, 'TorchBF': SoudenMVDR}


def enhancer_from_config(config=None) -> Enhancer:
    """An enhancer from the JAX configuration's form, ``{'factory': name,
    **kwargs}`` with the class's name or dotted path; ``Masking()`` for
    None, as the JAX ``Model`` defaults."""
    if config is None:
        return Masking()
    config = dict(config)
    name = factory_name(config.pop('factory', 'Masking'))
    if name not in _ENHANCERS:
        raise ValueError(f'unknown enhancer {name!r}')
    return _ENHANCERS[name](**config)
