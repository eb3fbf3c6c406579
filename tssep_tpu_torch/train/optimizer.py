"""The optimizer of the flagship's training step: port of ``Adam`` in
``tssep_tpu/train/optimizer.py``, which chains optax's
``clip_by_global_norm(gradient_clipping)`` and ``adam``.

The clip is written here, as optax writes it: below ``max_norm`` the
gradients stay as they are, above it each is scaled by ``max_norm / norm``
(``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead). The
update is ``torch.optim.Adam``, the same formula as optax's ``adam``
(``eps`` outside the square root, bias correction on both moments). Neither
step reads a value back to the host.

amsgrad, weight decay and multi-step accumulation are not ported yet and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

__all__ = ['Adam', 'ClippedAdam', 'clip_by_global_norm_']


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm):
    """Scales ``grads`` in place by ``max_norm / norm`` where their global
    norm is at least ``max_norm`` (optax ``clip_by_global_norm``); returns
    the norm as a tensor."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


class ClippedAdam:
    """Clip by global norm, then one Adam step, over ``params``."""

    def __init__(self, params, gradient_clipping, lr, betas, eps):
        self.params = [p for p in params if p.requires_grad]
        self.gradient_clipping = gradient_clipping
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=betas, eps=eps,
                                     foreach=True)

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def step(self):
        """Clips the gradients and updates the parameters; returns the
        gradients' global norm before the clip, as a tensor (None without
        clipping)."""
        norm = None
        if self.gradient_clipping:
            norm = clip_by_global_norm_(
                [p.grad for p in self.params if p.grad is not None],
                self.gradient_clipping)
        self.adam.step()
        return norm


class Adam:
    """Adam with gradient clipping, configured as the JAX package's
    (``lr`` 1e-3, clipping at 10)."""

    def __init__(self, gradient_clipping=10, lr=0.001, betas=(0.9, 0.999),
                 eps=1e-08, weight_decay=0, amsgrad=False):
        if amsgrad:
            raise NotImplementedError('Adam: amsgrad is not ported yet')
        if weight_decay:
            raise NotImplementedError('Adam: weight decay is not ported yet')
        self.gradient_clipping = gradient_clipping
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps

    def make(self, params, every_k_steps: int = 1) -> ClippedAdam:
        if every_k_steps and every_k_steps > 1:
            raise NotImplementedError('Adam: multi-step accumulation is not '
                                      'ported yet')
        return ClippedAdam(params, self.gradient_clipping, self.lr,
                           self.betas, self.eps)
