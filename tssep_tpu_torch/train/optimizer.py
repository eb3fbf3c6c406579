"""The optimizers of the training step: port of ``tssep_tpu/train/optimizer.py``,
which chains optax's ``clip_by_global_norm(gradient_clipping)`` with
``adam``, ``amsgrad``, ``adamw`` (Adam with ``weight_decay``) or ``sgd``,
wrapped in ``optax.MultiSteps`` for gradient accumulation (the recipes'
``virtual_minibatch_size``).

The clip is written here, as optax writes it: below ``max_norm`` the
gradients stay as they are, above it each is scaled by ``max_norm / norm``
(``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead).
The updates are torch's where its formula is optax's: ``torch.optim.Adam``
for ``adam`` (``eps`` outside the square root, bias correction on both
moments), ``torch.optim.AdamW`` for ``adamw`` (decoupled decay, ``lr *
weight_decay * p``), ``torch.optim.SGD`` for ``sgd`` (momentum as optax's
trace, the first step's buffer the gradient). ``amsgrad`` is written here:
optax keeps the running maximum of the bias-corrected second moment, torch
the maximum of the raw one. ``MultiSteps`` averages the gradients of k
calls and updates on the k-th, as optax's running mean does. No step reads
a value back to the host.
"""

from __future__ import annotations

import torch

__all__ = ['Adam', 'SGD', 'ClippedOptimizer', 'MultiSteps', 'AMSGrad',
           'clip_by_global_norm_']


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


class AMSGrad(torch.optim.Optimizer):
    """optax's ``amsgrad``: ``p -= lr m_hat / (sqrt(max_t v_hat) + eps)``,
    with m_hat and v_hat the bias-corrected moments."""

    def __init__(self, params, lr, betas, eps):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group['betas']
            params = [p for p in group['params'] if p.grad is not None]
            if not params:
                continue
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st['step'] = 0
                    for key in ('mu', 'nu', 'nu_max'):
                        st[key] = torch.zeros_like(p)
            step = states[0]['step'] + 1
            grads = [p.grad for p in params]
            mu = [st['mu'] for st in states]
            nu = [st['nu'] for st in states]
            nu_max = [st['nu_max'] for st in states]
            torch._foreach_lerp_(mu, grads, 1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, 1 - b2)
            nu_hat = torch._foreach_div(nu, 1 - b2 ** step)
            torch._foreach_maximum_(nu_max, nu_hat)
            denom = torch._foreach_sqrt(nu_max)
            torch._foreach_add_(denom, group['eps'])
            mu_hat = torch._foreach_div(mu, 1 - b1 ** step)
            torch._foreach_div_(mu_hat, denom)
            torch._foreach_add_(params, mu_hat, alpha=-group['lr'])
            for st in states:
                st['step'] = step


class ClippedOptimizer:
    """Clip by global norm, then one step of ``update``, a
    ``torch.optim.Optimizer`` over ``params``."""

    def __init__(self, params, gradient_clipping, update):
        self.params = list(params)
        self.gradient_clipping = gradient_clipping
        self.update = update

    def zero_grad(self):
        self.update.zero_grad(set_to_none=True)

    def step(self):
        """Clips the gradients and updates the parameters; returns the
        gradients' global norm before the clip, as a tensor (None without
        clipping)."""
        norm = None
        if self.gradient_clipping:
            norm = clip_by_global_norm_(
                [p.grad for p in self.params if p.grad is not None],
                self.gradient_clipping)
        self.update.step()
        return norm


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_steps)``: each ``step`` adds the
    gradients to a running mean, ``acc + (g - acc) / (n + 1)``; the k-th
    runs ``inner`` on the mean and starts over. ``zero_grad`` clears the
    gradients, not the mean. ``step`` returns the inner step's result on
    the k-th call, None on the others."""

    def __init__(self, inner: ClippedOptimizer, every_k_steps: int):
        self.inner = inner
        self.every_k_steps = every_k_steps
        self.params = inner.params
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self):
        self.inner.zero_grad()

    @torch.no_grad()
    def step(self):
        n = self.mini_step
        for acc, p in zip(self.acc, self.params):
            if p.grad is not None:
                acc.add_((p.grad - acc) / (n + 1))
        self.mini_step = (n + 1) % self.every_k_steps
        if self.mini_step:
            return None
        for acc, p in zip(self.acc, self.params):
            p.grad = acc.clone()
        result = self.inner.step()
        for acc in self.acc:
            acc.zero_()
        return result


def _accumulated(opt, every_k_steps):
    return MultiSteps(opt, every_k_steps) if (
        every_k_steps and every_k_steps > 1) else opt


class Adam:
    """Adam with gradient clipping, configured as the JAX package's
    (``lr`` 1e-3, clipping at 10); ``amsgrad`` as optax's ``amsgrad``
    (which then ignores ``weight_decay``, as the JAX package does), else
    ``weight_decay`` as optax's ``adamw``."""

    def __init__(self, gradient_clipping=10, lr=0.001, betas=(0.9, 0.999),
                 eps=1e-08, weight_decay=0, amsgrad=False):
        self.gradient_clipping = gradient_clipping
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.amsgrad = amsgrad

    def make(self, params, every_k_steps: int = 1):
        params = [p for p in params if p.requires_grad]
        if self.amsgrad:
            update = AMSGrad(params, self.lr, self.betas, self.eps)
        elif self.weight_decay:
            update = torch.optim.AdamW(params, lr=self.lr, betas=self.betas,
                                       eps=self.eps,
                                       weight_decay=self.weight_decay,
                                       foreach=True)
        else:
            update = torch.optim.Adam(params, lr=self.lr, betas=self.betas,
                                      eps=self.eps, foreach=True)
        return _accumulated(
            ClippedOptimizer(params, self.gradient_clipping, update),
            every_k_steps)


class SGD:
    """SGD with gradient clipping and optional momentum, configured as the
    JAX package's (``lr`` 0.01, clipping at 10)."""

    def __init__(self, gradient_clipping=10, lr=0.01, momentum=0.0):
        self.gradient_clipping = gradient_clipping
        self.lr = lr
        self.momentum = momentum

    def make(self, params, every_k_steps: int = 1):
        params = [p for p in params if p.requires_grad]
        update = torch.optim.SGD(params, lr=self.lr,
                                 momentum=self.momentum or 0, foreach=True)
        return _accumulated(
            ClippedOptimizer(params, self.gradient_clipping, update),
            every_k_steps)
