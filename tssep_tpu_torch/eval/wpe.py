"""Weighted prediction error (WPE) dereverberation: port of
``tssep_tpu/eval/wpe.py``. ``wpe``, ``WPE`` and ``ChannelWiseWPE`` are
copies (numpy float64 on the host); ``wpe_torch`` is the counterpart of
``wpe_jax`` (:122-200), the same real/imaginary block solve on a torch
device, in float64 for a host array (the host path's precision, which the
card computes; ``wpe_jax`` runs float32, the TPU's) and in the tensors' own
dtype for a ``(real, imag)`` pair.

Native equivalent of the nara_wpe ``wpe_v8`` capability the reference wraps
(``tssep/train/enhancer.py:292-367``; defaults taps=10, delay=2,
iterations=3).  Iterative MIMO linear prediction per frequency:

    for it in iterations:
        power[f, t]   = mean_d |X[f, d, t]|^2
        Y_tilde       = stacked taps of Y delayed by delay..delay+taps-1
        R             = Y_tilde diag(1/power) Y_tilde^H
        P             = Y_tilde diag(1/power) Y^H
        G             = solve(R, P)
        X             = Y - G^H Y_tilde

``statistics_mode='full'`` uses zero-padded history (every output frame has
a prediction); ``'valid'`` computes the correlations only where the full tap
history exists.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tssep_tpu_torch.utils.device import resolve_device

__all__ = ['wpe', 'wpe_torch', 'WPE', 'ChannelWiseWPE', 'build_tap_stack']

#: ``backend`` names: the port's ``'torch'`` and the JAX package's
#: ``'jax'``, which a configuration written for it names and which is read
#: as ``'torch'`` (as ``import_class`` reads ``tssep_tpu.`` factory paths).
_BACKENDS = {'numpy': 'numpy', 'torch': 'torch', 'jax': 'torch'}


def build_tap_stack(y, taps, delay):
    """y: (F, D, T) -> (F, D*taps, T): channel-major stack of delayed frames
    (tap k = delay + k)."""
    f, d, t = y.shape
    out = np.zeros((f, d * taps, t), dtype=y.dtype)
    for k in range(taps):
        shift = delay + k
        if shift < t:
            out[:, k * d:(k + 1) * d, shift:] = y[:, :, :t - shift]
    return out


def wpe(y, taps=10, delay=2, iterations=3, psd_context=0,
        statistics_mode='full', eps=1e-10):
    """Dereverberate y (F, D, T) complex -> same shape."""
    y = np.asarray(y)
    f, d, t = y.shape
    y_tilde = build_tap_stack(y, taps, delay)
    x = y.copy()
    for _ in range(iterations):
        power = np.mean(np.abs(x) ** 2, axis=1)  # (F, T)
        if psd_context:
            kernel = np.ones(2 * psd_context + 1)
            power = np.stack([
                np.convolve(p, kernel, mode='same')
                / np.convolve(np.ones_like(p), kernel, mode='same')
                for p in power])
        inv_power = 1.0 / np.maximum(power, eps)

        if statistics_mode == 'valid':
            s = slice(delay + taps - 1, None)
        else:
            s = slice(None)
        yt = y_tilde[..., s]
        ys = y[..., s]
        w = inv_power[:, None, s]
        r = np.einsum('fat,fbt->fab', yt * w, yt.conj())
        p = np.einsum('fat,fbt->fab', yt * w, ys.conj())
        # regularize
        r += eps * np.trace(r, axis1=-2, axis2=-1).real[:, None, None] \
            * np.eye(d * taps) / (d * taps) + eps * np.eye(d * taps)
        g = np.linalg.solve(r, p)  # (F, D*taps, D)
        x = y - np.einsum('fab,fat->fbt', g.conj(), y_tilde)
    return x


class WPE:
    """Config-compatible wrapper (reference ``enhancer.py:292-348``):
    operates on (D, T, F) layout.

    ``backend='numpy'`` runs the host path (float64 on a complex128
    observation); ``'torch'`` (or the JAX package's ``'jax'``) runs
    :func:`wpe_torch` on ``device`` (the reference's torch ``wpe_v8``
    branch equivalent, ``enhancer.py:316-347``) — same iteration, float64.
    Another name raises."""

    def __init__(self, taps=10, delay=2, iterations=3, psd_context=0,
                 statistics_mode='full', backend='numpy', *, device='cuda'):
        if backend not in _BACKENDS:
            raise ValueError(f'WPE backend {backend!r}: one of '
                             f'{sorted(_BACKENDS)}')
        self.taps = taps
        self.delay = delay
        self.iterations = iterations
        self.psd_context = psd_context
        self.statistics_mode = statistics_mode
        self.backend = _BACKENDS[backend]
        self.device = device

    def __call__(self, observation, inplace=False):
        obs = np.asarray(observation)
        y = np.transpose(obs, (2, 0, 1))  # d t f -> f d t
        if self.backend == 'torch':
            if self.psd_context or self.statistics_mode != 'full':
                raise ValueError(
                    'backend=torch supports psd_context=0, '
                    'statistics_mode=full')
            z = wpe_torch(y, taps=self.taps, delay=self.delay,
                          iterations=self.iterations, device=self.device)
        else:
            z = wpe(y, taps=self.taps, delay=self.delay,
                    iterations=self.iterations, psd_context=self.psd_context,
                    statistics_mode=self.statistics_mode)
        return np.transpose(z, (1, 2, 0))


class ChannelWiseWPE(WPE):
    """Apply WPE per channel (channels folded into frequency)."""

    def __call__(self, observation, inplace=False):
        obs = np.asarray(observation)
        d, t, f = obs.shape
        folded = obs.transpose(1, 0, 2).reshape(1, t, d * f)
        out = super().__call__(folded)
        return out.reshape(t, d, f).transpose(1, 0, 2)


# ---------------------------------------------------------------------------
# On-device WPE (torch)
# ---------------------------------------------------------------------------

def _wpe_torch_impl(yr, yi, taps, delay, iterations, eps):
    """``_wpe_jax_impl`` (``tssep_tpu/eval/wpe.py:122-177``) on torch
    tensors: complex arithmetic as real/imaginary pairs, the complex solve
    as the real 2x2 block system."""
    f, d, t = yr.shape
    k = d * taps

    def tap_stack(a):
        parts = [F.pad(a, (shift, 0))[:, :, :t] if shift < t
                 else torch.zeros_like(a)
                 for shift in range(delay, delay + taps)]
        return torch.cat(parts, dim=1)                   # (F, D*taps, T)

    ytr, yti = tap_stack(yr), tap_stack(yi)
    xr, xi = yr, yi
    eye = torch.eye(k, dtype=yr.dtype, device=yr.device)
    for _ in range(iterations):
        power = torch.mean(xr ** 2 + xi ** 2, dim=1)     # (F, T)
        w = 1.0 / torch.clamp(power, min=eps)            # (F, T)
        wr, wi = ytr * w[:, None, :], yti * w[:, None, :]
        # R = Yt W Yt^H (complex, via real parts)
        rr = (torch.einsum('fat,fbt->fab', wr, ytr)
              + torch.einsum('fat,fbt->fab', wi, yti))
        ri = (torch.einsum('fat,fbt->fab', wi, ytr)
              - torch.einsum('fat,fbt->fab', wr, yti))
        # P = Yt W Y^H
        pr = (torch.einsum('fat,fbt->fab', wr, yr)
              + torch.einsum('fat,fbt->fab', wi, yi))
        pi = (torch.einsum('fat,fbt->fab', wi, yr)
              - torch.einsum('fat,fbt->fab', wr, yi))
        # Regularize like the host path
        tr = torch.diagonal(rr, dim1=-2, dim2=-1).sum(-1)[:, None, None]
        rr = rr + (eps * tr / k + eps) * eye
        m = torch.cat([torch.cat([rr, -ri], dim=-1),
                       torch.cat([ri, rr], dim=-1)], dim=-2)  # (F, 2K, 2K)
        rhs = torch.cat([pr, pi], dim=-2)                      # (F, 2K, D)
        g = torch.linalg.solve(m, rhs)
        gr, gi = g[:, :k, :], g[:, k:, :]
        # x = y - G^H Yt  (x_b = y_b - sum_a conj(g_ab) yt_a)
        xr = yr - (torch.einsum('fab,fat->fbt', gr, ytr)
                   + torch.einsum('fab,fat->fbt', gi, yti))
        xi = yi - (torch.einsum('fab,fat->fbt', gr, yti)
                   - torch.einsum('fab,fat->fbt', gi, ytr))
    return xr, xi


def wpe_torch(y, taps=10, delay=2, iterations=3, eps=1e-10, device='cuda'):
    """On-device WPE: the iteration of :func:`wpe`
    (``statistics_mode='full'``) on a torch device, with ``wpe_jax``'s
    real/imaginary block solve.

    y: (F, D, T) complex numpy array (host), computed in float64 on
    ``device`` (the host path's precision; ``wpe_jax``'s float32 solves the
    1/power-weighted statistics less exactly) and returned as complex128;
    or a ``(real, imag)`` tuple of tensors, which stay on their device and
    dtype and come back as such a tuple.
    """
    if isinstance(y, tuple):
        yr, yi = y
        return _wpe_torch_impl(yr, yi, taps, delay, iterations, eps)
    device = resolve_device(device)
    y = np.asarray(y)
    xr, xi = _wpe_torch_impl(
        torch.as_tensor(y.real, dtype=torch.float64, device=device),
        torch.as_tensor(y.imag, dtype=torch.float64, device=device),
        taps, delay, iterations, eps)
    return torch.complex(xr, xi).cpu().numpy()
