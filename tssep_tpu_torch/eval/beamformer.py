"""Offline beamforming library (numpy, float64/complex128): a copy of
``tssep_tpu/eval/beamformer.py``, run on the host as there.

Native equivalent of the pb_bss extraction capabilities the reference's eval
enhancer dispatches to (``tssep/train/enhancer.py:497-537``):
``get_bf_vector`` with mvdr_souden / wmwf / rank1_gev+mvdr_souden /
scaled_gev_atf+mvdr / ch0 / ch1, plus masked PSD estimation with Hermitian
symmetrization (``enhancer.py:268-289``).

Shapes: PSDs are (..., F, D, D); beamforming vectors (..., F, D);
observations (F, D, T) (frequency-major, matching the segment loop).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    'get_psd', 'condition_covariance', 'get_bf_vector',
    'apply_beamforming_vector', 'mvdr_souden', 'wmwf', 'gev',
    'rank1_gev_mvdr_souden', 'scaled_gev_atf_mvdr', 'blind_analytic_normalization',
]


def get_psd(mask, observation, mask_power=1, symmetrize='real'):
    """Masked PSD pair (target, distortion) from a 2-mask stack.

    mask: (2, F, T) [target, distortion]; observation: (F, D, T).
    Returns two (F, D, D) PSDs, normalized by T.

    ``symmetrize='real'`` reproduces the reference's eval-path
    symmetrization ``(A + A^T)/2`` (``enhancer.py:288``) which — A being
    Hermitian — equals taking the real part; this is the parity default.
    ``'hermitian'`` keeps the complex Hermitian PSD (mathematically the
    full spatial statistic; pair with diagonal loading for stability).
    """
    if mask_power != 1:
        mask = mask ** mask_power
    psd = np.einsum('...t,...dt,...Dt->...dD', mask, observation,
                    observation.conj()) / observation.shape[-1]
    if symmetrize == 'real':
        psd = (psd + np.swapaxes(psd, -2, -1)) / 2
    elif symmetrize == 'hermitian':
        psd = (psd + np.swapaxes(psd, -2, -1).conj()) / 2
    else:
        raise ValueError(symmetrize)
    return psd


def condition_covariance(x, gamma=1e-10):
    """Diagonal loading: x + gamma * trace(x)/D * I."""
    d = x.shape[-1]
    scale = gamma * np.einsum('...dd->...', x).real[..., None, None] / d
    return x + scale * np.eye(d)


def apply_beamforming_vector(vector, mix):
    """vector: (..., F, D); mix: (..., F, D, T) -> (..., F, T)."""
    return np.einsum('...d,...dt->...t', vector.conj(), mix)


# ---------------------------------------------------------------------------
# Beamformers
# ---------------------------------------------------------------------------

def mvdr_souden(target_psd, noise_psd, ref_channel=0, eps=None):
    """w = (Rn^-1 Rx / trace(Rn^-1 Rx)) e_ref (Souden formulation)."""
    phi = np.linalg.solve(condition_covariance(noise_psd, 1e-10), target_psd)
    lambda_ = np.trace(phi, axis1=-2, axis2=-1)[..., None, None]
    if eps is None:
        eps = np.finfo(lambda_.dtype).tiny
    mat = phi / np.maximum(lambda_.real, eps)
    return mat[..., ref_channel]


def wmwf(target_psd, noise_psd, reference_channel=0, distortion_weight=1.0):
    """Speech-distortion-weighted multichannel Wiener filter:
    w = (Rx + mu*Rn)^-1 Rx e_ref."""
    denom = target_psd + distortion_weight * noise_psd
    mat = np.linalg.solve(condition_covariance(denom, 1e-10), target_psd)
    return mat[..., reference_channel]


def gev(target_psd, noise_psd, whitening_gamma=0.3):
    """Principal generalized eigenvector of (Rx, Rn), per frequency.

    ``whitening_gamma`` diagonally loads Rn *for the whitening only*
    (trace-relative).  Segment-level noise PSDs are estimated from few
    frames (the eval loop beamforms per VAD segment, reference
    ``enhancer.py:514-548``) and an undersampled Rn makes the raw GEV
    direction estimate erratic; loading interpolates toward plain PCA of
    the target PSD, which is the right ATF estimator when the noise
    statistic is uninformative.  0.3 reaches MVDR-class SDR on the CACG
    fixture at both segment and full-recording scale (see
    ``tests/test_eval.py`` quality bars); pass 0 for the textbook GEV.
    """
    noise_psd = condition_covariance(noise_psd, max(whitening_gamma, 1e-10))
    # Whiten: Rn = L L^H; solve ordinary eig on L^-1 Rx L^-H
    l = np.linalg.cholesky(noise_psd)
    l_inv = np.linalg.inv(l)
    m = l_inv @ target_psd @ np.swapaxes(l_inv, -2, -1).conj()
    m = (m + np.swapaxes(m, -2, -1).conj()) / 2
    _, vecs = np.linalg.eigh(m)
    w_white = vecs[..., -1]
    w = np.einsum('...dD,...D->...d',
                  np.swapaxes(l_inv, -2, -1).conj(), w_white)
    w = w / np.maximum(np.linalg.norm(w, axis=-1, keepdims=True), 1e-18)
    # Resolve the per-frequency eigenvector phase ambiguity (would otherwise
    # scramble phases across frequencies after ISTFT): align to channel 0.
    ref = w[..., 0:1]
    phase = ref / np.maximum(np.abs(ref), 1e-18)
    return w * phase.conj()


def blind_analytic_normalization(vector, noise_psd):
    """BAN postfilter scaling for GEV beamformers."""
    nom = np.sqrt(np.abs(np.einsum(
        '...a,...ab,...bc,...c->...', vector.conj(), noise_psd, noise_psd,
        vector)))
    denom = np.abs(np.einsum(
        '...a,...ab,...b->...', vector.conj(), noise_psd, vector))
    return vector * (nom / np.maximum(denom, 1e-18))[..., None]


def gev_atf(target_psd, noise_psd):
    """ATF (steering-vector) estimate from the GEV principal component.

    For a rank-1 target ``Rx = s·a·a^H`` the generalized eigenvector is
    ``w ∝ Rn^-1 a``, so the spatial *direction* of the target is
    ``a ∝ Rn·w`` — NOT ``w`` itself (pb_bss ``get_gev_atf_vector``
    semantics).  Returned unit-norm with the per-frequency eigenvector
    phase ambiguity resolved against channel 0."""
    w = gev(target_psd, noise_psd)
    a = np.einsum('...ab,...b->...a', noise_psd, w)
    a = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-18)
    ref = a[..., 0:1]
    phase = ref / np.maximum(np.abs(ref), 1e-18)
    return a * phase.conj()


def rank1_gev_mvdr_souden(target_psd, noise_psd, ref_channel=0):
    """Rank-1 reconstruction of the target PSD from the GEV-based ATF
    (``a ∝ Rn·w_gev``, trace-preserving scale), then MVDR-Souden."""
    a = gev_atf(target_psd, noise_psd)
    scale = np.einsum('...aa->...', target_psd).real
    rank1 = scale[..., None, None] * np.einsum(
        '...a,...b->...ab', a, a.conj())
    return mvdr_souden(rank1, noise_psd, ref_channel=ref_channel)


def scaled_gev_atf_mvdr(target_psd, noise_psd, ref_channel=0):
    """ATF estimate from the scaled GEV vector, then classic MVDR:
    w = Rn^-1 a / (a^H Rn^-1 a)."""
    w = gev(target_psd, noise_psd)
    # Scale the GEV vector into an ATF estimate: a ∝ Rn w (principal
    # component of Rx in the GEV metric), normalized to ref channel.
    a = np.einsum('...ab,...b->...a', noise_psd, w)
    ref = a[..., ref_channel][..., None]
    a = a / np.where(np.abs(ref) < 1e-18, 1, ref)
    noise_psd = condition_covariance(noise_psd, 1e-10)
    rn_inv_a = np.linalg.solve(noise_psd, a[..., None])[..., 0]
    denom = np.einsum('...a,...a->...', a.conj(), rn_inv_a)
    return rn_inv_a / np.maximum(denom.real, 1e-18)[..., None]


_DISPATCH = {
    'mvdr_souden': mvdr_souden,
    'wmwf': wmwf,
    'rank1_gev+mvdr_souden': rank1_gev_mvdr_souden,
    'scaled_gev_atf+mvdr': scaled_gev_atf_mvdr,
}


def get_bf_vector(name, target_psd, noise_psd, **kwargs):
    """Dispatch like pb_bss ``get_bf_vector`` (reference use
    ``enhancer.py:531-533``).  'ch0'/'ch1' select a channel directly."""
    if name in ('ch0', 'ch1'):
        d = target_psd.shape[-1]
        ch = int(name[2:])
        e = np.zeros(target_psd.shape[:-2] + (d,), dtype=target_psd.dtype)
        e[..., ch] = 1
        return e
    return _DISPATCH[name](target_psd, noise_psd, **kwargs)
