"""Separation / diarization metrics (numpy, float64): a copy of
``tssep_tpu/eval/metrics.py``, run on the host as there.

- ``si_sdr``: scale-invariant SDR.
- ``ci_sdr``: convolutive-transfer-function-invariant SDR (optimal 512-tap
  FIR projection of the reference onto the estimate) — the metric the
  reference's beamformer doctests pin (23.66/20.02 dB,
  ``enhancer.py:186-213``).
- ``bss_eval_sources_sdr``: mir_eval-style BSS-Eval SDR (projection onto
  delayed copies of all sources; 512 taps).
- ``der``: diarization error rate with optimal speaker mapping and optional
  collar.
"""

from __future__ import annotations


import numpy as np
import scipy.linalg
import scipy.signal

__all__ = ['si_sdr', 'ci_sdr', 'bss_eval_sources_sdr', 'der',
           'pit_permutation']


def si_sdr(reference, estimate, eps=1e-12):
    """Scale-invariant SDR.

    A (near-)silent estimate is a *catastrophic* separation failure, not a
    mediocre one: naively both the projected target and the residual are ~0
    and the ratio collapses to a plausible-looking 0.0 dB (this is exactly
    how the round-3 all-silence rehearsal eval hid as "mean_si_sdr 0.0").
    Such estimates score ``-inf`` so downstream aggregation must confront
    them (``eval.run`` flags them as ``degenerate``)."""
    reference = np.asarray(reference, dtype=np.float64)
    estimate = np.asarray(estimate, dtype=np.float64)
    ref_power = np.sum(reference ** 2, axis=-1)
    est_power = np.sum(estimate ** 2, axis=-1)
    alpha = (np.sum(reference * estimate, axis=-1, keepdims=True)
             / np.maximum(ref_power[..., None], eps))
    target = alpha * reference
    noise = estimate - target
    out = 10 * np.log10(
        np.maximum(np.sum(target ** 2, axis=-1), eps)
        / np.maximum(np.sum(noise ** 2, axis=-1), eps))
    # degenerate: estimate has (essentially) no energy relative to what a
    # real estimate of this reference would carry
    degenerate = est_power <= eps * np.maximum(ref_power, 1.0)
    return np.where(degenerate, -np.inf, out)


def _project_fir(reference, estimate, taps):
    """LS-optimal FIR (length taps) filtering of reference to approximate
    estimate.  Returns the filtered reference (same length as estimate)."""
    t = len(estimate)
    # Autocorrelation of the reference (Toeplitz normal equations)
    n_fft = int(2 ** np.ceil(np.log2(t + taps)))
    sf = np.fft.rfft(reference, n_fft)
    ef = np.fft.rfft(estimate, n_fft)
    acorr = np.fft.irfft(sf * sf.conj(), n_fft)[:taps]
    xcorr = np.fft.irfft(sf.conj() * ef, n_fft)[:taps]
    acorr[0] += 1e-10 * max(acorr[0], 1e-18)
    h = scipy.linalg.solve_toeplitz(acorr, xcorr)
    return scipy.signal.fftconvolve(reference, h)[:t]


def ci_sdr(reference, estimate, taps=512, eps=1e-18):
    """CI-SDR: SDR after optimally filtering the reference (512 taps)."""
    reference = np.atleast_2d(np.asarray(reference, dtype=np.float64))
    estimate = np.atleast_2d(np.asarray(estimate, dtype=np.float64))
    out = []
    for r, e in zip(reference, estimate):
        proj = _project_fir(r, e, taps)
        err = e - proj
        out.append(10 * np.log10(
            max(np.sum(proj ** 2), eps) / max(np.sum(err ** 2), eps)))
    out = np.array(out)
    return out if out.size > 1 else float(out[0])


def _delayed_matrix(sources, taps):
    """(nsrc, T) -> design matrix (T, nsrc*taps) of delayed copies."""
    nsrc, t = sources.shape
    cols = np.zeros((t, nsrc * taps))
    for s in range(nsrc):
        for k in range(taps):
            cols[k:, s * taps + k] = sources[s, :t - k]
    return cols


def bss_eval_sources_sdr(reference_sources, estimated_sources, taps=512,
                         compute_permutation=False, return_permutation=False):
    """BSS-Eval SDR.

    reference_sources/estimated_sources: (nsrc, T).

    ``compute_permutation=False`` matches estimate j to reference j
    (mir_eval's mode in the reference's doctest ``enhancer.py:419``).
    ``compute_permutation=True`` scores every (estimate, reference) pair
    and reports the SDRs under the Hungarian-optimal assignment
    (mir_eval ``bss_eval_sources`` default) — required when the
    separation output order is arbitrary.  ``return_permutation`` also
    returns the chosen reference index per estimate.
    """
    refs = np.asarray(reference_sources, dtype=np.float64)
    ests = np.asarray(estimated_sources, dtype=np.float64)
    nsrc, t = refs.shape
    a_all = _delayed_matrix(refs, taps)

    def sdr_of(e, target_idx):
        # Projection onto all sources' delayed span
        coef_all, *_ = np.linalg.lstsq(a_all, e, rcond=None)
        p_all = a_all @ coef_all
        # Projection onto the target source's delayed span
        a_j = a_all[:, target_idx * taps:(target_idx + 1) * taps]
        coef_j, *_ = np.linalg.lstsq(a_j, e, rcond=None)
        s_target = a_j @ coef_j
        e_interf = p_all - s_target
        e_artif = e - p_all
        num = np.sum(s_target ** 2)
        den = np.sum((e_interf + e_artif) ** 2)
        return 10 * np.log10(max(num, 1e-18) / max(den, 1e-18))

    if not compute_permutation:
        sdrs = np.array([sdr_of(ests[j], j) for j in range(nsrc)])
        perm = np.arange(nsrc)
    else:
        matrix = np.array([[sdr_of(ests[j], i) for i in range(nsrc)]
                           for j in range(nsrc)])
        perm = pit_permutation(matrix, maximize=True)
        sdrs = matrix[np.arange(nsrc), perm]
    if return_permutation:
        return sdrs, perm
    return sdrs


def pit_permutation(score_matrix, maximize=True):
    """Optimal assignment over a (est, ref) score matrix."""
    import scipy.optimize
    r, c = scipy.optimize.linear_sum_assignment(
        score_matrix, maximize=maximize)
    return c


def der(reference_activity, hypothesis_activity, *, collar=0,
        frame_shift=1.0, optimal_mapping=True):
    """Diarization error rate from per-speaker frame activities.

    reference_activity/hypothesis_activity: (n_spk_{ref,hyp}, frames) bool.
    Returns dict with der, miss, falarm, confusion, total (in frames *
    frame_shift units).
    """
    ref = np.asarray(reference_activity, dtype=bool)
    hyp = np.asarray(hypothesis_activity, dtype=bool)
    n_ref, t = ref.shape
    n_hyp = hyp.shape[0]
    frames = min(t, hyp.shape[1])
    ref, hyp = ref[:, :frames].copy(), hyp[:, :frames].copy()

    if collar:
        c = int(round(collar / frame_shift))
        if c > 0:
            # Exclude frames near reference speaker boundaries
            boundary = np.zeros(frames, dtype=bool)
            for r in ref:
                edges = np.where(np.diff(r.astype(np.int8)) != 0)[0]
                for e in edges:
                    boundary[max(0, e - c + 1):e + c + 1] = True
            keep = ~boundary
            ref, hyp = ref[:, keep], hyp[:, keep]
            frames = ref.shape[1]

    if optimal_mapping and n_ref and n_hyp:
        overlap = (ref[:, None, :] & hyp[None, :, :]).sum(-1)
        import scipy.optimize
        ri, hi = scipy.optimize.linear_sum_assignment(-overlap)
        mapping = dict(zip(hi, ri))
    else:
        mapping = {i: i for i in range(min(n_ref, n_hyp))}

    n_ref_frames = ref.sum(0)      # speakers active per frame (reference)
    n_hyp_frames = hyp.sum(0)
    # Correct = overlap of mapped pairs per frame
    correct = np.zeros(frames)
    for h, r in mapping.items():
        correct += (ref[r] & hyp[h])
    total = n_ref_frames.sum()
    miss = np.maximum(n_ref_frames - n_hyp_frames, 0).sum()
    falarm = np.maximum(n_hyp_frames - n_ref_frames, 0).sum()
    confusion = (np.minimum(n_ref_frames, n_hyp_frames) - correct).clip(0).sum()
    error = miss + falarm + confusion
    return {
        'der': float(error / max(total, 1)),
        'miss': float(miss * frame_shift),
        'falarm': float(falarm * frame_shift),
        'confusion': float(confusion * frame_shift),
        'total': float(total * frame_shift),
    }
