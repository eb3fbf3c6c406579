"""WER harness: word error rate, cpWER, and a pluggable ASR interface; a
copy of ``tssep_tpu/eval/wer.py`` (numpy, on the host).

The reference keeps ASR scoring in the companion repo (``tssep_data``,
reference ``README.md:79-82``); the north-star parity target is DER/WER, so
the framework ships its own harness:

- ``wer``: Levenshtein word error rate with insertion/deletion/substitution
  breakdown (dynamic programming over word sequences).
- ``cp_wer``: concatenated-minimum-permutation WER (Watanabe et al.,
  CHiME-6): per-speaker transcripts are concatenated, the hypothesis->
  reference speaker assignment minimizing the *total* word errors is found
  by Hungarian assignment, and WER is total errors / total reference words.
- ``orc_wer``: optimal-reference-combination WER for segment-level
  hypotheses without speaker labels (each hypothesis segment may be
  attributed to any reference speaker; dynamic program over segments).
- ``Transcriber``: the pluggable ASR-hypothesis interface; the eval driver
  accepts any callable ``(samples, sample_rate) -> str``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Sequence

import numpy as np

__all__ = ['WerResult', 'wer', 'cp_wer', 'orc_wer', 'Transcriber',
           'normalize_transcript']


def normalize_transcript(text: str) -> list[str]:
    """Uppercase, strip punctuation to whitespace-separated words."""
    keep = []
    for ch in text.upper():
        if ch.isalnum() or ch in "' ":
            keep.append(ch)
        else:
            keep.append(' ')
    return ''.join(keep).split()


@dataclasses.dataclass
class WerResult:
    errors: int
    length: int
    insertions: int
    deletions: int
    substitutions: int

    @property
    def error_rate(self) -> float:
        if self.length == 0:
            return 0.0 if self.errors == 0 else float('inf')
        return self.errors / self.length

    def __add__(self, other: 'WerResult') -> 'WerResult':
        return WerResult(
            self.errors + other.errors, self.length + other.length,
            self.insertions + other.insertions,
            self.deletions + other.deletions,
            self.substitutions + other.substitutions)

    def as_dict(self):
        return {'wer': self.error_rate, 'errors': self.errors,
                'length': self.length, 'insertions': self.insertions,
                'deletions': self.deletions,
                'substitutions': self.substitutions}


def _words(x) -> list[str]:
    if isinstance(x, str):
        return normalize_transcript(x)
    return list(x)


def _edit_ops(ref: list[str], hyp: list[str]):
    """(errors, ins, del, sub) via Levenshtein DP (numpy, O(R*H))."""
    r, h = len(ref), len(hyp)
    if r == 0:
        return h, h, 0, 0
    if h == 0:
        return r, 0, r, 0
    # cost[i,j]: (total, ins, del, sub) packed into separate arrays
    total = np.zeros((r + 1, h + 1), dtype=np.int32)
    total[:, 0] = np.arange(r + 1)
    total[0, :] = np.arange(h + 1)
    ops = np.zeros((r + 1, h + 1), dtype=np.int8)  # 0 diag, 1 ins, 2 del
    ops[:, 0] = 2
    ops[0, :] = 1
    ref_a = np.array(ref)
    for i in range(1, r + 1):
        match = (ref_a[i - 1] == np.array(hyp)) if h else np.array([])
        for j in range(1, h + 1):
            sub = total[i - 1, j - 1] + (0 if match[j - 1] else 1)
            ins = total[i, j - 1] + 1
            dele = total[i - 1, j] + 1
            best = min(sub, ins, dele)
            total[i, j] = best
            ops[i, j] = 0 if best == sub else (1 if best == ins else 2)
    # Backtrack for the op breakdown
    i, j = r, h
    n_ins = n_del = n_sub = 0
    while i > 0 or j > 0:
        op = ops[i, j]
        if op == 0 and i > 0 and j > 0:
            if ref[i - 1] != hyp[j - 1]:
                n_sub += 1
            i, j = i - 1, j - 1
        elif op == 1 and j > 0:
            n_ins += 1
            j -= 1
        else:
            n_del += 1
            i -= 1
    return int(total[r, h]), n_ins, n_del, n_sub


def wer(reference, hypothesis) -> WerResult:
    """Word error rate between one reference and one hypothesis.

    Inputs may be strings (normalized + split) or word sequences.
    """
    ref, hyp = _words(reference), _words(hypothesis)
    errors, n_ins, n_del, n_sub = _edit_ops(ref, hyp)
    return WerResult(errors, len(ref), n_ins, n_del, n_sub)


def cp_wer(reference_by_speaker: Sequence, hypothesis_by_speaker: Sequence,
           return_assignment=False):
    """Concatenated-minimum-permutation WER.

    ``reference_by_speaker`` / ``hypothesis_by_speaker``: one transcript per
    speaker — either a string, or a sequence of utterance strings that are
    concatenated in order.  Speaker counts may differ; the smaller side is
    padded with empty transcripts (unmatched hypothesis speakers count as
    insertions, unmatched reference speakers as deletions).
    """
    def concat(x):
        if isinstance(x, str):
            return _words(x)
        words = []
        for utt in x:
            words.extend(_words(utt))
        return words

    refs = [concat(x) for x in reference_by_speaker]
    hyps = [concat(x) for x in hypothesis_by_speaker]
    n = max(len(refs), len(hyps))
    refs += [[]] * (n - len(refs))
    hyps += [[]] * (n - len(hyps))

    table = [[wer(r, h) for h in hyps] for r in refs]
    cost = np.array([[t.errors for t in row] for row in table])
    import scipy.optimize
    ri, hi = scipy.optimize.linear_sum_assignment(cost)
    result = WerResult(0, 0, 0, 0, 0)
    for r, h in zip(ri, hi):
        result = result + table[r][h]
    if return_assignment:
        return result, dict(zip(hi.tolist(), ri.tolist()))
    return result


def _normalize_orc_inputs(reference_by_speaker, hypothesis_segments):
    refs = [_words(r) if isinstance(r, (str, list)) else list(r)
            for r in reference_by_speaker]
    segs = [_words(s) for s in hypothesis_segments]
    return refs, segs


def _orc_result(refs, segs, assignment):
    """Exact WerResult (with ins/del/sub breakdown) for one assignment."""
    streams = [[] for _ in range(len(refs))]
    for seg, ch in zip(segs, assignment):
        streams[ch].extend(seg)
    result = WerResult(0, 0, 0, 0, 0)
    for r, hyp_stream in zip(refs, streams):
        result = result + wer(r, hyp_stream)
    return result


def _orc_wer_exhaustive(reference_by_speaker: Sequence,
                        hypothesis_segments: Sequence,
                        return_assignment=False):
    """K^S exhaustive ORC-WER — the test oracle for ``orc_wer`` (guarded)."""
    refs, segs = _normalize_orc_inputs(reference_by_speaker,
                                       hypothesis_segments)
    k, s = len(refs), len(segs)
    if k == 0 or s == 0:
        return orc_wer(refs, segs, return_assignment=return_assignment)
    if k ** s > 250_000:
        raise ValueError(
            f'orc_wer exhaustive oracle: {k}^{s} assignments is too many')
    best, best_assign = None, None
    for assign in itertools.product(range(k), repeat=s):
        result = _orc_result(refs, segs, assign)
        if best is None or result.errors < best.errors:
            best, best_assign = result, assign
    if return_assignment:
        return best, list(best_assign)
    return best


def _extend_rows(rows, sub_costs, ar):
    """Append one hypothesis word to a stack of Levenshtein rows.

    ``rows``: (N, R+1) int array; ``rows[n, i]`` = edit distance between
    ``ref[:i]`` and hypothesis stream ``n`` so far.  ``sub_costs``: (R,)
    0/1 substitution costs of the new word vs each ref word.  ``ar``:
    ``arange(R+1)`` scratch.  Returns the updated (N, R+1) rows.

    Vectorized over N and R; the delete recurrence ``e[i]=e[i-1]+1`` is
    resolved with a prefix-min over ``base[j]-j``.
    """
    base = np.empty_like(rows)
    base[:, 0] = rows[:, 0] + 1
    if rows.shape[1] > 1:
        base[:, 1:] = np.minimum(rows[:, 1:] + 1,
                                 rows[:, :-1] + sub_costs[None, :])
    t = base - ar[None, :]
    np.minimum.accumulate(t, axis=1, out=t)
    return t + ar[None, :]


def orc_wer(reference_by_speaker: Sequence, hypothesis_segments: Sequence,
            max_speakers=8, beam=20_000, return_assignment=False):
    """Optimal-reference-combination WER.

    Hypothesis *segments* (in temporal order, no speaker labels) are each
    attributed to one reference speaker (channel); each channel's
    hypothesis stream is the in-order concatenation of its segments, and
    the assignment minimizing total word errors is found by a dynamic
    program over segments (reference keeps WER scoring in ``tssep_data``;
    this is the in-framework equivalent of MeetEval-style ORC-WER).

    State after ``t`` segments = one Levenshtein DP row per channel
    (distance of every ``ref_k`` prefix to the words assigned to ``k`` so
    far).  States are deduplicated, and branch-and-bound pruned against an
    incumbent (greedy) solution with the admissible bound
    ``sum_k min(row_k)`` — pruning by an admissible bound preserves
    exactness.  Only the ``beam`` cap (keep the ``beam`` lowest-bound
    states per step) can sacrifice optimality; with ``beam=None`` the
    search is exact.  Scales to meeting-size inputs (8 spk x 20+ segments)
    where the old K^S enumeration could not.

    ``max_speakers`` guards against accidentally huge channel counts.
    """
    refs, segs = _normalize_orc_inputs(reference_by_speaker,
                                       hypothesis_segments)
    k, s = len(refs), len(segs)
    if k > max_speakers:
        raise ValueError(
            f'orc_wer: {k} reference speakers > max_speakers={max_speakers}')
    if k == 0:
        total = sum(len(x) for x in segs)
        res = WerResult(total, 0, total, 0, 0)
        return (res, []) if return_assignment else res
    if s == 0:
        total = sum(len(r) for r in refs)
        res = WerResult(total, total, 0, total, 0)
        return (res, []) if return_assignment else res

    ref_arrays = [np.asarray(r, dtype=object) for r in refs]
    aranges = [np.arange(len(r) + 1, dtype=np.int32) for r in refs]
    # Per (channel, segment): 0/1 substitution-cost rows for each word.
    sub_cost = [
        [[(ra != w).astype(np.int32) for w in seg] for seg in segs]
        for ra in ref_arrays]

    def extend_matrix(rows, ch, seg_idx):
        for costs in sub_cost[ch][seg_idx]:
            rows = _extend_rows(rows, costs, aranges[ch])
        return rows

    # --- incumbent: greedy assignment (upper bound for pruning) --------
    g_rows = [aranges[ch][None, :].copy() for ch in range(k)]
    g_assign = []
    for t in range(s):
        best_ch, best_score, best_new = None, None, None
        mins = [r.min() for r in g_rows]
        for ch in range(k):
            new = extend_matrix(g_rows[ch], ch, t)
            score = int(new.min()) + sum(m for j, m in enumerate(mins)
                                         if j != ch)
            if best_score is None or score < best_score:
                best_ch, best_score, best_new = ch, score, new
        g_rows[best_ch] = best_new
        g_assign.append(best_ch)
    incumbent_cost = int(sum(r[0, -1] for r in g_rows))
    incumbent_assign = list(g_assign)

    # --- branch-and-bound DP over segments ------------------------------
    # Parallel arrays over live states: per-channel row matrices (N, R+1),
    # and the partial assignment per state.
    rows_by_ch = [aranges[ch][None, :].copy() for ch in range(k)]
    assigns = [()]
    for t in range(s):
        n = rows_by_ch[0].shape[0]
        ext = [extend_matrix(rows_by_ch[ch], ch, t) for ch in range(k)]
        min_static = np.stack([r.min(axis=1) for r in rows_by_ch])  # (K, N)
        min_ext = np.stack([e.min(axis=1) for e in ext])            # (K, N)
        total_static = min_static.sum(axis=0)                       # (N,)
        # child (ch, i): bound = total_static[i] - min_static[ch,i]
        #                        + min_ext[ch,i]
        bounds = total_static[None, :] - min_static + min_ext       # (K, N)
        keep_ch, keep_i = np.nonzero(bounds <= incumbent_cost)
        if keep_ch.size == 0:
            # Everything pruned: the incumbent is optimal.
            assigns = []
            break
        order = np.argsort(bounds[keep_ch, keep_i], kind='stable')
        if beam is not None and order.size > beam:
            order = order[:beam]
        seen = {}
        new_assigns = []
        sel_idx, sel_ch = [], []
        for o in order:
            ch, i = int(keep_ch[o]), int(keep_i[o])
            key = tuple(
                (ext[ch] if j == ch else rows_by_ch[j])[i].tobytes()
                for j in range(k))
            if key in seen:
                continue
            seen[key] = True
            sel_idx.append(i)
            sel_ch.append(ch)
            new_assigns.append(assigns[i] + (ch,))
        sel_idx = np.asarray(sel_idx)
        sel_ch_a = np.asarray(sel_ch)
        rows_by_ch = [
            np.where((sel_ch_a == j)[:, None],
                     ext[j][sel_idx], rows_by_ch[j][sel_idx])
            for j in range(k)]
        assigns = new_assigns
        # Tighten the incumbent with the best complete-now estimate.
        finals = sum(r[:, -1] for r in rows_by_ch)
        # (only a real incumbent at t == s-1; intermediate finals assume
        # no further segments on those channels, which is not available —
        # skip tightening mid-way.)
        if t == s - 1:
            best_i = int(np.argmin(finals))
            if int(finals[best_i]) < incumbent_cost:
                incumbent_cost = int(finals[best_i])
                incumbent_assign = list(assigns[best_i])

    result = _orc_result(refs, segs, incumbent_assign)
    if return_assignment:
        return result, incumbent_assign
    return result


class Transcriber:
    """Pluggable ASR-hypothesis interface for the eval driver.

    Any callable ``(samples: np.ndarray, sample_rate: int) -> str`` works;
    this base class just documents the contract.  Wire a real ASR (e.g. a
    local HuggingFace CTC checkpoint) by subclassing::

        class MyASR(Transcriber):
            def __call__(self, samples, sample_rate):
                return self.pipe(samples)['text']
    """

    def __call__(self, samples: np.ndarray, sample_rate: int) -> str:
        raise NotImplementedError


@dataclasses.dataclass
class FunctionTranscriber(Transcriber):
    fn: Callable[[np.ndarray, int], str]

    def __call__(self, samples, sample_rate):
        return self.fn(samples, sample_rate)
