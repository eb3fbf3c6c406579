"""The port's WER harness (``eval/wer.py``) against ``tssep_tpu``'s: ``wer``,
``cp_wer`` and ``orc_wer`` (and its exhaustive oracle) give equal results
on the same transcripts, and ``EvalDriver.score_wer`` the same metrics."""

import random

import numpy as np
import pytest

from tssep_tpu.eval import driver as jax_driver
from tssep_tpu.eval import wer as jax_wer
from tssep_tpu_torch.eval import driver
from tssep_tpu_torch.eval import wer

VOCAB = ['a', 'b', 'c', 'd', 'e']


def _transcripts(seed):
    rng = random.Random(seed)
    k = rng.randint(1, 3)
    refs = [' '.join(rng.choices(VOCAB, k=rng.randint(0, 6)))
            for _ in range(k)]
    segs = [' '.join(rng.choices(VOCAB, k=rng.randint(0, 4)))
            for _ in range(rng.randint(1, 6))]
    return refs, segs


@pytest.mark.parametrize('seed', range(4))
def test_wer_cp_wer_orc_wer_match_jax(seed):
    refs, segs = _transcripts(seed)
    ref, hyp = ' '.join(refs), ' '.join(segs) + ', Punct!'
    assert wer.wer(ref, hyp).as_dict() == jax_wer.wer(ref, hyp).as_dict()
    assert (wer.normalize_transcript(hyp)
            == jax_wer.normalize_transcript(hyp))
    got, got_assign = wer.cp_wer(refs, segs[:len(refs) + 1],
                                 return_assignment=True)
    want, want_assign = jax_wer.cp_wer(refs, segs[:len(refs) + 1],
                                       return_assignment=True)
    assert got.as_dict() == want.as_dict() and got_assign == want_assign
    got, got_assign = wer.orc_wer(refs, segs, return_assignment=True)
    want, want_assign = jax_wer.orc_wer(refs, segs, return_assignment=True)
    assert got.as_dict() == want.as_dict() and got_assign == want_assign
    assert (wer._orc_wer_exhaustive(refs, segs).as_dict()
            == jax_wer._orc_wer_exhaustive(refs, segs).as_dict())


def test_orc_wer_meeting_scale_matches_jax():
    refs = [' '.join(f's{k}w{i}' for i in range(6)) for k in range(4)]
    segs = [f's{k}w{2 * i} s{k}w{2 * i + 1}' for i in range(3)
            for k in range(4)]
    segs[5] = 'XXX YYY'
    got = wer.orc_wer(refs, segs, return_assignment=True)
    want = jax_wer.orc_wer(refs, segs, return_assignment=True)
    assert got[0].as_dict() == want[0].as_dict() and got[1] == want[1]
    with pytest.raises(ValueError):
        wer.orc_wer(['a'] * 9, ['x'] * 3, max_speakers=8)


def test_score_wer_matches_jax():
    """``EvalDriver.score_wer`` with a correlation-based fake recognizer,
    on whole streams and segment-wise over a sample diarization."""
    rng = np.random.default_rng(0)
    texts = ['the first speaker talks', 'second speaker here',
             'and a third one']
    refs = rng.normal(size=(3, 8000))

    def fake_asr(samples, sample_rate):
        scores = [abs(np.dot(samples, r[:len(samples)])) for r in refs]
        return texts[int(np.argmax(scores))]

    est = np.stack([refs[2], refs[0], refs[1]]) + 0.5 * rng.normal(
        size=(3, 8000))
    transcriber = wer.FunctionTranscriber(fake_asr)
    assert transcriber(est[0], 16000) == fake_asr(est[0], 16000)
    from tssep_tpu.signal.intervals import ArrayInterval as JaxAI
    from tssep_tpu_torch.signal.intervals import ArrayInterval
    spans = [[(0, 3000), (5000, 8000)], [(100, 7000)], []]
    for sample_dia in (None, spans):
        results = []
        for mod, ai in ((driver, ArrayInterval), (jax_driver, JaxAI)):
            result = {'time_estimate': est}
            if sample_dia is not None:
                result['sample_dia'] = [ai(s, shape=8000) for s in spans]
            results.append(mod.EvalDriver.__new__(mod.EvalDriver).score_wer(
                result, texts, fake_asr))
        assert results[0] == results[1]
