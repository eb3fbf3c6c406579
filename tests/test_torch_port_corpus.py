"""The port's corpus import (``data/import_corpus.py``) against
``tssep_tpu``'s on WAVs, an RTTM, a JSON manifest, transcripts and
enrollment recordings that the test writes: RTTM parsing, the sample VAD,
the enrollment cut, WAV reading, and ``import_corpus`` and its CLI giving
the same shard, byte for byte, in both packages."""

import json

import numpy as np
import pytest

from tssep_tpu.data import import_corpus as jax_import
from tssep_tpu.data.simulate import MeetingSimulator
from tssep_tpu_torch.data import import_corpus
from tssep_tpu_torch.data.shard_corpus import ShardCorpusReader
from tssep_tpu_torch.runtime import native

SR = 4000
AUX = 33
SLOTS = 6


def _intervals(mask):
    d = np.diff(np.concatenate([[0], np.asarray(mask, np.int8), [0]]))
    return list(zip(np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]))


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """Two recordings of 4 speakers (one of 1 channel, one of 2 channels),
    written by the port's native WAV writer; their RTTM, the same segments
    as a JSON manifest, transcripts, and an enrollment WAV per speaker."""
    tmp = tmp_path_factory.mktemp('corpus')
    wav_dir, enroll_dir = tmp / 'wavs', tmp / 'enroll'
    wav_dir.mkdir()
    enroll_dir.mkdir()
    rttm, manifest, trans = [], {}, {}
    for i, channels in enumerate((1, 2)):
        sim = MeetingSimulator(sample_rate=SR, duration=2.0, num_speakers=4,
                               num_channels=channels, aux_size=AUX, seed=i)
        ex = sim.example(i)
        rec = f'rec{i}'
        native.wav_write(wav_dir / f'{rec}.wav',
                         ex['audio_data']['observation'], SR)
        vad = ex['audio_data']['vad']
        manifest[rec], trans[rec] = {}, {}
        for s in range(vad.shape[0]):
            segs = [(b / SR, e / SR) for b, e in _intervals(vad[s])]
            manifest[rec][f'spk{s}'] = [list(seg) for seg in segs]
            rttm += [f'SPEAKER {rec} 1 {b:.3f} {e - b:.3f} <NA> <NA> '
                     f'spk{s} <NA> <NA>' for b, e in segs]
            trans[rec][f'spk{s}'] = (f'words of {s}' if s % 2
                                     else ['utt one', f'utt {s}'])
    for s in range(4):
        native.wav_write(enroll_dir / f'spk{s}.wav',
                         np.random.RandomState(s).randn(1, 2000) * 0.1, SR)
    (tmp / 'all.rttm').write_text('\n'.join(
        ['; a comment line', *rttm, 'LEXEME ignored']) + '\n')
    (tmp / 'manifest.json').write_text(json.dumps(manifest))
    (tmp / 'trans.json').write_text(json.dumps(trans))
    return tmp


def test_parse_rttm_matches_jax(corpus):
    got = import_corpus.parse_rttm(corpus / 'all.rttm')
    assert got == jax_import.parse_rttm(corpus / 'all.rttm')
    assert set(got) == {'rec0', 'rec1'} and len(got['rec1']) == 4


def test_sample_vad_and_enrollment_match_jax():
    segments = [(0.1, 0.35), (-0.2, 0.01), (0.9, 1.7), (0.5, 0.5)]
    got = import_corpus._sample_vad(segments, 4000, SR)
    np.testing.assert_array_equal(
        got, jax_import._sample_vad(segments, 4000, SR))
    rng = np.random.RandomState(0)
    sig = rng.randn(4000).astype(np.float32)
    other = jax_import._sample_vad([(0.3, 0.95)], 4000, SR)
    for vad, o, limit in ((got, other, 30.0), (got, other, 0.02),
                          (got, got, 30.0)):
        np.testing.assert_array_equal(
            import_corpus.cut_enrollment(sig, vad, o, SR, limit),
            jax_import.cut_enrollment(sig, vad, o, SR, limit))


def test_load_audio_matches_jax(corpus):
    for rec, channels in (('rec0', 1), ('rec1', 2)):
        got, sr = import_corpus.load_audio(corpus / 'wavs' / f'{rec}.wav')
        want, want_sr = jax_import.load_audio(corpus / 'wavs' / f'{rec}.wav')
        assert sr == want_sr == SR and got.shape[0] == channels
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('annotations,enrollment,kind', [
    ('all.rttm', 'auto', 'gate'), ('manifest.json', 'enroll', 'mel')])
def test_import_corpus_matches_jax(corpus, tmp_path, annotations, enrollment,
                                   kind):
    """The same shard, byte for byte, from the RTTM with auto enrollment
    and transcripts, and from the manifest with enrollment recordings; the
    port's reader serves it with its optional fields."""
    kwargs = dict(aux_size=AUX, embedding_kind=kind,
                  enrollment=(enrollment if enrollment == 'auto'
                              else str(corpus / enrollment)),
                  transcripts=(corpus / 'trans.json'
                               if enrollment == 'auto' else None),
                  num_speaker_slots=SLOTS, expected_sample_rate=SR,
                  verbose=False)
    ids = import_corpus.import_corpus(tmp_path / 'port.shard',
                                      corpus / 'wavs',
                                      corpus / annotations, **kwargs)
    want = jax_import.import_corpus(tmp_path / 'jax.shard', corpus / 'wavs',
                                    corpus / annotations, **kwargs)
    assert ids == want == ['rec0', 'rec1']
    assert ((tmp_path / 'port.shard').read_bytes()
            == (tmp_path / 'jax.shard').read_bytes())
    reader = ShardCorpusReader(eval_shard=str(tmp_path / 'port.shard'),
                               aux_size=AUX)
    ex = next(iter(reader('eval')))
    assert ex['speaker_ids'] == ['spk0', 'spk1', 'spk2', 'spk3', '', '']
    assert ex['auxInput'].shape == (SLOTS, AUX)
    if enrollment == 'auto':
        assert ex['transcription'][:2] == ['utt one utt 0', 'words of 1']
    else:
        assert 'transcription' not in ex


def test_cli_matches_jax(corpus, tmp_path, capsys):
    argv = ['--wav-dir', str(corpus / 'wavs'), '--rttm',
            str(corpus / 'all.rttm'), '--aux-size', str(AUX), '--slots',
            str(SLOTS), '--transcripts', str(corpus / 'trans.json')]
    import_corpus.main(argv + ['--out', str(tmp_path / 'port.shard')])
    jax_import.main(argv + ['--out', str(tmp_path / 'jax.shard')])
    assert ((tmp_path / 'port.shard').read_bytes()
            == (tmp_path / 'jax.shard').read_bytes())
    assert f'2 recordings -> {tmp_path / "port.shard"}' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        import_corpus.main(argv[:2] + ['--out', str(tmp_path / 'x.shard')])
