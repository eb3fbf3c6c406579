"""The port's meeting simulator and shard corpora (``data/simulate.py``,
``data/shard_corpus.py``) against ``tssep_tpu``'s, bit for bit: the speaker
embeddings in both kinds, the word codebook, ``MeetingSimulator.example`` in
the harmonic default, with a speaker pool, with a word vocabulary and with
6 channels and reverb taps, shards written by either package and read by the
other's ``ShardCorpusReader``, and the tracked ``egs/simulated`` shards
read by both readers. Every draw is numpy's, so nothing needs a tolerance.
"""

from pathlib import Path

import numpy as np
import pytest

from tssep_tpu.data import shard_corpus as jax_shard_corpus
from tssep_tpu.data import simulate as jax_simulate
from tssep_tpu_torch.data import shard_corpus, simulate

REPO = Path(__file__).resolve().parents[1]


def assert_same(got, want, path='example'):
    """Equal structure, types, dtypes, shapes and values."""
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert got.keys() == want.keys(), (path, got.keys(), want.keys())
        for k in want:
            assert_same(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize('kind,aux_size', [('mel', 40), ('gate', 65)])
def test_speaker_embedder_matches_jax(kind, aux_size):
    rng = np.random.RandomState(0)
    signal = rng.randn(4000).astype(np.float32)
    got = simulate.SpeakerEmbedder(aux_size, kind=kind)(signal)
    want = jax_simulate.SpeakerEmbedder(aux_size, kind=kind)(signal)
    assert_same(got, want)


def test_codebook_matches_jax():
    assert (simulate.MeetingSimulator._codebook()
            == jax_simulate.MeetingSimulator._codebook())
    assert len(simulate.MeetingSimulator._codebook()) == 23
    assert ([simulate.MeetingSimulator.word_pattern(w) for w in range(23)]
            == [jax_simulate.MeetingSimulator.word_pattern(w)
                for w in range(23)])


SIMULATORS = {
    'harmonic': dict(duration=1.0, aux_size=40),
    'speaker_pool': dict(duration=1.0, aux_size=65, embedding_kind='gate',
                         speaker_pool=4, seed=3),
    'vocabulary': dict(duration=2.0, aux_size=65, embedding_kind='gate',
                       speaker_pool=16, vocabulary=8, num_speakers=4),
    'multichannel': dict(duration=1.5, aux_size=65, embedding_kind='gate',
                         speaker_pool=16, vocabulary=8, num_channels=6,
                         reverb_taps=2, seed=2),
}


@pytest.mark.parametrize('form', sorted(SIMULATORS))
def test_meeting_matches_jax_bit_for_bit(form):
    kwargs = SIMULATORS[form]
    for index in (0, 5):
        got = simulate.MeetingSimulator(**kwargs).example(index)
        want = jax_simulate.MeetingSimulator(**kwargs).example(index)
        assert_same(got, want)
        assert ('transcription' in got) == bool(kwargs.get('vocabulary'))


def _readers(path):
    return [cls(train_shard=str(path), validate_shard=str(path),
                eval_shard=str(path), aux_size=65)
            for cls in (shard_corpus.ShardCorpusReader,
                        jax_shard_corpus.ShardCorpusReader)]


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_shards_cross_read(writer, tmp_path):
    """A shard either package simulated holds the same meetings, and the
    port's reader gives JAX's examples, the early images and the
    transcriptions included."""
    kwargs = SIMULATORS['multichannel']
    module = simulate if writer == 'port' else jax_simulate
    path = module.simulate_corpus(tmp_path / 'c.shard', 2,
                                  module.MeetingSimulator(**kwargs))
    port_reader, jax_reader = _readers(path)
    keys = ('observation', 'speaker_reverberation_early_ch0')
    for name in ('train', 'validate', 'eval'):
        got = list(port_reader(name, load_keys=keys))
        want = list(jax_reader(name, load_keys=keys))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert_same(g, w)
    sim = jax_simulate.MeetingSimulator(**kwargs)
    ex = next(iter(port_reader('eval', load_keys=keys)))
    assert ex['transcription'] == sim.example(0)['transcription']
    np.testing.assert_array_equal(ex['audio_data']['observation'],
                                  sim.example(0)['audio_data']['observation'])


def test_shard_written_by_each_package_is_the_same(tmp_path):
    kwargs = SIMULATORS['vocabulary']
    shards = [m.simulate_corpus(tmp_path / f'{i}.shard', 2,
                                m.MeetingSimulator(**kwargs))
              for i, m in enumerate((simulate, jax_simulate))]
    assert Path(shards[0]).read_bytes() == Path(shards[1]).read_bytes()


@pytest.mark.parametrize('split', ['train', 'validate', 'eval'])
def test_tracked_shards_read_as_jax_reads_them(split):
    path = REPO / 'egs' / 'simulated' / f'{split}.shard'
    port_reader, jax_reader = _readers(path)
    keys = ('observation', 'speaker_reverberation_early_ch0')
    got = port_reader(split, load_keys=keys)
    want = jax_reader(split, load_keys=keys)
    assert len(got) == len(want) > 0
    assert_same(next(iter(got)), next(iter(want)))
