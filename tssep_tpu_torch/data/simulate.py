"""Meeting simulation + lightweight speaker embeddings: port of
``tssep_tpu/data/simulate.py``, a numpy copy. Every draw is a numpy
``RandomState`` and the embeddings take the numpy float64 STFT
(``signal/stft.py`` ``_stft_np``), so the port simulates the JAX package's
meetings bit for bit.

The reference trains on simulated LibriSpeech meetings prepared by its
companion repo (``tssep_data``, reference ``README.md:79-82``); this module
provides that capability natively so the full pipeline — simulate → shard →
train → eval — lives in one framework:

- ``SpeakerEmbedder``: enrollment audio -> fixed-size embedding
  (log-mel statistics d-vector-lite, L2-normalized).  Stands in for the
  reference's externally-computed i-vectors; any (spk, aux_size) embedding
  source plugs into the same ``auxInput`` slot.
- ``MeetingSimulator``: synthesizes multi-speaker meetings with partial
  overlap, per-speaker gains, optional multi-channel delay/decay room
  approximation, and noise; yields examples satisfying the reader contract
  (``audio_data.observation``, per-speaker early images, sample VAD,
  ``auxInput``).
- ``simulate_corpus``: writes a corpus into the native shard store
  (``tssep_tpu_torch.runtime.native.ShardWriter``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tssep_tpu_torch.signal.mel import mel_filterbank
from tssep_tpu_torch.signal.stft import STFT

__all__ = ['SpeakerEmbedder', 'MeetingSimulator', 'simulate_corpus']


class SpeakerEmbedder:
    """Enrollment audio -> (aux_size,) embedding: the speaker's average
    mel-spectral profile (aux_size mel bands), log-compressed, mean-removed
    and L2-normalized — a sharp spectral fingerprint (d-vector-lite).  Any
    stronger embedding source (i-vectors, neural d-vectors) plugs into the
    same ``auxInput`` slot."""

    def __init__(self, aux_size=100, sample_rate=16000, n_mels=None,
                 stft_size=512, stft_shift=160, kind='mel'):
        self.aux_size = aux_size
        self.sample_rate = sample_rate
        self.kind = kind
        if kind == 'gate':
            # spectral-gate fingerprint: aux_size must match the model's
            # STFT bins; values in [0, 1], high where the speaker has
            # energy — the natural partner of 'mul' (LHUC) conditioning.
            stft_size = 2 * (aux_size - 1)
            self.stft = STFT(size=stft_size, shift=stft_size // 4,
                             window='hann')
            self.fbank = None
        else:
            self.stft = STFT(size=stft_size, shift=stft_shift, window='hann')
            self.fbank = mel_filterbank(
                n_freqs=stft_size // 2 + 1, f_min=40,
                f_max=sample_rate // 2 - 100, n_mels=n_mels or aux_size,
                sample_rate=sample_rate)

    def __call__(self, signal):
        spec = np.abs(self.stft.stft(np.asarray(signal, dtype=np.float64)))
        profile = (spec ** 2).mean(axis=-2)
        if self.kind == 'gate':
            # light smoothing + max-normalize -> [0, 1] gate profile
            kernel = np.ones(3) / 3
            profile = np.convolve(profile, kernel, mode='same')
            gate = profile / np.maximum(profile.max(), 1e-12)
            return np.sqrt(gate).astype(np.float32)
        mel = np.log(profile @ self.fbank + 1e-8)
        emb = mel - mel.mean()
        return (emb / np.maximum(np.linalg.norm(emb), 1e-9)).astype(np.float32)


@dataclasses.dataclass
class MeetingSimulator:
    """Synthetic meeting generator (sources default to harmonic 'speakers')."""

    sample_rate: int = 16000
    duration: float = 5.0
    num_speakers: int = 8
    num_channels: int = 1
    aux_size: int = 100
    overlap: float = 0.5           # fraction of each turn overlapping the next
    snr_db: float = 10.0           # speech-to-noise ratio
    reverb_taps: int = 0           # extra delayed/decayed copies per channel
    embedding_kind: str = 'mel'    # 'mel' (d-vector-lite) | 'gate' (spectral)
    seed: int = 0
    #: Size of a FIXED speaker-identity pool shared across simulator
    #: instances (independent of ``seed``): each meeting draws its
    #: speakers from the pool, so train/eval splits share voices — the
    #: closed-speaker-set condition of LibriCSS-style evaluation (the
    #: reference evaluates enrolled, known speakers; reference
    #: tssep/data.py:58-146 consumes precomputed per-speaker i-vectors).
    #: 0 = open set: every meeting gets fresh random voices.
    speaker_pool: int = 0
    #: >0: speakers utter WORDS from a closed vocabulary of this size
    #: instead of continuous harmonics — each word is a fixed on/off tone
    #: rhythm (speaker-independent energy envelope rendered with the
    #: speaker's f0/timbre), and every example carries a per-speaker
    #: ``transcription``.  This makes the corpus ASR-scorable: the
    #: in-framework CTC recognizer (``tssep_tpu_torch.eval.ctc``) trains on these
    #: words and produces real cpWER/ORC-WER numbers through the eval CLI.
    vocabulary: int = 0
    word_sec: float = 0.30
    #: Inter-word silence.  MUST stay longer than the longest in-word
    #: silence (2 slots + up to 2 trailing-off slots = 4 x 0.05 s): word
    #: boundaries are then decodable from the energy envelope alone.
    word_gap_sec: float = 0.25

    def __post_init__(self):
        self.embedder = SpeakerEmbedder(self.aux_size, self.sample_rate,
                                        kind=self.embedding_kind)

    # -- closed-vocabulary word speech -----------------------------------
    #: Slots per word (a word = an on/off tone rhythm over these slots).
    _WORD_SLOTS = 6

    @classmethod
    def word_pattern(cls, word: int):
        """Word id -> its on/off slot pattern (deterministic codebook).

        The codebook enumerates 6-slot binary rhythms that are
        SELF-DELIMITING in a word stream: every word starts with an 'on'
        slot and never contains >= 3 consecutive 'off' slots, while the
        inter-word gap (``word_gap_sec``) is > 4 slots of silence — so any
        long silence run is a word boundary and any short one is in-word
        structure.  (The first cut of this codebook allowed leading/
        arbitrary 'off' runs equal to the gap length; CTC training
        plateaued at ~90% WER because the parse was ill-posed, not because
        the model was weak.)  23 available words; rhythm is speaker-
        independent (pure energy envelope), so a small recognizer
        generalizes across voices."""
        patterns = cls._codebook()
        assert word < len(patterns), (word, len(patterns))
        return list(patterns[word])

    @classmethod
    def _codebook(cls):
        if getattr(cls, '_codebook_cache', None) is not None:
            return cls._codebook_cache
        candidates = []
        for p in range(2 ** cls._WORD_SLOTS):
            bits = tuple((p >> i) & 1 for i in range(cls._WORD_SLOTS))
            if bits[0] != 1 or not 2 <= sum(bits) <= 5:
                continue
            run = 0
            ok = True
            for b in bits:
                run = run + 1 if b == 0 else 0
                if run >= 3:
                    ok = False
                    break
            if ok:
                candidates.append(bits)
        # Greedy max-min-Hamming ordering: a vocabulary of the first V
        # words is then as mutually distinct as possible (the CTC
        # recognizer's residual confusions were nearest-neighbour words).
        dist = lambda a, b: sum(x != y for x, y in zip(a, b))  # noqa: E731
        chosen = [candidates.pop(0)]
        while candidates:
            best = max(candidates,
                       key=lambda c: (min(dist(c, ch) for ch in chosen),
                                      sum(c)))
            candidates.remove(best)
            chosen.append(best)
        cls._codebook_cache = chosen
        return chosen

    def _word_waveform(self, rng, word, f0, timbre_seed):
        """One word: an on/off harmonic-tone rhythm, speaker timbre."""
        slot = int(self.sample_rate * self.word_sec / self._WORD_SLOTS)
        t = np.arange(slot) / self.sample_rate
        timbre = np.random.RandomState(timbre_seed)
        n_harm = 8
        amps = timbre.uniform(0.05, 1.0, n_harm) / np.arange(1, n_harm + 1)
        env = np.hanning(2 * min(slot // 4, 160))
        fade = len(env) // 2
        nyquist = self.sample_rate / 2
        out = []
        for on in self.word_pattern(word):
            if not on:
                out.append(np.zeros(slot))
                continue
            sig = np.zeros(slot)
            for k in range(1, n_harm + 1):
                f = f0 * k
                if f >= nyquist * 0.95:
                    break
                sig += amps[k - 1] * np.sin(
                    2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
            sig[:fade] *= env[:fade]
            sig[-fade:] *= env[fade:]
            out.append(sig)
        return np.concatenate(out).astype(np.float32)

    def word_utterance(self, rng, num_samples, f0, timbre_seed, words=None):
        """Fill ``num_samples`` with words (+ gaps).  Returns (sig, words)."""
        gap = int(self.sample_rate * self.word_gap_sec)
        sig = np.zeros(num_samples, dtype=np.float32)
        pos = gap // 2
        out_words = []
        i = 0
        while True:
            w = (int(words[i % len(words)]) if words is not None
                 else int(rng.randint(self.vocabulary)))
            wav = self._word_waveform(rng, w, f0, timbre_seed)
            if pos + len(wav) > num_samples:
                break
            sig[pos:pos + len(wav)] = wav
            out_words.append(f'w{w}')
            pos += len(wav) + gap
            i += 1
        return sig, out_words

    def _speaker_source(self, rng, num_samples, voiced_f0, timbre_seed=None):
        """Harmonic-plus-noise 'speech' with a per-speaker timbre envelope.

        The speaker identity is (f0, timbre): harmonic amplitudes come from
        the timbre seed so enrollment and meeting speech share the same
        spectral fingerprint (as a real voice does), while phases/modulation
        vary per utterance.
        """
        t = np.arange(num_samples) / self.sample_rate
        if timbre_seed is None:
            timbre_seed = int(voiced_f0 * 1000) % (2 ** 31)
        timbre = np.random.RandomState(timbre_seed)
        n_harm = 8
        amps = timbre.uniform(0.05, 1.0, n_harm) / np.arange(1, n_harm + 1)
        sig = np.zeros(num_samples)
        nyquist = self.sample_rate / 2
        for k in range(1, n_harm + 1):
            if voiced_f0 * k >= nyquist * 0.95:
                break
            sig += amps[k - 1] * np.sin(2 * np.pi * voiced_f0 * k * t
                                        + rng.uniform(0, 2 * np.pi))
        am = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
        sig = sig * am + 0.05 * rng.randn(num_samples)
        return sig.astype(np.float32)

    def _turn_layout(self, num_samples):
        """Staircase turns with `overlap` fractional overlap."""
        vad = np.zeros((self.num_speakers, num_samples), dtype=bool)
        start = 0
        for i in range(self.num_speakers):
            end = num_samples * (i + 2) // (self.num_speakers + 1)
            vad[i, start:end] = True
            start = end - int((end - start) * self.overlap)
        return vad

    def example(self, index):
        rng = np.random.RandomState(self.seed * 100_003 + index)
        num_samples = int(self.sample_rate * self.duration)
        c = self.num_channels
        s = self.num_speakers

        # log-uniform f0 spread + per-speaker timbre -> discriminable
        # spectral fingerprints (like distinct voices)
        if self.speaker_pool:
            ids = rng.choice(self.speaker_pool, size=s,
                             replace=self.speaker_pool < s)
            pool = [np.random.RandomState(911_000_003 + int(i))
                    for i in ids]
            f0s = np.array([np.exp(pr.uniform(np.log(90), np.log(900)))
                            for pr in pool])
            timbres = np.array([pr.randint(0, 2 ** 31) for pr in pool])
        else:
            f0s = np.exp(rng.uniform(np.log(90), np.log(900), size=s))
            timbres = rng.randint(0, 2 ** 31, size=s)
        vad = self._turn_layout(num_samples)
        transcription = None
        if self.vocabulary:
            # word speech placed inside each speaker's turn; transcription
            # is the ground-truth word sequence (ASR-scorable corpus)
            sources = np.zeros((s, num_samples), dtype=np.float32)
            transcription = []
            for spk in range(s):
                active = np.where(vad[spk])[0]
                start, end = int(active[0]), int(active[-1]) + 1
                sig, words = self.word_utterance(
                    rng, end - start, f0s[spk], int(timbres[spk]))
                sources[spk, start:end] = sig
                transcription.append(' '.join(words))
        else:
            sources = np.stack([
                self._speaker_source(rng, num_samples, f0, int(ts))
                for f0, ts in zip(f0s, timbres)])            # (S, T)
            sources = sources * vad

        # Channel images: per-channel delay + decaying taps
        images = np.zeros((s, c, num_samples), dtype=np.float32)
        for spk in range(s):
            for ch in range(c):
                delay = 0 if ch == 0 else rng.randint(0, 8)
                img = np.roll(sources[spk], delay)
                img[:delay] = 0
                for tap in range(self.reverb_taps):
                    d = rng.randint(40, 400)
                    g = 0.5 ** (tap + 1) * rng.uniform(0.3, 1.0)
                    tail = np.roll(sources[spk], delay + d) * g
                    tail[:delay + d] = 0
                    img = img + tail
                images[spk, ch] = img

        speech = images.sum(axis=0)                          # (C, T)
        speech_power = np.mean(speech ** 2) + 1e-12
        noise = rng.randn(c, num_samples).astype(np.float32)
        noise *= np.sqrt(speech_power / np.mean(noise ** 2)
                         / (10 ** (self.snr_db / 10)))
        observation = speech + noise

        # Enrollment: a clean solo utterance per speaker (same voice
        # identity, fresh phases/modulation) -> embedding
        aux = np.stack([
            self.embedder(self._speaker_source(
                np.random.RandomState(self.seed * 7919 + 17 * spk),
                self.sample_rate, f0s[spk], int(timbres[spk])))
            for spk in range(s)])

        ex = {
            'example_id': f'sim_{index}',
            'num_samples': num_samples,
            'audio_data': {
                'observation': observation,
                'speaker_reverberation_early_ch0': images[:, 0],
                'vad': vad,
            },
            'auxInput': aux.astype(np.float32),
            'dataset': 'simulated',
        }
        if transcription is not None:
            ex['transcription'] = transcription
        return ex

    def __iter__(self):
        i = 0
        while True:
            yield self.example(i)
            i += 1


def simulate_corpus(shard_path, num_examples, simulator: MeetingSimulator = None,
                    **kwargs):
    """Simulate ``num_examples`` meetings into a native shard file."""
    from tssep_tpu_torch.runtime.native import ShardWriter
    if simulator is None:
        simulator = MeetingSimulator(**kwargs)
    with ShardWriter(shard_path) as w:
        for i in range(num_examples):
            ex = simulator.example(i)
            payload = {
                'observation': ex['audio_data']['observation'],
                'speaker_reverberation_early_ch0':
                    ex['audio_data']['speaker_reverberation_early_ch0'],
                'vad': ex['audio_data']['vad'],
                'auxInput': ex['auxInput'],
            }
            if 'transcription' in ex:
                from tssep_tpu_torch.data.import_corpus import _encode_strings
                payload['transcription'] = _encode_strings(
                    ex['transcription'])
            w.add_example(ex['example_id'], payload)
    return shard_path
