"""In-framework CTC word recognizer — a REAL ASR behind the WER harness:
port of ``tssep_tpu/eval/ctc.py``.

A small log-mel -> BLSTM (RNNP) -> CTC model over the meeting simulator's
closed word vocabulary (``data.simulate.MeetingSimulator(vocabulary=N)``).
The features are the JAX package's numpy code (float64 STFT, float32
log-mels), so they are JAX's bit for bit. The network is the port's
``RNNP`` (its BLSTM layer through the fully fused kernel pair on the card)
and a linear head, stored and computed in float32 as JAX computes it; the
loss is ``torch.nn.functional.ctc_loss`` where JAX takes optax's, the
optimizer the port's Adam with optax's defaults. Weights and batches are
drawn from seeded ``torch.Generator``s (JAX: ``jax.random``), the
utterance corpus from numpy ``RandomState(seed + 1234)`` as in JAX.

Usage::

    sim = MeetingSimulator(vocabulary=10, speaker_pool=16, ...)
    asr = CTCRecognizer.train_on(sim, steps=300)      # on the card
    asr(samples, sample_rate) -> 'w3 w7 w1 ...'   # Transcriber contract

The trained instance plugs into ``eval.run.evaluate(transcriber=asr)`` /
``EvalDriver.score_wer`` for end-to-end cpWER / ORC-WER on separated
streams. ``save``/``load`` keep JAX's npz layout (``rnnp/lstm0/...``,
``head/weight``, ``head/bias``), so a ``ctc_asr.npz`` that either package
wrote loads into the other.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from tssep_tpu_torch.eval.wer import Transcriber
from tssep_tpu_torch.nn.init import linear_init_
from tssep_tpu_torch.nn.rnnp import RNNP
from tssep_tpu_torch.signal.mel import mel_filterbank
from tssep_tpu_torch.signal.stft import STFT
from tssep_tpu_torch.train.optimizer import Adam
from tssep_tpu_torch.utils.device import resolve_device

__all__ = ['CTCRecognizer']


class CTCRecognizer(Transcriber):
    """Log-mel -> RNNP(BLSTM) -> linear -> CTC; greedy decode.

    Token 0 is the CTC blank; tokens 1..vocabulary map to words
    ``w0..w{vocabulary-1}``. ``device`` (the card unless ``'cpu'``) is the
    port's own argument; the network stores and computes in float32.
    """

    def __init__(self, vocabulary=10, sample_rate=16000, n_mels=40,
                 stft_size=512, stft_shift=160, units=48, projs=48,
                 elayers=1, subsample=3, seed=0, *, device='cuda'):
        self.vocabulary = int(vocabulary)
        self.sample_rate = sample_rate
        self.subsample = int(subsample)
        self.device = resolve_device(device)
        self.stft = STFT(size=stft_size, shift=stft_shift, window='hann')
        self.fbank = np.asarray(mel_filterbank(
            n_freqs=stft_size // 2 + 1, f_min=40,
            f_max=sample_rate // 2 - 100, n_mels=n_mels,
            sample_rate=sample_rate), dtype=np.float32)
        self.rnnp = RNNP(idim=n_mels * self.subsample, elayers=elayers,
                         cdim=units, hdim=projs, typ='blstm',
                         storage_dtype=torch.float32, device=self.device)
        self.head = nn.Linear(projs, self.vocabulary + 1, device=self.device)
        generator = torch.Generator().manual_seed(seed)
        self.rnnp.init_params(generator)
        linear_init_(self.head, generator)

    def parameters(self):
        return [*self.rnnp.parameters(), *self.head.parameters()]

    # -- model ------------------------------------------------------------
    def features(self, samples):
        """samples (..., T) -> MVN log-mel, x``subsample`` frame-stacked:
        (..., frames // subsample, n_mels * subsample) (numpy).

        Per-utterance mean/variance normalization over time makes the
        features level- and timbre-offset-invariant — train and inference
        MUST share this (a scale mismatch between them is unlearnable).
        Frame stacking shortens the CTC sequence 3x: without it the loss
        sits in the blank-collapse plateau for thousands of steps (CPU
        probe: sub=1 first fits the train set ~step 3000, sub=3 by 1000)."""
        spec = np.abs(self.stft.stft(np.asarray(samples, dtype=np.float64)))
        feats = np.log(spec.astype(np.float32) ** 2 @ self.fbank + 1e-6)
        mean = feats.mean(axis=-2, keepdims=True)
        std = feats.std(axis=-2, keepdims=True)
        feats = ((feats - mean) / (std + 1e-5)).astype(np.float32)
        s = self.subsample
        if s > 1:
            n = feats.shape[-2] // s
            feats = feats[..., :n * s, :].reshape(
                feats.shape[:-2] + (n, s * feats.shape[-1]))
        return feats

    def _logits(self, feats):
        """feats (B, T, M) float32 tensor -> (B, T, vocabulary + 1)."""
        h = self.rnnp(feats)
        return h @ self.head.weight.T + self.head.bias

    # -- training ----------------------------------------------------------
    def loss_fn(self, feats, feat_pad, labels, label_pad):
        """CTC loss, the mean over the batch of each sequence's negative
        log-likelihood (optax ``ctc_loss`` then ``jnp.mean``); feats (B, T,
        M) 0-padded with (B, T) ``feat_pad`` marking the padding (1.0);
        labels (B, L) 1-based, 0-padded, ``label_pad`` likewise. An
        infeasible sequence gives ``inf`` (optax: a large finite value)."""
        logits = self._logits(feats)
        log_probs = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
        input_lengths = (1 - feat_pad).sum(-1).round().long()
        target_lengths = (1 - label_pad).sum(-1).round().long()
        return nn.functional.ctc_loss(
            log_probs, labels.long(), input_lengths, target_lengths, blank=0,
            reduction='none', zero_infinity=False).mean()

    @classmethod
    def train_on(cls, simulator, steps=1600, batch=16, lr=2e-3,
                 utt_seconds=1.8, seed=0, verbose=False, corpus_size=768,
                 **kwargs):
        """Train on single-speaker word utterances drawn from the
        simulator's voice distribution (closed speaker pool honored).

        Utterance lengths vary per example (0.5..1 x ``utt_seconds``,
        features padded + CTC logit paddings): the recognizer transcribes
        variable-length separated turns at eval time, and fixed-length
        training measurably over-fits the length (heldout WER 0.33 at a
        1.2s-train/1.6s-eval mismatch vs matched-length training).
        The class defaults to ``elayers=1``: the 2-layer net sits in the
        CTC blank-collapse plateau ~4x longer (CPU probe, round 4;
        loss stuck ~3.5 at step 800 vs 0.7 for 1 layer).

        ``corpus_size`` utterances are synthesized/featurized ONCE up
        front, on the host, and copied to the device; each step samples a
        batch from them. ``kwargs`` go to the constructor (``device``
        among them). Raises if a step's loss was not finite."""
        assert simulator.vocabulary > 0, 'simulator needs vocabulary > 0'
        self = cls(vocabulary=simulator.vocabulary,
                   sample_rate=simulator.sample_rate, seed=seed, **kwargs)
        rng = np.random.RandomState(seed + 1234)
        max_samples = int(simulator.sample_rate * utt_seconds)
        max_labels = int(utt_seconds
                         / (simulator.word_sec + simulator.word_gap_sec)) + 1
        max_frames = self.features(np.zeros(max_samples)).shape[0]

        feats, fpads, labels, pads = [], [], [], []
        for _ in range(corpus_size):
            f0, timbre = _draw_voice(simulator, rng)
            num_samples = rng.randint(max_samples // 2, max_samples + 1)
            sig, words = simulator.word_utterance(
                rng, num_samples, f0, timbre)
            # Domain-match the corpus reverberation: the eval targets are
            # ch0 *images* (direct path + decaying taps, simulate.py), and
            # a dry-trained recognizer collapses on them (R5G: cpWER floor
            # 0.5625 on ORACLE CLEAN streams vs 0.056 on dry speech).
            # Same tap distribution as the simulator.
            for tap in range(getattr(simulator, 'reverb_taps', 0)):
                d = rng.randint(40, 400)
                g = 0.5 ** (tap + 1) * rng.uniform(0.3, 1.0)
                tail = np.roll(sig, d) * g
                tail[:d] = 0
                sig = sig + tail
            snr = rng.uniform(8, 25)
            noise = rng.randn(num_samples).astype(np.float32)
            p_sig = np.mean(sig ** 2) + 1e-9
            noise *= np.sqrt(p_sig / np.mean(noise ** 2) / 10 ** (snr / 10))
            f = self.features(sig + noise)
            fp = np.zeros(max_frames, dtype=np.float32)
            fp[f.shape[0]:] = 1.0
            f = np.pad(f, [(0, max_frames - f.shape[0]), (0, 0)])
            feats.append(f)
            fpads.append(fp)
            ids = [int(w[1:]) + 1 for w in words][:max_labels]
            pad = [0.0] * len(ids) + [1.0] * (max_labels - len(ids))
            labels.append(ids + [0] * (max_labels - len(ids)))
            pads.append(pad)
        device = self.device
        feats = torch.as_tensor(np.stack(feats), device=device)
        fpads = torch.as_tensor(np.stack(fpads), device=device)
        labels = torch.as_tensor(np.asarray(labels, dtype=np.int32),
                                 device=device)
        pads = torch.as_tensor(np.asarray(pads, dtype=np.float32),
                               device=device)

        opt = Adam(gradient_clipping=None, lr=lr).make(self.parameters())
        generator = torch.Generator().manual_seed(seed + 5)
        bad = torch.zeros((), dtype=torch.bool, device=device)
        for it in range(steps):
            idx = torch.randint(0, corpus_size, (batch,),
                                generator=generator).to(device)
            opt.zero_grad()
            loss = self.loss_fn(feats[idx], fpads[idx], labels[idx],
                                pads[idx])
            loss.backward()
            opt.step()
            bad |= ~torch.isfinite(loss.detach())
            if verbose and (it % max(steps // 10, 1) == 0
                            or it == steps - 1):
                print(f'ctc step {it}: loss {loss.item():.4f}', flush=True)
        if bool(bad):
            raise RuntimeError('CTC training: a step\'s loss was not finite '
                               '(an utterance shorter than its labels)')
        return self

    # -- inference ----------------------------------------------------------
    def __call__(self, samples, sample_rate=16000):
        samples = np.asarray(samples, dtype=np.float32)
        if sample_rate != self.sample_rate:
            raise ValueError(f'sample rate {sample_rate} != '
                             f'{self.sample_rate}')
        if samples.size < self.stft.window_length:
            return ''
        if np.max(np.abs(samples)) < 1e-6:
            return ''
        feats = self.features(samples)
        if feats.shape[-2] == 0:
            return ''
        with torch.inference_mode():
            logits = self._logits(torch.as_tensor(feats[None],
                                                  device=self.device))[0]
            ids = torch.argmax(logits, dim=-1).cpu().numpy()
        # CTC collapse: drop repeats, then blanks
        out = []
        prev = -1
        for t in ids:
            if t != prev and t != 0:
                out.append(f'w{int(t) - 1}')
            prev = int(t)
        return ' '.join(out)

    # -- persistence ---------------------------------------------------------
    def save(self, path):
        flat = {}
        for group, module in (('rnnp', self.rnnp), ('head', self.head)):
            for name, value in module.state_dict().items():
                flat[f'{group}/{name.replace(".", "/")}'] = (
                    value.detach().cpu().numpy())
        np.savez(path, **flat)

    def load(self, path):
        flat = dict(np.load(path))
        vocabulary = int(flat['head/bias'].size - 1)
        if vocabulary != self.vocabulary:
            self.vocabulary = vocabulary
            self.head = nn.Linear(self.head.in_features, vocabulary + 1,
                                  device=self.device)
        for group, module in (('rnnp', self.rnnp), ('head', self.head)):
            prefix = f'{group}/'
            module.load_state_dict({
                k[len(prefix):].replace('/', '.'): torch.from_numpy(v)
                for k, v in flat.items() if k.startswith(prefix)})
        return self


@functools.lru_cache(maxsize=None)
def _pool_voice(pool_id):
    pr = np.random.RandomState(911_000_003 + int(pool_id))
    f0 = float(np.exp(pr.uniform(np.log(90), np.log(900))))
    timbre = int(pr.randint(0, 2 ** 31))
    return f0, timbre


def _draw_voice(simulator, rng):
    """Voice (f0, timbre) from the simulator's distribution — the SAME
    closed pool when one is configured (pool RNG seeds match
    ``MeetingSimulator.example``)."""
    if simulator.speaker_pool:
        return _pool_voice(rng.randint(simulator.speaker_pool))
    f0 = float(np.exp(rng.uniform(np.log(90), np.log(900))))
    return f0, int(rng.randint(0, 2 ** 31))
