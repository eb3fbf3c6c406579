"""Streaming, low-latency inference: port of ``tssep_tpu/eval/streaming.py``.

The model runs on a stream of audio with bounded latency, as the JAX
package's ``StreamingSession`` runs it:

- audio arrives in blocks of any length; the session keeps a buffer of
  samples and of STFT frames, and emits masks and activity for
  ``chunk_frames`` frames once ``chunk_frames + lookahead_frames`` frames
  exist: the algorithmic latency is (chunk + lookahead) frames;
- the forward LSTM directions are exact: their ``(h, c)`` carries are
  committed at each chunk boundary and continue across blocks
  (:func:`_blstm_streaming`);
- the reverse directions run again for each block over chunk + lookahead
  from a zero state, the only approximation, bounded by the lookahead (with
  a lookahead that covers the rest of the utterance the output is the
  offline forward's);
- feature statistics that are global offline (the max norm's max, the MVN
  mean, the MFCC's top-dB reference) are running statistics, through the
  extractors' ``streaming_feature`` protocol (``features/extractor.py``);
  extractors with no causal form raise;
- with ``emit_audio=True`` the session also masks each chunk and
  synthesizes it by an overlap-add that carries the ``window_length -
  shift`` unfinished tail, emitting audio with the latency of the masks.

The host side (sample and frame buffers, the causal STFT, the features, the
overlap-add) is numpy, as in the JAX package. The block function runs on
the model's device: every LSTM direction through ``kernels.blstm.lstm_fwd``
(the CUDA kernel on the card, its plain version on the CPU), three launches
a layer and block where JAX runs three ``lax.scan``\\ s; the input
projections ``x W_ih^T + b`` are matrix products outside the kernel, as in
JAX.

Usage::

    sess = StreamingSession(model, aux, chunk_frames=50,
                            lookahead_frames=12, emit_audio=True)
    for block in audio_blocks:                 # any number of samples
        for masks, activity, audio in sess.process(block):
            ...         # (S, nmask, chunk, F), (S, chunk), (S, samples)
    for masks, activity, audio in sess.flush():
        ...
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from tssep_tpu_torch.kernels.blstm import lstm_fwd

__all__ = ['StreamingSession']


def _direction_inputs(layer, x, suffix, dtype):
    """Gate inputs ``x W_ih^T + b`` (B, T, 4H) and W_hh^T (H, 4H) of one
    direction of ``layer`` (a ``nn.rnnp.BLSTM``), in ``dtype``."""
    w_ih = getattr(layer, 'weight_ih_l0' + suffix).to(dtype)
    bias = (getattr(layer, 'bias_ih_l0' + suffix)
            + getattr(layer, 'bias_hh_l0' + suffix)).to(dtype)
    w_hh_t = getattr(layer, 'weight_hh_l0' + suffix).t().to(dtype)
    return nn.functional.linear(x.to(dtype), w_ih, bias), w_hh_t.contiguous()


def _blstm_streaming(layer, x, split, state, dtype):
    """One BLSTM layer over a block ``x = [chunk | lookahead]``, (B, T, I).

    Forward direction: exact and stateful across blocks, from ``state``
    (``(h, c)``, each (B, H) in ``dtype``, or None for zeros); the carry is
    committed at ``split``, the chunk boundary. Reverse direction: from
    zeros over the whole block. Returns (out (B, T, 2H), state at split)."""
    xg, w_hh_t = _direction_inputs(layer, x, '', dtype)
    h0, c0 = (None, None) if state is None else state
    h_chunk, c_chunk = lstm_fwd(xg[:, :split], w_hh_t, with_cell=True,
                                h0=h0, c0=c0)
    state_mid = (h_chunk[:, -1].contiguous(), c_chunk[:, -1].contiguous())
    parts = [h_chunk]
    if split < x.shape[1]:
        parts.append(lstm_fwd(xg[:, split:], w_hh_t, h0=state_mid[0],
                              c0=state_mid[1])[0])
    xg_r, w_hh_t_r = _direction_inputs(layer, x, '_reverse', dtype)
    h_rev, _ = lstm_fwd(xg_r, w_hh_t_r, reverse=True)
    return torch.cat([torch.cat(parts, dim=1), h_rev], dim=-1), state_mid


def _rnnp_streaming(block, x, split, states):
    """An RNNP stack (``nn.rnnp.RNNP``) over a block; rank-3 or rank-4
    input, as ``RNNP.forward`` takes it. Returns (out, states at split)."""
    lead = x.shape[:-2]
    h = x.reshape((-1,) + x.shape[-2:])
    if states is None:
        states = [None] * block.elayers
    new_states = []
    for i in range(block.elayers):
        h, state = _blstm_streaming(getattr(block, f'lstm{i}'), h, split,
                                    states[i], block.storage_dtype)
        new_states.append(state)
        h = block._project(i, h)
        if i < block.elayers - 1:
            h = torch.tanh(h)
    return h.reshape(lead + h.shape[-2:]), new_states


@dataclasses.dataclass
class StreamingSession:
    """Stateful incremental inference over one recording.

    model: the port's ``tasks.model.Model`` (its weights and device); aux:
    (S, A) enrollment embeddings, or aux frames where the model has an
    ``aux_net``."""

    model: object
    aux: object
    chunk_frames: int = 50
    lookahead_frames: int = 12
    #: emit separated audio for each chunk (masking and the overlap-add of
    #: the ISTFT, the offline synthesis of reference ``model.py:661-664``):
    #: ``process`` and ``flush`` then yield ``(masks, activity, audio (S,
    #: samples))`` triples.
    emit_audio: bool = False

    def __post_init__(self):
        me = self.model.mask_estimator
        if me.num_averaged_permutations not in (0, 1):
            raise ValueError('streaming supports num_averaged_permutations '
                             f'<= 1, got {me.num_averaged_permutations}')
        self.device = self.model.device
        aux = torch.as_tensor(np.asarray(self.aux), dtype=torch.float32,
                              device=self.device)[None]   # (1, S, A)
        with torch.no_grad():
            if me.aux_net is not None:
                aux = me.aux_net(aux)
            elif me.aux_normalizer is not None:
                aux = me.aux_normalizer(aux)
        self._aux = aux.to(me.storage_dtype)               # (1, S, A')
        self._states = {'pre_net': None,
                        **{f'birnn{i}': None for i in range(me.layers)}}
        self._sample_buf = np.zeros(0, dtype=np.float32)
        self._frame_buf = None                             # (T, F) complex
        self._fe_state = self.model.fe.init_streaming_state()
        self._ola_tail = None                              # (S, wl - shift)
        if self.emit_audio:
            fe = self.model.fe
            if me.odim != fe.size // 2 + 1:
                raise ValueError(
                    f'emit_audio needs masks over all STFT bins: odim='
                    f'{me.odim} != {fe.size // 2 + 1} frequencies')

    # -- device block function --------------------------------------------
    @torch.no_grad()
    def _block_fn(self, feats, states, split):
        """Logits (1, S, nmask, T, F') of a block's features (T, F) and the
        LSTM states committed at ``split``."""
        me = self.model.mask_estimator
        xs = feats[None]                                   # (1, T, F)
        new_states = dict(states)
        if me.input_normalizer is not None:
            xs = me.input_normalizer(xs)
        if me.pre_net is not None:
            xs, new_states['pre_net'] = _rnnp_streaming(
                me.pre_net, xs, split, states['pre_net'])
        xs = xs.to(me.storage_dtype)
        aux = self._aux
        if me.combination == 'mul':
            h = xs[:, None, :, :] * aux[:, :, None, :]
        else:
            B, T, S = xs.shape[0], xs.shape[1], aux.shape[1]
            h = torch.cat(
                [xs[:, None].expand(B, S, T, xs.shape[-1]),
                 aux[:, :, None, :].expand(B, S, T, aux.shape[-1])], dim=-1)
        for l in range(me.layers):
            if l == me.layers - 1 and me.ts_vad:
                # cross-speaker stacking: (B, S, T, F) -> (B, 1, T, S F)
                h = h.transpose(1, 2).reshape(h.shape[0], h.shape[2], 1,
                                              -1).transpose(1, 2)
            h, new_states[f'birnn{l}'] = _rnnp_streaming(
                getattr(me.post_net, f'birnn{l}'), h, split,
                states[f'birnn{l}'])
            if l < me.layers - 1:
                h = torch.tanh(h)
        lin = getattr(me.post_net, f'linear{me.layers - 1}')
        logit = nn.functional.linear(h, lin.weight.to(h.dtype),
                                     lin.bias.to(h.dtype))
        logit = me.reshape_head(logit, self._aux.shape[1], feats.shape[0])
        return logit, new_states

    # -- host-side buffering ----------------------------------------------
    def _stft_more(self):
        """Turns the buffered samples into whole STFT frames (causal: no
        fading pre-roll; a frame is made once its window is complete)."""
        fe = self.model.fe
        wl, shift = fe.window_length, fe.shift
        n = len(self._sample_buf)
        if n < wl:
            return
        num_frames = (n - wl) // shift + 1
        seg = self._sample_buf[:(num_frames - 1) * shift + wl]
        frames = np.lib.stride_tricks.sliding_window_view(seg, wl)[::shift]
        window = np.asarray(fe._stft.analysis_window)
        spec = np.fft.rfft(frames * window, n=fe.size, axis=-1)
        self._sample_buf = self._sample_buf[num_frames * shift:]
        self._frame_buf = (spec if self._frame_buf is None
                           else np.concatenate([self._frame_buf, spec]))

    def _emit_ready(self, final=False):
        """Yields (masks, activity[, audio]) for each complete chunk."""
        need = self.chunk_frames + self.lookahead_frames
        while self._frame_buf is not None and (
                len(self._frame_buf) >= need
                or (final and len(self._frame_buf) > 0)):
            block = self._frame_buf[:need]
            split = min(self.chunk_frames, len(block))
            feats = np.asarray(self._features(block, split),
                               dtype=np.float32)
            logit, self._states = self._block_fn(
                torch.from_numpy(feats).to(self.device), self._states,
                int(split))
            sig = torch.sigmoid(logit[0])                  # (S, nmask, T, F')
            masks = sig[..., :split, :].float().cpu().numpy()
            # each speaker's frame activity: the mask's mean over (nmask, F)
            activity = masks.mean(axis=(-3, -1))
            last = len(self._frame_buf) <= split
            if self.emit_audio:
                audio = self._synthesize(
                    masks[:, 0] * block[None, :split], final=final and last)
            self._frame_buf = self._frame_buf[split:]
            if len(self._frame_buf) == 0:
                self._frame_buf = None
            if self.emit_audio:
                yield masks, activity, audio
            else:
                yield masks, activity

    def _features(self, block, split=None):
        """Block features with causal statistics.

        The statistics look at the whole visible block (committed frames,
        chunk and lookahead, all within the latency budget; with a covering
        lookahead this gives the offline utterance statistics), but only
        the first ``split`` frames are committed into the kept state, so
        lookahead frames seen again next block are not counted twice."""
        fe = self.model.fe
        feats, peek_state = fe.streaming_feature(block, self._fe_state)
        commit = block if split is None else block[:split]
        if len(commit) == len(block):
            self._fe_state = peek_state
        else:
            _, self._fe_state = fe.streaming_feature(commit, self._fe_state)
        return feats

    def _synthesize(self, masked, final=False):
        """Streaming ISTFT: the overlap-add of ``masked`` (S, T, F) complex
        frames, carrying the (window_length - shift) unfinished tail across
        chunks; sample for sample the offline ``signal.stft.STFT.istft``
        with ``fading=False``."""
        fe = self.model.fe
        wl, shift = fe.window_length, fe.shift
        T = masked.shape[-2]
        segs = np.fft.irfft(masked, n=fe.size, axis=-1)[..., :wl]
        segs = segs * np.asarray(fe._stft.synthesis_window)
        total = (T - 1) * shift + wl
        out = np.zeros(masked.shape[:-2] + (total,), dtype=segs.dtype)
        for f in range(T):
            out[..., f * shift:f * shift + wl] += segs[..., f, :]
        if self._ola_tail is not None:
            out[..., :wl - shift] += self._ola_tail
        if final:
            self._ola_tail = None
            return out
        self._ola_tail = out[..., T * shift:]
        return out[..., :T * shift]

    def process(self, samples):
        """Feeds a block of audio samples; yields zero or more
        ``(masks (S, nmask, chunk, F), activity (S, chunk))`` chunks."""
        self._sample_buf = np.concatenate(
            [self._sample_buf, np.asarray(samples, dtype=np.float32)])
        self._stft_more()
        yield from self._emit_ready()

    def flush(self):
        """Emits everything left in the buffers (end of stream)."""
        self._stft_more()
        yield from self._emit_ready(final=True)
