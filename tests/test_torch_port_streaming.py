"""The port's streaming inference (``tssep_tpu_torch/eval/streaming.py``) and
the carried state of ``lstm_fwd`` against ``tssep_tpu`` on the CPU.

The model is ``tests/test_streaming.py``'s toy (fe 64/32, 4 kHz, units 4,
projs 5, 'mul', TS-VAD 4, four speakers, 'tf'), its weights drawn by JAX and
carried across by name (``compat/from_jax.py``), the audio and the aux
embeddings made with numpy from a seed. Both sessions get the same samples
in the same blocks. Tolerances, float32 on both sides, summed in other
orders through four recurrent layers: 1e-4 for masks, activity and audio
(the JAX streaming test's own 2e-5 against offline, with room for the two
packages' sum orders); 1e-5 for one LSTM direction with a carried state
against JAX's ``_lstm_scan``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tssep_tpu.eval.streaming import StreamingSession as JaxSession
from tssep_tpu.features import extractor as jax_fe
from tssep_tpu.nn import rnnp as jax_rnnp
from tssep_tpu.nn.rnnp import _lstm_scan
from tssep_tpu.tasks.model import Model as JaxModel
from tssep_tpu.train.checkpoint import params_to_named
from tssep_tpu_torch.compat.from_jax import load_named
from tssep_tpu_torch.eval.streaming import StreamingSession
from tssep_tpu_torch.features import extractor as fe
from tssep_tpu_torch.kernels import blstm as kb
from tssep_tpu_torch.signal.stft import STFT
from tssep_tpu_torch.tasks.model import Model

ATOL = 1e-4
SCAN_ATOL = 1e-5
CONFIG = {
    'fe': {'size': 64, 'shift': 32, 'window_length': 64},
    'reader': {'sample_rate': 4000, 'aux_size': 33},
    'mask_estimator': {'units': 4, 'projs': 5, 'combination': 'mul',
                       'ts_vad': 4, 'aux_net_output_size': 33,
                       'num_averaged_permutations': 1,
                       'output_resolution': 'tf'},
}
BLOCK = 1500


@pytest.fixture(scope='module', autouse=True)
def _scan_unroll_1():
    """JAX's scans unrolled once: its block functions compile in a fraction
    of the time, to the same values."""
    saved = jax_rnnp.DEFAULT_UNROLL
    jax_rnnp.DEFAULT_UNROLL = 1
    yield
    jax_rnnp.DEFAULT_UNROLL = saved


def _jax_params(init, seed=0):
    """A JAX params tree with ``init``'s names and shapes (``eval_shape``:
    no JAX draw to compile), its values drawn by numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda leaf: jnp.asarray(rng.uniform(-0.5, 0.5, leaf.shape).astype(
            np.float32)), jax.eval_shape(init, jax.random.PRNGKey(0)))


@pytest.fixture(scope='module')
def setup():
    jm = JaxModel.new(CONFIG)
    params = _jax_params(jm.init_params)
    ours = Model.from_config(CONFIG, storage_dtype=torch.float32,
                             device='cpu')
    load_named(ours, params_to_named(params))
    rng = np.random.RandomState(0)
    samples = rng.randn(4000).astype(np.float32)
    aux = rng.randn(4, 33).astype(np.float32)
    return jm, params, ours, samples, aux


def _collect(session, samples, block=BLOCK):
    chunks = []
    for i in range(0, len(samples), block):
        chunks.extend(session.process(samples[i:i + block]))
    chunks.extend(session.flush())
    return chunks


# -- the kernel's carried state ----------------------------------------------

@pytest.mark.parametrize('B,T,reverse', [(1, 12, False), (3, 7, True),
                                         (8, 5, False)])
def test_lstm_fwd_plain_with_state_matches_jax_scan(B, T, reverse):
    """``lstm_fwd`` (its plain version on the CPU) from a nonzero
    ``(h0, c0)`` against ``_lstm_scan(return_state=True)``: every h and c,
    and the final carry (the streaming session commits it)."""
    H = 6
    rng = np.random.default_rng(B * 100 + T)
    xg = rng.standard_normal((B, T, 4 * H)).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (4 * H, H)) / np.sqrt(H)).astype(np.float32)
    h0 = rng.uniform(-1, 1, (B, H)).astype(np.float32)
    c0 = rng.uniform(-2, 2, (B, H)).astype(np.float32)
    before = kb.lstm_fwd.launches
    h, c = kb.lstm_fwd(torch.from_numpy(xg), torch.from_numpy(w_hh.T.copy()),
                       reverse=reverse, with_cell=True,
                       h0=torch.from_numpy(h0), c0=torch.from_numpy(c0))
    assert kb.lstm_fwd.launches == before      # the CPU runs no kernel
    ys, (h_t, c_t) = _lstm_scan(jnp.swapaxes(jnp.asarray(xg), 0, 1),
                                jnp.asarray(w_hh), jnp.asarray(h0),
                                jnp.asarray(c0), reverse=reverse,
                                return_state=True)
    np.testing.assert_allclose(h.numpy(), np.swapaxes(np.asarray(ys), 0, 1),
                               atol=SCAN_ATOL, rtol=0)
    last = 0 if reverse else -1
    np.testing.assert_allclose(h[:, last].numpy(), np.asarray(h_t),
                               atol=SCAN_ATOL, rtol=0)
    np.testing.assert_allclose(c[:, last].numpy(), np.asarray(c_t),
                               atol=SCAN_ATOL, rtol=0)
    # no state is the zero state
    zero = torch.zeros(B, H)
    np.testing.assert_array_equal(
        kb.lstm_fwd(torch.from_numpy(xg), torch.from_numpy(w_hh.T.copy()),
                    reverse=reverse, h0=zero, c0=zero)[0].numpy(),
        kb.lstm_fwd(torch.from_numpy(xg), torch.from_numpy(w_hh.T.copy()),
                    reverse=reverse)[0].numpy())


def test_lstm_fwd_state_is_checked():
    xg, w = torch.zeros(2, 3, 16), torch.zeros(4, 16)
    with pytest.raises(ValueError, match='together'):
        kb.lstm_fwd(xg, w, h0=torch.zeros(2, 4))
    with pytest.raises(ValueError):
        kb.lstm_fwd(xg, w, h0=torch.zeros(3, 4), c0=torch.zeros(3, 4))
    with pytest.raises(ValueError):
        kb.lstm_fwd(xg, w, h0=torch.zeros(2, 4, dtype=torch.bfloat16),
                    c0=torch.zeros(2, 4, dtype=torch.bfloat16))


# -- the session against JAX's -----------------------------------------------

def _assert_chunks_match(ours, ref):
    assert len(ours) == len(ref)
    for got, want in zip(ours, ref):
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.shape == np.asarray(w).shape
            np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)


def test_streaming_matches_jax_bounded_lookahead(setup):
    """A lookahead of 8 frames: every chunk's masks, activity and audio are
    JAX's. (124 frames: two blocks of 66 and a last one of 8, so JAX
    compiles its block function twice.)"""
    jm, params, ours, samples, aux = setup
    kw = dict(chunk_frames=58, lookahead_frames=8, emit_audio=True)
    got = _collect(StreamingSession(ours, aux, **kw), samples)
    want = _collect(JaxSession(jm, params, aux, **kw), samples)
    assert [m.shape[-2] for m, _, _ in got] == [58, 58, 8]
    _assert_chunks_match(got, want)


@pytest.mark.slow
def test_streaming_matches_jax_covering_lookahead(setup):
    """A lookahead that covers the utterance, chunks of 16 frames as in
    ``tests/test_streaming.py`` (slow there too: JAX compiles the block
    function for each block length)."""
    jm, params, ours, samples, aux = setup
    kw = dict(chunk_frames=16, lookahead_frames=1000, emit_audio=True)
    got = _collect(StreamingSession(ours, aux, **kw), samples)
    want = _collect(JaxSession(jm, params, aux, **kw), samples)
    _assert_chunks_match(got, want)


def _offline(model, session, samples, aux):
    """The causal frame matrix of ``samples`` (as the session frames it), its
    features, and the offline model's masks on them (1, S, 1, T, F)."""
    session._sample_buf = np.concatenate([session._sample_buf, samples])
    session._stft_more()
    frames = session._frame_buf
    feats = session._features(frames).astype(np.float32)
    out = model({'Input': feats[None], 'auxInput': aux[None],
                 'Observation': frames[None, None].astype(np.complex64),
                 'reference_channel': 0})
    return frames, out.mask[0].numpy()


def test_streaming_with_covering_lookahead_is_offline(setup):
    """With a lookahead that covers the utterance, the streamed masks are the
    port's offline ``Model.forward`` on the same causal frames, and the
    streamed audio the offline synthesis (``fading=False``) of those frames
    masked (JAX: ``tests/test_streaming.py``'s two slow tests)."""
    _, _, ours, samples, aux = setup
    sess = StreamingSession(ours, aux, chunk_frames=16,
                            lookahead_frames=1000, emit_audio=True)
    chunks = _collect(sess, samples)
    masks = np.concatenate([m for m, _, _ in chunks], axis=-2)
    audio = np.concatenate([a for _, _, a in chunks], axis=-1)
    frames, offline = _offline(
        ours, StreamingSession(ours, aux, chunk_frames=10 ** 6), samples,
        aux)
    assert masks.shape == offline.shape
    np.testing.assert_allclose(masks, offline, atol=ATOL, rtol=0)
    fe_ = ours.fe
    nofade = STFT(size=fe_.size, shift=fe_.shift,
                  window_length=fe_.window_length, fading=False,
                  window=fe_.window)
    want = nofade.istft(torch.from_numpy(offline[:, 0] * frames[None]))
    assert audio.shape == tuple(want.shape)
    np.testing.assert_allclose(audio, want.numpy(), atol=ATOL, rtol=0)


def test_streaming_bounded_lookahead_approximates_offline(setup):
    _, _, ours, samples, aux = setup
    sess = StreamingSession(ours, aux, chunk_frames=16, lookahead_frames=8)
    masks = np.concatenate([m for m, _ in _collect(sess, samples)], axis=-2)
    _, offline = _offline(
        ours, StreamingSession(ours, aux, chunk_frames=10 ** 6), samples,
        aux)
    assert masks.shape == offline.shape
    assert np.abs(masks - offline).mean() < 0.1   # masks lie in [0, 1]


def test_streaming_emission_latency(setup):
    """A chunk is emitted as soon as chunk + lookahead frames exist, and
    nothing is held back beyond that."""
    _, _, ours, samples, aux = setup
    chunk, look = 8, 4
    sess = StreamingSession(ours, aux, chunk_frames=chunk,
                            lookahead_frames=look)
    need = (chunk + look - 1) * ours.fe.shift + ours.fe.window_length
    assert list(sess.process(samples[:need - 1])) == []
    emitted = list(sess.process(samples[need - 1:need]))
    assert len(emitted) == 1
    masks, activity = emitted[0]
    assert masks.shape == (4, 1, chunk, 33)
    assert activity.shape == (4, chunk)
    assert np.all((activity >= 0) & (activity <= 1))


def test_streaming_launches_three_per_layer_and_block(setup, monkeypatch):
    """Each LSTM layer of a block calls ``lstm_fwd`` three times (chunk from
    the carried state, lookahead from the committed state, reverse from
    zeros), twice where the block has no lookahead left; the chunk call
    starts from the state the previous block committed."""
    _, _, ours, samples, aux = setup
    from tssep_tpu_torch.eval import streaming
    calls = []
    real = streaming.lstm_fwd

    def counted(xg, w_hh_t, **kw):
        calls.append((xg.shape[1], kw.get('h0') is not None,
                      kw.get('reverse', False)))
        return real(xg, w_hh_t, **kw)

    monkeypatch.setattr(streaming, 'lstm_fwd', counted)
    sess = StreamingSession(ours, aux, chunk_frames=40, lookahead_frames=8)
    chunks = _collect(sess, samples)
    layers = 1 + ours.mask_estimator.layers
    # 124 frames: blocks of 48, 48 and 44 frames (chunk 40), then the last 4
    assert len(chunks) == 4
    assert len(calls) == layers * (3 + 3 + 3 + 2)
    first = calls[:3 * layers]
    assert first[0] == (40, False, False)       # no state before the first
    assert first[1] == (8, True, False)
    assert first[2] == (48, False, True)
    assert calls[3 * layers] == (40, True, False)   # the committed state


@pytest.mark.parametrize('name', ['Log1pMaxNormAbsSTFT', 'MVNLog1pAbsSTFT'])
def test_streaming_session_features_match_jax(setup, name):
    """The session's causal features, committed state and peeked block,
    against JAX's for the running-max and running-mean extractors."""
    jm, params, ours, samples, aux = setup
    jax_cls, cls = getattr(jax_fe, name), getattr(fe, name)
    kw = dict(size=64, shift=32, window_length=64)
    saved = jm.fe, ours.fe
    jm.fe, ours.fe = jax_cls(**kw), cls(**kw)
    try:
        a = JaxSession(jm, params, aux, chunk_frames=10, lookahead_frames=5)
        b = StreamingSession(ours, aux, chunk_frames=10, lookahead_frames=5)
        for s in (a, b):
            s._sample_buf = samples
            s._stft_more()
        np.testing.assert_array_equal(a._frame_buf, b._frame_buf)
        for i in range(0, 60, 10):
            block = a._frame_buf[i:i + 15]
            np.testing.assert_allclose(b._features(block, 10),
                                       a._features(block, 10), rtol=1e-6)
    finally:
        jm.fe, ours.fe = saved


# -- the extractors' streaming protocol ---------------------------------------

def _frames(n=40, F=33, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, F) + 1j * rng.randn(n, F)).astype(np.complex64)


def _stream(extractor, frames, step):
    state = extractor.init_streaming_state()
    parts = []
    for i in range(0, len(frames), step):
        f, state = extractor.streaming_feature(frames[i:i + step], state)
        parts.append(np.asarray(f))
    return np.concatenate(parts), state


@pytest.mark.parametrize('name,kwargs,boost', [
    ('Log1pAbsSTFT', {}, 1),
    ('AbsSTFT', {}, 1),
    ('NoFeatureSTFT', {}, 1),
    ('Log1pMaxNormAbsSTFT', {'statistics_axis': 'tf'}, 10),
    ('Log1pMaxNormAbsSTFT', {'statistics_axis': 't'}, 10),
    ('Log1pMaxNormAbsSTFT', {'statistics_axis': 'f'}, 1),
    ('MVNLog1pAbsSTFT', {}, 1),
    ('MFCC', {'n_mfcc': 5, 'n_mels': 8, 'f_max': -8, 'sample_rate': 16000},
     100),
    ('MFCC', {'n_mfcc': 5, 'n_mels': 8, 'f_max': -8, 'sample_rate': 16000,
              'log_mels': True}, 1),
])
def test_streaming_feature_matches_jax(name, kwargs, boost):
    """Block by block with the causal statistics, each extractor's features
    and state are JAX's; frame-local ones equal their offline features, and
    the running statistics equal offline once they have seen the maximum
    (boosted into the first block, as in ``tests/test_streaming.py``)."""
    frames = _frames()
    frames[:7] *= boost
    ours = getattr(fe, name)(size=64, shift=32, **kwargs)
    ref = getattr(jax_fe, name)(size=64, shift=32, **kwargs)
    got, state = _stream(ours, frames, 7)
    want, ref_state = _stream(ref, frames, 7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if name == 'MVNLog1pAbsSTFT':
        assert state['count'] == ref_state['count'] == 40
        np.testing.assert_allclose(state['sum'] / 40,
                                   np.log1p(np.abs(frames)).mean(axis=-2),
                                   rtol=1e-5)
    else:
        offline = ours.stft_to_feature(torch.from_numpy(frames)).numpy()
        np.testing.assert_allclose(got, offline, rtol=1e-4, atol=1e-4)


def test_streaming_feature_concatenation_and_ipd():
    """The concatenation streams each part with its own state; the IPD
    extractors and the plain STFT (no causal form) raise, as in JAX."""
    frames = _frames()
    kw = dict(size=64, shift=32)
    parts = [fe.Log1pMaxNormAbsSTFT(**kw),
             fe.MFCC(n_mfcc=5, n_mels=8, f_max=-8, **kw)]
    ours = fe.ConcatenatedSTFTFeatures(*parts, **kw)
    ref = jax_fe.ConcatenatedSTFTFeatures(
        jax_fe.Log1pMaxNormAbsSTFT(**kw),
        jax_fe.MFCC(n_mfcc=5, n_mels=8, f_max=-8, **kw), **kw)
    np.testing.assert_allclose(_stream(ours, frames, 9)[0],
                               _stream(ref, frames, 9)[0], rtol=1e-5,
                               atol=1e-5)
    two = np.stack([frames, frames])
    for cls in (fe.AbsIPDSTFT, fe.Log1pAbsIPDSTFT, fe.Log1pMaxNormAbsIPDSTFT,
                fe.STFTFeatures):
        extractor = cls(**kw)
        with pytest.raises(NotImplementedError):
            extractor.streaming_feature(two, extractor.init_streaming_state())
