"""The port's CTC word recognizer (``eval/ctc.py``) against ``tssep_tpu``'s
on the CPU: the numpy features exactly; with JAX's weights carried over by
JAX's ``save`` and the port's ``load``, the logits (JAX's BLSTM through its
fully fused Pallas kernel in interpret mode, as its kernel tests run it) and
the greedy decode; the CTC loss against optax's and every parameter's
gradient at 1e-4 on a padded batch (JAX's default CPU path, its scan);
``save``/``load`` both ways. Slow tier: a short training run through the
port's Adam lowers the loss."""

import jax
import numpy as np
import pytest
import torch

from tssep_tpu.data.simulate import MeetingSimulator as JaxSimulator
from tssep_tpu.eval import ctc as jax_ctc
from tssep_tpu.train.checkpoint import params_to_named
from tssep_tpu_torch.data.simulate import MeetingSimulator
from tssep_tpu_torch.eval import ctc

ATOL = 1e-4
WIDTHS = dict(vocabulary=6, units=8, projs=8)


@pytest.fixture
def pallas(monkeypatch):
    """JAX's RNNP through its Pallas kernels in the interpreter, with tiny
    blocking."""
    from tssep_tpu.kernels import blstm
    from tssep_tpu.nn import rnnp
    monkeypatch.setattr(blstm, 'INTERPRET', True)
    monkeypatch.setattr(blstm, 'BATCH_BLOCK', 8)
    monkeypatch.setattr(blstm, 'TIME_BLOCK', 4)
    monkeypatch.setattr(rnnp, '_FORCED_IMPL', 'pallas')


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    """(JAX recognizer, port recognizer with JAX's weights)."""
    path = tmp_path_factory.mktemp('ctc') / 'jax.npz'
    theirs = jax_ctc.CTCRecognizer(**WIDTHS, seed=1)
    theirs.save(path)
    ours = ctc.CTCRecognizer(**WIDTHS, device='cpu').load(path)
    return theirs, ours


def _speech(seconds, seed=0):
    sim = MeetingSimulator(vocabulary=6, speaker_pool=4)
    sig, _ = sim.word_utterance(np.random.RandomState(seed),
                                int(16000 * seconds), 140.0, 7)
    return sig + 0.01 * np.random.RandomState(seed).randn(sig.size)


def test_features_match_jax(pair):
    theirs, ours = pair
    rng = np.random.RandomState(0)
    for x in (_speech(1.0), rng.randn(2, 3000).astype(np.float32),
              np.zeros(700)):
        got, want = ours.features(x), theirs.features(x)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_logits_and_decode_match_jax(pallas, pair):
    theirs, ours = pair
    feats = theirs.features(_speech(0.8))[None]
    want = np.asarray(theirs._logits(theirs.params, feats))
    with torch.no_grad():
        got = ours._logits(torch.as_tensor(feats)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    for seed in range(3):
        x = _speech(0.8, seed)
        assert ours(x) == theirs(x)
    assert ours(np.zeros(8000)) == theirs(np.zeros(8000)) == ''
    with pytest.raises(ValueError):
        ours(x, sample_rate=8000)


def _batch():
    rng = np.random.RandomState(1)
    B, T = 3, 16
    feats = rng.randn(B, T, 120).astype(np.float32)
    feat_pad = np.zeros((B, T), np.float32)
    feat_pad[1, -4:] = feat_pad[2, -7:] = 1
    feats[feat_pad > 0] = 0
    labels = np.array([[1, 2, 3], [4, 4, 0], [6, 0, 0]], np.int32)
    return feats, feat_pad, labels, (labels == 0).astype(np.float32)


def test_loss_and_gradients_match_optax(pair):
    """optax's ``ctc_loss`` mean over the batch against the port's
    ``ctc_loss(reduction='none').mean()``, a repeated label and padding
    included; every parameter's gradient."""
    theirs, ours = pair
    batch = _batch()
    loss, grads = jax.jit(jax.value_and_grad(theirs.loss_fn))(
        theirs.params, *batch)
    for p in ours.parameters():
        p.grad = None
    got = ours.loss_fn(*map(torch.as_tensor, batch))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=ATOL)
    want = {**{f'rnnp.{k}': v for k, v in params_to_named(
        grads['rnnp']).items()},
        **{f'head.{k}': v for k, v in grads['head'].items()}}
    named = {**{f'rnnp.{k}': p for k, p in ours.rnnp.named_parameters()},
             **{f'head.{k}': p for k, p in ours.head.named_parameters()}}
    assert named.keys() == want.keys()
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]),
                                   atol=ATOL, err_msg=name)


def test_infeasible_sequence_is_infinite(pair):
    """Three labels cannot fit in two frames: torch gives inf (optax a
    large finite value); the port does not zero it."""
    _, ours = pair
    feats, feat_pad, labels, label_pad = map(torch.as_tensor, _batch())
    feat_pad[0, 2:] = 1
    loss = ours.loss_fn(feats, feat_pad, labels, label_pad)
    assert torch.isinf(loss)


def test_save_load_both_ways(pair, tmp_path):
    theirs, ours = pair
    ours.save(tmp_path / 'port.npz')
    back = jax_ctc.CTCRecognizer(**WIDTHS).load(tmp_path / 'port.npz')
    flat = dict(np.load(tmp_path / 'port.npz'))
    assert sorted(flat) == sorted(
        ['head/weight', 'head/bias']
        + [f'rnnp/{k.replace(".", "/")}' for k in ours.rnnp.state_dict()])
    for name, value in params_to_named(back.params['rnnp']).items():
        np.testing.assert_array_equal(
            value, params_to_named(theirs.params['rnnp'])[name])
    np.testing.assert_array_equal(back.params['head']['bias'],
                                  np.asarray(theirs.params['head']['bias']))
    wider = ctc.CTCRecognizer(vocabulary=2, units=8, projs=8,
                              device='cpu').load(tmp_path / 'port.npz')
    assert wider.vocabulary == 6 and wider.head.out_features == 7


@pytest.mark.slow
def test_train_on_lowers_the_loss(monkeypatch):
    """A few steps on a small corpus of the simulator's words through the
    port's Adam: the loss falls; the corpus draws are JAX's (numpy). Slow
    tier: the first use of ``torch.optim`` in a process imports most of
    torch (2 s alone, about a minute under the Tier-1 run's workers);
    ``chip_smoke.py``'s ``recipe simulated`` checks the same on the card."""
    sim = MeetingSimulator(vocabulary=4, speaker_pool=4, reverb_taps=1)
    losses = []
    loss_fn = ctc.CTCRecognizer.loss_fn

    def record(self, *args):
        out = loss_fn(self, *args)
        losses.append(out.item())
        return out
    monkeypatch.setattr(ctc.CTCRecognizer, 'loss_fn', record)
    asr = ctc.CTCRecognizer.train_on(sim, steps=6, batch=4, lr=2e-2,
                                     utt_seconds=0.9, corpus_size=6,
                                     units=8, projs=8, device='cpu')
    assert isinstance(asr, ctc.CTCRecognizer) and asr.vocabulary == 4
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert ctc._draw_voice(sim, np.random.RandomState(0)) == \
        jax_ctc._draw_voice(JaxSimulator(vocabulary=4, speaker_pool=4),
                            np.random.RandomState(0))
