"""The port's unidirectional core pair (``lstm_fwd`` / ``lstm_bwd``), its
``LSTMCore`` Function, the ``typ='lstm'`` RNNP and the ``bidi=False`` path
against ``tssep_tpu`` on the CPU.

``lstm_fwd`` / ``lstm_bwd`` replace ``_fwd_kernel`` / ``_bwd_kernel``;
``LSTMCore`` replaces ``_lstm_core``'s custom VJP, which ``lstm_fused``
wraps. The JAX side runs its Pallas kernels in the interpreter with tiny
blocks (the ``kb`` fixture, as in ``tests/test_torch_port_cond.py``), the
port runs the plain versions of its kernels. Inputs are made with numpy from
a seed. Tolerances, float32 on both sides, summed in other orders: forward
at atol 2e-5 and gradients at atol 1e-4, the kernel tolerances of
``tests/test_kernels.py``; the RNNP block and the model at atol 1e-4, each
parameter gradient of ``Model.loss_fn`` at 1e-4 of that gradient's max,
against the JAX default path (``tests/test_kernels.py`` holds the JAX
kernels against its scan path), except in the one test marked ``slow``,
which runs JAX's own ``BIDI=0`` path in the interpreter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tssep_tpu.nn.rnnp import RNNP as JaxRNNP
from tssep_tpu.tasks.model import Model as JaxModel
from tssep_tpu.train.checkpoint import params_to_named
from tssep_tpu_torch.compat.from_jax import load_named
from tssep_tpu_torch.kernels import blstm as port
from tssep_tpu_torch.nn import rnnp
from tssep_tpu_torch.tasks.model import Model

F32 = torch.float32
FWD_ATOL, GRAD_ATOL, MODEL_ATOL = 2e-5, 1e-4, 1e-4
H = 16
TARGET = 'speaker_reverberation_early_ch0'


@pytest.fixture(scope='module')
def kb():
    """The JAX kernels module in interpret mode with tiny blocking, restored
    on teardown (as ``tests/test_kernels.py`` patches it)."""
    from tssep_tpu.kernels import blstm
    saved = (blstm.INTERPRET, blstm.BATCH_BLOCK, blstm.BIDI_BATCH_BLOCK,
             blstm.TIME_BLOCK)
    blstm.INTERPRET = True
    blstm.BATCH_BLOCK = 8
    blstm.BIDI_BATCH_BLOCK = 8
    blstm.TIME_BLOCK = 4
    yield blstm
    (blstm.INTERPRET, blstm.BATCH_BLOCK, blstm.BIDI_BATCH_BLOCK,
     blstm.TIME_BLOCK) = saved


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _core_inputs(B, T, seed):
    """xg (B, T, 4H), w_hh_t (H, 4H), dout (B, T, H)."""
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((B, T, 4 * H)).astype(np.float32)
    w_hh_t = (rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    dout = rng.standard_normal((B, T, H)).astype(np.float32)
    return xg, w_hh_t, dout


def _time_major(a):
    return jnp.swapaxes(jnp.asarray(a), 0, 1)


# B 3 and 10 pad the JAX batch to 8 and 16 rows, T 7 and 13 its time to 8
# and 16; the reverse direction walks a time-flipped copy there
CASES = [(3, 7, False), (3, 7, True), (10, 13, False), (10, 13, True)]


@pytest.mark.parametrize('B,T,reverse', CASES)
def test_lstm_fwd_plain_matches_jax(kb, B, T, reverse):
    xg, w_hh_t, _ = _core_inputs(B, T, seed=B * 100 + T)
    ref = kb.lstm_fused(_time_major(xg), jnp.asarray(w_hh_t), reverse)
    h, c = port.lstm_fwd_plain(torch.from_numpy(xg),
                               torch.from_numpy(w_hh_t), reverse=reverse,
                               with_cell=True)
    assert h.shape == c.shape == (B, T, H)
    _close(h, np.swapaxes(np.asarray(ref), 0, 1), FWD_ATOL)


@pytest.mark.parametrize('B,T,reverse', CASES)
def test_lstm_core_matches_jax_vjp(kb, B, T, reverse):
    """dxg and dW_hh of ``LSTMCore`` against ``jax.vjp`` of ``lstm_fused``,
    whose backward runs ``_bwd_kernel`` in the interpreter."""
    xg, w_hh_t, dout = _core_inputs(B, T, seed=B * 100 + T)
    ref, vjp = jax.vjp(lambda x, w: kb.lstm_fused(x, w, reverse),
                       _time_major(xg), jnp.asarray(w_hh_t))
    ref_dxg, ref_dw = vjp(_time_major(dout))

    xg_t = torch.from_numpy(xg).requires_grad_()
    w_t = torch.from_numpy(w_hh_t).requires_grad_()
    h = rnnp.LSTMCore.apply(xg_t, w_t, F32, reverse)
    assert type(h.grad_fn).__name__ == 'LSTMCoreBackward'
    _close(h.detach(), np.swapaxes(np.asarray(ref), 0, 1), FWD_ATOL)
    h.backward(torch.from_numpy(dout))
    _close(xg_t.grad, np.swapaxes(np.asarray(ref_dxg), 0, 1), GRAD_ATOL)
    _close(w_t.grad, ref_dw, GRAD_ATOL)


def test_lstm_core_gradients_in_bf16_storage():
    """With bf16 storage ``LSTMCore`` casts the float32 master W_hh^T inside
    and returns its gradient in float32, dxg in the storage dtype."""
    xg, w_hh_t, dout = _core_inputs(2, 5, seed=0)
    xg_t = torch.from_numpy(xg).bfloat16().requires_grad_()
    w_t = torch.from_numpy(w_hh_t).requires_grad_()
    h = rnnp.LSTMCore.apply(xg_t, w_t, torch.bfloat16, True)
    assert h.dtype == torch.bfloat16
    h.float().backward(torch.from_numpy(dout))
    assert xg_t.grad.dtype == torch.bfloat16
    assert w_t.grad.dtype == F32


def test_lstm_wrappers_reject_what_no_kernel_takes():
    B, T = 2, 5
    xg, w = torch.zeros(B, T, 4 * H), torch.zeros(H, 4 * H)
    seq = torch.zeros(B, T, H)
    with pytest.raises(ValueError, match='no kernel for device'):
        port.lstm_fwd(xg.to('meta'), w.to('meta'))
    with pytest.raises(ValueError, match='no kernel for device'):
        port.lstm_bwd(*(t.to('meta') for t in (xg, w, seq, seq, seq)))
    with pytest.raises(ValueError, match='expected width 4H'):
        port.lstm_fwd(torch.zeros(B, T, 8 * H), w)
    with pytest.raises(ValueError, match='expected torch.float32'):
        port.lstm_bwd(xg, w, seq, seq, seq.bfloat16())


# -- the unidirectional RNNP -------------------------------------------------

def test_unidirectional_rnnp_matches_jax():
    """A two-layer ``RNNP(typ='lstm')`` against JAX's (its scan path):
    names, ``num_params``, output and every gradient."""
    idim, hdim = 9, 10
    jr = JaxRNNP(idim=idim, elayers=2, cdim=H, hdim=hdim, typ='lstm')
    params = jr.init(jax.random.PRNGKey(0))
    ours = rnnp.RNNP(idim, elayers=2, cdim=H, hdim=hdim, typ='lstm',
                     storage_dtype=F32, device='cpu')
    named = params_to_named(params)
    assert sorted(named) == sorted(ours.state_dict())
    assert not any('_reverse' in name for name in named)
    load_named(ours, named)
    assert sum(p.numel() for p in ours.parameters()) == jr.num_params()

    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 11, idim)).astype(np.float32)
    dout = rng.standard_normal((3, 11, hdim)).astype(np.float32)
    ref, vjp = jax.vjp(lambda p: jr.apply(p, jnp.asarray(x)), params)
    (ref_grads,) = vjp(jnp.asarray(dout))
    out = ours(torch.from_numpy(x))
    _close(out.detach(), ref, MODEL_ATOL)
    out.backward(torch.from_numpy(dout))
    for name, want in params_to_named(ref_grads).items():
        _close(dict(ours.named_parameters())[name].grad, want, GRAD_ATOL)
    with torch.no_grad():
        _close(ours(torch.from_numpy(x)), ref, MODEL_ATOL)


@pytest.mark.parametrize('typ', ['gru', 'bgru'])
def test_gru_arms_are_not_ported(typ):
    """The GRU arms are ported (``tests/test_torch_port_recipe.py`` holds
    them against JAX): either builds with ``torch.nn.GRU``'s three-gate
    layout, and a typ of neither cell raises."""
    block = rnnp.RNNP(9, cdim=5, typ=typ, storage_dtype=F32, device='cpu')
    assert block.lstm0.weight_ih_l0.shape == (15, 9)
    assert block.lstm0.weight_hh_l0.shape == (15, 5)
    assert hasattr(block.lstm0, 'weight_ih_l0_reverse') == (typ == 'bgru')
    with pytest.raises(ValueError):
        rnnp.RNNP(9, typ='rnn', storage_dtype=F32, device='cpu')


def test_bidi_off_layer_matches_jax_vjp(kb, monkeypatch):
    """A bidirectional layer with ``bidi=False`` that is not fully fused:
    each direction through ``LSTMCore``, against ``jax.vjp`` of
    ``blstm_apply_fused`` with ``BIDI`` off (per direction ``lstm_fused``)."""
    monkeypatch.setattr(kb, 'BIDI', False)
    F, B, T = 12, 3, 9
    rng = np.random.default_rng(5)
    bound = 1 / np.sqrt(H)
    params = {n + s: rng.uniform(-bound, bound, (4 * H,) + sh).astype(
        np.float32) for s in ('', '_reverse')
        for n, sh in (('weight_ih_l0', (F,)), ('weight_hh_l0', (H,)),
                      ('bias_ih_l0', ()), ('bias_hh_l0', ()))}
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    dout = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    fn = lambda p, x: kb.blstm_apply_fused(p, x, hidden_size=H)  # noqa
    ref, vjp = jax.vjp(fn, {k: jnp.asarray(v) for k, v in params.items()},
                       jnp.asarray(x))
    ref_params, ref_dx = vjp(jnp.asarray(dout))

    layer = rnnp.BLSTM(F, H, device='cpu')
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    xt = torch.from_numpy(x).requires_grad_()
    h = rnnp.blstm_apply(layer, xt, F32, fullfuse=False, bidi=False)
    _close(h.detach(), ref, FWD_ATOL)
    h.backward(torch.from_numpy(dout))
    _close(xt.grad, ref_dx, GRAD_ATOL)
    for name, p in layer.named_parameters():
        _close(p.grad, ref_params[name], GRAD_ATOL)


# -- the model ---------------------------------------------------------------

@pytest.fixture
def scan_unroll_1():
    """The JAX scan path with one step per scan iteration: the same
    arithmetic as its default of 8, compiled in a fraction of the time."""
    from tssep_tpu.nn import rnnp as jax_rnnp
    saved = jax_rnnp.DEFAULT_UNROLL
    jax_rnnp.DEFAULT_UNROLL = 1
    yield
    jax_rnnp.DEFAULT_UNROLL = saved


@pytest.fixture
def flagship_split(monkeypatch):
    """The fully fused width limit cut to 33, so that the small model's
    layers split as the flagship's do: ``pre_net``, ``birnn0`` (33 wide) and
    ``birnn1`` (12) fully fused, the stacked ``birnn2`` (36) not."""
    monkeypatch.setattr(rnnp, 'FULLFUSE_MAX_INPUT', 33)


def _small_config():
    """The small 'mul' configuration of ``tests/test_torch_port_cond.py``."""
    return {
        'fe': {'size': 64, 'shift': 16, 'window': 'hann'},
        'mask_estimator': {
            'units': 16, 'projs': 12, 'combination': 'mul', 'ts_vad': 3,
            'layers': 3, 'aux_net_output_size': 33,
            'output_resolution': 'tf',
        },
    }


def _batch(B, S_, A, samples=600, seed=3):
    rng = np.random.default_rng(seed)
    return {'observation': rng.standard_normal((B, 1, samples)).astype(
                np.float32),
            'auxInput': rng.uniform(0, 1, (B, S_, A)).astype(np.float32),
            TARGET: 0.3 * rng.standard_normal((B, S_, samples)).astype(
                np.float32),
            'reference_channel': 0}


def _torch_batch(ex):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in ex.items()}


def _both(cfg, **switches):
    jm = JaxModel.new(cfg)
    params = jm.init_params(jax.random.PRNGKey(0))
    ours = Model.from_config(cfg, storage_dtype=F32, device='cpu',
                             **switches)
    load_named(ours, params_to_named(params))
    return jm, params, ours


def test_bidi_off_forward_matches_jax(scan_unroll_1, flagship_split):
    """Served masks, logits and waveforms with ``bidi=False`` (``birnn2``
    per direction) against the JAX default path."""
    jm, params, ours = _both(_small_config(), bidi=False)
    ex = _batch(2, 3, 33)
    samples = ex['observation'].shape[-1]

    @jax.jit   # the same numbers as op by op, in a fraction of the time
    def served(p, arrays):
        out = jm.forward(p, dict(arrays, reference_channel=0), rng=None)
        return out.mask, out.logit, jm.fe.istft(out.stft_estimate,
                                                num_samples=samples)

    mask, logit, wave = served(params, {
        k: jnp.asarray(v) for k, v in ex.items()
        if isinstance(v, np.ndarray) and k != TARGET})
    out = ours(_torch_batch(ex))
    _close(out.mask, mask, MODEL_ATOL)
    _close(out.logit, logit, MODEL_ATOL)
    _close(out.time_estimate, wave, MODEL_ATOL)


@pytest.mark.parametrize('switches', [
    dict(bidi=False), dict(bidi=False, fullfuse=False),
    dict(bidi=False, spill=True, cond_fuse=True)])
def test_bidi_off_loss_fn_and_gradients_match_jax(scan_unroll_1,
                                                  flagship_split, switches):
    cfg = _small_config()
    jm, params, ours = _both(cfg, **switches)
    ex = _batch(2, 3, 33)

    @jax.jit
    def value_and_grad(p, arrays):
        return jax.value_and_grad(jm.loss_fn, has_aux=True)(
            p, dict(arrays, reference_channel=0), None, True)

    (ref_loss, _), ref_grads = value_and_grad(
        params, {k: jnp.asarray(v) for k, v in ex.items()
                 if isinstance(v, np.ndarray)})
    loss, _ = ours.loss_fn(_torch_batch(ex))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=MODEL_ATOL,
                               rtol=0)
    named = dict(ours.named_parameters())
    ref_named = params_to_named(ref_grads)
    assert sorted(named) == sorted(ref_named)
    for name, want in ref_named.items():
        want = np.asarray(want)
        err = np.abs(named[name].grad.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)


def _counting(monkeypatch, names):
    """Counts the calls ``nn/rnnp.py`` makes to the named kernel wrappers."""
    counts = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(rnnp, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            counts[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(rnnp, name, counted)
    return counts


KERNELS = ('blstm_fullfused_cond_fwd', 'blstm_fullfused_cond_bwd',
           'blstm_fullfused_fwd', 'blstm_fullfused_bwd', 'blstm_bidi_fwd',
           'blstm_bidi_bwd', 'lstm_fwd', 'lstm_bwd')


@pytest.mark.parametrize('switches,want', [
    (dict(bidi=False), dict(fullfused=3, lstm=2)),
    (dict(bidi=False, fullfuse=False), dict(lstm=8)),
    (dict(bidi=False, cond_fuse=True), dict(cond=1, fullfused=2, lstm=2)),
    (dict(bidi=False, cond_fuse=True, fullfuse=False),
     dict(cond=1, lstm=6)),
])
def test_dispatch_runs_each_direction(monkeypatch, flagship_split, switches,
                                      want):
    """Which kernels a served request and a training step run with
    ``bidi=False``, by layer count (``lstm`` counts directions); the
    backward runs as many as the forward."""
    model = Model.from_config(_small_config(), storage_dtype=F32,
                              device='cpu', **switches)
    model.init_params(torch.Generator().manual_seed(0))
    counts = _counting(monkeypatch, KERNELS)
    ex = _torch_batch(_batch(1, 3, 33, samples=400))
    model(ex)
    served = dict(counts)
    loss, _ = model.loss_fn(ex)
    loss.backward()
    step = {k: counts[k] - served[k] for k in KERNELS}
    names = {'cond': 'blstm_fullfused_cond_fwd',
             'fullfused': 'blstm_fullfused_fwd', 'bidi': 'blstm_bidi_fwd',
             'lstm': 'lstm_fwd'}
    expect = {fwd: want.get(key, 0) for key, fwd in names.items()}
    assert {k: served[k] for k in expect} == expect
    assert all(served[k] == 0 for k in KERNELS if k.endswith('_bwd'))
    for fwd, n in expect.items():
        assert step[fwd] == step[fwd.replace('_fwd', '_bwd')] == n, step


def test_switches_keep_the_parameters():
    """``spill`` and ``bidi`` change no parameter: the JAX package's named
    arrays load into every combination."""
    cfg = _small_config()
    named = params_to_named(JaxModel.new(cfg).init_params(
        jax.random.PRNGKey(0)))
    for spill in (False, True):
        for bidi in (False, True):
            ours = Model.from_config(cfg, storage_dtype=F32, device='cpu',
                                     spill=spill, bidi=bidi)
            load_named(ours, named)
            for name, value in named.items():
                np.testing.assert_array_equal(
                    ours.state_dict()[name].numpy(), value)


@pytest.mark.slow
def test_bidi_off_matches_jax_bidi_off_path(kb, monkeypatch, scan_unroll_1):
    """The port's ``fullfuse=False, bidi=False`` path against JAX's own
    (``FULLFUSE`` and ``BIDI`` off, every layer through ``lstm_fused`` in
    the interpreter): served masks and the training step's gradients."""
    from tssep_tpu.nn import rnnp as jax_rnnp
    monkeypatch.setattr(jax_rnnp, 'FULLFUSE', False)
    monkeypatch.setattr(jax_rnnp, '_FORCED_IMPL', 'pallas')
    monkeypatch.setattr(kb, 'BIDI', False)
    cfg = _small_config()
    jm, params, ours = _both(cfg, fullfuse=False, bidi=False)
    ex = _batch(2, 3, 33)
    ref = jm.forward(params, {k: jnp.asarray(v) for k, v in ex.items()
                              if k != TARGET}, rng=None)
    out = ours(_torch_batch(ex))
    _close(out.mask, ref.mask, MODEL_ATOL)
    _close(out.logit, ref.logit, MODEL_ATOL)

    (ref_loss, _), ref_grads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        params, {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                 for k, v in ex.items()}, None, True)
    loss, _ = ours.loss_fn(_torch_batch(ex))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=MODEL_ATOL,
                               rtol=0)
    named = dict(ours.named_parameters())
    for name, want in params_to_named(ref_grads).items():
        want = np.asarray(want)
        err = np.abs(named[name].grad.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)
