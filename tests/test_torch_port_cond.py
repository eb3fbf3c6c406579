"""The port's conditioned first post-net layer (``cond_fuse``), its
permutation trials and its ``fullfuse=False`` path against ``tssep_tpu`` on
the CPU.

The JAX side runs its Pallas kernels in the interpreter with tiny blocks
(the ``kb`` fixture, as in ``tests/test_torch_port_backward.py``); the port
runs the plain versions of its kernels. Inputs are made with numpy from a
seed. Tolerances, float32 on both sides, summed in other orders:
- the conditioned layer's forward (h) at atol 2e-5 and every gradient of
  the layers (dx, daux, the eight parameters) at atol 1e-4, the kernel
  tolerances of ``tests/test_kernels.py``;
- the model (masks, logits, waveforms, loss) at atol 1e-4, as in
  ``tests/test_torch_port_model.py``, and each parameter gradient of
  ``Model.loss_fn`` at 1e-4 of that gradient's max, as in
  ``tests/test_torch_port_train.py``. The JAX reference is its default path
  (the materialized conditioning, ``tests/test_kernels.py:359-388`` shows
  that the fused JAX path agrees with it to 2e-5), except in the one test
  marked ``slow``, which runs JAX's conditioned path in the interpreter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tssep_tpu.tasks.model import Model as JaxModel
from tssep_tpu.train.checkpoint import params_to_named
from tssep_tpu_torch.compat.from_jax import load_named
from tssep_tpu_torch.kernels import blstm as port
from tssep_tpu_torch.nn import rnnp
from tssep_tpu_torch.tasks.model import Model

F32 = torch.float32
FWD_ATOL, GRAD_ATOL, MODEL_ATOL = 2e-5, 1e-4, 1e-4
S, F, H = 3, 12, 16
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


def _params(rng, width):
    bound = 1 / np.sqrt(H)
    return {n + s: rng.uniform(-bound, bound, (4 * H,) + sh).astype(
        np.float32) for s in ('', '_reverse')
        for n, sh in (('weight_ih_l0', (width,)), ('weight_hh_l0', (H,)),
                      ('bias_ih_l0', ()), ('bias_hh_l0', ()))}


def _cond_inputs(B, T, seed):
    """xs (B, T, F), aux (B, S, F), one layer's params, dout (B, S, T, 2H)."""
    rng = np.random.default_rng(seed)
    params = _params(rng, F)
    xs = rng.standard_normal((B, T, F)).astype(np.float32)
    aux = rng.uniform(0, 1.5, (B, S, F)).astype(np.float32)
    dout = rng.standard_normal((B, S, T, 2 * H)).astype(np.float32)
    return xs, aux, params, dout


def _stack(params, name):
    return torch.stack([torch.from_numpy(params[name]),
                        torch.from_numpy(params[name + '_reverse'])])


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _compare_grads(got, want, atol=GRAD_ATOL):
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        _close(got[name], value, atol)


CASES = [(3, 7), (3, 13), (10, 7), (10, 13)]


# -- the conditioned layer ---------------------------------------------------

@pytest.mark.parametrize('B,T', CASES)
def test_cond_fwd_plain_matches_jax(kb, B, T):
    xs, aux, params, _ = _cond_inputs(B, T, seed=B * 100 + T)
    ref = kb.blstm_layer_fullfused_cond(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(xs),
        jnp.asarray(aux))
    w_ih_t = _stack(params, 'weight_ih_l0').transpose(1, 2).contiguous()
    w_hh_t = _stack(params, 'weight_hh_l0').transpose(1, 2).contiguous()
    bias = _stack(params, 'bias_ih_l0') + _stack(params, 'bias_hh_l0')
    h, c = port.blstm_fullfused_cond_fwd_plain(
        torch.from_numpy(xs), torch.from_numpy(aux), w_ih_t, w_hh_t, bias,
        with_cell=True)
    assert h.shape == c.shape == (B, S, T, 2 * H)
    _close(h, ref, FWD_ATOL)


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize('B,T', CASES)
def test_cond_function_matches_jax_vjp(kb, B, T):
    """dx, daux and all eight parameter gradients of the conditioned
    layer's Function against ``jax.vjp`` of ``blstm_layer_fullfused_cond``,
    whose backward runs ``_ffc_bwd_kernel`` in the interpreter."""
    xs, aux, params, dout = _cond_inputs(B, T, seed=B * 100 + T)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    _, vjp = jax.vjp(kb.blstm_layer_fullfused_cond, jp, jnp.asarray(xs),
                     jnp.asarray(aux))
    ref_params, ref_dx, ref_daux = vjp(jnp.asarray(dout))

    x_t, a_t = _leaves(xs, aux)
    tensors = {n: torch.from_numpy(params[n]).requires_grad_()
               for n in rnnp.PARAM_NAMES}
    h = rnnp.BLSTMLayerFullFusedCond.apply(x_t, a_t, *tensors.values(), F32)
    assert type(h.grad_fn).__name__ == 'BLSTMLayerFullFusedCondBackward'
    h.backward(torch.from_numpy(dout))
    _close(x_t.grad, ref_dx, GRAD_ATOL)
    _close(a_t.grad, ref_daux, GRAD_ATOL)
    _compare_grads({n: t.grad for n, t in tensors.items()},
                   {k: np.asarray(v) for k, v in ref_params.items()})


@pytest.mark.parametrize('B,T', [(3, 7), (10, 13)])
def test_bidi_core_path_matches_jax_vjp(kb, B, T):
    """``blstm_apply(..., fullfuse=False)`` under autograd: the projection
    in autograd and ``BLSTMBidiCore`` (backward ``blstm_bidi_bwd``) against
    ``jax.vjp`` of ``blstm_apply_fused_bidi``, whose backward runs
    ``_bi_core_bwd`` in the interpreter."""
    rng = np.random.default_rng(B * 100 + T)
    params = _params(rng, F)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    dout = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    fn = lambda p, x: kb.blstm_apply_fused_bidi(p, x, hidden_size=H)  # noqa
    ref, vjp = jax.vjp(fn, {k: jnp.asarray(v) for k, v in params.items()},
                       jnp.asarray(x))
    ref_params, ref_dx = vjp(jnp.asarray(dout))

    layer = rnnp.BLSTM(F, H, device='cpu')
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    (xt,) = _leaves(x)
    h = rnnp.blstm_apply(layer, xt, F32, fullfuse=False)
    assert type(h.grad_fn).__name__ == 'BLSTMBidiCoreBackward'
    _close(h.detach(), ref, FWD_ATOL)
    h.backward(torch.from_numpy(dout))
    _close(xt.grad, ref_dx, GRAD_ATOL)
    _compare_grads({n: p.grad for n, p in layer.named_parameters()},
                   {k: np.asarray(v) for k, v in ref_params.items()})


@pytest.mark.parametrize('B,T', [(2, 5), (3, 7)])
def test_cond_bwd_plain_rounds_dx_once_in_bf16(kb, monkeypatch, B, T):
    """In bf16 storage the plain backward (the function the card holds the
    bf16 kernel against) rounds dx and daux to bf16 once, after both
    directions and all speakers are summed in float32, as
    ``_ffc_layer_bwd`` rounds ``dxa + dxb`` (``jax.vjp`` of
    ``blstm_layer_fullfused_cond`` in interpret mode, JAX's storage dtype
    set to bf16). Inputs are bf16 values on both sides; the forward is the
    port's, from the same inputs. Rounding each direction's share first
    would move dx by a bf16 ulp of the value, more than the tolerance."""
    monkeypatch.setattr(kb, 'STORAGE_DTYPE', jnp.bfloat16)
    BF = torch.bfloat16
    xs, aux, params, dout = _cond_inputs(B, T, seed=B * 100 + T)
    xs_t, aux_t, dout_t = (torch.from_numpy(a).to(BF)
                           for a in (xs, aux, dout))

    def jbf(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    _, vjp = jax.vjp(kb.blstm_layer_fullfused_cond, jp, jbf(xs_t),
                     jbf(aux_t))
    ref_params, ref_dx, ref_daux = vjp(jbf(dout_t))
    assert ref_dx.dtype == ref_daux.dtype == jnp.bfloat16

    w_ih_t = _stack(params, 'weight_ih_l0').transpose(1, 2).to(BF)
    w_hh_t = _stack(params, 'weight_hh_l0').transpose(1, 2).to(BF)
    bias = _stack(params, 'bias_ih_l0') + _stack(params, 'bias_hh_l0')
    args = (xs_t, aux_t, w_ih_t.contiguous(), w_hh_t.contiguous(), bias)
    h, c = port.blstm_fullfused_cond_fwd_plain(*args, with_cell=True)
    dx, daux, dw_ih_t, dw_hh_t, db = port.blstm_fullfused_cond_bwd_plain(
        *args, h, c, dout_t)
    for got in (dx, daux):
        assert got.dtype == F32 and torch.equal(got, got.to(BF).float())
    ref_dx = np.asarray(ref_dx.astype(jnp.float32))
    _close(dx, ref_dx, GRAD_ATOL)
    _close(daux, np.asarray(ref_daux.astype(jnp.float32)), GRAD_ATOL)
    got_params = {}
    for d, suffix in enumerate(('', '_reverse')):
        got_params['weight_ih_l0' + suffix] = dw_ih_t[d].T
        got_params['weight_hh_l0' + suffix] = dw_hh_t[d].T
        got_params['bias_ih_l0' + suffix] = db[d]
        got_params['bias_hh_l0' + suffix] = db[d]
    _compare_grads(got_params,
                   {k: np.asarray(v) for k, v in ref_params.items()})

    # the check can fail: each direction's share rounded first
    fold = lambda t: t.reshape(B * S, *t.shape[2:])    # noqa: E731
    dgates = port._fullfused_bwd_sums(
        port._conditioned(xs_t, aux_t), *args[2:], fold(h), fold(c),
        fold(dout_t))[0]
    each = port._dx_each_rounded(dgates, w_ih_t, BF).view(B, S, T, F)
    dx_each = (each * aux_t.float()[:, :, None]).sum(dim=1).to(BF).float()
    assert np.abs(dx_each.numpy() - ref_dx).max() > GRAD_ATOL


def test_gradients_stay_float32_in_bf16_storage():
    """With bf16 storage the two new Functions take float32 master weights
    and return float32 weight gradients; dx and daux come back in their
    inputs' dtypes."""
    xs, aux, params, dout = _cond_inputs(2, 5, seed=0)
    x_t, a_t = _leaves(xs, aux)
    tensors = [torch.from_numpy(params[n]).requires_grad_()
               for n in rnnp.PARAM_NAMES]
    h = rnnp.BLSTMLayerFullFusedCond.apply(x_t, a_t, *tensors, torch.bfloat16)
    assert h.dtype == torch.bfloat16
    h.float().backward(torch.from_numpy(dout))
    assert x_t.grad.dtype == a_t.grad.dtype == F32
    assert all(t.grad.dtype == F32 for t in tensors)

    layer = rnnp.BLSTM(F, H, device='cpu')
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    (x_t,) = _leaves(xs)
    h = rnnp.blstm_apply(layer, x_t, torch.bfloat16, fullfuse=False)
    assert h.dtype == torch.bfloat16
    h.float().sum().backward()
    assert all(p.grad.dtype == F32 for p in layer.parameters())


def test_cond_wrappers_reject_what_no_kernel_takes():
    B, T = 2, 5
    xs, aux = torch.zeros(B, T, F), torch.zeros(B, S, F)
    w_ih_t, w_hh_t = torch.zeros(2, F, 4 * H), torch.zeros(2, H, 4 * H)
    bias, seq = torch.zeros(2, 4 * H), torch.zeros(B, S, T, 2 * H)
    with pytest.raises(ValueError, match='no kernel for device'):
        port.blstm_fullfused_cond_fwd(*(t.to('meta') for t in (
            xs, aux, w_ih_t, w_hh_t, bias)))
    with pytest.raises(ValueError, match='no kernel for device'):
        port.blstm_fullfused_cond_bwd(*(t.to('meta') for t in (
            xs, aux, w_ih_t, w_hh_t, bias, seq, seq, seq)))
    with pytest.raises(ValueError, match='expected shape'):
        port.blstm_fullfused_cond_fwd(xs, aux[:, :, :-1], w_ih_t, w_hh_t,
                                      bias)
    with pytest.raises(ValueError, match='expected torch.float32'):
        port.blstm_fullfused_cond_fwd(xs, aux.bfloat16(), w_ih_t, w_hh_t,
                                      bias)
    with pytest.raises(ValueError, match='expected shape'):
        port.blstm_fullfused_cond_bwd(xs, aux, w_ih_t, w_hh_t, bias,
                                      seq[:, :-1], seq, seq)


def test_forward_conditioned_needs_one_layer():
    block = rnnp.RNNP(F, elayers=2, cdim=H, hdim=10, storage_dtype=F32,
                      device='cpu')
    with pytest.raises(ValueError, match='elayers == 1'):
        block.forward_conditioned(torch.zeros(1, 3, F), torch.zeros(1, S, F))


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


def _small_config(combination='mul', ts_vad=3, trials=1, layers=3):
    """The small 'mul' configuration of ``test_forward_matches_jax``."""
    return {
        'fe': {'size': 64, 'shift': 16, 'window': 'hann'},
        'mask_estimator': {
            'units': 16, 'projs': 12, 'combination': combination,
            'ts_vad': ts_vad, 'layers': layers,
            'aux_net_output_size': 33 if combination == 'mul' else 20,
            'output_resolution': 'tf', 'num_averaged_permutations': trials,
        },
    }


def _batch(B, S_, A, samples=1200, seed=3):
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


@pytest.mark.parametrize('trials', [1, 2])
def test_cond_fuse_forward_matches_jax(scan_unroll_1, trials):
    cfg = _small_config(trials=trials)
    jm, params, ours = _both(cfg, cond_fuse=True)
    ex = _batch(2, 3, 33)
    ref = jm.forward(params, {k: jnp.asarray(v) for k, v in ex.items()
                              if k != TARGET}, rng=None)
    ref_wave = jm.fe.istft(ref.stft_estimate,
                           num_samples=ex['observation'].shape[-1])
    out = ours(_torch_batch(ex))
    assert out.mask.shape == ref.mask.shape
    _close(out.mask, ref.mask, MODEL_ATOL)
    _close(out.logit, ref.logit, MODEL_ATOL)
    _close(out.time_estimate, ref_wave, MODEL_ATOL)


_JAX_LOSS = {}


def _jax_loss_and_grads(trials):
    """Loss and named gradients of the JAX model's default path, cached per
    number of trials."""
    if trials not in _JAX_LOSS:
        cfg = _small_config(trials=trials)
        jm = JaxModel.new(cfg)
        params = jm.init_params(jax.random.PRNGKey(0))
        ex = _batch(2, 3, 33)

        @jax.jit
        def value_and_grad(p, arrays):
            return jax.value_and_grad(jm.loss_fn, has_aux=True)(
                p, dict(arrays, reference_channel=0), None, True)

        (loss, _), grads = value_and_grad(
            params, {k: jnp.asarray(v) for k, v in ex.items()
                     if isinstance(v, np.ndarray)})
        _JAX_LOSS[trials] = (params, float(loss), {
            k: np.asarray(v) for k, v in params_to_named(grads).items()})
    return _JAX_LOSS[trials]


@pytest.mark.parametrize('cond_fuse,fullfuse,trials', [
    (True, True, 1), (True, True, 2), (False, False, 1), (True, False, 2),
    (False, True, 2)])
def test_loss_fn_and_gradients_match_jax(scan_unroll_1, cond_fuse, fullfuse,
                                         trials):
    params, ref_loss, ref_grads = _jax_loss_and_grads(trials)
    ours = Model.from_config(_small_config(trials=trials), storage_dtype=F32,
                             device='cpu', cond_fuse=cond_fuse,
                             fullfuse=fullfuse)
    load_named(ours, params_to_named(params))
    loss, _ = ours.loss_fn(_torch_batch(_batch(2, 3, 33)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, atol=MODEL_ATOL, rtol=0)
    named = dict(ours.named_parameters())
    assert sorted(named) == sorted(ref_grads)
    for name, want in ref_grads.items():
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
           'blstm_bidi_bwd')


@pytest.mark.parametrize('combination,ts_vad,layers,cond_fuse,fullfuse,want', [
    # JAX's condition holds: birnn0 is the conditioned layer
    ('mul', 3, 3, True, True, dict(cond=1, fullfused=3)),
    ('mul', False, 1, True, True, dict(cond=1, fullfused=1)),
    ('mul', 3, 3, True, False, dict(cond=1, bidi=3)),
    # it does not: the materialized conditioning
    ('mul', 3, 3, False, True, dict(fullfused=4)),
    ('cat', 3, 3, True, True, dict(fullfused=4)),
    ('mul', 3, 1, True, True, dict(fullfused=2)),   # stacking comes first
    ('mul', 3, 3, False, False, dict(bidi=4)),
])
def test_dispatch_picks_the_conditioned_layer(monkeypatch, combination,
                                              ts_vad, layers, cond_fuse,
                                              fullfuse, want):
    """Which kernels a served request and a training step run, by layer
    count: ``cond`` the conditioned pair, ``fullfused`` and ``bidi`` the
    others; the backward runs as many as the forward."""
    cfg = _small_config(combination, ts_vad, layers=layers)
    model = Model.from_config(cfg, storage_dtype=F32, device='cpu',
                              cond_fuse=cond_fuse, fullfuse=fullfuse)
    model.init_params(torch.Generator().manual_seed(0))
    assert model.mask_estimator.conditioned_first_layer() == bool(
        want.get('cond'))
    counts = _counting(monkeypatch, KERNELS)
    ex = _torch_batch(_batch(2, 3, cfg['mask_estimator'][
        'aux_net_output_size']))
    model(ex)
    served = dict(counts)
    loss, _ = model.loss_fn(ex)
    loss.backward()
    step = {k: counts[k] - served[k] for k in KERNELS}
    expect = {'blstm_fullfused_cond_fwd': want.get('cond', 0),
              'blstm_fullfused_fwd': want.get('fullfused', 0),
              'blstm_bidi_fwd': want.get('bidi', 0)}
    assert {k: served[k] for k in expect} == expect
    assert all(served[k] == 0 for k in KERNELS if k.endswith('_bwd'))
    for fwd, n in expect.items():
        assert step[fwd] == step[fwd.replace('_fwd', '_bwd')] == n, step


def test_switches_keep_the_parameters():
    """``cond_fuse`` and ``fullfuse`` change no parameter: the JAX package's
    named arrays load into every combination."""
    cfg = _small_config(trials=2)
    named = params_to_named(JaxModel.new(cfg).init_params(
        jax.random.PRNGKey(0)))
    for cond_fuse in (False, True):
        for fullfuse in (False, True):
            ours = Model.from_config(cfg, storage_dtype=F32, device='cpu',
                                     cond_fuse=cond_fuse, fullfuse=fullfuse)
            load_named(ours, named)
            for name, value in named.items():
                np.testing.assert_array_equal(
                    ours.state_dict()[name].numpy(), value)


@pytest.mark.slow
def test_cond_fuse_matches_jax_conditioned_path(kb, monkeypatch):
    """The port's conditioned path against JAX's own (``CONDFUSE`` on, every
    layer through its Pallas kernels in the interpreter), at 2 trials."""
    from tssep_tpu.nn import rnnp as jax_rnnp
    monkeypatch.setattr(jax_rnnp, 'CONDFUSE', True)
    monkeypatch.setattr(jax_rnnp, '_FORCED_IMPL', 'pallas')
    cfg = _small_config(trials=2)
    jm, params, ours = _both(cfg, cond_fuse=True)
    ex = _batch(2, 3, 33)
    ref = jm.forward(params, {k: jnp.asarray(v) for k, v in ex.items()
                              if k != TARGET}, rng=None)
    out = ours(_torch_batch(ex))
    _close(out.mask, ref.mask, MODEL_ATOL)
    _close(out.logit, ref.logit, MODEL_ATOL)
