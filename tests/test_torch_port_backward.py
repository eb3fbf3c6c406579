"""The port's two backward BLSTM kernels, through their plain versions on the
CPU, and the two autograd Functions built on them, against ``jax.vjp`` of the
JAX package's ``blstm_layer_fullfused`` and ``blstm_layer_fused``, whose
backward runs the Pallas kernels ``_ff_bwd_kernel`` and ``_bi_bwd_kernel`` in
the Pallas interpreter with tiny blocks.

T in {7, 13} is not a multiple of the JAX time block (4) and B in {3, 10} not
a multiple of its batch block (8), so the JAX side pads time and batch and
runs its ``pad_t`` branches; B 10 also spans two batch blocks. dx and all
eight named parameter gradients are compared at atol 1e-4, the gradient
tolerance of ``tests/test_kernels.py``: float32 on both sides, summed in
other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tssep_tpu_torch.kernels import blstm as port
from tssep_tpu_torch.nn import rnnp

ATOL = 1e-4
I, H = 12, 16
F32 = torch.float32


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


def _inputs(B, T, width, seed):
    """x, one layer's torch-named params and a cotangent dout, float32."""
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(H)
    params = {name: rng.uniform(-bound, bound, (4 * H,) + shape).astype(
        np.float32) for name, shape in (
            (n + s, sh) for s in ('', '_reverse')
            for n, sh in (('weight_ih_l0', (width,)), ('weight_hh_l0', (H,)),
                          ('bias_ih_l0', ()), ('bias_hh_l0', ())))}
    x = rng.standard_normal((B, T, width)).astype(np.float32)
    dout = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    return x, params, dout


_JAX_CACHE = {}


def _jax_vjp(kb, kind, B, T, width=I):
    """(dx, {name: grad}) of the JAX layer, cached per case."""
    key = (kind, B, T, width)
    if key not in _JAX_CACHE:
        x, params, dout = _inputs(B, T, width, seed=B * 100 + T)
        fn = {'fullfused': kb.blstm_layer_fullfused,
              'fused': kb.blstm_layer_fused}[kind]
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        _, vjp = jax.vjp(fn, jp, jnp.asarray(x))
        dparams, dx = vjp(jnp.asarray(dout))
        _JAX_CACHE[key] = (np.asarray(dx),
                           {k: np.asarray(v) for k, v in dparams.items()})
    return _JAX_CACHE[key]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), want, atol=ATOL, rtol=0)


def _compare(got_dx, got_params, ref):
    ref_dx, ref_params = ref
    _close(got_dx, ref_dx)
    assert sorted(got_params) == sorted(ref_params)
    for name, value in got_params.items():
        _close(value, ref_params[name])


def _per_direction(grads_t):
    """(2, M, 4H) transposed gradients -> the two (4H, M) torch layouts."""
    return grads_t[0].T, grads_t[1].T


def _named(dw_ih, dw_hh, db):
    out = {}
    for d, suffix in enumerate(('', '_reverse')):
        out['weight_ih_l0' + suffix] = dw_ih[d]
        out['weight_hh_l0' + suffix] = dw_hh[d]
        out['bias_ih_l0' + suffix] = db[d]
        out['bias_hh_l0' + suffix] = db[d]
    return out


def _stack(params, name):
    return torch.stack([torch.from_numpy(params[name]),
                        torch.from_numpy(params[name + '_reverse'])])


CASES = [(3, 7), (3, 13), (10, 7), (10, 13)]


@pytest.mark.parametrize('B,T', CASES)
def test_fullfused_bwd_plain_matches_jax(kb, B, T):
    x, params, dout = _inputs(B, T, I, seed=B * 100 + T)
    xt = torch.from_numpy(x)
    w_ih_t = _stack(params, 'weight_ih_l0').transpose(1, 2).contiguous()
    w_hh_t = _stack(params, 'weight_hh_l0').transpose(1, 2).contiguous()
    bias = _stack(params, 'bias_ih_l0') + _stack(params, 'bias_hh_l0')
    h, c = port.blstm_fullfused_fwd(xt, w_ih_t, w_hh_t, bias, with_cell=True)
    dx, dw_ih_t, dw_hh_t, db = port.blstm_fullfused_bwd(
        xt, w_ih_t, w_hh_t, bias, h, c, torch.from_numpy(dout))
    _compare(dx, _named(_per_direction(dw_ih_t), _per_direction(dw_hh_t),
                        db), _jax_vjp(kb, 'fullfused', B, T))


@pytest.mark.parametrize('B,T', CASES)
def test_bidi_bwd_plain_matches_jax(kb, B, T):
    """The bidi kernel gives dxg and dW_hh; dW_ih, db and dx follow from
    dxg by the products ``_layer_bwd`` runs outside its kernel."""
    x, params, dout = _inputs(B, T, I, seed=B * 100 + T)
    xt = torch.from_numpy(x)
    w_ih = _stack(params, 'weight_ih_l0')                   # (2, 4H, I)
    w_hh_t = _stack(params, 'weight_hh_l0').transpose(1, 2).contiguous()
    bias = _stack(params, 'bias_ih_l0') + _stack(params, 'bias_hh_l0')
    xg = xt @ w_ih.reshape(-1, I).T + bias.reshape(-1)
    h, c = port.blstm_bidi_fwd(xg, w_hh_t, with_cell=True)
    dxg, dw_hh_t = port.blstm_bidi_bwd(xg, w_hh_t, h, c,
                                       torch.from_numpy(dout))
    dxg_d = torch.stack([dxg[..., :4 * H], dxg[..., 4 * H:]])
    dw_ih = torch.einsum('dbtg,bti->dgi', dxg_d, xt)
    dx = dxg_d[0] @ w_ih[0] + dxg_d[1] @ w_ih[1]
    _compare(dx, _named(dw_ih, _per_direction(dw_hh_t),
                        dxg_d.sum(dim=(1, 2))),
             _jax_vjp(kb, 'fused', B, T))


def _function_grads(fn, x, params, dout):
    xt = torch.from_numpy(x).requires_grad_()
    tensors = {name: torch.from_numpy(params[name]).requires_grad_()
               for name in rnnp.PARAM_NAMES}
    h = fn.apply(xt, *tensors.values(), F32)
    h.backward(torch.from_numpy(dout))
    return xt.grad, {name: t.grad for name, t in tensors.items()}


@pytest.mark.parametrize('B,T', CASES)
@pytest.mark.parametrize('kind', ['fullfused', 'fused'])
def test_autograd_function_matches_jax(kb, kind, B, T):
    fn = {'fullfused': rnnp.BLSTMLayerFullFused,
          'fused': rnnp.BLSTMLayerFused}[kind]
    x, params, dout = _inputs(B, T, I, seed=B * 100 + T)
    _compare(*_function_grads(fn, x, params, dout),
             _jax_vjp(kb, kind, B, T))


@pytest.mark.parametrize('width,kind', [
    (I, 'fullfused'),
    (rnnp.FULLFUSE_MAX_INPUT + 1, 'fused'),   # wider: the bidi kernel's arm
])
def test_blstm_apply_picks_the_jax_layer_by_width(kb, width, kind):
    """``blstm_apply`` under autograd runs the Function that JAX's
    ``blstm_apply`` picks for the width, with the same gradients."""
    B, T = 3, 7
    x, params, dout = _inputs(B, T, width, seed=B * 100 + T)
    layer = rnnp.BLSTM(width, H, device='cpu')
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    xt = torch.from_numpy(x).requires_grad_()
    h = rnnp.blstm_apply(layer, xt, F32)
    assert type(h.grad_fn).__name__ == {
        'fullfused': 'BLSTMLayerFullFusedBackward',
        'fused': 'BLSTMLayerFusedBackward'}[kind]
    h.backward(torch.from_numpy(dout))
    _compare(xt.grad, {name: p.grad for name, p in layer.named_parameters()},
             _jax_vjp(kb, kind, B, T, width))


def test_gradients_stay_float32_in_bf16_storage():
    """With bf16 storage the Functions take the float32 master parameters
    and return float32 gradients for all eight of them, as JAX's custom
    VJPs do; dx comes back in x's dtype."""
    x, params, dout = _inputs(3, 5, I, seed=0)
    for fn in (rnnp.BLSTMLayerFullFused, rnnp.BLSTMLayerFused):
        xt = torch.from_numpy(x).requires_grad_()
        tensors = [torch.from_numpy(params[n]).requires_grad_()
                   for n in rnnp.PARAM_NAMES]
        h = fn.apply(xt, *tensors, torch.bfloat16)
        assert h.dtype == torch.bfloat16
        h.float().backward(torch.from_numpy(dout))
        assert xt.grad.dtype == F32
        assert all(t.grad.dtype == F32 for t in tensors)


def test_cpu_runs_plain_and_counts_no_launch():
    x, params, dout = _inputs(3, 5, I, seed=0)
    before = (port.blstm_fullfused_bwd.launches, port.blstm_bidi_bwd.launches)
    for fn in (rnnp.BLSTMLayerFullFused, rnnp.BLSTMLayerFused):
        _function_grads(fn, x, params, dout)
    assert (port.blstm_fullfused_bwd.launches,
            port.blstm_bidi_bwd.launches) == before


def test_backward_wrappers_reject_what_no_kernel_takes():
    B, T = 3, 5
    x = torch.zeros(B, T, I)
    w_ih_t, w_hh_t = torch.zeros(2, I, 4 * H), torch.zeros(2, H, 4 * H)
    bias, seq = torch.zeros(2, 4 * H), torch.zeros(B, T, 2 * H)
    with pytest.raises(ValueError, match='no kernel for device'):
        port.blstm_fullfused_bwd(*(t.to('meta') for t in (
            x, w_ih_t, w_hh_t, bias, seq, seq, seq)))
    with pytest.raises(ValueError, match='expected shape'):
        port.blstm_fullfused_bwd(x, w_ih_t, w_hh_t, bias, seq[:, :-1], seq,
                                 seq)
    with pytest.raises(ValueError, match='expected torch.float32'):
        port.blstm_bidi_bwd(torch.zeros(B, T, 8 * H, dtype=torch.bfloat16),
                            w_hh_t.bfloat16(), seq.bfloat16(),
                            seq.bfloat16(), seq.bfloat16())
