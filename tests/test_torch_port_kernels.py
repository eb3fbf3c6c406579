"""The port's two forward BLSTM kernels, through their plain versions on the
CPU, against the JAX package's Pallas kernels run by the Pallas interpreter.

Data passes between the frameworks as numpy arrays made from a seed. The
tolerance is that of ``tests/test_kernels.py`` (atol 2e-5 in float32): both
sides compute the same f32 recurrence, summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tssep_tpu_torch.kernels import blstm as port

ATOL = 2e-5
I, H = 12, 16


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


def _layer(B, T, width, seed=0):
    """x (B, T, width) and one bidirectional layer's torch-named params."""
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(H)
    params = {}
    for suffix in ('', '_reverse'):
        for name, shape in (('weight_ih_l0', (4 * H, width)),
                            ('weight_hh_l0', (4 * H, H)),
                            ('bias_ih_l0', (4 * H,)), ('bias_hh_l0', (4 * H,))):
            params[name + suffix] = rng.uniform(
                -bound, bound, shape).astype(np.float32)
    x = rng.standard_normal((B, T, width)).astype(np.float32)
    return x, params


def _stack(params, name):
    return torch.stack([torch.from_numpy(params[name]),
                        torch.from_numpy(params[name + '_reverse'])])


def _port_weights(params):
    w_ih_t = _stack(params, 'weight_ih_l0').transpose(1, 2).contiguous()
    w_hh_t = _stack(params, 'weight_hh_l0').transpose(1, 2).contiguous()
    bias = _stack(params, 'bias_ih_l0') + _stack(params, 'bias_hh_l0')
    return w_ih_t, w_hh_t, bias


# odd T (not a multiple of TIME_BLOCK) exercises pad_t; B not a multiple of
# 8 exercises _pad_batch
SHAPES = [(16, 24), (13, 23), (5, 7)]


@pytest.mark.parametrize('B,T', SHAPES)
def test_fullfused_plain_matches_jax(kb, B, T):
    x, params = _layer(B, T, I)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref_h, (_, _, hsf, hsr, csf, csr, real_b, real_t) = kb._ff_layer_fwd(
        jp, jnp.asarray(x))
    h, c = port.blstm_fullfused_fwd(torch.from_numpy(x),
                                    *_port_weights(params), with_cell=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=ATOL)
    ref_c = np.concatenate([np.asarray(csf)[:real_t, :real_b],
                            np.asarray(csr)[:real_t, :real_b]], axis=-1)
    np.testing.assert_allclose(c.numpy(), ref_c.swapaxes(0, 1), atol=ATOL)


@pytest.mark.parametrize('B,T', SHAPES)
def test_bidi_plain_matches_jax(kb, B, T):
    x, params = _layer(B, T, I, seed=1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref_h, (_, _, hsf, hsr, csf, csr, real_b, real_t) = kb._layer_fwd(
        jp, jnp.asarray(x))
    _, w_hh_t, bias = _port_weights(params)
    w_ih = _stack(params, 'weight_ih_l0').reshape(8 * H, I)
    xg = torch.from_numpy(x) @ w_ih.T + bias.reshape(-1)
    h, c = port.blstm_bidi_fwd(xg, w_hh_t, with_cell=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=ATOL)
    # the TPU kernel stores the reverse direction time-flipped
    ref_c = np.concatenate(
        [np.asarray(csf)[:real_t, :real_b],
         np.asarray(csr)[:real_t][::-1][:, :real_b]], axis=-1)
    np.testing.assert_allclose(c.numpy(), ref_c.swapaxes(0, 1), atol=ATOL)


def test_plain_versions_agree():
    """The fused form equals the gate-input form with xg = x @ W_ih^T + b."""
    x, params = _layer(6, 9, I, seed=2)
    w_ih_t, w_hh_t, bias = _port_weights(params)
    xt = torch.from_numpy(x)
    h_ff, _ = port.blstm_fullfused_fwd_plain(xt, w_ih_t, w_hh_t, bias)
    xg = torch.cat([xt @ w_ih_t[0] + bias[0], xt @ w_ih_t[1] + bias[1]], -1)
    h_bi, _ = port.blstm_bidi_fwd_plain(xg, w_hh_t)
    torch.testing.assert_close(h_ff, h_bi, atol=ATOL, rtol=0)


def test_cpu_runs_plain_and_counts_no_launch():
    x, params = _layer(3, 5, I)
    before = (port.blstm_fullfused_fwd.launches, port.blstm_bidi_fwd.launches)
    w_ih_t, w_hh_t, bias = _port_weights(params)
    port.blstm_fullfused_fwd(torch.from_numpy(x), w_ih_t, w_hh_t, bias)
    port.blstm_bidi_fwd(torch.zeros(3, 5, 8 * H), w_hh_t)
    assert (port.blstm_fullfused_fwd.launches,
            port.blstm_bidi_fwd.launches) == before


def test_wrappers_reject_what_no_kernel_takes():
    x, params = _layer(3, 5, I)
    w_ih_t, w_hh_t, bias = _port_weights(params)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match='no kernel for device'):
        port.blstm_fullfused_fwd(xt.to('meta'), w_ih_t.to('meta'),
                                 w_hh_t.to('meta'), bias.to('meta'))
    with pytest.raises(ValueError, match='expected shape'):
        port.blstm_fullfused_fwd(xt, w_ih_t[:, :-1], w_hh_t, bias)
    with pytest.raises(ValueError, match='expected torch.float32'):
        port.blstm_fullfused_fwd(xt, w_ih_t, w_hh_t, bias.double())
    with pytest.raises(ValueError, match='storage dtype'):
        port.blstm_bidi_fwd(torch.zeros(3, 5, 8 * H, dtype=torch.float16),
                            w_hh_t.half())
    with pytest.raises(ValueError, match='width 8H'):
        port.blstm_bidi_fwd(torch.zeros(3, 5, 4 * H), w_hh_t)
