"""LSTM with projection (RNNP): port of ``tssep_tpu/nn/rnnp.py``.

``[(B)LSTM -> Linear (-> Dropout -> Tanh)] x elayers`` with the nonlinearity
dropped after the last layer, on rank-2/3/4 inputs (speakers folded into the
batch axis); ``typ`` 'blstm' (bidirectional) or 'lstm' (one direction), or
the GRU arms 'bgru' and 'gru'. Parameters keep torch's names and layouts
(``weight_ih_l0`` is (4H, I), gate order i, f, g, o, ``_reverse`` for the
second direction; a GRU's is (3H, I), gate order r, z, n), so the JAX
package's named parameters load by name.

The GRU arms have no Pallas kernel in the JAX package, which runs them on
``lax.scan`` (``_gru_scan``, ``tssep_tpu/nn/rnnp.py:69``); here
:func:`bgru_apply` is the same step loop in float32, under autograd.

Every layer runs through the kernels of ``tssep_tpu_torch.kernels.blstm``,
chosen as ``blstm_apply`` chooses (``tssep_tpu/nn/rnnp.py:311-342``). With
``fullfuse`` (the TPU default, ``TSSEP_PALLAS_FULLFUSE``), input width up to
``FULLFUSE_MAX_INPUT`` goes to ``blstm_fullfused_fwd``, wider goes to
``blstm_bidi_fwd`` with the input projection as one matrix product outside.
Where a gradient is wanted, the layer is a ``torch.autograd.Function`` whose
backward is the matching backward kernel: ``BLSTMLayerFullFused``
(``blstm_layer_fullfused``, JAX :1052-1195) and ``BLSTMLayerFused``
(``blstm_layer_fused``, JAX :681-783). Both take the layer's float32 master
parameters, cast them inside, and return float32 gradients for all eight
of them, as JAX's custom VJPs do.

Without ``fullfuse`` every layer goes the way of ``blstm_apply_fused_bidi``
(JAX ``kernels/blstm.py:615``): the input projection in autograd, then
``BLSTMBidiCore`` (JAX ``_bi_core``, backward ``_bi_core_bwd`` :555) over the
gate inputs xg, whose backward kernel ``blstm_bidi_bwd`` gives dxg in the
storage dtype and dW_hh in float32.

``spill`` (JAX ``TSSEP_PALLAS_SPILL``) runs every fully fused layer through
``blstm_fullfused_spill_fwd`` and, for a gradient, ``BLSTMLayerFullFusedSpill``
(JAX ``blstm_layer_fullfused_spill``, :1473-1627), which saves x, h and the
c carry of every ``SPILL_BLOCK``'th step instead of the c sequence; its
backward ``blstm_fullfused_spill_bwd`` rebuilds c from those boundaries.

One direction: ``bidi=False`` (JAX ``TSSEP_PALLAS_BIDI=0``) runs each
direction of a layer that is not fully fused on its own, and a
unidirectional RNNP (``typ='lstm'``) its one direction, the way of
``lstm_fused`` (JAX :319-361): the input projection in autograd, then
``LSTMCore`` (JAX ``_lstm_core``, :255-316) over that direction's gate
inputs, through ``lstm_fwd`` / ``lstm_bwd``.

``RNNP.forward_conditioned`` runs a one-layer block on the 'mul'-conditioned
input ``xs[:, None] * aux[:, :, None]`` through ``blstm_fullfused_cond_fwd``
and, for a gradient, ``BLSTMLayerFullFusedCond`` (JAX
``blstm_layer_fullfused_cond``, :1923-2044), which forms the product inside
the kernels and never writes it.

No remat: the forward keeps x, h and c of every layer for its backward.
JAX wraps the folded layers in ``jax.checkpoint`` to fit a 16 GB TPU; on an
80 GB card the saved x, h and c of a folded layer at batch 256 come to about
2.2 GB in bf16 (x 2048 x 316 x 513 x 2 B, about 0.66 GB; h and c
2 x 2048 x 316 x 600 x 2 B, about 1.55 GB), and the numbers are the same
with or without it.
"""

from __future__ import annotations

import torch
from torch import nn

from tssep_tpu_torch.dist.mesh import batch_rand
from tssep_tpu_torch.kernels.blstm import (blstm_bidi_bwd, blstm_bidi_fwd,
                                           blstm_fullfused_bwd,
                                           blstm_fullfused_cond_bwd,
                                           blstm_fullfused_cond_fwd,
                                           blstm_fullfused_fwd,
                                           blstm_fullfused_spill_bwd,
                                           blstm_fullfused_spill_fwd,
                                           lstm_bwd, lstm_fwd)
from tssep_tpu_torch.nn.init import linear_init_, lstm_init_
from tssep_tpu_torch.utils.device import resolve_device

__all__ = ['BLSTM', 'BGRU', 'RNNP', 'blstm_apply', 'bgru_apply',
           'BLSTMLayerFullFused',
           'BLSTMLayerFused', 'BLSTMLayerFullFusedCond',
           'BLSTMLayerFullFusedSpill', 'BLSTMBidiCore', 'LSTMCore',
           'FULLFUSE_MAX_INPUT', 'PARAM_NAMES', 'inverted_dropout']

#: Widest input the fully fused kernel takes (``tssep_tpu/nn/rnnp.py:286``).
FULLFUSE_MAX_INPUT = 2048

_SUFFIXES = ('', '_reverse')

#: The eight named tensors of a layer, in the order the Functions take them.
PARAM_NAMES = tuple(name + suffix for suffix in _SUFFIXES
                    for name in ('weight_ih_l0', 'weight_hh_l0', 'bias_ih_l0',
                                 'bias_hh_l0'))


class BLSTM(nn.Module):
    """One (bidirectional) LSTM layer's parameters, named as
    ``torch.nn.LSTM`` names them: without ``bidirectional``, only the
    forward direction's four. Float32 master weights; :func:`blstm_apply`
    runs it."""

    gates = 4

    def __init__(self, input_size, hidden_size, *, bidirectional=True,
                 device='cuda'):
        super().__init__()
        device = resolve_device(device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.bidirectional = bidirectional
        G = self.gates * hidden_size
        for suffix in _SUFFIXES[:2 if bidirectional else 1]:
            for name, shape in (('weight_ih_l0', (G, input_size)),
                                ('weight_hh_l0', (G, hidden_size)),
                                ('bias_ih_l0', (G,)), ('bias_hh_l0', (G,))):
                self.register_parameter(name + suffix, nn.Parameter(
                    torch.zeros(shape, device=device)))


class BGRU(BLSTM):
    """One (bidirectional) GRU layer's parameters, named as ``torch.nn.GRU``
    names them (three gates r, z, n); :func:`bgru_apply` runs it."""

    gates = 3


def _gru_scan(xg, b_hh, w_hh, reverse):
    """One GRU direction over time, as ``_gru_scan`` steps it: xg (B, T, 3H)
    the input projections with the input bias; the hidden bias stays out of
    xg, since the n gate's hidden term is gated by r with its bias, ``n =
    tanh(x_n + r (W_hn h + b_hn))``. -> (B, T, H)."""
    B, T, G = xg.shape
    H = G // 3
    w_hh_t = w_hh.t()
    h = xg.new_zeros(B, H)
    out = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hg = h @ w_hh_t + b_hh
        r = torch.sigmoid(xg[:, t, :H] + hg[:, :H])
        z = torch.sigmoid(xg[:, t, H:2 * H] + hg[:, H:2 * H])
        n = torch.tanh(xg[:, t, 2 * H:] + r * hg[:, 2 * H:])
        h = (1 - z) * n + z * h
        out[t] = h
    return torch.stack(out, dim=1)


def bgru_apply(layer: BGRU, x, storage_dtype):
    """x: (B, T, I) -> (B, T, 2H), or (B, T, H) for one direction, in
    ``storage_dtype``: the projection and the steps in float32, under
    autograd (JAX ``bgru_apply``, ``tssep_tpu/nn/rnnp.py:117``)."""
    x = x.float()
    outs = []
    for suffix, reverse in zip(_SUFFIXES[:2 if layer.bidirectional else 1],
                               (False, True)):
        w_ih, w_hh, b_ih, b_hh = (getattr(layer, name + suffix) for name in
                                  PARAM_NAMES[:4])
        xg = nn.functional.linear(x, w_ih, b_ih)
        outs.append(_gru_scan(xg, b_hh, w_hh, reverse))
    return torch.cat(outs, dim=-1).to(storage_dtype)


def _layer_params(layer):
    return tuple(getattr(layer, name)
                 for name in PARAM_NAMES[:8 if layer.bidirectional else 4])


def _stacked(params):
    """The eight tensors in ``PARAM_NAMES`` order -> (w_ih, w_hh, bias),
    each stacked over the two directions: (2, 4H, I), (2, 4H, H) float32
    and the summed biases (2, 4H) float32."""
    fwd, rev = params[:4], params[4:]
    w_ih = torch.stack([fwd[0], rev[0]])
    w_hh = torch.stack([fwd[1], rev[1]])
    bias = torch.stack([fwd[2] + fwd[3], rev[2] + rev[3]])
    return w_ih, w_hh, bias


def _to_params(dw_ih, dw_hh, db):
    """Per-direction gradients -> the eight tensors' gradients in
    ``PARAM_NAMES`` order; both biases get db (JAX :1184-1190)."""
    grads = []
    for d in range(2):
        grads += [dw_ih[d], dw_hh[d], db[d], db[d]]
    return tuple(grads)


def _fullfused_prep(x, params, storage_dtype):
    w_ih, w_hh, bias = _stacked(params)
    return (x.to(storage_dtype),
            w_ih.transpose(1, 2).to(storage_dtype).contiguous(),
            w_hh.transpose(1, 2).to(storage_dtype).contiguous(),
            bias.contiguous())


def _projection(x, w_ih, bias, storage_dtype):
    """Both directions' input projections as one product in the storage
    dtype, gates of the forward direction in [..., :4H], of the reverse one
    in [..., 4H:]."""
    return torch.nn.functional.linear(
        x.to(storage_dtype),
        w_ih.reshape(-1, w_ih.shape[-1]).to(storage_dtype),
        bias.reshape(-1).to(storage_dtype))


def _bidi_prep(x, params, storage_dtype):
    """``_bidi_prep``: xg, the float32 w_ih and the cast w_hh_t."""
    w_ih, w_hh, bias = _stacked(params)
    xg = _projection(x, w_ih, bias, storage_dtype)
    return xg, w_ih, w_hh.transpose(1, 2).to(storage_dtype).contiguous()


class BLSTMLayerFullFused(torch.autograd.Function):
    """One layer through ``blstm_fullfused_fwd`` / ``blstm_fullfused_bwd``
    (JAX ``blstm_layer_fullfused``). ``apply(x, *params, storage_dtype)``
    with ``params`` the layer's tensors in ``PARAM_NAMES`` order."""

    @staticmethod
    def forward(ctx, x, *args):
        *params, storage_dtype = args
        xs, w_ih_t, w_hh_t, bias = _fullfused_prep(x, params, storage_dtype)
        h, c = blstm_fullfused_fwd(xs, w_ih_t, w_hh_t, bias, with_cell=True)
        ctx.save_for_backward(xs, w_ih_t, w_hh_t, bias, h, c)
        ctx.x_dtype = x.dtype
        return h

    @staticmethod
    def backward(ctx, dout):
        xs, w_ih_t, w_hh_t, bias, h, c = ctx.saved_tensors
        # dh streams in the storage dtype, as ``_ff_layer_bwd``'s pad_ct
        dh = dout.to(xs.dtype).contiguous()
        dx, dw_ih_t, dw_hh_t, db = blstm_fullfused_bwd(xs, w_ih_t, w_hh_t,
                                                       bias, h, c, dh)
        grads = _to_params(dw_ih_t.transpose(1, 2), dw_hh_t.transpose(1, 2),
                           db)
        return (dx.to(ctx.x_dtype),) + grads + (None,)


class BLSTMLayerFused(torch.autograd.Function):
    """One layer through ``blstm_bidi_fwd`` / ``blstm_bidi_bwd`` with the
    input projection outside (JAX ``blstm_layer_fused``): the backward
    kernel gives dxg and dW_hh, and dW_ih, the bias gradient and dx are
    float32 products of dxg, as ``_layer_bwd`` (:770-780) computes them."""

    @staticmethod
    def forward(ctx, x, *args):
        *params, storage_dtype = args
        xg, w_ih, w_hh_t = _bidi_prep(x, params, storage_dtype)
        h, c = blstm_bidi_fwd(xg, w_hh_t, with_cell=True)
        ctx.save_for_backward(x, xg, w_ih, w_hh_t, h, c)
        return h

    @staticmethod
    def backward(ctx, dout):
        x, xg, w_ih, w_hh_t, h, c = ctx.saved_tensors
        dxg, dw_hh_t = blstm_bidi_bwd(xg, w_hh_t, h, c,
                                      dout.float().contiguous())
        G = w_ih.shape[1]
        dxg = dxg.float()
        dxg_d = torch.stack([dxg[..., :G], dxg[..., G:]])   # (2, B, T, 4H)
        rows = dxg_d.flatten(1, 2)                          # (2, B*T, 4H)
        xf = x.float().flatten(0, 1)                        # (B*T, I)
        dw_ih = rows.transpose(1, 2) @ xf                   # (2, 4H, I)
        db = rows.sum(dim=1)
        dx = (dxg_d[0] @ w_ih[0] + dxg_d[1] @ w_ih[1]).to(x.dtype)
        return (dx,) + _to_params(dw_ih, dw_hh_t.transpose(1, 2), db) + (
            None,)


class BLSTMLayerFullFusedCond(torch.autograd.Function):
    """The 'mul'-conditioned layer through ``blstm_fullfused_cond_fwd`` /
    ``blstm_fullfused_cond_bwd`` (JAX ``blstm_layer_fullfused_cond``).
    ``apply(xs, aux, *params, storage_dtype)`` with xs (B, T, F), aux
    (B, S, F) and ``params`` in ``PARAM_NAMES`` order -> h (B, S, T, 2H).
    Returns dx, daux and float32 gradients for all eight parameters."""

    @staticmethod
    def forward(ctx, xs, aux, *args):
        *params, storage_dtype = args
        x, w_ih_t, w_hh_t, bias = _fullfused_prep(xs, params, storage_dtype)
        a = aux.to(storage_dtype).contiguous()
        h, c = blstm_fullfused_cond_fwd(x, a, w_ih_t, w_hh_t, bias,
                                        with_cell=True)
        ctx.save_for_backward(x, a, w_ih_t, w_hh_t, bias, h, c)
        ctx.dtypes = xs.dtype, aux.dtype
        return h

    @staticmethod
    def backward(ctx, dout):
        x, a, w_ih_t, w_hh_t, bias, h, c = ctx.saved_tensors
        dx, daux, dw_ih_t, dw_hh_t, db = blstm_fullfused_cond_bwd(
            x, a, w_ih_t, w_hh_t, bias, h, c, dout.to(x.dtype).contiguous())
        grads = _to_params(dw_ih_t.transpose(1, 2), dw_hh_t.transpose(1, 2),
                           db)
        return (dx.to(ctx.dtypes[0]), daux.to(ctx.dtypes[1])) + grads + (
            None,)


class BLSTMLayerFullFusedSpill(torch.autograd.Function):
    """One layer through ``blstm_fullfused_spill_fwd`` /
    ``blstm_fullfused_spill_bwd`` (JAX ``blstm_layer_fullfused_spill``):
    as :class:`BLSTMLayerFullFused`, but it saves x, h and the c boundaries,
    not the c sequence."""

    @staticmethod
    def forward(ctx, x, *args):
        *params, storage_dtype = args
        xs, w_ih_t, w_hh_t, bias = _fullfused_prep(x, params, storage_dtype)
        h, cb = blstm_fullfused_spill_fwd(xs, w_ih_t, w_hh_t, bias,
                                          with_boundaries=True)
        ctx.save_for_backward(xs, w_ih_t, w_hh_t, bias, h, cb)
        ctx.x_dtype = x.dtype
        return h

    @staticmethod
    def backward(ctx, dout):
        xs, w_ih_t, w_hh_t, bias, h, cb = ctx.saved_tensors
        # dh streams in the storage dtype, as ``_ffs_layer_bwd``'s pad_ct
        dh = dout.to(xs.dtype).contiguous()
        dx, dw_ih_t, dw_hh_t, db = blstm_fullfused_spill_bwd(
            xs, w_ih_t, w_hh_t, bias, h, cb, dh)
        grads = _to_params(dw_ih_t.transpose(1, 2), dw_hh_t.transpose(1, 2),
                           db)
        return (dx.to(ctx.x_dtype),) + grads + (None,)


class BLSTMBidiCore(torch.autograd.Function):
    """The two recurrences of a layer from gate inputs through
    ``blstm_bidi_fwd`` / ``blstm_bidi_bwd`` (JAX ``_bi_core``).
    ``apply(xg, w_hh_t, storage_dtype)``: xg (B, T, 8H) in the storage
    dtype, w_hh_t (2, H, 4H) float32 master weights, cast inside. The
    backward returns dxg in the storage dtype, as ``_bi_core_bwd`` (:607)
    does, and dW_hh^T in float32."""

    @staticmethod
    def forward(ctx, xg, w_hh_t, storage_dtype):
        w = w_hh_t.to(storage_dtype).contiguous()
        h, c = blstm_bidi_fwd(xg, w, with_cell=True)
        ctx.save_for_backward(xg, w, h, c)
        return h

    @staticmethod
    def backward(ctx, dout):
        xg, w, h, c = ctx.saved_tensors
        # dh in float32, as ``_bi_core_bwd`` casts its cotangents
        dxg, dw_hh_t = blstm_bidi_bwd(xg, w, h, c, dout.float().contiguous())
        return dxg, dw_hh_t, None


class LSTMCore(torch.autograd.Function):
    """One direction's recurrence from gate inputs through ``lstm_fwd`` /
    ``lstm_bwd`` (JAX ``_lstm_core``). ``apply(xg, w_hh_t, storage_dtype,
    reverse)``: xg (B, T, 4H) in the storage dtype, w_hh_t (H, 4H) float32
    master weights, cast inside. The backward returns dxg in the storage
    dtype and dW_hh^T in float32, as ``BLSTMBidiCore`` does."""

    @staticmethod
    def forward(ctx, xg, w_hh_t, storage_dtype, reverse):
        w = w_hh_t.to(storage_dtype).contiguous()
        h, c = lstm_fwd(xg, w, reverse=reverse, with_cell=True)
        ctx.save_for_backward(xg, w, h, c)
        ctx.reverse = reverse
        return h

    @staticmethod
    def backward(ctx, dout):
        xg, w, h, c = ctx.saved_tensors
        # dh in float32, as ``_lstm_core_bwd`` casts its cotangents
        dxg, dw_hh_t = lstm_bwd(xg, w, h, c, dout.float().contiguous(),
                                reverse=ctx.reverse)
        return dxg, dw_hh_t, None, None


def _bidi_core_layer(x, params, storage_dtype):
    """``blstm_apply_fused_bidi`` under autograd: the projection recorded
    by autograd, the recurrences by :class:`BLSTMBidiCore`."""
    w_ih, w_hh, bias = _stacked(params)
    xg = _projection(x, w_ih, bias, storage_dtype)
    return BLSTMBidiCore.apply(xg, w_hh.transpose(1, 2), storage_dtype)


def _direction(x, params, storage_dtype, reverse):
    """One direction the way of ``lstm_fused``: the projection in autograd,
    the recurrence by :class:`LSTMCore` where autograd records, else by
    ``lstm_fwd``. params: that direction's four tensors in ``PARAM_NAMES``
    order -> (B, T, H) in ``storage_dtype``."""
    w_ih, w_hh, b_ih, b_hh = params
    xg = nn.functional.linear(x.to(storage_dtype), w_ih.to(storage_dtype),
                              (b_ih + b_hh).to(storage_dtype))
    if _records_grad(xg, w_hh):
        return LSTMCore.apply(xg, w_hh.t(), storage_dtype, reverse)
    h, _ = lstm_fwd(xg, w_hh.t().to(storage_dtype).contiguous(),
                    reverse=reverse)
    return h


def _records_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def blstm_apply(layer: BLSTM, x, storage_dtype, fullfuse=True, spill=False,
                bidi=True):
    """x: (B, T, I) -> (B, T, 2H), or (B, T, H) for a unidirectional layer,
    in ``storage_dtype``; the kernels chosen as JAX's ``blstm_apply``
    chooses them (``tssep_tpu/nn/rnnp.py:311-342``). Where autograd
    records, the layer runs as one of the Functions and saves what its
    backward reads; elsewhere (serving) the forward kernel writes h only.
    A bidirectional layer of input width up to ``FULLFUSE_MAX_INPUT`` runs
    fully fused with ``fullfuse``, through the spill pair with ``spill``
    too; any other takes the gate-input path, both directions in one kernel
    with ``bidi``, else each on its own (``lstm_fwd``)."""
    params = _layer_params(layer)
    if not layer.bidirectional:
        return _direction(x, params, storage_dtype, False)
    grad = _records_grad(x, *params)
    if fullfuse and x.shape[-1] <= FULLFUSE_MAX_INPUT:
        if grad:
            fn = BLSTMLayerFullFusedSpill if spill else BLSTMLayerFullFused
            return fn.apply(x, *params, storage_dtype)
        fwd = blstm_fullfused_spill_fwd if spill else blstm_fullfused_fwd
        h, _ = fwd(*_fullfused_prep(x, params, storage_dtype))
        return h
    # xg computed outside the kernel
    if not bidi:
        return torch.cat([_direction(x, params[:4], storage_dtype, False),
                          _direction(x, params[4:], storage_dtype, True)],
                         dim=-1)
    if grad:
        if not fullfuse:
            return _bidi_core_layer(x, params, storage_dtype)
        return BLSTMLayerFused.apply(x, *params, storage_dtype)
    xg, _, w_hh_t = _bidi_prep(x, params, storage_dtype)
    h, _ = blstm_bidi_fwd(xg, w_hh_t)
    return h


class RNNP(nn.Module):
    """RNN-with-projection block: [(B)LSTM -> Linear (-> Tanh)] x elayers.

    ``typ`` 'blstm', 'lstm', 'bgru' or 'gru', as the JAX ``RNNP`` takes
    it: a leading 'b' is bidirectional, 'lstm' in the name the LSTM cell,
    else the GRU. Dropout between the layers runs in training, with its
    draws from a generator. ``fullfuse``, ``spill`` and ``bidi`` choose the
    LSTM kernels (:func:`blstm_apply`); the GRU arms run
    :func:`bgru_apply`.
    """

    def __init__(self, idim, elayers=1, cdim=300, hdim=320, dropout=0.0,
                 typ='blstm', *, storage_dtype=torch.bfloat16, fullfuse=True,
                 spill=False, bidi=True, device='cuda'):
        super().__init__()
        if typ not in ('blstm', 'lstm', 'bgru', 'gru'):
            raise ValueError(f"RNNP typ={typ!r}: one of 'blstm', 'lstm', "
                             f"'bgru', 'gru'")
        device = resolve_device(device)
        self.idim, self.elayers, self.cdim, self.hdim = idim, elayers, cdim, hdim
        self.dropout = dropout
        self.typ = typ
        self.bidirectional = typ.startswith('b')
        self.cell = 'lstm' if 'lstm' in typ else 'gru'
        layer_cls = BLSTM if self.cell == 'lstm' else BGRU
        self.storage_dtype = storage_dtype
        self.fullfuse, self.spill, self.bidi = fullfuse, spill, bidi
        scale = 2 if self.bidirectional else 1
        for i in range(elayers):
            inputdim = idim if i == 0 else hdim
            self.add_module(f'lstm{i}', layer_cls(
                inputdim, cdim, bidirectional=self.bidirectional,
                device=device))
            self.add_module(f'proj{i}', nn.Linear(scale * cdim, hdim,
                                                  device=device))

    def init_params(self, generator: torch.Generator):
        for i in range(self.elayers):
            # torch.nn.GRU draws its tensors as torch.nn.LSTM does
            lstm_init_(getattr(self, f'lstm{i}'), self.cdim, generator)
            linear_init_(getattr(self, f'proj{i}'), generator)

    def forward(self, x, generator: torch.Generator | None = None,
                training=False):
        """x: (..., T, idim) with rank 2, 3 or 4 (batch [, speaker], time,
        feature) -> (..., T, hdim) in the storage dtype. Drops between the
        layers when ``training`` and a ``generator`` are given."""
        if x.dim() not in (2, 3, 4):
            raise ValueError(tuple(x.shape))
        lead = x.shape[:-2]
        h = x.reshape((-1,) + x.shape[-2:])
        for i in range(self.elayers):
            layer = getattr(self, f'lstm{i}')
            if self.cell == 'gru':
                h = bgru_apply(layer, h, self.storage_dtype)
            else:
                h = blstm_apply(layer, h, self.storage_dtype, self.fullfuse,
                                self.spill, self.bidi)
            h = self._project(i, h)
            if i < self.elayers - 1:
                if training:
                    h = inverted_dropout(h, self.dropout, generator)
                h = torch.tanh(h)
        return h.reshape(lead + h.shape[-2:])

    def _project(self, i, h):
        proj = getattr(self, f'proj{i}')
        return nn.functional.linear(h, proj.weight.to(h.dtype),
                                    proj.bias.to(h.dtype))

    def forward_conditioned(self, xs, aux):
        """The block on the 'mul'-conditioned input, ``forward(xs[:, None]
        * aux[:, :, None])``, with the product formed inside the kernels
        (JAX ``RNNP.apply_conditioned``, ``tssep_tpu/nn/rnnp.py:414-435``).
        xs: (B, T, idim); aux: (B, S, idim) -> (B, S, T, hdim) in the
        storage dtype. Needs ``elayers == 1`` and a bidirectional layer;
        ``spill`` and ``bidi`` do not apply, as in JAX."""
        if self.elayers != 1 or self.typ != 'blstm':
            raise ValueError(f'forward_conditioned needs elayers == 1 and '
                             f"typ='blstm', got {self.elayers}, {self.typ!r}")
        params = _layer_params(self.lstm0)
        if _records_grad(xs, aux, *params):
            h = BLSTMLayerFullFusedCond.apply(xs, aux, *params,
                                              self.storage_dtype)
        else:
            x, w_ih_t, w_hh_t, bias = _fullfused_prep(xs, params,
                                                      self.storage_dtype)
            h, _ = blstm_fullfused_cond_fwd(
                x, aux.to(self.storage_dtype).contiguous(), w_ih_t, w_hh_t,
                bias)
        return self._project(0, h)


def inverted_dropout(h, p, generator: torch.Generator | None):
    """Inverted dropout with keep probability ``1 - p``, drawn from
    ``generator``; the identity when ``p`` is 0 or there is no generator
    (JAX: ``training and dropout > 0 and rng is not None``)."""
    if not p or generator is None:
        return h
    keep = batch_rand(generator, h.shape) < 1 - p
    return torch.where(keep.to(h.device), h / (1 - p), torch.zeros_like(h))
