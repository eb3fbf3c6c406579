"""Bidirectional LSTM with projection (RNNP): port of ``tssep_tpu/nn/rnnp.py``.

``[BLSTM -> Linear (-> Dropout -> Tanh)] x elayers`` with the nonlinearity
dropped after the last layer, on rank-2/3/4 inputs (speakers folded into the
batch axis). Parameters keep torch's names and layouts (``weight_ih_l0`` is
(4H, I), gate order i, f, g, o), so the JAX package's named parameters load
by name.

Every layer runs through the kernels of ``tssep_tpu_torch.kernels.blstm``,
chosen as ``blstm_apply`` chooses with its TPU defaults
(``tssep_tpu/nn/rnnp.py:311-342``): input width up to ``FULLFUSE_MAX_INPUT``
goes to ``blstm_fullfused_fwd``, wider goes to ``blstm_bidi_fwd`` with the
input projection as one matrix product outside. Where a gradient is wanted,
the layer is a ``torch.autograd.Function`` whose backward is the matching
backward kernel: ``BLSTMLayerFullFused`` (``blstm_layer_fullfused``, JAX
:1052-1195) and ``BLSTMLayerFused`` (``blstm_layer_fused``, JAX :681-783).
Both take the layer's float32 master parameters, cast them inside, and
return float32 gradients for all eight of them, as JAX's custom VJPs do.

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

from tssep_tpu_torch.kernels.blstm import (blstm_bidi_bwd, blstm_bidi_fwd,
                                           blstm_fullfused_bwd,
                                           blstm_fullfused_fwd)
from tssep_tpu_torch.nn.init import linear_init_, lstm_init_
from tssep_tpu_torch.utils.device import resolve_device

__all__ = ['BLSTM', 'RNNP', 'blstm_apply', 'BLSTMLayerFullFused',
           'BLSTMLayerFused', 'FULLFUSE_MAX_INPUT', 'PARAM_NAMES',
           'inverted_dropout']

#: Widest input the fully fused kernel takes (``tssep_tpu/nn/rnnp.py:286``).
FULLFUSE_MAX_INPUT = 2048

_SUFFIXES = ('', '_reverse')

#: The eight named tensors of a layer, in the order the Functions take them.
PARAM_NAMES = tuple(name + suffix for suffix in _SUFFIXES
                    for name in ('weight_ih_l0', 'weight_hh_l0', 'bias_ih_l0',
                                 'bias_hh_l0'))


class BLSTM(nn.Module):
    """One bidirectional LSTM layer's parameters, named as ``torch.nn.LSTM``
    names them. Float32 master weights; :func:`blstm_apply` runs it."""

    def __init__(self, input_size, hidden_size, *, device='cuda'):
        super().__init__()
        device = resolve_device(device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        G = 4 * hidden_size
        for suffix in _SUFFIXES:
            for name, shape in (('weight_ih_l0', (G, input_size)),
                                ('weight_hh_l0', (G, hidden_size)),
                                ('bias_ih_l0', (G,)), ('bias_hh_l0', (G,))):
                self.register_parameter(name + suffix, nn.Parameter(
                    torch.zeros(shape, device=device)))


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


def _bidi_prep(x, params, storage_dtype):
    """``_bidi_prep``: both directions' projections as one product, gates of
    the forward direction in [..., :4H], of the reverse one in [..., 4H:]."""
    w_ih, w_hh, bias = _stacked(params)
    xs = x.to(storage_dtype)
    xg = torch.nn.functional.linear(
        xs, w_ih.reshape(-1, w_ih.shape[-1]).to(storage_dtype),
        bias.reshape(-1).to(storage_dtype))
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


def blstm_apply(layer: BLSTM, x, storage_dtype):
    """x: (B, T, I) -> (B, T, 2H) in ``storage_dtype``. Where autograd
    records, the layer runs as one of the two Functions and saves c for
    its backward; elsewhere (serving) the forward kernel writes h only."""
    params = tuple(getattr(layer, name) for name in PARAM_NAMES)
    wide = x.shape[-1] > FULLFUSE_MAX_INPUT
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x,) + params):
        fn = BLSTMLayerFused if wide else BLSTMLayerFullFused
        return fn.apply(x, *params, storage_dtype)
    if wide:
        xg, _, w_hh_t = _bidi_prep(x, params, storage_dtype)
        h, _ = blstm_bidi_fwd(xg, w_hh_t)
    else:
        h, _ = blstm_fullfused_fwd(*_fullfused_prep(x, params, storage_dtype))
    return h


class RNNP(nn.Module):
    """RNN-with-projection block: [BLSTM -> Linear (-> Tanh)] x elayers.

    Only the bidirectional LSTM arm of the JAX ``RNNP`` is ported. Dropout
    between the layers runs in training, with its draws from a generator.
    """

    def __init__(self, idim, elayers=1, cdim=300, hdim=320, dropout=0.0,
                 typ='blstm', *, storage_dtype=torch.bfloat16, device='cuda'):
        super().__init__()
        if typ != 'blstm':
            raise NotImplementedError(f'RNNP typ={typ!r}: only the '
                                      f"bidirectional LSTM ('blstm') is ported")
        device = resolve_device(device)
        self.idim, self.elayers, self.cdim, self.hdim = idim, elayers, cdim, hdim
        self.dropout = dropout
        self.storage_dtype = storage_dtype
        for i in range(elayers):
            inputdim = idim if i == 0 else hdim
            self.add_module(f'lstm{i}', BLSTM(inputdim, cdim, device=device))
            self.add_module(f'proj{i}', nn.Linear(2 * cdim, hdim,
                                                  device=device))

    def init_params(self, generator: torch.Generator):
        for i in range(self.elayers):
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
            h = blstm_apply(getattr(self, f'lstm{i}'), h, self.storage_dtype)
            proj = getattr(self, f'proj{i}')
            h = nn.functional.linear(h, proj.weight.to(h.dtype),
                                     proj.bias.to(h.dtype))
            if i < self.elayers - 1:
                if training:
                    h = inverted_dropout(h, self.dropout, generator)
                h = torch.tanh(h)
        return h.reshape(lead + h.shape[-2:])


def inverted_dropout(h, p, generator: torch.Generator | None):
    """Inverted dropout with keep probability ``1 - p``, drawn from
    ``generator``; the identity when ``p`` is 0 or there is no generator
    (JAX: ``training and dropout > 0 and rng is not None``)."""
    if not p or generator is None:
        return h
    keep = torch.rand(h.shape, generator=generator,
                      device=generator.device) < 1 - p
    return torch.where(keep.to(h.device), h / (1 - p), torch.zeros_like(h))
