"""Bidirectional LSTM with projection (RNNP): port of ``tssep_tpu/nn/rnnp.py``.

``[BLSTM -> Linear (-> Tanh)] x elayers`` with the nonlinearity dropped after
the last layer, on rank-2/3/4 inputs (speakers folded into the batch axis).
Parameters keep torch's names and layouts (``weight_ih_l0`` is (4H, I), gate
order i, f, g, o), so the JAX package's named parameters load by name.

Every layer runs through one of the two kernels of
``tssep_tpu_torch.kernels.blstm``, chosen as ``blstm_apply`` chooses with its
TPU defaults (``tssep_tpu/nn/rnnp.py:311-342``): input width up to
``FULLFUSE_MAX_INPUT`` goes to ``blstm_fullfused_fwd``, wider goes to
``blstm_bidi_fwd`` with the input projection as one matrix product outside.
"""

from __future__ import annotations

import torch
from torch import nn

from tssep_tpu_torch.kernels.blstm import blstm_bidi_fwd, blstm_fullfused_fwd
from tssep_tpu_torch.nn.init import linear_init_, lstm_init_
from tssep_tpu_torch.utils.device import resolve_device

__all__ = ['BLSTM', 'RNNP', 'blstm_apply', 'FULLFUSE_MAX_INPUT']

#: Widest input the fully fused kernel takes (``tssep_tpu/nn/rnnp.py:286``).
FULLFUSE_MAX_INPUT = 2048

_SUFFIXES = ('', '_reverse')


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

    def stacked(self, name):
        """(2, ...) stack of the forward and reverse tensors ``name``."""
        return torch.stack([getattr(self, name + s) for s in _SUFFIXES])


def blstm_apply(layer: BLSTM, x, storage_dtype):
    """x: (B, T, I) -> (B, T, 2H) in ``storage_dtype``."""
    x = x.to(storage_dtype)
    w_hh_t = layer.stacked('weight_hh_l0').transpose(1, 2).to(
        storage_dtype).contiguous()                       # (2, H, 4H)
    bias = layer.stacked('bias_ih_l0') + layer.stacked('bias_hh_l0')
    w_ih = layer.stacked('weight_ih_l0')                  # (2, 4H, I)
    if x.shape[-1] <= FULLFUSE_MAX_INPUT:
        w_ih_t = w_ih.transpose(1, 2).to(storage_dtype).contiguous()
        h, _ = blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias.contiguous())
        return h
    # ``_bidi_prep``: both directions' projections as one product, gates of
    # the forward direction in [..., :4H], of the reverse one in [..., 4H:]
    xg = torch.nn.functional.linear(
        x, w_ih.reshape(-1, w_ih.shape[-1]).to(storage_dtype),
        bias.reshape(-1).to(storage_dtype))
    h, _ = blstm_bidi_fwd(xg, w_hh_t)
    return h


class RNNP(nn.Module):
    """RNN-with-projection block: [BLSTM -> Linear (-> Tanh)] x elayers.

    Only the bidirectional LSTM arm of the JAX ``RNNP`` is ported. ``dropout``
    is kept for the configuration's sake; the serving forward does not drop.
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

    def forward(self, x):
        """x: (..., T, idim) with rank 2, 3 or 4 (batch [, speaker], time,
        feature) -> (..., T, hdim) in the storage dtype."""
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
                h = torch.tanh(h)
        return h.reshape(lead + h.shape[-2:])
