"""The two forward BLSTM kernels of the serving path, with their plain versions.

``blstm_fullfused_fwd`` replaces the TPU kernel ``_ff_fwd_kernel``
(``tssep_tpu/kernels/blstm.py:797``) and runs every bidirectional layer whose
input is at most ``FULLFUSE_MAX_INPUT`` wide: the input projection happens
inside the recurrence. ``blstm_bidi_fwd`` replaces ``_bi_fwd_kernel``
(``tssep_tpu/kernels/blstm.py:374``) and runs the recurrence from gate inputs
``xg`` computed outside, for the wider ts_vad stacked layer. The CUDA sources,
with what bounds each kernel on an H100, are in ``csrc/``.

Both wrappers take one layer's two directions stacked on a leading axis of 2
(forward, reverse) and return ``h`` (and ``c`` when asked) as (B, T, 2H), the
forward direction in ``[..., :H]`` and the reverse in ``[..., H:]``, both in
original time order. Streamed tensors are in the storage dtype (float32 or
bfloat16); the carries, the sums and the bias are float32, and the recurrent
product reads h rounded to the storage dtype, as the TPU kernels do.

A wrapper runs its plain PyTorch version for tensors on the CPU and launches
its CUDA kernel for tensors on a CUDA device; it raises for any other device.
Each wrapper counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from tssep_tpu_torch.kernels import _build

__all__ = ['blstm_fullfused_fwd', 'blstm_bidi_fwd',
           'blstm_fullfused_fwd_plain', 'blstm_bidi_fwd_plain']

_STORAGE_DTYPES = (torch.float32, torch.bfloat16)

#: Threads of a block are the hidden units (blstm_common.cuh).
_MAX_HIDDEN = 512

#: Dynamic shared memory one block may use on Hopper.
_MAX_SHARED_BYTES = 232448


# ---------------------------------------------------------------------------
# Plain versions: the same function in PyTorch, one time step at a time
# ---------------------------------------------------------------------------

def _walk_plain(gates_in, w_hh_t, batch, steps, dtype, with_cell):
    """Both directions of one layer; ``gates_in(t_fwd, t_rev)`` gives the
    input part of the gates, (2, B, 4H) float32, for the forward direction
    at time ``t_fwd`` and the reverse one at ``t_rev``. Follows
    ``tssep_tpu/nn/rnnp.py`` ``_lstm_scan``."""
    H = w_hh_t.shape[1]
    whh = w_hh_t.float()
    h = torch.zeros(2, batch, H, device=w_hh_t.device)
    c = torch.zeros_like(h)
    hs = torch.empty(batch, steps, 2 * H, dtype=dtype, device=w_hh_t.device)
    cs = torch.empty_like(hs) if with_cell else None
    for s in range(steps):
        t = (s, steps - 1 - s)
        gates = gates_in(*t) + torch.bmm(h.to(dtype).float(), whh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        for d in range(2):
            hs[:, t[d], d * H:(d + 1) * H] = h[d]
            if with_cell:
                cs[:, t[d], d * H:(d + 1) * H] = c[d]
    return hs, cs


def blstm_fullfused_fwd_plain(x, w_ih_t, w_hh_t, bias, *, with_cell=False):
    """Plain version of :func:`blstm_fullfused_fwd`."""
    wih = w_ih_t.float()
    b = bias.float()[:, None]

    def gates_in(tf, tr):
        return torch.bmm(torch.stack([x[:, tf], x[:, tr]]).float(), wih) + b

    return _walk_plain(gates_in, w_hh_t, x.shape[0], x.shape[1], x.dtype,
                       with_cell)


def blstm_bidi_fwd_plain(xg, w_hh_t, *, with_cell=False):
    """Plain version of :func:`blstm_bidi_fwd`."""
    G = w_hh_t.shape[2]

    def gates_in(tf, tr):
        return torch.stack([xg[:, tf, :G], xg[:, tr, G:]]).float()

    return _walk_plain(gates_in, w_hh_t, xg.shape[0], xg.shape[1], xg.dtype,
                       with_cell)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check(name, tensor, shape, dtype, device):
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, got '
                         f'{tuple(tensor.shape)}')
    if tensor.dtype != dtype:
        raise ValueError(f'{name}: expected {dtype}, got {tensor.dtype}')
    if tensor.device != device:
        raise ValueError(f'{name}: expected device {device}, got '
                         f'{tensor.device}')


def _check_stream_input(name, x):
    if x.dim() != 3:
        raise ValueError(f'{name}: expected (B, T, width), got '
                         f'{tuple(x.shape)}')
    if x.dtype not in _STORAGE_DTYPES:
        raise ValueError(f'{name}: storage dtype must be one of '
                         f'{_STORAGE_DTYPES}, got {x.dtype}')


def _launch_tile(x, H, shared_floats_per_row, weights):
    """Rows per block for a launch on ``x``; raises where no kernel runs."""
    if x.device.type != 'cuda':
        raise ValueError(f'no kernel for device {x.device}')
    if x.numel() == 0:
        raise ValueError(f'empty input {tuple(x.shape)}')
    if x.stride(-1) != 1:
        raise ValueError('the last axis of the input must be contiguous')
    if not all(w.is_contiguous() for w in weights):
        raise ValueError('weights and bias must be contiguous')
    if H > _MAX_HIDDEN:
        raise ValueError(f'hidden size {H} > {_MAX_HIDDEN}')
    bt = _batch_tile(x.shape[0], x.device)
    if 4 * bt * shared_floats_per_row > _MAX_SHARED_BYTES:
        raise ValueError(f'needs {4 * bt * shared_floats_per_row} bytes of '
                         f'shared memory per block, more than '
                         f'{_MAX_SHARED_BYTES}')
    return bt


def _batch_tile(batch, device):
    """Rows per block: 16 when that still gives a block to every SM, else 4
    (more blocks, each streaming the weights for fewer rows)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 16 if 2 * -(-batch // 16) >= sms else 4


def _outputs(x, H, with_cell):
    B, T = x.shape[:2]
    h = torch.empty(B, T, 2 * H, dtype=x.dtype, device=x.device)
    c = torch.empty_like(h) if with_cell else None
    return h, c


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err} at launch')


def blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias, *, with_cell=False):
    """One bidirectional LSTM layer with the input projection in the kernel.

    x: (B, T, F); w_ih_t: (2, F, 4H); w_hh_t: (2, H, 4H), all in the storage
    dtype; bias: (2, 4H) float32, the sum of both torch biases. Returns
    ``(h, c)``, each (B, T, 2H) in the storage dtype; ``c`` is None unless
    ``with_cell``.
    """
    _check_stream_input('x', x)
    B, T, F = x.shape
    H = w_hh_t.shape[1]
    _check('w_ih_t', w_ih_t, (2, F, 4 * H), x.dtype, x.device)
    _check('w_hh_t', w_hh_t, (2, H, 4 * H), x.dtype, x.device)
    _check('bias', bias, (2, 4 * H), torch.float32, x.device)
    if x.device.type == 'cpu':
        return blstm_fullfused_fwd_plain(x, w_ih_t, w_hh_t, bias,
                                         with_cell=with_cell)
    bt = _launch_tile(x, H, 2 * H + F, (w_ih_t, w_hh_t, bias))
    h, c = _outputs(x, H, with_cell)
    with torch.cuda.device(x.device):
        err = _build.library().tssep_blstm_fullfused_fwd(
            x.data_ptr(), x.stride(0), x.stride(1), F, w_ih_t.data_ptr(),
            bias.data_ptr(), w_hh_t.data_ptr(), h.data_ptr(),
            c.data_ptr() if with_cell else None, h.stride(0), h.stride(1),
            B, T, H, int(x.dtype == torch.bfloat16), bt,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, 'blstm_fullfused_fwd')
    blstm_fullfused_fwd.launches += 1
    return h, c


blstm_fullfused_fwd.launches = 0


def blstm_bidi_fwd(xg, w_hh_t, *, with_cell=False):
    """The recurrences of one bidirectional LSTM layer from gate inputs.

    xg: (B, T, 8H), the forward direction's ``x @ W_ih^T + b`` in
    ``[..., :4H]`` and the reverse one's in ``[..., 4H:]``, both in original
    time order; w_hh_t: (2, H, 4H), same dtype. Returns ``(h, c)`` as
    :func:`blstm_fullfused_fwd` does.
    """
    _check_stream_input('xg', xg)
    B, T, G2 = xg.shape
    H = w_hh_t.shape[1]
    if G2 != 8 * H:
        raise ValueError(f'xg: expected width 8H = {8 * H}, got {G2}')
    _check('w_hh_t', w_hh_t, (2, H, 4 * H), xg.dtype, xg.device)
    if xg.device.type == 'cpu':
        return blstm_bidi_fwd_plain(xg, w_hh_t, with_cell=with_cell)
    bt = _launch_tile(xg, H, 2 * H, (w_hh_t,))
    h, c = _outputs(xg, H, with_cell)
    with torch.cuda.device(xg.device):
        err = _build.library().tssep_blstm_bidi_fwd(
            xg.data_ptr(), xg.stride(0), xg.stride(1), w_hh_t.data_ptr(),
            h.data_ptr(), c.data_ptr() if with_cell else None, h.stride(0),
            h.stride(1), B, T, H, int(xg.dtype == torch.bfloat16), bt,
            torch.cuda.current_stream(xg.device).cuda_stream)
    _raise_on(err, 'blstm_bidi_fwd')
    blstm_bidi_fwd.launches += 1
    return h, c


blstm_bidi_fwd.launches = 0
