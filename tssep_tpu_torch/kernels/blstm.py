"""The BLSTM kernels of the flagship's serving and training paths, with their
plain versions.

Forward: ``blstm_fullfused_fwd`` replaces the TPU kernel ``_ff_fwd_kernel``
(``tssep_tpu/kernels/blstm.py:797``) and runs every bidirectional layer whose
input is at most ``FULLFUSE_MAX_INPUT`` wide: the input projection happens
inside the recurrence. ``blstm_bidi_fwd`` replaces ``_bi_fwd_kernel``
(``tssep_tpu/kernels/blstm.py:374``) and runs the recurrence from gate inputs
``xg`` computed outside, for the wider ts_vad stacked layer.

Backward: ``blstm_fullfused_bwd`` replaces ``_ff_bwd_kernel`` (:861, launched
by ``_ff_layer_bwd`` :1074) and returns dx and every weight and bias
gradient; ``blstm_bidi_bwd`` replaces ``_bi_bwd_kernel`` (:424, launched by
``_layer_bwd`` :697 and ``_bi_core_bwd`` :555) and returns dxg and dW_hh.
The CUDA sources, with what bounds each kernel on an H100, are in ``csrc/``.

Each wrapper takes one layer's two directions stacked on a leading axis of 2
(forward, reverse). Sequences are (B, T, 2H), the forward direction in
``[..., :H]`` and the reverse in ``[..., H:]``, both in original time order.
Streamed tensors are in the storage dtype (float32 or bfloat16); the
carries, the sums, the bias and the weight gradients are float32, and the
recurrent product reads h rounded to the storage dtype, as the TPU kernels
do.

A wrapper runs its plain PyTorch version for tensors on the CPU and launches
its CUDA kernel for tensors on a CUDA device; it raises for any other device.
Each wrapper counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import torch

from tssep_tpu_torch.kernels import _build

__all__ = ['blstm_fullfused_fwd', 'blstm_bidi_fwd', 'blstm_fullfused_bwd',
           'blstm_bidi_bwd', 'blstm_fullfused_fwd_plain',
           'blstm_bidi_fwd_plain', 'blstm_fullfused_bwd_plain',
           'blstm_bidi_bwd_plain']

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


def _directions(seq):
    """(B, T, 2H) -> (2, B, T, H) float32, forward direction first."""
    H = seq.shape[-1] // 2
    return torch.stack([seq[..., :H], seq[..., H:]]).float()


def _previous(states):
    """The state before each step of each direction's walk, (2, B, T, H):
    the forward direction's at t - 1, the reverse one's at t + 1, zero
    before the first step."""
    prev = torch.zeros_like(states)
    prev[0, :, 1:] = states[0, :, :-1]
    prev[1, :, :-1] = states[1, :, 1:]
    return prev


def _walk_bwd_plain(gates_in, w_hh_t, h, c, dh):
    """The serial part of both backward kernels: the gate gradients
    (2, B, T, 4H) float32 of both directions. ``gates_in(t_fwd, t_rev)`` as
    in :func:`_walk_plain`; h, c from the forward; dh the cotangent of h.
    Follows ``_bi_bwd_kernel`` / ``_ff_bwd_kernel``'s ``one_direction``."""
    B, T = h.shape[:2]
    whh = w_hh_t.float()
    hp, cs = _previous(_directions(h)), _directions(c)
    cp, dhs = _previous(cs), _directions(dh)
    dgates = torch.empty(2, B, T, 4 * w_hh_t.shape[1], device=h.device)
    dh_carry = torch.zeros_like(hp[:, :, 0])
    dc_carry = torch.zeros_like(dh_carry)
    for s in reversed(range(T)):
        tf, tr = s, T - 1 - s

        def at(seq):
            return torch.stack([seq[0, :, tf], seq[1, :, tr]])

        gates = gates_in(tf, tr) + torch.bmm(at(hp), whh)
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = i.sigmoid(), f.sigmoid(), g.tanh(), o.sigmoid()
        dh_t = dh_carry + at(dhs)
        tanh_c = at(cs).tanh()
        dc = dc_carry + dh_t * o * (1 - tanh_c * tanh_c)
        dg = torch.cat([dc * g * i * (1 - i), dc * at(cp) * f * (1 - f),
                        dc * i * (1 - g * g), dh_t * tanh_c * o * (1 - o)], -1)
        dgates[0, :, tf] = dg[0]
        dgates[1, :, tr] = dg[1]
        dh_carry = torch.bmm(dg, whh.transpose(1, 2))
        dc_carry = dc * f
    return dgates


def _weight_sums(rows, dgates):
    """sum over batch and time of rows^T dgates per direction: rows
    (2, B, T, M), dgates (2, B, T, 4H) -> (2, M, 4H) float32."""
    return torch.einsum('dbtm,dbtg->dmg', rows, dgates)


def blstm_fullfused_bwd_plain(x, w_ih_t, w_hh_t, bias, h, c, dh):
    """Plain version of :func:`blstm_fullfused_bwd`."""
    wih = w_ih_t.float()
    b = bias.float()[:, None]

    def gates_in(tf, tr):
        return torch.bmm(torch.stack([x[:, tf], x[:, tr]]).float(), wih) + b

    dgates = _walk_bwd_plain(gates_in, w_hh_t, h, c, dh)
    xf = x.float().expand(2, *x.shape)
    dw_ih_t = _weight_sums(xf, dgates)
    dw_hh_t = _weight_sums(_previous(_directions(h)), dgates)
    db = dgates.sum(dim=(1, 2))
    # dx per direction rounded to the storage dtype, summed in float32
    dx = sum(torch.matmul(dgates[d], wih[d].T).to(x.dtype).float()
             for d in range(2))
    return dx, dw_ih_t, dw_hh_t, db


def blstm_bidi_bwd_plain(xg, w_hh_t, h, c, dh):
    """Plain version of :func:`blstm_bidi_bwd`."""
    G = w_hh_t.shape[2]

    def gates_in(tf, tr):
        return torch.stack([xg[:, tf, :G], xg[:, tr, G:]]).float()

    dgates = _walk_bwd_plain(gates_in, w_hh_t, h, c, dh)
    dxg = torch.cat([dgates[0], dgates[1]], dim=-1).to(xg.dtype)
    return dxg, _weight_sums(_previous(_directions(h)), dgates)


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


def _launch_tile(x, H, shared_floats_per_row, tensors):
    """Rows per block for a launch on ``x``; raises where no kernel runs."""
    if x.device.type != 'cuda':
        raise ValueError(f'no kernel for device {x.device}')
    if x.numel() == 0:
        raise ValueError(f'empty input {tuple(x.shape)}')
    if x.stride(-1) != 1:
        raise ValueError('the last axis of the input must be contiguous')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('weights, bias and saved states must be contiguous')
    if H > _MAX_HIDDEN:
        raise ValueError(f'hidden size {H} > {_MAX_HIDDEN}')
    bt = _batch_tile(x.shape[0], x.device)
    if 4 * bt * shared_floats_per_row > _MAX_SHARED_BYTES:
        bt = 4
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


def _check_saved(x, H, h, c, dh, dh_dtype):
    B, T = x.shape[:2]
    for name, t in (('h', h), ('c', c)):
        _check(name, t, (B, T, 2 * H), x.dtype, x.device)
    _check('dh', dh, (B, T, 2 * H), dh_dtype, x.device)
    if x.device.type == 'cuda' and dh.stride(-1) != 1:
        raise ValueError('the last axis of dh must be contiguous')


def blstm_fullfused_bwd(x, w_ih_t, w_hh_t, bias, h, c, dh):
    """The backward of :func:`blstm_fullfused_fwd`.

    x, w_ih_t, w_hh_t, bias as for the forward; h, c: (B, T, 2H), the
    forward's outputs; dh: (B, T, 2H), the cotangent of h in the storage
    dtype. Returns ``(dx, dw_ih_t, dw_hh_t, db)`` in float32: dx (B, T, F),
    each direction's share rounded to the storage dtype before the two are
    summed; dw_ih_t (2, F, 4H); dw_hh_t (2, H, 4H); db (2, 4H), the
    gradient of each of the two torch biases.
    """
    _check_stream_input('x', x)
    B, T, F = x.shape
    H = w_hh_t.shape[1]
    _check('w_ih_t', w_ih_t, (2, F, 4 * H), x.dtype, x.device)
    _check('w_hh_t', w_hh_t, (2, H, 4 * H), x.dtype, x.device)
    _check('bias', bias, (2, 4 * H), torch.float32, x.device)
    _check_saved(x, H, h, c, dh, x.dtype)
    if x.device.type == 'cpu':
        return blstm_fullfused_bwd_plain(x, w_ih_t, w_hh_t, bias, h, c, dh)
    bt = _launch_tile(x, H, 7 * H + F, (w_ih_t, w_hh_t, bias, h, c))
    w_ih = w_ih_t.transpose(1, 2).contiguous()
    w_hh = w_hh_t.transpose(1, 2).contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dg = torch.empty(2, B, T, 4 * H, **f32)            # workspace
    dw = torch.empty(2, F + H + 1, 4 * H, **f32)       # [dW_ih^T; dW_hh^T; db]
    dx = torch.empty(B, T, F, **f32)
    with torch.cuda.device(x.device):
        err = _build.library().tssep_blstm_fullfused_bwd(
            x.data_ptr(), x.stride(0), x.stride(1), F, w_ih_t.data_ptr(),
            w_ih.data_ptr(), bias.data_ptr(), w_hh_t.data_ptr(),
            w_hh.data_ptr(), h.data_ptr(), c.data_ptr(), h.stride(0),
            h.stride(1), dh.data_ptr(), dh.stride(0), dh.stride(1),
            dg.data_ptr(), dw.data_ptr(), dx.data_ptr(), B, T, H,
            int(x.dtype == torch.bfloat16), bt,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, 'blstm_fullfused_bwd')
    blstm_fullfused_bwd.launches += 1
    return dx, dw[:, :F], dw[:, F:F + H], dw[:, F + H]


blstm_fullfused_bwd.launches = 0


def blstm_bidi_bwd(xg, w_hh_t, h, c, dh):
    """The backward of :func:`blstm_bidi_fwd`.

    xg, w_hh_t as for the forward; h, c: (B, T, 2H), the forward's
    outputs; dh: (B, T, 2H) float32, the cotangent of h. Returns
    ``(dxg, dw_hh_t)``: dxg (B, T, 8H) in the storage dtype and dw_hh_t
    (2, H, 4H) float32.
    """
    _check_stream_input('xg', xg)
    B, T, G2 = xg.shape
    H = w_hh_t.shape[1]
    if G2 != 8 * H:
        raise ValueError(f'xg: expected width 8H = {8 * H}, got {G2}')
    _check('w_hh_t', w_hh_t, (2, H, 4 * H), xg.dtype, xg.device)
    _check_saved(xg, H, h, c, dh, torch.float32)
    if xg.device.type == 'cpu':
        return blstm_bidi_bwd_plain(xg, w_hh_t, h, c, dh)
    bt = _launch_tile(xg, H, 7 * H, (w_hh_t, h, c))
    w_hh = w_hh_t.transpose(1, 2).contiguous()
    dg = torch.empty(2, B, T, 4 * H, dtype=torch.float32, device=xg.device)
    dxg = torch.empty(B, T, 8 * H, dtype=xg.dtype, device=xg.device)
    dw = torch.empty(2, H, 4 * H, dtype=torch.float32, device=xg.device)
    with torch.cuda.device(xg.device):
        err = _build.library().tssep_blstm_bidi_bwd(
            xg.data_ptr(), xg.stride(0), xg.stride(1), w_hh_t.data_ptr(),
            w_hh.data_ptr(), h.data_ptr(), c.data_ptr(), h.stride(0),
            h.stride(1), dh.data_ptr(), dh.stride(0), dh.stride(1),
            dg.data_ptr(), dxg.data_ptr(), dw.data_ptr(), B, T, H,
            int(xg.dtype == torch.bfloat16), bt,
            torch.cuda.current_stream(xg.device).cuda_stream)
    _raise_on(err, 'blstm_bidi_bwd')
    blstm_bidi_bwd.launches += 1
    return dxg, dw


blstm_bidi_bwd.launches = 0
