"""The LSTM kernels of the flagship's serving and training paths, with their
plain versions: ten CUDA kernels, one for each TPU kernel of
``tssep_tpu/kernels/blstm.py``.

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

Conditioned: ``blstm_fullfused_cond_fwd`` replaces ``_ffc_fwd_kernel``
(:1656, launched by ``_ffc_fwd_impl`` :1858) and runs the first post-net
layer on the 'mul'-conditioned rows ``xs[b] * aux[b, s]``, formed inside the
kernel from xs (B, T, F) and aux (B, S, F); ``blstm_fullfused_cond_bwd``
replaces ``_ffc_bwd_kernel`` (:1707, launched by ``_ffc_layer_bwd`` :1949)
and returns dx summed over the speakers, daux and every weight gradient.

Spill: ``blstm_fullfused_spill_fwd`` replaces ``_ffs_fwd_kernel`` (:1228,
launched by ``_ffs_fwd_impl`` :1431), the fully fused forward that saves,
besides h, only the c carry entering every ``SPILL_BLOCK``'th step of each
walk; ``blstm_fullfused_spill_bwd`` replaces ``_ffs_bwd_kernel`` (:1280,
launched by ``_ffs_layer_bwd`` :1522) and rebuilds c from those boundaries.

One direction: ``lstm_fwd`` replaces ``_fwd_kernel`` (:52, launched by
``_core_fwd_impl`` :217) and ``lstm_bwd`` replaces ``_bwd_kernel`` (:82,
launched by ``_lstm_core_bwd`` :267): one direction's recurrence from gate
inputs ``xg`` (B, T, 4H) and its backward, dxg and dW_hh; ``reverse=True``
walks t = T-1 .. 0.
The CUDA sources, with what bounds each kernel on an H100, are in ``csrc/``.

Each bidirectional wrapper takes one layer's two directions stacked on a
leading axis of 2 (forward, reverse). Sequences are (B, T, 2H), the forward direction in
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
           'blstm_bidi_bwd', 'blstm_fullfused_cond_fwd',
           'blstm_fullfused_cond_bwd', 'blstm_fullfused_spill_fwd',
           'blstm_fullfused_spill_bwd', 'lstm_fwd', 'lstm_bwd',
           'blstm_fullfused_fwd_plain', 'blstm_bidi_fwd_plain',
           'blstm_fullfused_bwd_plain', 'blstm_bidi_bwd_plain',
           'blstm_fullfused_cond_fwd_plain', 'blstm_fullfused_cond_bwd_plain',
           'blstm_fullfused_spill_fwd_plain', 'blstm_fullfused_spill_bwd_plain',
           'lstm_fwd_plain', 'lstm_bwd_plain', 'SPILL_BLOCK']

_STORAGE_DTYPES = (torch.float32, torch.bfloat16)

#: Threads of a block are the hidden units (blstm_common.cuh).
_MAX_HIDDEN = 512

#: Dynamic shared memory one block may use on Hopper.
_MAX_SHARED_BYTES = 232448

#: Steps between the c boundaries the spill forward saves
#: (``tssep_tpu/kernels/blstm.py:1225``).
SPILL_BLOCK = 8

#: The walk order of a layer's directions: forward, then reverse.
_BIDI = (False, True)


# ---------------------------------------------------------------------------
# Plain versions: the same function in PyTorch, one time step at a time
# ---------------------------------------------------------------------------

def _walk_plain(gates_in, w_hh_t, batch, steps, dtype, with_cell,
                revs=_BIDI, spill=0):
    """The directions of one layer, ``revs[d]`` True where direction d
    walks t = T-1 .. 0; ``gates_in(*ts)`` gives the input part of the gates,
    (n, B, 4H) float32, of each direction at its time ``ts[d]``. Follows
    ``tssep_tpu/nn/rnnp.py`` ``_lstm_scan``. Returns ``(h, c)``, each
    (B, T, nH); with ``spill``, the second is instead the c carry entering
    every ``spill``'th step of each walk, (n, ceil(T / spill), B, H), in
    ``dtype`` as the spill forward stores it."""
    n, H = len(revs), w_hh_t.shape[1]
    whh = w_hh_t.float()
    h = torch.zeros(n, batch, H, device=w_hh_t.device)
    c = torch.zeros_like(h)
    hs = torch.empty(batch, steps, n * H, dtype=dtype, device=w_hh_t.device)
    cs = torch.empty_like(hs) if with_cell else None
    if spill:
        cs = torch.empty(n, -(-steps // spill), batch, H, dtype=dtype,
                         device=w_hh_t.device)
    for s in range(steps):
        t = tuple(steps - 1 - s if r else s for r in revs)
        if spill and s % spill == 0:
            cs[:, s // spill] = c
        gates = gates_in(*t) + torch.bmm(h.to(dtype).float(), whh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        for d in range(n):
            hs[:, t[d], d * H:(d + 1) * H] = h[d]
            if with_cell:
                cs[:, t[d], d * H:(d + 1) * H] = c[d]
    return hs, cs


def _fullfused_gates_in(x, w_ih_t, bias):
    """``gates_in`` of the fully fused layer: x_t W_ih^T + b per direction."""
    wih = w_ih_t.float()
    b = bias.float()[:, None]

    def gates_in(tf, tr):
        return torch.bmm(torch.stack([x[:, tf], x[:, tr]]).float(), wih) + b

    return gates_in


def blstm_fullfused_fwd_plain(x, w_ih_t, w_hh_t, bias, *, with_cell=False):
    """Plain version of :func:`blstm_fullfused_fwd`."""
    return _walk_plain(_fullfused_gates_in(x, w_ih_t, bias), w_hh_t,
                       x.shape[0], x.shape[1], x.dtype, with_cell)


def blstm_fullfused_spill_fwd_plain(x, w_ih_t, w_hh_t, bias, *,
                                    with_boundaries=False):
    """Plain version of :func:`blstm_fullfused_spill_fwd`."""
    h, cb = _walk_plain(_fullfused_gates_in(x, w_ih_t, bias), w_hh_t,
                        x.shape[0], x.shape[1], x.dtype, False,
                        spill=SPILL_BLOCK)
    return h, (cb if with_boundaries else None)


def lstm_fwd_plain(xg, w_hh_t, *, reverse=False, with_cell=False):
    """Plain version of :func:`lstm_fwd`."""
    return _walk_plain(lambda t: xg[:, t].float()[None], w_hh_t[None],
                       xg.shape[0], xg.shape[1], xg.dtype, with_cell,
                       revs=(reverse,))


def _conditioned(xs, aux):
    """The 'mul'-conditioned rows (B S, T, F) in the storage dtype, row
    b S + s = ``xs[b] * aux[b, s]``: one rounding of the product, as the
    materialized ``xs[:, None] * aux[:, :, None]``."""
    B, T, F = xs.shape
    return (xs[:, None] * aux[:, :, None]).reshape(B * aux.shape[1], T, F)


def blstm_fullfused_cond_fwd_plain(xs, aux, w_ih_t, w_hh_t, bias, *,
                                   with_cell=False):
    """Plain version of :func:`blstm_fullfused_cond_fwd`: the product, then
    the fully fused layer's walk."""
    B, S = aux.shape[:2]
    h, c = blstm_fullfused_fwd_plain(_conditioned(xs, aux), w_ih_t, w_hh_t,
                                     bias, with_cell=with_cell)
    return tuple(None if t is None else t.view(B, S, *t.shape[1:])
                 for t in (h, c))


def blstm_bidi_fwd_plain(xg, w_hh_t, *, with_cell=False):
    """Plain version of :func:`blstm_bidi_fwd`."""
    G = w_hh_t.shape[2]

    def gates_in(tf, tr):
        return torch.stack([xg[:, tf, :G], xg[:, tr, G:]]).float()

    return _walk_plain(gates_in, w_hh_t, xg.shape[0], xg.shape[1], xg.dtype,
                       with_cell)


def _directions(seq, n=2):
    """(B, T, nH) -> (n, B, T, H) float32, forward direction first."""
    H = seq.shape[-1] // n
    return torch.stack([seq[..., d * H:(d + 1) * H]
                        for d in range(n)]).float()


def _previous(states, revs=_BIDI):
    """The state before each step of each direction's walk, (n, B, T, H):
    a forward direction's at t - 1, a reverse one's at t + 1, zero before
    the first step."""
    prev = torch.zeros_like(states)
    for d, rev in enumerate(revs):
        if rev:
            prev[d, :, :-1] = states[d, :, 1:]
        else:
            prev[d, :, 1:] = states[d, :, :-1]
    return prev


def _walk_bwd_core(pre, w_hh_t, cs, cp, dhs, revs):
    """The serial walk of every backward kernel: the gate gradients
    (n, B, T, 4H) float32. ``pre(ts, at)`` gives the gate pre-activations
    (n, B, 4H) at each direction's time ``ts[d]``, where ``at(seq)`` picks
    those times of an (n, B, T, ...) tensor; cs and cp are c after and
    before each step, dhs the cotangent of h, all (n, B, T, H). Follows
    ``_bi_bwd_kernel`` / ``_ff_bwd_kernel``'s ``one_direction``."""
    n, B, T = cs.shape[:3]
    whh = w_hh_t.float()
    dgates = torch.empty(n, B, T, 4 * w_hh_t.shape[1], device=cs.device)
    dh_carry = torch.zeros_like(cs[:, :, 0])
    dc_carry = torch.zeros_like(dh_carry)
    for s in reversed(range(T)):
        ts = tuple(T - 1 - s if r else s for r in revs)

        def at(seq):
            return torch.stack([seq[d, :, ts[d]] for d in range(n)])

        gates = pre(ts, at)
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = i.sigmoid(), f.sigmoid(), g.tanh(), o.sigmoid()
        dh_t = dh_carry + at(dhs)
        tanh_c = at(cs).tanh()
        dc = dc_carry + dh_t * o * (1 - tanh_c * tanh_c)
        dg = torch.cat([dc * g * i * (1 - i), dc * at(cp) * f * (1 - f),
                        dc * i * (1 - g * g), dh_t * tanh_c * o * (1 - o)], -1)
        for d in range(n):
            dgates[d, :, ts[d]] = dg[d]
        dh_carry = torch.bmm(dg, whh.transpose(1, 2))
        dc_carry = dc * f
    return dgates


def _walk_bwd_plain(gates_in, w_hh_t, h, c, dh, revs=_BIDI):
    """The walk of the backward kernels that read the saved c: the gates
    recomputed from ``gates_in(*ts)`` (as in :func:`_walk_plain`) and the
    saved h; h, c from the forward; dh the cotangent of h."""
    n = len(revs)
    whh = w_hh_t.float()
    hp = _previous(_directions(h, n), revs)
    cs = _directions(c, n)

    def pre(ts, at):
        return gates_in(*ts) + torch.bmm(at(hp), whh)

    return _walk_bwd_core(pre, w_hh_t, cs, _previous(cs, revs),
                          _directions(dh, n), revs)


def _weight_sums(rows, dgates):
    """sum over batch and time of rows^T dgates per direction: rows
    (2, B, T, M), dgates (2, B, T, 4H) -> (2, M, 4H) float32."""
    return torch.einsum('dbtm,dbtg->dmg', rows, dgates)


def _fullfused_sums(x, h, dgates):
    """The weight and bias sums of a fully fused backward from its gate
    gradients: ``(dw_ih_t, dw_hh_t, db)``."""
    xf = x.float().expand(2, *x.shape)
    return (_weight_sums(xf, dgates),
            _weight_sums(_previous(_directions(h)), dgates),
            dgates.sum(dim=(1, 2)))


def _fullfused_bwd_sums(x, w_ih_t, w_hh_t, bias, h, c, dh):
    """The gate gradients and the weight and bias sums of the fully fused
    backward: ``(dgates, dw_ih_t, dw_hh_t, db)``."""
    dgates = _walk_bwd_plain(_fullfused_gates_in(x, w_ih_t, bias), w_hh_t, h,
                             c, dh)
    return (dgates,) + _fullfused_sums(x, h, dgates)


def _dx_each_rounded(dgates, w_ih_t, dtype):
    """dx per direction rounded to the storage dtype, summed in float32."""
    wih = w_ih_t.float()
    return sum(torch.matmul(dgates[d], wih[d].T).to(dtype).float()
               for d in range(2))


def blstm_fullfused_bwd_plain(x, w_ih_t, w_hh_t, bias, h, c, dh):
    """Plain version of :func:`blstm_fullfused_bwd`."""
    dgates, dw_ih_t, dw_hh_t, db = _fullfused_bwd_sums(x, w_ih_t, w_hh_t,
                                                       bias, h, c, dh)
    return _dx_each_rounded(dgates, w_ih_t, x.dtype), dw_ih_t, dw_hh_t, db


def blstm_fullfused_spill_bwd_plain(x, w_ih_t, w_hh_t, bias, h, cb, dh):
    """Plain version of :func:`blstm_fullfused_spill_bwd`, in the phases of
    ``_ffs_bwd_kernel``: every gate pre-activation from the saved h at once,
    c rebuilt inside each spill block from its stored boundary, the reverse
    walk, the sums."""
    B, T = x.shape[:2]
    hp = _previous(_directions(h))
    gates = (torch.einsum('btf,dfg->dbtg', x.float(), w_ih_t.float())
             + torch.einsum('dbth,dhg->dbtg', hp, w_hh_t.float())
             + bias.float()[:, None, None])
    cs = torch.empty_like(hp)
    cp = torch.empty_like(hp)
    for s in range(T):
        ts = (s, T - 1 - s)
        if s % SPILL_BLOCK == 0:
            c = cb[:, s // SPILL_BLOCK].float()
        g = torch.stack([gates[d, :, ts[d]] for d in range(2)])
        i, f, gg, _ = g.chunk(4, dim=-1)
        for d in range(2):
            cp[d, :, ts[d]] = c[d]
        c = f.sigmoid() * c + i.sigmoid() * gg.tanh()
        for d in range(2):
            cs[d, :, ts[d]] = c[d]
    dgates = _walk_bwd_core(lambda ts, at: at(gates), w_hh_t, cs, cp,
                            _directions(dh), _BIDI)
    return (_dx_each_rounded(dgates, w_ih_t, x.dtype),) + _fullfused_sums(
        x, h, dgates)


def blstm_fullfused_cond_bwd_plain(xs, aux, w_ih_t, w_hh_t, bias, h, c, dh):
    """Plain version of :func:`blstm_fullfused_cond_bwd`."""
    B, S = aux.shape[:2]
    fold = lambda t: t.reshape(B * S, *t.shape[2:])    # noqa: E731
    dgates, dw_ih_t, dw_hh_t, db = _fullfused_bwd_sums(
        _conditioned(xs, aux), w_ih_t, w_hh_t, bias, fold(h), fold(c),
        fold(dh))
    wih = w_ih_t.float()
    # both directions summed in float32, then split and rounded once
    dcond = sum(torch.matmul(dgates[d], wih[d].T) for d in range(2))
    dcond = dcond.view(B, S, *dcond.shape[1:])          # (B, S, T, F)
    dx = (dcond * aux.float()[:, :, None]).sum(dim=1)
    daux = (dcond * xs.float()[:, None]).sum(dim=2)
    return (dx.to(xs.dtype).float(), daux.to(aux.dtype).float(), dw_ih_t,
            dw_hh_t, db)


def blstm_bidi_bwd_plain(xg, w_hh_t, h, c, dh):
    """Plain version of :func:`blstm_bidi_bwd`."""
    G = w_hh_t.shape[2]

    def gates_in(tf, tr):
        return torch.stack([xg[:, tf, :G], xg[:, tr, G:]]).float()

    dgates = _walk_bwd_plain(gates_in, w_hh_t, h, c, dh)
    dxg = torch.cat([dgates[0], dgates[1]], dim=-1).to(xg.dtype)
    return dxg, _weight_sums(_previous(_directions(h)), dgates)


def lstm_bwd_plain(xg, w_hh_t, h, c, dh, *, reverse=False):
    """Plain version of :func:`lstm_bwd`."""
    revs = (reverse,)
    dgates = _walk_bwd_plain(lambda t: xg[:, t].float()[None], w_hh_t[None],
                             h, c, dh, revs)
    dw_hh_t = _weight_sums(_previous(_directions(h, 1), revs), dgates)
    return dgates[0].to(xg.dtype), dw_hh_t[0]


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


def _launch_tile(x, H, shared_floats_per_row, tensors, rows=None):
    """Rows per block for a launch on ``x`` with ``rows`` rows (default
    ``x.shape[0]``); raises where no kernel runs."""
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
    bt = _batch_tile(x.shape[0] if rows is None else rows, x.device)
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


def _check_cond_inputs(xs, aux, w_ih_t, w_hh_t, bias):
    """Checks the conditioned layer's inputs; returns (B, S, T, F, H)."""
    _check_stream_input('xs', xs)
    B, T, F = xs.shape
    if aux.dim() != 3:
        raise ValueError(f'aux: expected (B, S, F), got {tuple(aux.shape)}')
    S = aux.shape[1]
    H = w_hh_t.shape[1]
    _check('aux', aux, (B, S, F), xs.dtype, xs.device)
    _check('w_ih_t', w_ih_t, (2, F, 4 * H), xs.dtype, xs.device)
    _check('w_hh_t', w_hh_t, (2, H, 4 * H), xs.dtype, xs.device)
    _check('bias', bias, (2, 4 * H), torch.float32, xs.device)
    return B, S, T, F, H


def blstm_fullfused_cond_fwd(xs, aux, w_ih_t, w_hh_t, bias, *,
                             with_cell=False):
    """One bidirectional LSTM layer over the 'mul'-conditioned rows
    ``xs[b] * aux[b, s]``, formed in the kernel: the layer of
    :func:`blstm_fullfused_fwd` on ``xs[:, None] * aux[:, :, None]``
    without that (B, S, T, F) tensor.

    xs: (B, T, F); aux: (B, S, F); w_ih_t: (2, F, 4H); w_hh_t: (2, H, 4H),
    all in the storage dtype; bias: (2, 4H) float32. Returns ``(h, c)``,
    each (B, S, T, 2H) in the storage dtype; ``c`` is None unless
    ``with_cell``.
    """
    B, S, T, F, H = _check_cond_inputs(xs, aux, w_ih_t, w_hh_t, bias)
    if xs.device.type == 'cpu':
        return blstm_fullfused_cond_fwd_plain(xs, aux, w_ih_t, w_hh_t, bias,
                                              with_cell=with_cell)
    bt = _launch_tile(xs, H, 2 * H + F, (aux, w_ih_t, w_hh_t, bias),
                      rows=B * S)
    h = torch.empty(B * S, T, 2 * H, dtype=xs.dtype, device=xs.device)
    c = torch.empty_like(h) if with_cell else None
    with torch.cuda.device(xs.device):
        err = _build.library().tssep_blstm_fullfused_cond_fwd(
            xs.data_ptr(), xs.stride(0), xs.stride(1), F, aux.data_ptr(), S,
            w_ih_t.data_ptr(), bias.data_ptr(), w_hh_t.data_ptr(),
            h.data_ptr(), c.data_ptr() if with_cell else None, h.stride(0),
            h.stride(1), B, T, H, int(xs.dtype == torch.bfloat16), bt,
            torch.cuda.current_stream(xs.device).cuda_stream)
    _raise_on(err, 'blstm_fullfused_cond_fwd')
    blstm_fullfused_cond_fwd.launches += 1
    return tuple(None if t is None else t.view(B, S, T, 2 * H) for t in (h, c))


blstm_fullfused_cond_fwd.launches = 0


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


def blstm_fullfused_cond_bwd(xs, aux, w_ih_t, w_hh_t, bias, h, c, dh):
    """The backward of :func:`blstm_fullfused_cond_fwd`.

    xs, aux, w_ih_t, w_hh_t, bias as for the forward; h, c: (B, S, T, 2H),
    the forward's outputs; dh: (B, S, T, 2H), the cotangent of h in the
    storage dtype. Returns ``(dx, daux, dw_ih_t, dw_hh_t, db)`` in float32:
    dx (B, T, F), summed over the speakers and both directions, then
    rounded to the storage dtype; daux (B, S, F), rounded to the storage
    dtype; dw_ih_t (2, F, 4H); dw_hh_t (2, H, 4H); db (2, 4H), the gradient
    of each of the two torch biases.
    """
    B, S, T, F, H = _check_cond_inputs(xs, aux, w_ih_t, w_hh_t, bias)
    for name, t in (('h', h), ('c', c), ('dh', dh)):
        _check(name, t, (B, S, T, 2 * H), xs.dtype, xs.device)
    if xs.device.type == 'cpu':
        return blstm_fullfused_cond_bwd_plain(xs, aux, w_ih_t, w_hh_t, bias,
                                              h, c, dh)
    bt = _launch_tile(xs, H, 7 * H + F, (aux, w_ih_t, w_hh_t, bias, h, c),
                      rows=B * S)
    # the speakers folded into the rows (views of the contiguous h and c)
    h, c, dh = (t.reshape(B * S, T, 2 * H) for t in (h, c, dh))
    if dh.stride(-1) != 1:
        raise ValueError('the last axis of dh must be contiguous')
    w_ih = w_ih_t.transpose(1, 2).contiguous()
    w_hh = w_hh_t.transpose(1, 2).contiguous()
    f32 = dict(dtype=torch.float32, device=xs.device)
    dg = torch.empty(2, B * S, T, 4 * H, **f32)        # workspace
    dcond = torch.empty(B * S, T, F, **f32)            # workspace
    dw = torch.empty(2, F + H + 1, 4 * H, **f32)       # [dW_ih^T; dW_hh^T; db]
    dx = torch.empty(B, T, F, **f32)
    daux = torch.empty(B, S, F, **f32)
    with torch.cuda.device(xs.device):
        err = _build.library().tssep_blstm_fullfused_cond_bwd(
            xs.data_ptr(), xs.stride(0), xs.stride(1), F, aux.data_ptr(), S,
            w_ih_t.data_ptr(), w_ih.data_ptr(), bias.data_ptr(),
            w_hh_t.data_ptr(), w_hh.data_ptr(), h.data_ptr(), c.data_ptr(),
            h.stride(0), h.stride(1), dh.data_ptr(), dh.stride(0),
            dh.stride(1), dg.data_ptr(), dcond.data_ptr(), dw.data_ptr(),
            dx.data_ptr(), daux.data_ptr(), B, T, H,
            int(xs.dtype == torch.bfloat16), bt,
            torch.cuda.current_stream(xs.device).cuda_stream)
    _raise_on(err, 'blstm_fullfused_cond_bwd')
    blstm_fullfused_cond_bwd.launches += 1
    return dx, daux, dw[:, :F], dw[:, F:F + H], dw[:, F + H]


blstm_fullfused_cond_bwd.launches = 0


def _boundary_shape(B, T, H):
    return (2, -(-T // SPILL_BLOCK), B, H)


def blstm_fullfused_spill_fwd(x, w_ih_t, w_hh_t, bias, *,
                              with_boundaries=False):
    """The layer of :func:`blstm_fullfused_fwd` that saves, instead of the c
    sequence, only the c carry entering every ``SPILL_BLOCK``'th step of
    each walk (JAX ``_ffs_fwd_impl``).

    Arguments as for :func:`blstm_fullfused_fwd`. Returns ``(h, cb)``: h
    (B, T, 2H) and cb (2, ceil(T / SPILL_BLOCK), B, H), both in the storage
    dtype, ``cb[d, k]`` the c carry of direction d before its walk's step
    ``k SPILL_BLOCK`` (``cb[:, 0]`` is zero); ``cb`` is None unless
    ``with_boundaries``.
    """
    _check_stream_input('x', x)
    B, T, F = x.shape
    H = w_hh_t.shape[1]
    _check('w_ih_t', w_ih_t, (2, F, 4 * H), x.dtype, x.device)
    _check('w_hh_t', w_hh_t, (2, H, 4 * H), x.dtype, x.device)
    _check('bias', bias, (2, 4 * H), torch.float32, x.device)
    if x.device.type == 'cpu':
        return blstm_fullfused_spill_fwd_plain(
            x, w_ih_t, w_hh_t, bias, with_boundaries=with_boundaries)
    bt = _launch_tile(x, H, 2 * H + F, (w_ih_t, w_hh_t, bias))
    h, _ = _outputs(x, H, False)
    cb = (torch.empty(_boundary_shape(B, T, H), dtype=x.dtype,
                      device=x.device) if with_boundaries else None)
    with torch.cuda.device(x.device):
        err = _build.library().tssep_blstm_fullfused_spill_fwd(
            x.data_ptr(), x.stride(0), x.stride(1), F, w_ih_t.data_ptr(),
            bias.data_ptr(), w_hh_t.data_ptr(), h.data_ptr(),
            cb.data_ptr() if with_boundaries else None, h.stride(0),
            h.stride(1), B, T, H, SPILL_BLOCK, int(x.dtype == torch.bfloat16),
            bt, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, 'blstm_fullfused_spill_fwd')
    blstm_fullfused_spill_fwd.launches += 1
    return h, cb


blstm_fullfused_spill_fwd.launches = 0


def blstm_fullfused_spill_bwd(x, w_ih_t, w_hh_t, bias, h, cb, dh):
    """The backward of :func:`blstm_fullfused_spill_fwd` (JAX
    ``_ffs_layer_bwd``), from the saved h and c boundaries: c is rebuilt
    inside each spill block from its stored, rounded boundary.

    x, w_ih_t, w_hh_t, bias as for the forward; h (B, T, 2H) and cb
    (2, ceil(T / SPILL_BLOCK), B, H), the forward's outputs; dh (B, T, 2H),
    the cotangent of h in the storage dtype. Returns what
    :func:`blstm_fullfused_bwd` returns.
    """
    _check_stream_input('x', x)
    B, T, F = x.shape
    H = w_hh_t.shape[1]
    _check('w_ih_t', w_ih_t, (2, F, 4 * H), x.dtype, x.device)
    _check('w_hh_t', w_hh_t, (2, H, 4 * H), x.dtype, x.device)
    _check('bias', bias, (2, 4 * H), torch.float32, x.device)
    _check('h', h, (B, T, 2 * H), x.dtype, x.device)
    _check('cb', cb, _boundary_shape(B, T, H), x.dtype, x.device)
    _check('dh', dh, (B, T, 2 * H), x.dtype, x.device)
    if x.device.type == 'cpu':
        return blstm_fullfused_spill_bwd_plain(x, w_ih_t, w_hh_t, bias, h, cb,
                                               dh)
    if dh.stride(-1) != 1:
        raise ValueError('the last axis of dh must be contiguous')
    # the walk keeps dh, dc and two steps' gate gradients per row
    bt = _launch_tile(x, H, 10 * H, (w_ih_t, w_hh_t, bias, h, cb))
    w_ih = w_ih_t.transpose(1, 2).contiguous()
    w_hh = w_hh_t.transpose(1, 2).contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    gates = torch.empty(2, B, T, 4 * H, **f32)         # workspace
    cells = torch.empty(2, B, T, H, **f32)             # workspace
    dw = torch.empty(2, F + H + 1, 4 * H, **f32)       # [dW_ih^T; dW_hh^T; db]
    dx = torch.empty(B, T, F, **f32)
    with torch.cuda.device(x.device):
        err = _build.library().tssep_blstm_fullfused_spill_bwd(
            x.data_ptr(), x.stride(0), x.stride(1), F, w_ih_t.data_ptr(),
            w_ih.data_ptr(), bias.data_ptr(), w_hh_t.data_ptr(),
            w_hh.data_ptr(), h.data_ptr(), h.stride(0), h.stride(1),
            cb.data_ptr(), dh.data_ptr(), dh.stride(0), dh.stride(1),
            gates.data_ptr(), cells.data_ptr(), dw.data_ptr(), dx.data_ptr(),
            B, T, H, SPILL_BLOCK, int(x.dtype == torch.bfloat16), bt,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, 'blstm_fullfused_spill_bwd')
    blstm_fullfused_spill_bwd.launches += 1
    return dx, dw[:, :F], dw[:, F:F + H], dw[:, F + H]


blstm_fullfused_spill_bwd.launches = 0


def _check_uni(xg, w_hh_t):
    """Checks one direction's gate inputs; returns (B, T, H)."""
    _check_stream_input('xg', xg)
    B, T, G = xg.shape
    H = w_hh_t.shape[0]
    if G != 4 * H:
        raise ValueError(f'xg: expected width 4H = {4 * H}, got {G}')
    _check('w_hh_t', w_hh_t, (H, 4 * H), xg.dtype, xg.device)
    return B, T, H


def lstm_fwd(xg, w_hh_t, *, reverse=False, with_cell=False):
    """One direction of an LSTM layer from gate inputs (JAX
    ``_core_fwd_impl``).

    xg: (B, T, 4H), ``x @ W_ih^T + b`` in original time order; w_hh_t:
    (H, 4H), same dtype; ``reverse`` walks t = T-1 .. 0. Returns ``(h, c)``,
    each (B, T, H) in the storage dtype; ``c`` is None unless ``with_cell``.
    """
    B, T, H = _check_uni(xg, w_hh_t)
    if xg.device.type == 'cpu':
        return lstm_fwd_plain(xg, w_hh_t, reverse=reverse,
                              with_cell=with_cell)
    bt = _launch_tile(xg, H, 2 * H, (w_hh_t,))
    h = torch.empty(B, T, H, dtype=xg.dtype, device=xg.device)
    c = torch.empty_like(h) if with_cell else None
    with torch.cuda.device(xg.device):
        err = _build.library().tssep_lstm_fwd(
            xg.data_ptr(), xg.stride(0), xg.stride(1), w_hh_t.data_ptr(),
            h.data_ptr(), c.data_ptr() if with_cell else None, h.stride(0),
            h.stride(1), B, T, H, int(reverse),
            int(xg.dtype == torch.bfloat16), bt,
            torch.cuda.current_stream(xg.device).cuda_stream)
    _raise_on(err, 'lstm_fwd')
    lstm_fwd.launches += 1
    return h, c


lstm_fwd.launches = 0


def lstm_bwd(xg, w_hh_t, h, c, dh, *, reverse=False):
    """The backward of :func:`lstm_fwd` (JAX ``_lstm_core_bwd``).

    xg, w_hh_t and ``reverse`` as for the forward; h, c: (B, T, H), the
    forward's outputs; dh: (B, T, H) float32, the cotangent of h. Returns
    ``(dxg, dw_hh_t)``: dxg (B, T, 4H) in the storage dtype and dw_hh_t
    (H, 4H) float32.
    """
    B, T, H = _check_uni(xg, w_hh_t)
    for name, t in (('h', h), ('c', c)):
        _check(name, t, (B, T, H), xg.dtype, xg.device)
    _check('dh', dh, (B, T, H), torch.float32, xg.device)
    if xg.device.type == 'cpu':
        return lstm_bwd_plain(xg, w_hh_t, h, c, dh, reverse=reverse)
    if dh.stride(-1) != 1:
        raise ValueError('the last axis of dh must be contiguous')
    bt = _launch_tile(xg, H, 7 * H, (w_hh_t, h, c))
    w_hh = w_hh_t.t().contiguous()
    dg = torch.empty(1, B, T, 4 * H, dtype=torch.float32, device=xg.device)
    dxg = torch.empty(B, T, 4 * H, dtype=xg.dtype, device=xg.device)
    dw = torch.empty(H, 4 * H, dtype=torch.float32, device=xg.device)
    with torch.cuda.device(xg.device):
        err = _build.library().tssep_lstm_bwd(
            xg.data_ptr(), xg.stride(0), xg.stride(1), w_hh_t.data_ptr(),
            w_hh.data_ptr(), h.data_ptr(), c.data_ptr(), h.stride(0),
            h.stride(1), dh.data_ptr(), dh.stride(0), dh.stride(1),
            dg.data_ptr(), dxg.data_ptr(), dw.data_ptr(), B, T, H,
            int(reverse), int(xg.dtype == torch.bfloat16), bt,
            torch.cuda.current_stream(xg.device).cuda_stream)
    _raise_on(err, 'lstm_bwd')
    lstm_bwd.launches += 1
    return dxg, dw


lstm_bwd.launches = 0
