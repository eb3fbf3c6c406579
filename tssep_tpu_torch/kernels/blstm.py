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

The fully fused pair, the bidi pair, the conditioned pair and the spill
pair have two routes by storage dtype. bfloat16, the one the flagship
serves and trains in, runs the Hopper design of
``csrc/blstm_cluster_fwd.cuh`` and ``csrc/blstm_cluster_bwd.cuh``: W_hh
split over a thread-block cluster and resident in shared memory,
tensor-core products, the input projection (or the copy of the gate inputs
xg) off the serial chain; the bidi pair runs its gate-input form, the
conditioned pair its conditioned form, which forms the rows
``xs[b] * aux[b, s]`` where the projection form stages x, and the spill
pair the projection form, whose forward writes the c boundaries and whose
walk rebuilds c from them. Its launch geometry comes from
:func:`cluster_geometry`, and the weights enter it packed per CTA in the
tensor cores' fragment order (:func:`_pack_fwd`, :func:`_pack_walk`).
float32, the tests' and checks' mode, keeps the first design
(``csrc/blstm_common.cuh``, ``csrc/blstm_bwd_common.cuh``), which the
other two kernels share.

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

import ctypes
import dataclasses
import functools

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
           'lstm_fwd_plain', 'lstm_bwd_plain', 'SPILL_BLOCK',
           'ClusterGeometry', 'cluster_geometry', 'wgrad_splits',
           'gate_wgrad_splits']

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
    dgates = _spill_bwd_gates(x, w_ih_t, w_hh_t, bias, h, cb, dh)
    return (_dx_each_rounded(dgates, w_ih_t, x.dtype),) + _fullfused_sums(
        x, h, dgates)


def _spill_bwd_gates(x, w_ih_t, w_hh_t, bias, h, cb, dh):
    """The gate gradients (2, B, T, 4H) float32 of the spill backward: c
    rebuilt in float32 inside each spill block from its boundary, which is
    read as stored (rounded to the storage dtype)."""
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
    return _walk_bwd_core(lambda ts, at: at(gates), w_hh_t, cs, cp,
                          _directions(dh), _BIDI)


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
# Launch geometry and weight packing of the fully fused pair's bf16 route
# ---------------------------------------------------------------------------

#: SMs of an H100 SXM: the card the geometry is sized for.
H100_SMS = 132

#: Most m-tiles (16 gate rows) one CTA of the forward owns: its block is a
#: consumer and a producer warp per m-tile, at most 640 threads.
_FWD_MAX_MTILES = 10

#: Most threads of a walk CTA, and (unit, row) elements each thread updates.
_WALK_MAX_THREADS, _WALK_EPT = 512, 4


def _ceil_to(n, m):
    return -(-n // m) * m


def _fwd_xg_shared(MT, KH, BT, TC):
    """Shared bytes of a forward CTA in the gate-input form
    (``csrc/blstm_cluster_fwd.cuh``): the W_hh^T slice, two h buffers, a
    two-chunk ring of f32 gate inputs and two mbarriers."""
    return (MT * (KH // 16) * 512 + 4 * BT * (KH + 8)
            + 2 * TC * MT * (BT // 8) * 512 + 16)


def _fwd_shared(MT, KH, BT, TC, KX, KA=0):
    """Shared bytes of a forward CTA in the projection form: the gate-input
    form's and the staged x rows; in the conditioned form (KA = KF) also
    the tile's aux rows, KA values each."""
    return (_fwd_xg_shared(MT, KH, BT, TC) + 2 * TC * BT * (KX + 8)
            + 2 * BT * KA)


def _walk_shared(MT, KH, U, nact, BT, cache=0):
    """Shared bytes of a walk CTA (``csrc/blstm_cluster_bwd.cuh``): the
    W_hh^T slice, two buffers of the C partials of dh, two steps' split gate
    gradients and two mbarriers; in the spill form also ``cache`` f32 c
    values per (unit, row), a block's rebuilt c (``SPILL_BLOCK`` + 1)."""
    return (MT * (KH // 16) * 512 + 8 * nact * U * BT + 8 * BT * (4 * U + 8)
            + 16 + 4 * cache * U * BT)


@dataclasses.dataclass(frozen=True)
class ClusterGeometry:
    """How one launch of the clustered kernels (bf16 route) is cut.

    ``cluster`` CTAs a cluster, CTA r owning the hidden units
    ``[r units, min(H, (r + 1) units))``, the first ``active`` of them owning
    any; one cluster per (tile of ``row_tile`` rows, direction),
    ``clusters`` in all, ``clusters_per_wave`` resident at once;
    ``threads`` and ``shared`` bytes a CTA. Forward only: ``chunk`` steps of
    gate inputs computed (or copied) at a time; projection form only: x
    staged ``k_block`` columns at a time."""
    kind: str
    cluster: int
    units: int
    active: int
    row_tile: int
    tiles: int
    threads: int
    shared: int
    chunk: int
    k_block: int
    clusters: int
    clusters_per_wave: int

    @property
    def waves(self):
        return -(-self.clusters // self.clusters_per_wave)


#: The kinds of :func:`cluster_geometry`: the forward in its projection,
#: conditioned and gate-input forms, the backward's walk (the same in the
#: fully fused, conditioned and gate-input forms) and the spill form of the
#: walk, which rebuilds c into shared memory.
GEOMETRY_KINDS = ('fwd', 'fwd_cond', 'fwd_xg', 'bwd', 'bwd_spill')


def cluster_geometry(kind, rows, F, H, sms=H100_SMS, slots=None):
    """The launch geometry of ``blstm_fullfused_fwd`` (``kind`` 'fwd'), of
    ``blstm_fullfused_cond_fwd`` ('fwd_cond', the conditioned form: rows
    are the B S conditioned rows), of ``blstm_bidi_fwd`` ('fwd_xg', the
    gate-input form) or of the walk of ``blstm_fullfused_bwd``,
    ``blstm_fullfused_cond_bwd`` and ``blstm_bidi_bwd`` ('bwd') or of
    ``blstm_fullfused_spill_bwd`` ('bwd_spill', whose walk also holds a
    spill block's rebuilt c) in bf16 storage, for ``rows`` rows, input
    width F (read by the projection forms only) and hidden size H:
    a pure function of its arguments. ``slots(cluster, row_tile, chunk,
    threads, shared)`` gives the clusters of the kernel that such a plan
    launches that the card holds at once, or None (an H100 SXM holds 15
    clusters of 8 CTAs that take a whole SM each, not 132 // 8 = 16, as its
    SMs sit in GPCs of unequal size); without it, or where it gives None,
    ``sms // cluster``.

    The cluster is 8 CTAs (portable) where each CTA's share fits (the
    forward's at most 10 m-tiles, H <= 320; the walk's in shared memory,
    H <= 416), else 16 (non-portable); fewer CTAs where H needs fewer (a
    power of two). Units per CTA are a multiple of 4, so that
    each m-tile holds the four gates of four units. The row tile is the
    smallest of 8, 16, 24, 32 that puts every cluster in one wave, else the
    largest that fits with all of F staged at once (else the largest that
    fits). The forward then takes the longest chunk of steps
    that fits in 232,448 bytes: the projection forms 1, 2 or 4 steps of at
    most 32 columns and the widest x block (at least 256 columns, or all of
    F), beside the tile's aux rows in the conditioned form; the gate-input
    form 1, 2, 4 or 8 steps of at most 64 columns.
    Raises ValueError where H exceeds ``_MAX_HIDDEN`` or nothing fits."""
    if kind not in GEOMETRY_KINDS:
        raise ValueError(f'kind must be one of {GEOMETRY_KINDS}, got {kind!r}')
    if rows < 1 or F < 1 or H < 1:
        raise ValueError(f'empty layer: rows {rows}, F {F}, H {H}')
    if H > _MAX_HIDDEN:
        raise ValueError(f'hidden size {H} > {_MAX_HIDDEN}')
    KH, KF = _ceil_to(H, 16), _ceil_to(F, 16)
    for C in (8, 16):
        U = 4 * -(-H // (4 * C))
        MT = U // 4
        if not kind.startswith('bwd') and MT > _FWD_MAX_MTILES:
            continue
        nact = -(-H // U)
        cluster = 1 << (nact - 1).bit_length()
        plans = []
        for BT in (8, 16, 24, 32):
            if kind in ('fwd', 'fwd_cond'):
                plan = _fwd_plan(MT, KH, KF, BT,
                                 KF if kind == 'fwd_cond' else 0)
            elif kind == 'fwd_xg':
                plan = _fwd_xg_plan(MT, KH, BT)
            else:
                plan = _walk_plan(MT, KH, U, nact, BT,
                                  SPILL_BLOCK + 1 if kind == 'bwd_spill'
                                  else 0)
            if plan is not None:
                threads, shared, TC, _ = plan
                per_wave = ((slots and slots(cluster, BT, TC, threads, shared))
                            or sms // cluster)
                plans.append((BT, plan, per_wave))
        if not plans:
            continue
        one_wave = [p for p in plans if 2 * -(-rows // p[0]) <= p[2]]
        # x staged in blocks costs each step a barrier pair and a short
        # product per block, more than a smaller tile's extra waves cost:
        # chip_smoke.py times the conditioned forward both ways at 2048 rows
        whole = [p for p in plans if p[1][3] in (0, KF)] or plans
        BT, (threads, shared, TC, KX), per_wave = (
            one_wave[0] if one_wave else whole[-1])
        tiles = -(-rows // BT)
        return ClusterGeometry(
            kind=kind, cluster=cluster, units=U, active=nact, row_tile=BT,
            tiles=tiles, threads=threads, shared=shared, chunk=TC,
            k_block=KX, clusters=2 * tiles,
            clusters_per_wave=min(per_wave, 2 * tiles))
    raise ValueError(f'no cluster of at most 16 CTAs holds a {kind} layer '
                     f'with H {H}, F {F} in shared memory')


def _fwd_plan(MT, KH, KF, BT, KA=0):
    """(threads, shared, chunk, x block) of the forward at row tile BT, or
    None where nothing fits with x staged at least 256 columns at a time;
    KA as for :func:`_fwd_shared`."""
    for TC in (4, 2, 1):
        if TC * BT > 32:
            continue
        for nk in range(1, KF // 16 + 1):
            KX = _ceil_to(-(-KF // nk), 16)
            if KX < min(KF, 256):
                break
            shared = _fwd_shared(MT, KH, BT, TC, KX, KA)
            if shared <= _MAX_SHARED_BYTES:
                return 2 * MT * 32, shared, TC, KX
    return None


def _fwd_xg_plan(MT, KH, BT):
    """(threads, shared, chunk, 0) of the gate-input forward at row tile BT,
    or None."""
    for TC in (8, 4, 2, 1):
        shared = _fwd_xg_shared(MT, KH, BT, TC)
        if TC * BT <= 64 and shared <= _MAX_SHARED_BYTES:
            return 2 * MT * 32, shared, TC, 0
    return None


def _walk_plan(MT, KH, U, nact, BT, cache=0):
    """(threads, shared, 1, 0) of the walk at row tile BT, or None; cache
    as for :func:`_walk_shared`."""
    warps = max(min(16, KH // 16), -(-U * BT // (32 * _WALK_EPT)))
    shared = _walk_shared(MT, KH, U, nact, BT, cache)
    if 32 * warps > _WALK_MAX_THREADS or shared > _MAX_SHARED_BYTES:
        return None
    return 32 * warps, shared, 1, 0


def wgrad_splits(rows, F, H, sms=H100_SMS):
    """Row ranges the bf16 fully fused backward's weight sums cut its
    ``rows`` (B T) rows into, so that 2 x the output's 128 x 128 tiles
    times the ranges leave the least of their last wave of ``sms`` SMs
    idle: at most 8, at least 64 blocks of 32 rows each, and no more
    partials (each 2 (F + H + 1) 4H floats) than dx's B T F floats hold. A
    pure function."""
    room = 1 + rows * F // (2 * (F + H + 1) * 4 * H)
    return _splits(F + H + 1, rows, H, room, sms)


def gate_wgrad_splits(rows, H, sms=H100_SMS):
    """Row ranges of the bf16 bidi backward's weight sums dW_hh^T, (H, 4H)
    per direction, as :func:`wgrad_splits` cuts them; the partials go to a
    workspace of their own. A pure function."""
    return _splits(H, rows, H, 8, sms)


def _splits(M, rows, H, room, sms):
    """The ranges for 2 outputs (M, 4H) summed over ``rows`` rows."""
    tiles = 2 * -(-M // 128) * -(-(4 * H) // 128)
    best = 1
    for splits in range(2, min(8, room, rows // (32 * 64)) + 1):
        if (-(-tiles * splits // sms) * best
                < -(-tiles * best // sms) * splits):
            best = splits
    return best


def _fragment_offsets():
    """(row, column) inside a 16 x 16 tile of each of the 8 bf16 values that
    lane l = 4 q + t holds in mma.m16n8k16's A registers: rows q, q + 8,
    columns 2t, 2t + 1, 2t + 8, 2t + 9 (``csrc/blstm_cluster.cuh``)."""
    lane = torch.arange(32)[:, None]
    e = torch.arange(8)[None, :]
    row = lane // 4 + 8 * ((e // 2) % 2)
    col = 2 * (lane % 4) + e % 2 + 8 * (e // 4)
    return row, col


def _fragments(a):
    """a (..., M, K), M and K multiples of 16 -> (..., M/16, K/16, 32, 8):
    each 16 x 16 tile as the 8 values each lane loads in one 16 bytes."""
    *lead, M, K = a.shape
    tiles = a.reshape(*lead, M // 16, 16, K // 16, 16).transpose(-3, -2)
    row, col = _fragment_offsets()
    return tiles[..., row, col]


@functools.lru_cache(maxsize=32)
def _gate_rows(H, cluster, U, device):
    """(cluster, 4U) int64: the global gate row g H + u of each CTA's local
    gate row m = 16 mt + 4 g + r (unit u = CTA U + 4 mt + r), or 4H where
    the unit is padding."""
    m = torch.arange(4 * U)
    gate, unit = (m % 16) // 4, 4 * (m // 16) + m % 4
    unit = torch.arange(cluster)[:, None] * U + unit
    return torch.where(unit < H, gate * H + unit,
                       torch.full_like(unit, 4 * H)).to(device)


@functools.lru_cache(maxsize=32)
def _pack_index(kind, k, H, cluster, U, device):
    """Where each value of a packed weight comes from: for w_t (2, k, 4H)
    flattened per direction with one zero appended (at k 4H, read for
    padded units and for rows beyond k), and the two directions then laid
    end to end, the flat index (int32) of each value of :func:`_pack_fwd`'s
    (kind 'fwd') or :func:`_pack_walk`'s ('walk') fragments, (2, C, U/4,
    K/16, 32, 8) or (2, C, K/16, U/4, 32, 8)."""
    n, K = k * 4 * H, _ceil_to(k, 16)
    src = torch.nn.functional.pad(torch.arange(n).reshape(k, 4 * H),
                                  (0, 1, 0, K - k), value=n)
    rows = _gate_rows(H, cluster, U, torch.device('cpu'))
    tiles = src[:, rows].permute(1, 2, 0)                 # (C, 4U, K)
    if kind == 'walk':
        tiles = tiles.transpose(-1, -2)
    idx = _fragments(tiles)
    idx = torch.stack([idx, idx + n + 1])
    return idx.to(device=device, dtype=torch.int32)


def _pack(w_t, kind, geo, H):
    """w_t (2, k, 4H) in fragment order by :func:`_pack_index`, contiguous:
    one pad and one gather."""
    idx = _pack_index(kind, w_t.shape[1], H, geo.cluster, geo.units,
                      w_t.device)
    return torch.nn.functional.pad(w_t.reshape(2, -1), (0, 1)).view(-1)[idx]


def _pack_fwd(w_ih_t, w_hh_t, bias, geo, H):
    """The forward's operands: W_ih^T and W_hh^T CTA slices as fragments
    (2, C, U/4, K/16, 32, 8) and the bias (2, C, 4U), in local gate-row
    order."""
    rows = _gate_rows(H, geo.cluster, geo.units, w_hh_t.device)
    bpad = torch.nn.functional.pad(bias, (0, 1))
    return (_pack(w_ih_t, 'fwd', geo, H), _pack(w_hh_t, 'fwd', geo, H),
            bpad[:, rows])


@functools.lru_cache(maxsize=32)
def _xg_columns(H, cluster, U, device):
    """(2, C, 4U) int32: the column of xg (B, T, 8H) that each CTA's local
    gate row takes its gate input from in direction d, d 4H plus the global
    gate row of :func:`_gate_rows`, or -1 where the unit is padding. The
    gate-input forward's producers copy by it
    (``csrc/blstm_cluster_fwd.cuh``)."""
    rows = _gate_rows(H, cluster, U, torch.device('cpu'))
    cols = torch.stack([rows + 4 * H * d for d in range(2)])
    return torch.where(rows < 4 * H, cols, -1).to(device=device,
                                                   dtype=torch.int32)


def _pack_walk(w_hh_t, geo, H):
    """The walk's operand: per CTA, W_hh^T (KH, 4U) restricted to its gate
    rows, as fragments (2, C, KH/16, U/4, 32, 8)."""
    return _pack(w_hh_t, 'walk', geo, H)


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


#: The capacity query of the kernel that each (geometry kind, route)
#: launches: the forward's projection, conditioned or gate-input form, the
#: walk with dh in bf16 (fully fused, conditioned) or f32 (bidi), and the
#: walk's spill form.
_SLOT_QUERIES = {('fwd', 'fullfused'): 'tssep_cluster_fwd_slots',
                 ('fwd_cond', 'cond'): 'tssep_cond_fwd_slots',
                 ('fwd_xg', 'bidi'): 'tssep_bidi_fwd_slots',
                 ('bwd', 'fullfused'): 'tssep_cluster_walk_slots',
                 ('bwd', 'bidi'): 'tssep_bidi_walk_slots',
                 ('bwd_spill', 'spill'): 'tssep_spill_walk_slots'}


@functools.lru_cache(maxsize=256)
def _cluster_slots(kind, device, cluster, row_tile, chunk, threads, shared,
                   route='fullfused'):
    """Clusters of ``cluster`` CTAs of the kernel that a plan of ``kind``
    launches on ``route`` that ``device`` holds at once, from
    cudaOccupancyMaxActiveClusters on that kernel; None where the query
    fails."""
    n = ctypes.c_int(0)
    query = getattr(_build.library(), _SLOT_QUERIES[kind, route])
    with torch.cuda.device(device):
        if kind.startswith('bwd'):
            err = query(cluster, row_tile, threads, shared, ctypes.byref(n))
        else:
            err = query(cluster, row_tile, chunk, threads, shared,
                        ctypes.byref(n))
    return n.value if err == 0 and n.value > 0 else None


@functools.lru_cache(maxsize=64)
def _geometry(kind, rows, F, H, device, route='fullfused'):
    """:func:`cluster_geometry` for a launch on ``device`` of the kernel
    that ``kind`` and ``route`` ('fullfused', 'cond', 'bidi' or 'spill')
    name."""
    return cluster_geometry(
        kind, rows, F, H, _sms(device),
        slots=functools.partial(_cluster_slots, kind, device, route=route))


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


def _check_launch(x, H, tensors):
    """Raises where no kernel runs on ``x`` with hidden size H."""
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


def _launch_tile(x, H, shared_floats_per_row, tensors, rows=None):
    """Rows per block of the first design's kernels for a launch on ``x``
    with ``rows`` rows (default ``x.shape[0]``); raises where no kernel
    runs."""
    _check_launch(x, H, tensors)
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

    On a CUDA device, bfloat16 storage runs the clustered Hopper kernel
    (``csrc/blstm_cluster_fwd.cuh``, geometry from :func:`cluster_geometry`);
    float32 storage, the tests' and checks' mode, runs the first design
    (``csrc/blstm_common.cuh``).
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
    if x.dtype == torch.bfloat16:
        out = _fullfused_fwd_cluster(x, w_ih_t, w_hh_t, bias, with_cell)
        blstm_fullfused_fwd.launches += 1
        return out
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


def _fullfused_fwd_cluster(x, w_ih_t, w_hh_t, bias, with_cell):
    """The bf16 route of :func:`blstm_fullfused_fwd` on a CUDA device."""
    B, T, F = x.shape
    H = w_hh_t.shape[1]
    _check_launch(x, H, (w_ih_t, w_hh_t, bias))
    geo = _geometry('fwd', B, F, H, x.device)
    wih_p, whh_p, bias_p = _pack_fwd(w_ih_t, w_hh_t, bias, geo, H)
    h, c = _outputs(x, H, with_cell)
    with torch.cuda.device(x.device):
        err = _build.library().tssep_blstm_fullfused_fwd_cluster(
            x.data_ptr(), x.stride(0), x.stride(1), F, wih_p.data_ptr(),
            whh_p.data_ptr(), bias_p.data_ptr(), h.data_ptr(),
            c.data_ptr() if with_cell else None, h.stride(0), h.stride(1),
            B, T, H, geo.cluster, geo.units, geo.active, geo.row_tile,
            geo.chunk, geo.k_block,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, 'blstm_fullfused_fwd')
    return h, c


blstm_fullfused_fwd.launches = 0


def blstm_bidi_fwd(xg, w_hh_t, *, with_cell=False):
    """The recurrences of one bidirectional LSTM layer from gate inputs.

    xg: (B, T, 8H), the forward direction's ``x @ W_ih^T + b`` in
    ``[..., :4H]`` and the reverse one's in ``[..., 4H:]``, both in original
    time order, any batch and time strides; w_hh_t: (2, H, 4H), same dtype.
    Returns ``(h, c)`` as :func:`blstm_fullfused_fwd` does.

    On a CUDA device, bfloat16 storage runs the gate-input form of the
    clustered Hopper kernel (``csrc/blstm_cluster_fwd.cuh``, geometry from
    :func:`cluster_geometry` kind 'fwd_xg'); float32 storage, the tests' and
    checks' mode, runs the first design (``csrc/blstm_common.cuh``).
    """
    _check_stream_input('xg', xg)
    B, T, G2 = xg.shape
    H = w_hh_t.shape[1]
    if G2 != 8 * H:
        raise ValueError(f'xg: expected width 8H = {8 * H}, got {G2}')
    _check('w_hh_t', w_hh_t, (2, H, 4 * H), xg.dtype, xg.device)
    if xg.device.type == 'cpu':
        return blstm_bidi_fwd_plain(xg, w_hh_t, with_cell=with_cell)
    if xg.dtype == torch.bfloat16:
        out = _bidi_fwd_cluster(xg, w_hh_t, with_cell)
        blstm_bidi_fwd.launches += 1
        return out
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


def _bidi_fwd_cluster(xg, w_hh_t, with_cell):
    """The bf16 route of :func:`blstm_bidi_fwd` on a CUDA device."""
    B, T, _ = xg.shape
    H = w_hh_t.shape[1]
    _check_launch(xg, H, (w_hh_t,))
    geo = _geometry('fwd_xg', B, 8 * H, H, xg.device, 'bidi')
    whh_p = _pack(w_hh_t, 'fwd', geo, H)
    cols = _xg_columns(H, geo.cluster, geo.units, xg.device)
    h, c = _outputs(xg, H, with_cell)
    with torch.cuda.device(xg.device):
        err = _build.library().tssep_blstm_bidi_fwd_cluster(
            xg.data_ptr(), xg.stride(0), xg.stride(1), whh_p.data_ptr(),
            cols.data_ptr(), h.data_ptr(), c.data_ptr() if with_cell else None,
            h.stride(0), h.stride(1), B, T, H, geo.cluster, geo.units,
            geo.active, geo.row_tile, geo.chunk,
            torch.cuda.current_stream(xg.device).cuda_stream)
    _raise_on(err, 'blstm_bidi_fwd')
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

    On a CUDA device, bfloat16 storage runs the conditioned form of the
    clustered Hopper kernel (``csrc/blstm_cluster_fwd.cuh``, geometry from
    :func:`cluster_geometry` kind 'fwd_cond' at B S rows); float32 storage,
    the tests' and checks' mode, runs the first design
    (``csrc/blstm_common.cuh``).
    """
    B, S, T, F, H = _check_cond_inputs(xs, aux, w_ih_t, w_hh_t, bias)
    if xs.device.type == 'cpu':
        return blstm_fullfused_cond_fwd_plain(xs, aux, w_ih_t, w_hh_t, bias,
                                              with_cell=with_cell)
    route = (_fullfused_cond_fwd_cluster if xs.dtype == torch.bfloat16
             else _fullfused_cond_fwd_first)
    out = route(xs, aux, w_ih_t, w_hh_t, bias, with_cell)
    blstm_fullfused_cond_fwd.launches += 1
    return out


def _fullfused_cond_fwd_first(xs, aux, w_ih_t, w_hh_t, bias, with_cell):
    """The first design of :func:`blstm_fullfused_cond_fwd` on a CUDA device
    (``csrc/blstm_common.cuh``), in either storage dtype: the route of
    float32."""
    B, T, F = xs.shape
    S, H = aux.shape[1], w_hh_t.shape[1]
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
    return tuple(None if t is None else t.view(B, S, T, 2 * H) for t in (h, c))


def _fullfused_cond_fwd_cluster(xs, aux, w_ih_t, w_hh_t, bias, with_cell,
                                geo=None):
    """The bf16 route of :func:`blstm_fullfused_cond_fwd` on a CUDA device;
    ``geo`` replaces the launch geometry of :func:`cluster_geometry`, so
    that another plan can be timed on the same work."""
    B, T, F = xs.shape
    S, H = aux.shape[1], w_hh_t.shape[1]
    _check_launch(xs, H, (aux, w_ih_t, w_hh_t, bias))
    if geo is None:
        geo = _geometry('fwd_cond', B * S, F, H, xs.device, 'cond')
    wih_p, whh_p, bias_p = _pack_fwd(w_ih_t, w_hh_t, bias, geo, H)
    h = torch.empty(B * S, T, 2 * H, dtype=xs.dtype, device=xs.device)
    c = torch.empty_like(h) if with_cell else None
    with torch.cuda.device(xs.device):
        err = _build.library().tssep_blstm_fullfused_cond_fwd_cluster(
            xs.data_ptr(), xs.stride(0), xs.stride(1), F, aux.data_ptr(), S,
            wih_p.data_ptr(), whh_p.data_ptr(), bias_p.data_ptr(),
            h.data_ptr(), c.data_ptr() if with_cell else None, h.stride(0),
            h.stride(1), B, T, H, geo.cluster, geo.units, geo.active,
            geo.row_tile, geo.chunk, geo.k_block,
            torch.cuda.current_stream(xs.device).cuda_stream)
    _raise_on(err, 'blstm_fullfused_cond_fwd')
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

    On a CUDA device, bfloat16 storage runs the Hopper design
    (``csrc/blstm_cluster_bwd.cuh``: the gate pre-activations as one
    tensor-core product, a clustered walk, tensor-core weight sums and dx);
    float32 storage, the tests' and checks' mode, runs the first design
    (``csrc/blstm_bwd_common.cuh``).
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
    if x.dtype == torch.bfloat16:
        out = _fullfused_bwd_cluster(x, w_ih_t, w_hh_t, bias, h, c, dh)
        blstm_fullfused_bwd.launches += 1
        return out
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


#: The launches of the bf16 backward, in order, by their ``parts`` bit.
FULLFUSED_BWD_PARTS = {'gates': 1, 'walk': 2, 'wgrad': 4, 'dx': 8}


def _fullfused_bwd_buffers(x, H):
    """The bf16 fully fused (or spill) backward's workspace and outputs for
    x (B, T, F): ``(dg, dw, dx)``, the f32 gate gradients (2, B, T, 4H),
    [dW_ih^T; dW_hh^T; db] (2, F + H + 1, 4H) and dx (B, T, F), which also
    holds the weight sums' split partials."""
    B, T, F = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty(2, B, T, 4 * H, **f32),
            torch.empty(2, F + H + 1, 4 * H, **f32),
            torch.empty(B, T, F, **f32))


def _fullfused_bwd_cluster(x, w_ih_t, w_hh_t, bias, h, c, dh, parts=15,
                           out=None):
    """The bf16 route of :func:`blstm_fullfused_bwd` on a CUDA device;
    ``parts`` picks its launches (:data:`FULLFUSED_BWD_PARTS`) and ``out``
    gives the buffers of :func:`_fullfused_bwd_buffers` to reuse, so that
    each launch can be timed alone."""
    B, T, F = x.shape
    H = w_hh_t.shape[1]
    _check_launch(x, H, (w_ih_t, w_hh_t, bias, h, c))
    geo = _geometry('bwd', B, F, H, x.device)
    wp = _pack_walk(w_hh_t, geo, H)
    dg, dw, dx = _fullfused_bwd_buffers(x, H) if out is None else out
    with torch.cuda.device(x.device):
        err = _build.library().tssep_blstm_fullfused_bwd_cluster(
            x.data_ptr(), x.stride(0), x.stride(1), F, w_ih_t.data_ptr(),
            w_hh_t.data_ptr(), bias.data_ptr(), wp.data_ptr(), h.data_ptr(),
            c.data_ptr(), h.stride(0), h.stride(1), dh.data_ptr(),
            dh.stride(0), dh.stride(1), dg.data_ptr(), dw.data_ptr(),
            dx.data_ptr(), B, T, H, geo.cluster, geo.units, geo.active,
            geo.row_tile, geo.threads,
            wgrad_splits(B * T, F, H, _sms(x.device)),
            parts, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, 'blstm_fullfused_bwd')
    return dx, dw[:, :F], dw[:, F:F + H], dw[:, F + H]


blstm_fullfused_bwd.launches = 0


def blstm_bidi_bwd(xg, w_hh_t, h, c, dh):
    """The backward of :func:`blstm_bidi_fwd`.

    xg, w_hh_t as for the forward; h, c: (B, T, 2H), the forward's
    outputs; dh: (B, T, 2H) float32, the cotangent of h, any batch and time
    strides. Returns ``(dxg, dw_hh_t)``: dxg (B, T, 8H) in the storage dtype
    and dw_hh_t (2, H, 4H) float32.

    On a CUDA device, bfloat16 storage runs the gate-input form of the
    Hopper design (``csrc/blstm_cluster_bwd.cuh``: the gate pre-activations
    as one tensor-core product, a clustered walk that writes dxg, tensor-core
    weight sums); float32 storage, the tests' and checks' mode, runs the
    first design (``csrc/blstm_bwd_common.cuh``).
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
    if xg.dtype == torch.bfloat16:
        out = _bidi_bwd_cluster(xg, w_hh_t, h, c, dh)
        blstm_bidi_bwd.launches += 1
        return out
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


#: The launches of the bf16 bidi backward, in order, by their ``parts`` bit.
BIDI_BWD_PARTS = {'gates': 1, 'walk': 2, 'wgrad': 4}


def _bidi_bwd_buffers(xg, H):
    """The bf16 bidi backward's workspace and outputs for gate inputs xg:
    ``(dg, dxg, dw, ws)``, the f32 gate gradients (2, B, T, 4H), dxg
    (B, T, 8H), dW_hh^T (2, H, 4H) and the weight sums' split partials."""
    B, T, _ = xg.shape
    splits = gate_wgrad_splits(B * T, H, _sms(xg.device))
    f32 = dict(dtype=torch.float32, device=xg.device)
    return (torch.empty(2, B, T, 4 * H, **f32),
            torch.empty(B, T, 8 * H, dtype=xg.dtype, device=xg.device),
            torch.empty(2, H, 4 * H, **f32),
            torch.empty(splits - 1, 2, H, 4 * H, **f32))


def _bidi_bwd_cluster(xg, w_hh_t, h, c, dh, parts=7, out=None):
    """The bf16 route of :func:`blstm_bidi_bwd` on a CUDA device; ``parts``
    picks its launches (:data:`BIDI_BWD_PARTS`) and ``out`` gives the
    buffers of :func:`_bidi_bwd_buffers` to reuse, so that each launch can
    be timed alone."""
    B, T, _ = xg.shape
    H = w_hh_t.shape[1]
    _check_launch(xg, H, (w_hh_t, h, c))
    geo = _geometry('bwd', B, 8 * H, H, xg.device, 'bidi')
    wp = _pack_walk(w_hh_t, geo, H)
    dg, dxg, dw, ws = _bidi_bwd_buffers(xg, H) if out is None else out
    splits = ws.shape[0] + 1
    with torch.cuda.device(xg.device):
        err = _build.library().tssep_blstm_bidi_bwd_cluster(
            xg.data_ptr(), xg.stride(0), xg.stride(1), w_hh_t.data_ptr(),
            wp.data_ptr(), h.data_ptr(), c.data_ptr(), h.stride(0),
            h.stride(1), dh.data_ptr(), dh.stride(0), dh.stride(1),
            dg.data_ptr(), dxg.data_ptr(), dw.data_ptr(),
            ws.data_ptr() if splits > 1 else None, B, T, H, geo.cluster,
            geo.units, geo.active, geo.row_tile, geo.threads, splits, parts,
            torch.cuda.current_stream(xg.device).cuda_stream)
    _raise_on(err, 'blstm_bidi_bwd')
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

    On a CUDA device, bfloat16 storage runs the conditioned form of the
    Hopper design (``csrc/blstm_cluster_bwd.cuh``: the gate pre-activations
    over the conditioned rows as one tensor-core product, the clustered walk
    of the fully fused backward at B S rows, tensor-core weight sums, dcond
    as one tensor-core product over both directions, then its split into dx
    and daux); float32 storage, the tests' and checks' mode, runs the first
    design (``csrc/blstm_bwd_common.cuh``).
    """
    B, S, T, F, H = _check_cond_inputs(xs, aux, w_ih_t, w_hh_t, bias)
    for name, t in (('h', h), ('c', c), ('dh', dh)):
        _check(name, t, (B, S, T, 2 * H), xs.dtype, xs.device)
    if xs.device.type == 'cpu':
        return blstm_fullfused_cond_bwd_plain(xs, aux, w_ih_t, w_hh_t, bias,
                                              h, c, dh)
    route = (_fullfused_cond_bwd_cluster if xs.dtype == torch.bfloat16
             else _fullfused_cond_bwd_first)
    out = route(xs, aux, w_ih_t, w_hh_t, bias, h, c, dh)
    blstm_fullfused_cond_bwd.launches += 1
    return out


def _fullfused_cond_bwd_first(xs, aux, w_ih_t, w_hh_t, bias, h, c, dh):
    """The first design of :func:`blstm_fullfused_cond_bwd` on a CUDA device
    (``csrc/blstm_bwd_common.cuh``), in either storage dtype: the route of
    float32."""
    B, T, F = xs.shape
    S, H = aux.shape[1], w_hh_t.shape[1]
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
    return dx, daux, dw[:, :F], dw[:, F:F + H], dw[:, F + H]


#: The launches of the bf16 conditioned backward, in order, by their
#: ``parts`` bit.
COND_BWD_PARTS = {'gates': 1, 'walk': 2, 'wgrad': 4, 'dcond': 8, 'split': 16}


def _cond_bwd_buffers(xs, S, H):
    """The bf16 conditioned backward's workspaces and outputs for xs
    (B, T, F) and S speakers: ``(dg, dcond, dw, dx, daux)``, the f32 gate
    gradients (2, B S, T, 4H), dcond (B S, T, F), which also holds the
    weight sums' split partials, [dW_ih^T; dW_hh^T; db] (2, F + H + 1, 4H),
    dx (B, T, F) and daux (B, S, F)."""
    B, T, F = xs.shape
    f32 = dict(dtype=torch.float32, device=xs.device)
    return (torch.empty(2, B * S, T, 4 * H, **f32),
            torch.empty(B * S, T, F, **f32),
            torch.empty(2, F + H + 1, 4 * H, **f32),
            torch.empty(B, T, F, **f32),
            torch.empty(B, S, F, **f32))


def _fullfused_cond_bwd_cluster(xs, aux, w_ih_t, w_hh_t, bias, h, c, dh,
                                parts=31, out=None):
    """The bf16 route of :func:`blstm_fullfused_cond_bwd` on a CUDA device;
    ``parts`` picks its launches (:data:`COND_BWD_PARTS`) and ``out`` gives
    the buffers of :func:`_cond_bwd_buffers` to reuse, so that each launch
    can be timed alone."""
    B, T, F = xs.shape
    S, H = aux.shape[1], w_hh_t.shape[1]
    _check_launch(xs, H, (aux, w_ih_t, w_hh_t, bias, h, c))
    # the speakers folded into the rows (views of the contiguous h and c)
    h, c, dh = (t.reshape(B * S, T, 2 * H) for t in (h, c, dh))
    if dh.stride(-1) != 1:
        raise ValueError('the last axis of dh must be contiguous')
    geo = _geometry('bwd', B * S, F, H, xs.device)
    wp = _pack_walk(w_hh_t, geo, H)
    if out is None:
        out = _cond_bwd_buffers(xs, S, H)
    dg, dcond, dw, dx, daux = out
    with torch.cuda.device(xs.device):
        err = _build.library().tssep_blstm_fullfused_cond_bwd_cluster(
            xs.data_ptr(), xs.stride(0), xs.stride(1), F, aux.data_ptr(), S,
            w_ih_t.data_ptr(), w_hh_t.data_ptr(), bias.data_ptr(),
            wp.data_ptr(), h.data_ptr(), c.data_ptr(), h.stride(0),
            h.stride(1), dh.data_ptr(), dh.stride(0), dh.stride(1),
            dg.data_ptr(), dcond.data_ptr(), dw.data_ptr(), dx.data_ptr(),
            daux.data_ptr(), B, T, H, geo.cluster, geo.units, geo.active,
            geo.row_tile, geo.threads,
            wgrad_splits(B * S * T, F, H, _sms(xs.device)), parts,
            torch.cuda.current_stream(xs.device).cuda_stream)
    _raise_on(err, 'blstm_fullfused_cond_bwd')
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

    On a CUDA device, bfloat16 storage runs the clustered Hopper kernel of
    :func:`blstm_fullfused_fwd` (``csrc/blstm_cluster_fwd.cuh``), whose
    consumers write the boundaries where they update c: its h has the bits
    of :func:`blstm_fullfused_fwd`'s. float32 storage, the tests' and
    checks' mode, runs the first design (``csrc/blstm_common.cuh``).
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
    route = (_fullfused_spill_fwd_cluster if x.dtype == torch.bfloat16
             else _fullfused_spill_fwd_first)
    out = route(x, w_ih_t, w_hh_t, bias, with_boundaries)
    blstm_fullfused_spill_fwd.launches += 1
    return out


def _spill_outputs(x, H, with_boundaries):
    B, T = x.shape[:2]
    h, _ = _outputs(x, H, False)
    cb = (torch.empty(_boundary_shape(B, T, H), dtype=x.dtype,
                      device=x.device) if with_boundaries else None)
    return h, cb


def _fullfused_spill_fwd_first(x, w_ih_t, w_hh_t, bias, with_boundaries):
    """The first design of :func:`blstm_fullfused_spill_fwd` on a CUDA
    device (``csrc/blstm_common.cuh``), in either storage dtype: the route
    of float32."""
    B, T, F = x.shape
    H = w_hh_t.shape[1]
    bt = _launch_tile(x, H, 2 * H + F, (w_ih_t, w_hh_t, bias))
    h, cb = _spill_outputs(x, H, with_boundaries)
    with torch.cuda.device(x.device):
        err = _build.library().tssep_blstm_fullfused_spill_fwd(
            x.data_ptr(), x.stride(0), x.stride(1), F, w_ih_t.data_ptr(),
            bias.data_ptr(), w_hh_t.data_ptr(), h.data_ptr(),
            cb.data_ptr() if with_boundaries else None, h.stride(0),
            h.stride(1), B, T, H, SPILL_BLOCK, int(x.dtype == torch.bfloat16),
            bt, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, 'blstm_fullfused_spill_fwd')
    return h, cb


def _fullfused_spill_fwd_cluster(x, w_ih_t, w_hh_t, bias, with_boundaries):
    """The bf16 route of :func:`blstm_fullfused_spill_fwd` on a CUDA
    device: the fully fused forward's geometry and packing (kind 'fwd')."""
    B, T, F = x.shape
    H = w_hh_t.shape[1]
    _check_launch(x, H, (w_ih_t, w_hh_t, bias))
    geo = _geometry('fwd', B, F, H, x.device)
    wih_p, whh_p, bias_p = _pack_fwd(w_ih_t, w_hh_t, bias, geo, H)
    h, cb = _spill_outputs(x, H, with_boundaries)
    with torch.cuda.device(x.device):
        err = _build.library().tssep_blstm_fullfused_spill_fwd_cluster(
            x.data_ptr(), x.stride(0), x.stride(1), F, wih_p.data_ptr(),
            whh_p.data_ptr(), bias_p.data_ptr(), h.data_ptr(),
            cb.data_ptr() if with_boundaries else None, h.stride(0),
            h.stride(1), B, T, H, SPILL_BLOCK, geo.cluster, geo.units,
            geo.active, geo.row_tile, geo.chunk, geo.k_block,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, 'blstm_fullfused_spill_fwd')
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

    On a CUDA device, bfloat16 storage runs the Hopper design of
    :func:`blstm_fullfused_bwd` (``csrc/blstm_cluster_bwd.cuh``) with the
    walk in its spill form, which rebuilds each spill block's c itself
    (geometry kind 'bwd_spill'); float32 storage, the tests' and checks'
    mode, runs the first design (``csrc/blstm_fullfused_spill_bwd.cu``).
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
    route = (_fullfused_spill_bwd_cluster if x.dtype == torch.bfloat16
             else _fullfused_spill_bwd_first)
    out = route(x, w_ih_t, w_hh_t, bias, h, cb, dh)
    blstm_fullfused_spill_bwd.launches += 1
    return out


def _fullfused_spill_bwd_first(x, w_ih_t, w_hh_t, bias, h, cb, dh):
    """The first design of :func:`blstm_fullfused_spill_bwd` on a CUDA
    device (``csrc/blstm_fullfused_spill_bwd.cu``), in either storage
    dtype: the route of float32."""
    B, T, F = x.shape
    H = w_hh_t.shape[1]
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
    return dx, dw[:, :F], dw[:, F:F + H], dw[:, F + H]


#: The launches of the bf16 spill backward, in order, by their ``parts``
#: bit: those of the fully fused backward, the walk in its spill form.
SPILL_BWD_PARTS = FULLFUSED_BWD_PARTS


def _fullfused_spill_bwd_cluster(x, w_ih_t, w_hh_t, bias, h, cb, dh,
                                 parts=15, out=None):
    """The bf16 route of :func:`blstm_fullfused_spill_bwd` on a CUDA device;
    ``parts`` picks its launches (:data:`SPILL_BWD_PARTS`) and ``out``
    gives the buffers of :func:`_fullfused_bwd_buffers` to reuse, so that
    each launch can be timed alone."""
    B, T, F = x.shape
    H = w_hh_t.shape[1]
    _check_launch(x, H, (w_ih_t, w_hh_t, bias, h, cb))
    geo = _geometry('bwd_spill', B, F, H, x.device, 'spill')
    wp = _pack_walk(w_hh_t, geo, H)
    dg, dw, dx = _fullfused_bwd_buffers(x, H) if out is None else out
    with torch.cuda.device(x.device):
        err = _build.library().tssep_blstm_fullfused_spill_bwd_cluster(
            x.data_ptr(), x.stride(0), x.stride(1), F, w_ih_t.data_ptr(),
            w_hh_t.data_ptr(), bias.data_ptr(), wp.data_ptr(), h.data_ptr(),
            h.stride(0), h.stride(1), cb.data_ptr(), dh.data_ptr(),
            dh.stride(0), dh.stride(1), dg.data_ptr(), dw.data_ptr(),
            dx.data_ptr(), B, T, H, SPILL_BLOCK, geo.cluster, geo.units,
            geo.active, geo.row_tile, geo.threads,
            wgrad_splits(B * T, F, H, _sms(x.device)), parts,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, 'blstm_fullfused_spill_bwd')
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
