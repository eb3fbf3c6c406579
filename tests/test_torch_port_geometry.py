"""The launch geometry and weight packing of the clustered kernels, the bf16
route of every pair, the one-direction pair's on a grid of one direction
(``kernels/blstm.py`` ``cluster_geometry``, ``_pack_fwd``, ``_pack_walk``,
``_xg_columns``): pure Python, no card, no JAX.

The CUDA kernels (``csrc/blstm_cluster_*.cuh``) trust what these give them:
that every hidden unit has exactly one owning CTA, that every row lies in a
tile, that each CTA's shared memory fits, that the packed fragments put
each weight where mma.sync's register layout expects it, and that the
gate-input forward copies each column of xg into the gate row that reads it.
"""

import dataclasses
import itertools

import pytest
import torch

from tssep_tpu_torch.kernels import blstm as kb

ROWS = (1, 13, 16, 128, 300, 2048)
WIDTHS = (12, 320, 513, 2048)


#: The card's cluster capacity as an H100 SXM reports it for CTAs that take
#: a whole SM each: 15 clusters of 8 at once, 7 of 16 (GPCs of unequal
#: size), whatever the plan.
def _h100_slots(cluster, row_tile, chunk, threads, shared):
    return {1: 132, 2: 66, 4: 32, 8: 15, 16: 7}[cluster]


def _check(geo, rows, F, H):
    C, U = geo.cluster, geo.units
    assert C <= 16 and C & (C - 1) == 0
    assert U % 4 == 0 and 1 <= geo.active <= C
    # every hidden unit owned exactly once, by the first `active` CTAs
    owner = torch.zeros(H, dtype=torch.int64)
    for r in range(C):
        lo, hi = r * U, min(H, (r + 1) * U)
        if r >= geo.active:
            assert lo >= H
        else:
            assert lo < hi
            owner[lo:hi] += 1
    assert bool((owner == 1).all())
    # every row in a tile, no tile empty
    assert geo.tiles * geo.row_tile >= rows > (geo.tiles - 1) * geo.row_tile
    assert geo.row_tile in (8, 16, 24, 32)
    assert geo.clusters == geo.directions * geo.tiles
    assert geo.clusters_per_wave * C <= kb.H100_SMS
    assert geo.waves * geo.clusters_per_wave >= geo.clusters
    assert geo.shared <= 232448 and geo.threads % 32 == 0
    KH, KF, MT = kb._ceil_to(H, 16), kb._ceil_to(F, 16), U // 4
    if geo.kind in ('fwd', 'fwd_cond'):
        assert geo.threads == 2 * MT * 32 <= 640
        assert geo.chunk in (1, 2, 4) and geo.chunk * geo.row_tile <= 32
        assert geo.k_block % 16 == 0 and min(KF, 256) <= geo.k_block <= KF
        KA = KF if geo.kind == 'fwd_cond' else 0
        assert geo.shared == kb._fwd_shared(MT, KH, geo.row_tile, geo.chunk,
                                            geo.k_block, KA)
    elif geo.kind == 'fwd_xg':
        assert geo.threads == 2 * MT * 32 <= 640
        assert geo.chunk in (1, 2, 4, 8) and geo.chunk * geo.row_tile <= 64
        assert geo.k_block == 0
        assert geo.shared == kb._fwd_xg_shared(MT, KH, geo.row_tile,
                                               geo.chunk)
    else:
        assert geo.threads <= 512
        assert U * geo.row_tile <= 4 * geo.threads
        cache = kb.SPILL_BLOCK + 1 if geo.kind == 'bwd_spill' else 0
        assert geo.shared == kb._walk_shared(MT, KH, U, geo.active,
                                             geo.row_tile, cache)


@pytest.mark.parametrize('directions', [2, 1])
@pytest.mark.parametrize('kind', ['fwd', 'bwd', 'fwd_xg', 'fwd_cond',
                                  'bwd_spill'])
@pytest.mark.parametrize('slots', [None, _h100_slots],
                         ids=['sms-over-cluster', 'h100-capacity'])
@pytest.mark.parametrize('H', [16, 37, 300, 512])
def test_geometry_invariants(kind, slots, H, directions):
    """Over rows and widths, with the card's cluster capacity known or
    not, for a launch of both directions or of one: units owned once, rows
    covered, a cluster per tile and direction, shared bytes and threads
    within Hopper's limits, clusters of a wave within 132 SMs."""
    for rows, F in itertools.product(ROWS, WIDTHS):
        geo = kb.cluster_geometry(kind, rows, F, H, slots=slots,
                                  directions=directions)
        assert geo.kind == kind and geo.directions == directions
        _check(geo, rows, F, H)


@pytest.mark.parametrize('kind,largest_of_8', [('fwd', 320), ('bwd', 416),
                                               ('fwd_xg', 320),
                                               ('fwd_cond', 320),
                                               ('bwd_spill', 416)])
def test_cluster_size_follows_hidden_size(kind, largest_of_8):
    """8 CTAs (portable) up to the largest H whose share fits one CTA: 10
    m-tiles of four units in the forward, the walk's shared memory in the
    backward; 16 (non-portable) above, as H 512 needs; fewer where H needs
    fewer; no geometry above the kernels' largest H."""
    def size(H):
        return kb.cluster_geometry(kind, 128, 513, H).cluster

    assert [size(H) for H in (4, 16, 37, 300, largest_of_8)] == [1, 4, 8, 8, 8]
    assert [size(H) for H in (largest_of_8 + 1, 512)] == [16, 16]
    with pytest.raises(ValueError):
        kb.cluster_geometry(kind, 128, 513, kb._MAX_HIDDEN + 1)


def test_geometry_at_flagship_shapes():
    """pre_net (16 rows, F 513), birnn0 and birnn1 (128 rows, F 513 and 320)
    of a served request or a training step at batch 16, and birnn0 at batch
    256 (2048 rows): clusters of 8 CTAs of 40 units, one wave where the rows
    allow."""
    def g(kind, rows, F):
        geo = kb.cluster_geometry(kind, rows, F, 300)
        return (geo.cluster, geo.units, geo.active, geo.row_tile, geo.tiles,
                geo.threads, geo.chunk, geo.k_block, geo.waves)

    # as the card reports it: 15 clusters of 8 at once (GPCs of unequal size)
    def on_h100(kind, rows, F):
        return kb.cluster_geometry(kind, rows, F, 300, slots=_h100_slots)

    assert on_h100('fwd', 128, 513).row_tile == 24
    assert on_h100('bwd', 128, 513).tiles == 6
    assert on_h100('fwd', 16, 513).row_tile == 8
    assert g('fwd', 16, 513) == (8, 40, 8, 8, 2, 640, 4, 528, 1)
    assert g('fwd', 128, 513) == (8, 40, 8, 16, 8, 640, 2, 528, 1)
    assert g('fwd', 128, 320) == (8, 40, 8, 16, 8, 640, 2, 320, 1)
    assert g('fwd', 2048, 513) == (8, 40, 8, 32, 64, 640, 1, 528, 8)
    assert g('bwd', 16, 513) == (8, 40, 8, 8, 2, 512, 1, 0, 1)
    assert g('bwd', 128, 513) == (8, 40, 8, 16, 8, 512, 1, 0, 1)
    assert g('bwd', 2048, 513) == (8, 40, 8, 32, 64, 512, 1, 0, 8)
    assert kb.cluster_geometry('fwd', 128, 513, 300).shared == 192528


def test_geometry_at_recipe_shapes():
    """The toy recipe's fully fused layers (``tssep_tpu/exp/
    init_cfg_common.yaml``, H 300 at flagship width): pre_net on its 553
    features at 16 rows stages x in one block of KF 560 and fits one wave of
    4 clusters; birnn0 at 2 permutation trials (256 rows) takes 32-row tiles,
    16 clusters of 8 where the card holds 15: two waves, forward and
    backward alike."""
    for kind in ('fwd', 'bwd'):
        geo = kb.cluster_geometry(kind, 16, 553, 300, slots=_h100_slots)
        _check(geo, 16, 553, 300)
        assert (geo.cluster, geo.row_tile, geo.clusters, geo.waves) == (
            8, 8, 4, 1)
        assert geo.k_block == (560 if kind == 'fwd' else 0)
        geo = kb.cluster_geometry(kind, 256, 513, 300, slots=_h100_slots)
        _check(geo, 256, 513, 300)
        assert (geo.cluster, geo.row_tile, geo.tiles, geo.clusters,
                geo.clusters_per_wave, geo.waves) == (8, 32, 8, 16, 15, 2)
        assert geo.shared <= 232448


def _unfragment(frags):
    """(..., M/16, K/16, 32, 8) -> (..., M, K), reading each lane's values
    by mma.m16n8k16's A layout as PTX states it: value i of lane 4 g + t is
    row g (i in 0, 1, 4, 5) or g + 8, column 2t + i % 2 (+ 8 for i >= 4)."""
    *lead, MT, KT = frags.shape[:-2]
    out = torch.zeros(*lead, MT * 16, KT * 16, dtype=frags.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(8):
            row = g if (i < 2 or 4 <= i < 6) else g + 8
            col = 2 * t + i % 2 + (8 if i >= 4 else 0)
            out[..., row::16, col::16] = frags[..., lane, i]
    return out


def test_fragments_follow_the_mma_layout():
    a = torch.randn(3, 32, 48)
    frags = kb._fragments(a)
    assert frags.shape == (3, 2, 3, 32, 8)
    torch.testing.assert_close(_unfragment(frags), a, atol=0, rtol=0)


@pytest.mark.parametrize('H,F', [(16, 12), (37, 20), (300, 513)])
def test_packed_weights_hold_each_gate_row_once(H, F):
    """_pack_fwd and _pack_walk: CTA r's local row 16 mt + 4 g + j is gate g
    of unit r U + 4 mt + j, zero where that unit is padding; every gate row
    of both directions appears exactly once."""
    gen = torch.Generator().manual_seed(0)
    w_ih_t = torch.randn(2, F, 4 * H, generator=gen)
    w_hh_t = torch.randn(2, H, 4 * H, generator=gen)
    bias = torch.randn(2, 4 * H, generator=gen)
    geo = kb.cluster_geometry('fwd', 16, F, H)
    wih_p, whh_p, bias_p = kb._pack_fwd(w_ih_t, w_hh_t, bias, geo, H)
    walk = kb._pack_walk(w_hh_t, kb.cluster_geometry('bwd', 16, F, H), H)
    # the kernels read them through raw pointers
    assert all(t.is_contiguous() for t in (wih_p, whh_p, bias_p, walk))
    wih, whh = _unfragment(wih_p), _unfragment(whh_p)  # (2, C, 4U, K)
    walk = _unfragment(walk)                          # (2, C, KH, 4U)
    C, U = geo.cluster, geo.units
    seen = torch.zeros(4 * H, dtype=torch.int64)
    for r in range(C):
        for m in range(4 * U):
            g, unit = (m % 16) // 4, r * U + 4 * (m // 16) + m % 4
            if unit < H:
                row = g * H + unit
                seen[row] += 1
                torch.testing.assert_close(wih[:, r, m, :F], w_ih_t[:, :, row])
                torch.testing.assert_close(whh[:, r, m, :H], w_hh_t[:, :, row])
                torch.testing.assert_close(walk[:, r, :H, m],
                                           w_hh_t[:, :, row])
                torch.testing.assert_close(bias_p[:, r, m], bias[:, row])
            else:
                assert not wih[:, r, m].any() and not whh[:, r, m].any()
                assert not walk[:, r, :, m].any() and not bias_p[:, r, m].any()
    assert bool((seen == 1).all())
    assert not wih[..., F:].any() and not whh[..., H:].any()
    assert not walk[:, :, H:].any()


def test_local_rows_give_each_lane_pair_the_four_gates():
    """In an m16n8 accumulator lane 4 q + t holds rows q and q + 8: with the
    local row order, lane q < 4 holds the i and g rows of unit q and lane
    q + 4 (lane ^ 16) the f and o rows of the same unit."""
    for q in range(4):
        rows = {q: None, q + 8: None, q + 4: None, q + 12: None}
        for m in rows:
            rows[m] = ((m % 16) // 4, m % 4)     # (gate, unit in the tile)
        assert rows[q] == (0, q) and rows[q + 8] == (2, q)
        assert rows[q + 4] == (1, q) and rows[q + 12] == (3, q)


def test_wgrad_splits_fit_the_dx_buffer():
    """The weight sums' row ranges: their partials fit in dx's memory, each
    range is at least 64 blocks of 32 rows, and at the flagship's shapes
    the 140 tiles of birnn0 (F 513) fill 8 ranges' waves where one range
    would leave most of a second wave idle."""
    for rows in (1, 13, 5056, 40448, 647168):
        for F, H in ((12, 16), (320, 300), (513, 300), (2048, 512)):
            splits = kb.wgrad_splits(rows, F, H)
            assert 1 <= splits <= 8
            assert (splits - 1) * 2 * (F + H + 1) * 4 * H <= rows * F
            assert splits == 1 or rows // splits >= 32 * 64
    assert [kb.wgrad_splits(16 * 316, 513, 300),
            kb.wgrad_splits(128 * 316, 513, 300),
            kb.wgrad_splits(128 * 316, 320, 300)] == [2, 8, 5]


def test_gate_input_geometry_at_birnn2():
    """The bidi pair's bf16 route at the flagship's birnn2 (H 300, xg 8H
    wide): 16 rows (a served request or a training step at batch 16) take
    8-row tiles, 4 clusters of 8 in one wave, 8 steps a chunk; 128 rows
    (``fullfuse=False``'s folded layers) 24-row tiles, 12 clusters in one
    wave; 256 rows (batch 256) 32-row tiles, 16 clusters, one more than the
    15 an H100 holds at once. The walk takes the fully fused walk's plan."""
    def g(kind, rows):
        geo = kb.cluster_geometry(kind, rows, 8 * 300, 300,
                                  slots=_h100_slots)
        return (geo.cluster, geo.units, geo.active, geo.row_tile, geo.tiles,
                geo.threads, geo.chunk, geo.clusters, geo.waves)

    assert g('fwd_xg', 16) == (8, 40, 8, 8, 2, 640, 8, 4, 1)
    assert g('fwd_xg', 128) == (8, 40, 8, 24, 6, 640, 2, 12, 1)
    assert g('fwd_xg', 256) == (8, 40, 8, 32, 8, 640, 2, 16, 2)
    assert g('bwd', 16) == (8, 40, 8, 8, 2, 512, 1, 4, 1)
    assert g('bwd', 128) == (8, 40, 8, 24, 6, 512, 1, 12, 1)
    assert g('bwd', 256) == (8, 40, 8, 32, 8, 512, 1, 16, 2)
    for rows in (16, 128, 256):
        walk = kb.cluster_geometry('bwd', rows, 8 * 300, 300)
        assert walk == kb.cluster_geometry('bwd', rows, 513, 300)


@pytest.mark.parametrize('H', [16, 37, 128, 300, 320, 416, 512])
def test_gate_input_forward_shared_memory_fits(H):
    """The gate-input forward's shared bytes (the W_hh^T slice, two h
    buffers of BT rows, a two-chunk ring of f32 gate inputs in the
    accumulator layout, two mbarriers) at every row tile and chunk it may
    pick, within Hopper's 232,448 bytes a block: what the header's
    ``fwd_shared_bytes`` gives without the x staging."""
    for rows in (1, 16, 128, 256, 2048):
        geo = kb.cluster_geometry('fwd_xg', rows, 8 * H, H)
        MT, KH, BT, TC = (geo.units // 4, kb._ceil_to(H, 16), geo.row_tile,
                          geo.chunk)
        parts = (MT * (KH // 16) * 32 * 16,           # W_hh^T fragments
                 2 * 2 * BT * (KH + 8),               # h, double-buffered
                 2 * TC * MT * (BT // 8) * 32 * 16,   # ring: float4 a lane
                 2 * 8)                               # two mbarriers
        assert geo.shared == sum(parts) <= 232448
        assert kb._fwd_shared(MT, KH, BT, TC, 512) == (
            geo.shared + 2 * TC * BT * (512 + 8))


@pytest.mark.parametrize('H,C', [(16, 4), (37, 8), (300, 8), (512, 16)])
def test_xg_columns_hold_each_gate_column_once(H, C):
    """The gate-input forward's column map: local gate row m of CTA r in
    direction d reads column d 4H + g H + u of xg, gate g of unit u in
    ``_gate_rows``' local order (m = 16 mt + 4 g + j, u = r U + 4 mt + j),
    -1 where u is padding; every one of the 8H columns is read exactly
    once."""
    geo = kb.cluster_geometry('fwd_xg', 16, 8 * H, H)
    assert geo.cluster == C
    U = geo.units
    cols = kb._xg_columns(H, C, U, torch.device('cpu'))
    assert cols.dtype == torch.int32 and cols.shape == (2, C, 4 * U)
    assert cols.is_contiguous()
    rows = kb._gate_rows(H, C, U, torch.device('cpu'))
    seen = torch.zeros(8 * H, dtype=torch.int64)
    for d in range(2):
        for r in range(C):
            for m in range(4 * U):
                g, unit = (m % 16) // 4, r * U + 4 * (m // 16) + m % 4
                col = int(cols[d, r, m])
                if unit < H:
                    assert col == d * 4 * H + g * H + unit
                    assert col == d * 4 * H + int(rows[r, m])
                    seen[col] += 1
                else:
                    assert col == -1
    assert bool((seen == 1).all())


def test_gate_wgrad_splits():
    """The bidi backward's weight sums dW_hh^T (60 tiles of 128 x 128 at H
    300, both directions) take 2 row ranges at the flagship's 16, 128 and
    256 rows of 316 steps, which fill one wave of 132 SMs; at most 8, each
    at least 64 blocks of 32 rows."""
    for rows in (1, 13, 5056, 40448, 80896, 647168):
        for H in (16, 300, 512):
            splits = kb.gate_wgrad_splits(rows, H)
            assert 1 <= splits <= 8
            assert splits == 1 or rows // splits >= 32 * 64
    assert [kb.gate_wgrad_splits(b * 316, 300) for b in (16, 128, 256)] == [
        2, 2, 2]
    assert kb.gate_wgrad_splits(1000, 300) == 1


@pytest.mark.parametrize('slots', [None, _h100_slots],
                         ids=['sms-over-cluster', 'h100-capacity'])
@pytest.mark.parametrize('F', [12, 513, 2048])
def test_conditioned_forward_fits_at_every_hidden_size(slots, F):
    """The conditioned forward's plan at B S rows (1, birnn0's 128 of a
    request of batch 16, 2048 of batch 256) fits Hopper's 232,448 bytes a
    block at every H that ``cluster_geometry`` accepts: the projection
    form's shared bytes and the tile's aux rows, KF bf16 values each
    (``csrc/blstm_cluster_fwd.cuh`` ``fwd_shared_bytes``)."""
    KF = kb._ceil_to(F, 16)
    for H in range(1, kb._MAX_HIDDEN + 1):
        for rows in (1, 128, 2048):
            geo = kb.cluster_geometry('fwd_cond', rows, F, H, slots=slots)
            _check(geo, rows, F, H)
            MT, KH = geo.units // 4, kb._ceil_to(H, 16)
            assert geo.shared == (kb._fwd_shared(
                MT, KH, geo.row_tile, geo.chunk, geo.k_block)
                + 2 * geo.row_tile * KF) <= 232448


@pytest.mark.parametrize('H', [16, 37, 128, 300, 320, 512])
def test_conditioned_plan_is_the_projection_plan_where_aux_fits(H):
    """Where the tile's aux rows fit beside the projection form's plan at
    every row tile, the conditioned forward takes that plan (cluster, units,
    row tile, chunk, x block, waves) and only its shared bytes grow, by
    2 BT KF; with no aux term the plan is the projection form's. At
    birnn0's 128 rows of a request of batch 16 (F 513, H 300) on an H100 it
    is the fully fused forward's: 24-row tiles, one step a chunk, all of F
    staged at once, 12 clusters in one wave; at 2048 rows it keeps all of F
    staged at once on 24-row tiles, where the fully fused forward takes
    32."""
    for rows, F in itertools.product(ROWS, WIDTHS):
        KF = kb._ceil_to(F, 16)
        proj = kb.cluster_geometry('fwd', rows, F, H, slots=_h100_slots)
        cond = kb.cluster_geometry('fwd_cond', rows, F, H, slots=_h100_slots)
        MT, KH = proj.units // 4, kb._ceil_to(H, 16)
        plans = [kb._fwd_plan(MT, KH, KF, BT) for BT in (8, 16, 24, 32)]
        for BT, plan in zip((8, 16, 24, 32), plans):
            assert kb._fwd_plan(MT, KH, KF, BT, 0) == plan
        fits = all(plan is None or plan[1] + 2 * BT * KF <= 232448
                   for BT, plan in zip((8, 16, 24, 32), plans))
        if fits:
            assert cond == dataclasses.replace(
                proj, kind='fwd_cond',
                shared=proj.shared + 2 * proj.row_tile * KF)
    geo = kb.cluster_geometry('fwd_cond', 128, 513, 300, slots=_h100_slots)
    assert (geo.cluster, geo.units, geo.row_tile, geo.chunk, geo.k_block,
            geo.clusters, geo.waves) == (8, 40, 24, 1, 528, 12, 1)
    assert geo.shared == kb.cluster_geometry(
        'fwd', 128, 513, 300, slots=_h100_slots).shared + 2 * 24 * 528
    # at 2048 rows (batch 256) a 32-row tile holds its aux rows only with F
    # staged in two blocks; no plan fits one wave, so the largest tile that
    # stages all of F at once is taken
    geo = kb.cluster_geometry('fwd_cond', 2048, 513, 300, slots=_h100_slots)
    assert (geo.row_tile, geo.chunk, geo.k_block, geo.clusters,
            geo.waves) == (24, 1, 528, 172, 12)
    assert kb._fwd_plan(10, 304, 528, 32, 528)[3] == 272


@pytest.mark.parametrize('B,S', [(1, 1), (5, 3), (16, 8), (3, 1)])
def test_conditioned_rows_map_to_xs_row_and_aux_row(B, S):
    """Layer row r of the conditioned pair is xs row r // S times aux row r
    of aux (B, S, F) seen as (B S, F), every row once: the order
    (row = b S + s) in which the kernels divide a row by S, and which the
    plain version (``_conditioned``) materializes."""
    T, F = 3, 5
    xs = torch.arange(B * T * F, dtype=torch.float64).reshape(B, T, F) + 1
    aux = torch.arange(B * S * F, dtype=torch.float64).reshape(B, S, F) + 7
    cond = kb._conditioned(xs, aux)
    assert cond.shape == (B * S, T, F)
    rows = aux.reshape(B * S, F)
    for r in range(B * S):
        torch.testing.assert_close(cond[r], xs[r // S] * rows[r][None],
                                   atol=0, rtol=0)
    assert sorted({r // S for r in range(B * S)}) == list(range(B))


def test_spill_walk_geometry_holds_the_rebuilt_cells():
    """The spill form of the walk (kind 'bwd_spill') holds, beside the
    walk's shared memory, SPILL_BLOCK + 1 f32 c values per (unit, row) of
    its tile: at the flagship's 16 and 128 rows it takes the fully fused
    walk's plan (8 and 24-row tiles, one wave on an H100), at 2048 rows
    24-row tiles where the fully fused walk takes 32 (whose 46 KB of
    cells do not fit)."""
    def g(kind, rows):
        return kb.cluster_geometry(kind, rows, 513, 300, slots=_h100_slots)

    for rows in (16, 128, 2048):
        walk, spill = g('bwd', rows), g('bwd_spill', rows)
        assert spill.kind == 'bwd_spill'
        assert (spill.cluster, spill.units, spill.threads) == (8, 40, 512)
        assert spill.shared == kb._walk_shared(
            10, 304, 40, 8, spill.row_tile, kb.SPILL_BLOCK + 1)
        assert spill.shared <= 232448
        if rows <= 128:
            assert spill.row_tile == walk.row_tile and spill.waves == 1
    assert g('bwd', 2048).row_tile == 32 and g('bwd_spill', 2048).row_tile == 24
    assert kb._walk_shared(10, 304, 40, 8, 32, kb.SPILL_BLOCK + 1) > 232448


@pytest.mark.parametrize('kind,route', sorted(kb._SLOT_QUERIES))
def test_each_slot_query_is_a_kernel_capacity_export(kind, route):
    """Each (kind, route) of the capacity queries names a geometry kind and
    a C export of the kernels' library that takes the plan's numbers (the
    walk's without a chunk) and a pointer to the count, defined in one of
    the CUDA sources."""
    from tssep_tpu_torch.kernels import _build
    name = kb._SLOT_QUERIES[kind, route]
    assert kind in kb.GEOMETRY_KINDS
    argtypes = _build._SIGNATURES[name]
    ints = 4 if kind.startswith('bwd') else 5
    assert argtypes == [_build._I] * ints + [_build._P]
    sources = ''.join(p.read_text() for p in _build.CSRC.glob('*.cu'))
    assert f'extern "C" int {name}(' in sources


@pytest.mark.parametrize('kind', ['fwd_xg', 'bwd'])
def test_one_direction_geometry_at_birnn2(kind):
    """The one-direction pair's bf16 route (``lstm_fwd``, ``lstm_bwd``) at
    the flagship's birnn2 (H 300) with ``bidi=False``: 16 rows (a request
    or a step at batch 16), 128 (the folded layers with
    ``fullfuse=False``) and 256 (batch 256) take one cluster per row tile
    and fit one wave of the 15 clusters an H100 holds; at 256 rows on
    24-row tiles (11 clusters), where the bidi plan needs 16 clusters of
    32-row tiles, two waves."""
    def g(rows, directions):
        return kb.cluster_geometry(kind, rows, 4 * 300, 300,
                                   slots=_h100_slots, directions=directions)

    for rows in (16, 128, 256):
        geo = g(rows, 1)
        assert geo.clusters == geo.tiles and geo.waves == 1
        assert (geo.cluster, geo.units, geo.active) == (8, 40, 8)
        _check(geo, rows, 4 * 300, 300)
    assert [g(rows, 1).row_tile for rows in (16, 128, 256)] == [8, 16, 24]
    assert g(256, 1).clusters == 11
    bidi = g(256, 2)
    assert (bidi.row_tile, bidi.clusters, bidi.waves) == (32, 16, 2)
    # the plan at a row tile does not depend on the direction count
    assert g(16, 1) == dataclasses.replace(g(16, 2), clusters=2,
                                           clusters_per_wave=2, directions=1)
    with pytest.raises(ValueError):
        kb.cluster_geometry(kind, 16, 1200, 300, directions=3)


@pytest.mark.parametrize('H,C', [(16, 4), (37, 8), (300, 8), (512, 16)])
def test_one_direction_xg_columns_hold_each_gate_column_once(H, C):
    """The one-direction forward's column map, (1, C, 4U): local gate row m
    of CTA r reads column g H + u of xg (B, T, 4H), -1 where u is padding,
    every one of the 4H columns exactly once; it is direction 0 of the
    bidi table."""
    geo = kb.cluster_geometry('fwd_xg', 16, 4 * H, H, directions=1)
    assert geo.cluster == C
    U = geo.units
    cols = kb._xg_columns(H, C, U, torch.device('cpu'), 1)
    assert cols.dtype == torch.int32 and cols.shape == (1, C, 4 * U)
    assert cols.is_contiguous()
    both = kb._xg_columns(H, C, U, torch.device('cpu'))
    torch.testing.assert_close(cols[0], both[0], atol=0, rtol=0)
    real = cols[cols >= 0]
    assert sorted(real.tolist()) == list(range(4 * H))
    rows = kb._gate_rows(H, C, U, torch.device('cpu'))
    assert bool(((cols[0] == -1) == (rows == 4 * H)).all())


@pytest.mark.parametrize('H,F', [(16, 12), (37, 20), (300, 513)])
def test_one_direction_packing_is_the_first_directions(H, F):
    """_pack and _pack_walk of one direction's w_hh_t[None], as
    ``lstm_fwd`` and ``lstm_bwd`` pack it: the fragments of a two-direction
    pack's direction 0, contiguous, for the forward and the walk."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(2, H, 4 * H, generator=gen)
    for kind, pack in (('fwd_xg', lambda t, geo: kb._pack(t, 'fwd', geo, H)),
                       ('bwd', lambda t, geo: kb._pack_walk(t, geo, H))):
        geo = kb.cluster_geometry(kind, 16, 4 * H, H, directions=1)
        one, both = pack(w[:1], geo), pack(w, geo)
        assert one.is_contiguous() and one.shape == (1, *both.shape[1:])
        torch.testing.assert_close(one[0], both[0], atol=0, rtol=0)


def test_one_output_wgrad_splits_fit_their_workspace(monkeypatch):
    """The one-direction backward's weight sums dW_hh^T (30 tiles of 128 x
    128 at H 300): at most 8 ranges of at least 64 blocks of 32 rows that
    cover the B T rows, their partials in the (splits - 1, H, 4H) workspace
    of ``_lstm_bwd_buffers`` (what ``csrc/lstm_bwd.cu`` requires); 2, 4 and
    4 ranges at the flagship's 16, 128 and 256 rows of 316 steps."""
    monkeypatch.setattr(kb, '_sms', lambda device: kb.H100_SMS)
    for rows in (1, 13, 5056, 40448, 80896, 647168):
        for H in (16, 300, 512):
            splits = kb.gate_wgrad_splits(rows, H, outputs=1)
            assert 1 <= splits <= 8
            assert splits == 1 or rows // splits >= 32 * 64
            kps = -(-(-(-rows // splits)) // 32) * 32
            assert (splits - 1) * kps < rows <= splits * kps
    for B, splits in ((16, 2), (128, 4), (256, 4)):
        assert kb.gate_wgrad_splits(B * 316, 300, outputs=1) == splits
        xg = torch.empty(B, 316, 4 * 300, dtype=torch.bfloat16)
        dg, dxg, dw, ws = kb._lstm_bwd_buffers(xg, 300)
        assert dg.shape == (1, B, 316, 1200) and dw.shape == (300, 1200)
        assert dxg.shape == xg.shape and dxg.dtype == torch.bfloat16
        assert ws.shape == (splits - 1, 300, 1200)
        assert ws.dtype == dg.dtype == dw.dtype == torch.float32
