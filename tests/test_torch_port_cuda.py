"""The port's ten CUDA kernels against their plain versions, on the card.

Every pair's bfloat16 route runs the clustered Hopper kernels
(``csrc/blstm_cluster_*.cuh``, the bidi pair in their gate-input form, the
one-direction pair in that form on a grid of one direction, the
conditioned pair in their conditioned form, the spill pair with the
forward writing the c boundaries and the walk rebuilding c); their tests
below stress the cluster split, the row tiles and waves, the x staging (and
the conditioned product formed there), the copy of xg, the reverse walk,
the boundaries and the walk, at the acceptance tolerances: forward 1.6e-2
abs (one bf16 ulp of c below 4, flipped by a sum order that differs from
the plain version's), backward 5e-3 of each output's peak (dx is rounded to
bf16 per direction, the conditioned dx and daux once; the gate gradients
enter the tensor-core products as a two-term bf16 split, relative error
~2^-16).

Needs an NVIDIA card with the CUDA toolkit; skips elsewhere. This file
imports no JAX, so it also runs where JAX is missing, without the suite's
conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances as in ``chip_smoke.py``: forward float32 1e-4 (the same sums in
another order), bfloat16 3e-2 (h is rounded to bf16 before each recurrent
product, so an f32 sum order that differs flips a rounding now and then, one
bf16 ulp each). Backward: each gradient's max abs error relative to its max,
float32 1e-4 (f32 sums in another order), bfloat16 1e-2 (the recomputed
gates read the same bf16 h and c, but dx and dxg are rounded to bf16 and a
sum order that differs flips one of those roundings now and then: one bf16
ulp, 2^-8 of the value).
"""

import pytest
import torch

from tssep_tpu_torch.kernels import blstm as kb

ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device='cuda').manual_seed(0)


def _uniform(gen, shape, bound, dtype):
    return ((2 * torch.rand(shape, generator=gen, device='cuda') - 1)
            * bound).to(dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,T,F,H', [(13, 23, 12, 16), (3, 1, 40, 300),
                                     (70, 9, 513, 300), (16, 31, 553, 300)])
def test_fullfused_kernel_matches_plain(gen, dtype, B, T, F, H):
    x = torch.randn(B, T, F, generator=gen, device='cuda').to(dtype)
    w_ih_t = _uniform(gen, (2, F, 4 * H), H ** -0.5, dtype)
    w_hh_t = _uniform(gen, (2, H, 4 * H), H ** -0.5, dtype)
    bias = _uniform(gen, (2, 4 * H), H ** -0.5, torch.float32)
    before = kb.blstm_fullfused_fwd.launches
    got = kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias, with_cell=True)
    assert kb.blstm_fullfused_fwd.launches == before + 1
    want = kb.blstm_fullfused_fwd_plain(x, w_ih_t, w_hh_t, bias,
                                        with_cell=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=ATOL[dtype],
                                   rtol=0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,T,H', [(13, 23, 16), (70, 9, 300)])
def test_bidi_kernel_matches_plain(gen, dtype, B, T, H):
    xg = torch.randn(B, T, 8 * H, generator=gen, device='cuda').to(dtype)
    w_hh_t = _uniform(gen, (2, H, 4 * H), H ** -0.5, dtype)
    before = kb.blstm_bidi_fwd.launches
    got = kb.blstm_bidi_fwd(xg, w_hh_t, with_cell=True)
    assert kb.blstm_bidi_fwd.launches == before + 1
    want = kb.blstm_bidi_fwd_plain(xg, w_hh_t, with_cell=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=ATOL[dtype],
                                   rtol=0)


def test_strided_input_reads_in_place(gen):
    """The kernel takes x with any batch and time strides (a slice here)."""
    base = torch.randn(6, 11, 2 * 24, generator=gen, device='cuda')
    x = base[:, :, :24]
    H = 16
    w_ih_t = _uniform(gen, (2, 24, 4 * H), H ** -0.5, torch.float32)
    w_hh_t = _uniform(gen, (2, H, 4 * H), H ** -0.5, torch.float32)
    bias = _uniform(gen, (2, 4 * H), H ** -0.5, torch.float32)
    got, _ = kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias)
    want, _ = kb.blstm_fullfused_fwd_plain(x.contiguous(), w_ih_t, w_hh_t,
                                           bias)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def _rel_err(got, want):
    return max(((g.float() - w.float()).abs().max()
                / w.float().abs().max().clamp(min=1e-30)).item()
               for g, w in zip(got, want))


def _fullfused_bwd_inputs(gen, dtype, B, T, F, H):
    x = torch.randn(B, T, F, generator=gen, device='cuda').to(dtype)
    w_ih_t = _uniform(gen, (2, F, 4 * H), H ** -0.5, dtype)
    w_hh_t = _uniform(gen, (2, H, 4 * H), H ** -0.5, dtype)
    bias = _uniform(gen, (2, 4 * H), H ** -0.5, torch.float32)
    h, c = kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias, with_cell=True)
    dh = torch.randn(B, T, 2 * H, generator=gen, device='cuda').to(dtype)
    return x, w_ih_t, w_hh_t, bias, h, c, dh


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,T,F,H', [(13, 23, 12, 16), (3, 1, 40, 300),
                                     (70, 9, 513, 300), (16, 31, 553, 300)])
def test_fullfused_bwd_kernel_matches_plain(gen, dtype, B, T, F, H):
    args = _fullfused_bwd_inputs(gen, dtype, B, T, F, H)
    before = kb.blstm_fullfused_bwd.launches
    got = kb.blstm_fullfused_bwd(*args)
    assert kb.blstm_fullfused_bwd.launches == before + 1
    want = kb.blstm_fullfused_bwd_plain(*args)
    assert _rel_err(got, want) <= BWD_RTOL[dtype]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,T,H', [(13, 23, 16), (70, 9, 300)])
def test_bidi_bwd_kernel_matches_plain(gen, dtype, B, T, H):
    xg = torch.randn(B, T, 8 * H, generator=gen, device='cuda').to(dtype)
    w_hh_t = _uniform(gen, (2, H, 4 * H), H ** -0.5, dtype)
    h, c = kb.blstm_bidi_fwd(xg, w_hh_t, with_cell=True)
    dh = torch.randn(B, T, 2 * H, generator=gen, device='cuda')
    before = kb.blstm_bidi_bwd.launches
    got = kb.blstm_bidi_bwd(xg, w_hh_t, h, c, dh)
    assert kb.blstm_bidi_bwd.launches == before + 1
    want = kb.blstm_bidi_bwd_plain(xg, w_hh_t, h, c, dh)
    assert _rel_err(got, want) <= BWD_RTOL[dtype]


def test_bwd_strided_inputs_read_in_place(gen):
    """The backward kernels take x (or xg) and dh with any batch and time
    strides (slices here)."""
    B, T, F, H = 6, 11, 24, 16
    x, w_ih_t, w_hh_t, bias, h, c, _ = _fullfused_bwd_inputs(
        gen, torch.float32, B, T, F, H)
    wide_x = torch.zeros(B, T, 2 * F, device='cuda')
    wide_x[..., :F] = x
    wide_dh = torch.randn(B, T + 3, 3 * H, generator=gen, device='cuda')
    dh = wide_dh[:, 1:T + 1, :2 * H]
    got = kb.blstm_fullfused_bwd(wide_x[..., :F], w_ih_t, w_hh_t, bias, h, c,
                                 dh)
    want = kb.blstm_fullfused_bwd_plain(x, w_ih_t, w_hh_t, bias, h, c,
                                        dh.contiguous())
    assert _rel_err(got, want) <= 1e-4

    wide_xg = torch.randn(B, T, 9 * H, generator=gen, device='cuda')
    xg = wide_xg[..., :8 * H]
    h, c = kb.blstm_bidi_fwd(xg, w_hh_t, with_cell=True)
    got = kb.blstm_bidi_bwd(xg, w_hh_t, h, c, dh)
    want = kb.blstm_bidi_bwd_plain(xg.contiguous(), w_hh_t, h, c,
                                   dh.contiguous())
    assert _rel_err(got, want) <= 1e-4


def _cond_inputs(gen, dtype, B, S, T, F, H):
    xs = torch.randn(B, T, F, generator=gen, device='cuda').to(dtype)
    aux = torch.rand(B, S, F, generator=gen, device='cuda').to(dtype)
    w_ih_t = _uniform(gen, (2, F, 4 * H), H ** -0.5, dtype)
    w_hh_t = _uniform(gen, (2, H, 4 * H), H ** -0.5, dtype)
    bias = _uniform(gen, (2, 4 * H), H ** -0.5, torch.float32)
    return xs, aux, w_ih_t, w_hh_t, bias


COND_CASES = [(3, 4, 23, 12, 16), (2, 8, 9, 513, 300)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,S,T,F,H', COND_CASES)
def test_fullfused_cond_kernel_matches_plain(gen, dtype, B, S, T, F, H):
    args = _cond_inputs(gen, dtype, B, S, T, F, H)
    before = kb.blstm_fullfused_cond_fwd.launches
    got = kb.blstm_fullfused_cond_fwd(*args, with_cell=True)
    assert kb.blstm_fullfused_cond_fwd.launches == before + 1
    want = kb.blstm_fullfused_cond_fwd_plain(*args, with_cell=True)
    for g, w in zip(got, want):
        assert g.shape == (B, S, T, 2 * H)
        torch.testing.assert_close(g.float(), w.float(), atol=ATOL[dtype],
                                   rtol=0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,S,T,F,H', COND_CASES)
def test_fullfused_cond_bwd_kernel_matches_plain(gen, dtype, B, S, T, F, H):
    args = _cond_inputs(gen, dtype, B, S, T, F, H)
    h, c = kb.blstm_fullfused_cond_fwd(*args, with_cell=True)
    dh = torch.randn(B, S, T, 2 * H, generator=gen, device='cuda').to(dtype)
    before = kb.blstm_fullfused_cond_bwd.launches
    got = kb.blstm_fullfused_cond_bwd(*args, h, c, dh)
    assert kb.blstm_fullfused_cond_bwd.launches == before + 1
    want = kb.blstm_fullfused_cond_bwd_plain(*args, h, c, dh)
    assert _rel_err(got, want) <= BWD_RTOL[dtype]


# ragged T with several spill blocks and a short last one; the served
# widths at a few rows
SPILL_CASES = [(13, 37, 12, 16), (3, 1, 40, 300), (70, 19, 513, 300)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,T,F,H', SPILL_CASES)
def test_spill_kernel_matches_plain(gen, dtype, B, T, F, H):
    """h and the c boundaries; without boundaries the same h."""
    x, w_ih_t, w_hh_t, bias, *_ = _fullfused_bwd_inputs(gen, dtype, B, T, F,
                                                        H)
    before = kb.blstm_fullfused_spill_fwd.launches
    got = kb.blstm_fullfused_spill_fwd(x, w_ih_t, w_hh_t, bias,
                                       with_boundaries=True)
    assert kb.blstm_fullfused_spill_fwd.launches == before + 1
    want = kb.blstm_fullfused_spill_fwd_plain(x, w_ih_t, w_hh_t, bias,
                                              with_boundaries=True)
    assert got[1].shape == (2, -(-T // kb.SPILL_BLOCK), B, H)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=ATOL[dtype],
                                   rtol=0)
    served, cb = kb.blstm_fullfused_spill_fwd(x, w_ih_t, w_hh_t, bias)
    assert cb is None
    torch.testing.assert_close(served, got[0], atol=0, rtol=0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,T,F,H', SPILL_CASES)
def test_spill_bwd_kernel_matches_plain(gen, dtype, B, T, F, H):
    x, w_ih_t, w_hh_t, bias, *_, dh = _fullfused_bwd_inputs(gen, dtype, B, T,
                                                           F, H)
    h, cb = kb.blstm_fullfused_spill_fwd(x, w_ih_t, w_hh_t, bias,
                                         with_boundaries=True)
    args = (x, w_ih_t, w_hh_t, bias, h, cb, dh)
    before = kb.blstm_fullfused_spill_bwd.launches
    got = kb.blstm_fullfused_spill_bwd(*args)
    assert kb.blstm_fullfused_spill_bwd.launches == before + 1
    want = kb.blstm_fullfused_spill_bwd_plain(*args)
    assert _rel_err(got, want) <= BWD_RTOL[dtype]


LSTM_CASES = [(13, 23, 16), (70, 9, 300)]


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,T,H', LSTM_CASES)
def test_lstm_kernels_match_plain(gen, dtype, B, T, H, reverse):
    """Both kernels of one direction, forward and backward."""
    xg = torch.randn(B, T, 4 * H, generator=gen, device='cuda').to(dtype)
    w_hh_t = _uniform(gen, (H, 4 * H), H ** -0.5, dtype)
    before = kb.lstm_fwd.launches, kb.lstm_bwd.launches
    h, c = kb.lstm_fwd(xg, w_hh_t, reverse=reverse, with_cell=True)
    want = kb.lstm_fwd_plain(xg, w_hh_t, reverse=reverse, with_cell=True)
    for g, w in zip((h, c), want):
        torch.testing.assert_close(g.float(), w.float(), atol=ATOL[dtype],
                                   rtol=0)
    dh = torch.randn(B, T, H, generator=gen, device='cuda')
    got = kb.lstm_bwd(xg, w_hh_t, h, c, dh, reverse=reverse)
    assert (kb.lstm_fwd.launches, kb.lstm_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = kb.lstm_bwd_plain(xg, w_hh_t, h, c, dh, reverse=reverse)
    assert _rel_err(got, want) <= BWD_RTOL[dtype]


def test_lstm_strided_gate_inputs_read_in_place(gen):
    """One direction of the bidi layer's xg (a slice) and a strided dh."""
    B, T, H = 6, 11, 16
    xg2 = torch.randn(B, T, 8 * H, generator=gen, device='cuda')
    w_hh_t = _uniform(gen, (H, 4 * H), H ** -0.5, torch.float32)
    xg = xg2[..., 4 * H:]
    h, c = kb.lstm_fwd(xg, w_hh_t, reverse=True, with_cell=True)
    want = kb.lstm_fwd_plain(xg.contiguous(), w_hh_t, reverse=True,
                             with_cell=True)
    torch.testing.assert_close(h, want[0], atol=1e-4, rtol=0)
    wide_dh = torch.randn(B, T + 2, 2 * H, generator=gen, device='cuda')
    dh = wide_dh[:, 1:T + 1, :H]
    got = kb.lstm_bwd(xg, w_hh_t, h, c, dh, reverse=True)
    want = kb.lstm_bwd_plain(xg.contiguous(), w_hh_t, h, c, dh.contiguous(),
                             reverse=True)
    assert _rel_err(got, want) <= 1e-4


# The bf16 route of the fully fused pair (csrc/blstm_cluster_fwd.cuh,
# csrc/blstm_cluster_bwd.cuh), (B, T, F, H): H 16 on a cluster of 4, H 37
# with CTAs that own no unit, H 300 as served and H 512 on a 16-CTA cluster;
# F 12 to 2048 (x staged in blocks); 1 row, 13, 16 and 128 rows (the served
# tiles of pre_net and birnn0) and 300 rows (more than one wave at H 512);
# T 1, 2 and 316; the toy recipe's pre_net (F 553, MFCC40 + 513 bins, x
# staged in one block of 560) and its birnn0 and birnn1 at 2 permutation
# trials (256 rows: 16 clusters of 8, two waves of the card's 15).
CLUSTER_CASES = [(1, 1, 12, 16), (13, 2, 513, 37), (13, 316, 12, 300),
                 (16, 316, 513, 300), (128, 316, 513, 300),
                 (300, 9, 2048, 512), (300, 2, 320, 300),
                 (16, 316, 553, 300), (256, 316, 513, 300),
                 (256, 316, 320, 300)]
CLUSTER_FWD_ATOL = 1.6e-2
CLUSTER_BWD_RTOL = 5e-3


@pytest.mark.parametrize('B,T,F,H', CLUSTER_CASES)
def test_cluster_fwd_matches_plain(gen, B, T, F, H):
    x = torch.randn(B, T, F, generator=gen, device='cuda').to(torch.bfloat16)
    w_ih_t = _uniform(gen, (2, F, 4 * H), H ** -0.5, torch.bfloat16)
    w_hh_t = _uniform(gen, (2, H, 4 * H), H ** -0.5, torch.bfloat16)
    bias = _uniform(gen, (2, 4 * H), H ** -0.5, torch.float32)
    before = kb.blstm_fullfused_fwd.launches
    got = kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias, with_cell=True)
    assert kb.blstm_fullfused_fwd.launches == before + 1
    want = kb.blstm_fullfused_fwd_plain(x, w_ih_t, w_hh_t, bias,
                                        with_cell=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=CLUSTER_FWD_ATOL, rtol=0)
    h_only, c_none = kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias)
    assert c_none is None
    torch.testing.assert_close(h_only, got[0], atol=0, rtol=0)


@pytest.mark.parametrize('B,T,F,H', CLUSTER_CASES)
def test_cluster_bwd_matches_plain_and_repeats(gen, B, T, F, H):
    """Against the plain version, and two launches give the same bits."""
    args = _fullfused_bwd_inputs(gen, torch.bfloat16, B, T, F, H)
    before = kb.blstm_fullfused_bwd.launches
    got = kb.blstm_fullfused_bwd(*args)
    again = kb.blstm_fullfused_bwd(*args)
    assert kb.blstm_fullfused_bwd.launches == before + 2
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    want = kb.blstm_fullfused_bwd_plain(*args)
    assert _rel_err(got, want) <= CLUSTER_BWD_RTOL


def test_cluster_strided_inputs_read_in_place(gen):
    """The bf16 route takes x and dh with any batch and time strides."""
    B, T, F, H = 6, 11, 24, 16
    x, w_ih_t, w_hh_t, bias, h, c, _ = _fullfused_bwd_inputs(
        gen, torch.bfloat16, B, T, F, H)
    wide_x = torch.zeros(B, T + 1, 2 * F, device='cuda', dtype=torch.bfloat16)
    wide_x[:, 1:, :F] = x
    xv = wide_x[:, 1:, :F]
    got, _ = kb.blstm_fullfused_fwd(xv, w_ih_t, w_hh_t, bias)
    want, _ = kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    wide_dh = torch.randn(B, T + 3, 3 * H, generator=gen,
                          device='cuda').to(torch.bfloat16)
    dh = wide_dh[:, 1:T + 1, :2 * H]
    got = kb.blstm_fullfused_bwd(xv, w_ih_t, w_hh_t, bias, h, c, dh)
    want = kb.blstm_fullfused_bwd(x, w_ih_t, w_hh_t, bias, h, c,
                                  dh.contiguous())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize('kind', ['fwd', 'bwd'])
def test_cluster_capacity_is_that_of_the_kernel_that_runs(gen, kind):
    """The geometry asks cudaOccupancyMaxActiveClusters about the kernel
    instance, threads and shared bytes it picks: at the flagship's shapes
    each CTA takes a whole SM, every picked plan fits the card, and 128
    rows run in one wave."""
    device = torch.device('cuda', torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for rows, F in ((16, 513), (128, 513), (128, 320), (2048, 513)):
        geo = kb._geometry(kind, rows, F, 300, device)
        held = kb._cluster_slots(kind, device, geo.cluster, geo.row_tile,
                                 geo.chunk, geo.threads, geo.shared)
        assert held is not None and held * geo.cluster <= sms
        assert geo.clusters_per_wave == min(held, geo.clusters)
        if rows == 128:
            assert geo.waves == 1


# The bidi pair's bf16 route (the gate-input form of csrc/blstm_cluster_*.cuh),
# (B, T, H): H 16 on a cluster of 4, H 37 with CTAs that own no unit and
# gate columns only 2-byte aligned, H 300 as served and trained (16 rows)
# and as fullfuse=False runs it (128 rows), 256 rows at H 300 and 300 rows at
# H 416 and 512 (more than one wave; 16-CTA clusters); T 1, 2, 9 and 316.
GATE_CASES = [(1, 1, 16), (13, 2, 37), (13, 316, 300), (16, 316, 300),
              (128, 316, 300), (256, 9, 300), (300, 2, 416), (300, 9, 512)]


def _bidi_inputs(gen, B, T, H):
    xg = torch.randn(B, T, 8 * H, generator=gen, device='cuda').to(
        torch.bfloat16)
    w_hh_t = _uniform(gen, (2, H, 4 * H), H ** -0.5, torch.bfloat16)
    return xg, w_hh_t


@pytest.mark.parametrize('B,T,H', GATE_CASES)
def test_cluster_bidi_fwd_matches_plain(gen, B, T, H):
    xg, w_hh_t = _bidi_inputs(gen, B, T, H)
    before = kb.blstm_bidi_fwd.launches
    got = kb.blstm_bidi_fwd(xg, w_hh_t, with_cell=True)
    assert kb.blstm_bidi_fwd.launches == before + 1
    want = kb.blstm_bidi_fwd_plain(xg, w_hh_t, with_cell=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=CLUSTER_FWD_ATOL, rtol=0)
    h_only, c_none = kb.blstm_bidi_fwd(xg, w_hh_t)
    assert c_none is None
    torch.testing.assert_close(h_only, got[0], atol=0, rtol=0)


@pytest.mark.parametrize('B,T,H', GATE_CASES)
def test_cluster_bidi_bwd_matches_plain_and_repeats(gen, B, T, H):
    """dxg and dW_hh against the plain version, dh in float32; two launches
    give the same bits."""
    xg, w_hh_t = _bidi_inputs(gen, B, T, H)
    h, c = kb.blstm_bidi_fwd(xg, w_hh_t, with_cell=True)
    dh = torch.randn(B, T, 2 * H, generator=gen, device='cuda')
    before = kb.blstm_bidi_bwd.launches
    got = kb.blstm_bidi_bwd(xg, w_hh_t, h, c, dh)
    again = kb.blstm_bidi_bwd(xg, w_hh_t, h, c, dh)
    assert kb.blstm_bidi_bwd.launches == before + 2
    assert got[0].shape == (B, T, 8 * H) and got[0].dtype == torch.bfloat16
    assert got[1].shape == (2, H, 4 * H) and got[1].dtype == torch.float32
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    want = kb.blstm_bidi_bwd_plain(xg, w_hh_t, h, c, dh)
    assert _rel_err(got, want) <= CLUSTER_BWD_RTOL


def test_cluster_bidi_strided_inputs_read_in_place(gen):
    """The bidi pair's bf16 route reads xg and dh with any batch and time
    strides (slices of wider tensors), giving the bits of contiguous
    inputs."""
    B, T, H = 6, 11, 37
    xg, w_hh_t = _bidi_inputs(gen, B, T, H)
    wide = torch.zeros(B, T + 1, 9 * H, device='cuda', dtype=torch.bfloat16)
    wide[:, 1:, H:] = xg
    xv = wide[:, 1:, H:]
    got = kb.blstm_bidi_fwd(xv, w_hh_t, with_cell=True)
    want = kb.blstm_bidi_fwd(xg, w_hh_t, with_cell=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    h, c = want
    wide_dh = torch.randn(B, T + 3, 3 * H, generator=gen, device='cuda')
    dh = wide_dh[:, 1:T + 1, H:]
    got = kb.blstm_bidi_bwd(xv, w_hh_t, h, c, dh)
    want = kb.blstm_bidi_bwd(xg, w_hh_t, h, c, dh.contiguous())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize('kind', ['fwd_xg', 'bwd'])
def test_cluster_bidi_capacity_is_that_of_the_kernel_that_runs(gen, kind):
    """The bidi pair's geometry asks cudaOccupancyMaxActiveClusters about
    the gate-input forward, or the walk that takes dh in float32, at the
    row tile, chunk, threads and shared bytes it picks: at birnn2's 16 rows
    and fullfuse=False's 128 every picked plan fits the card in one wave."""
    device = torch.device('cuda', torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for rows in (16, 128, 256):
        geo = kb._geometry(kind, rows, 8 * 300, 300, device, 'bidi')
        held = kb._cluster_slots(kind, device, geo.cluster, geo.row_tile,
                                 geo.chunk, geo.threads, geo.shared,
                                 route='bidi')
        assert held is not None and held * geo.cluster <= sms
        assert geo.clusters_per_wave == min(held, geo.clusters)
        if rows <= 128:
            assert geo.waves == 1


# The conditioned pair's bf16 route (the conditioned form of
# csrc/blstm_cluster_*.cuh), (B, S, T, F, H): one row at H 16 (a cluster of
# 4); S 3 with H 37 (CTAs that own no unit) at 9 rows; S 8 at 16 rows and at
# birnn0's 128 (T 316); S 3 at 15 rows (8-row tiles that straddle speaker
# groups); S 1 at H 128; 300 rows at H 512 (16-CTA clusters, more than one
# wave, F 2048 staged beside its aux rows); 2048 rows at H 300 (the
# flagship's batch 256, more than one wave).
COND_CLUSTER_CASES = [(1, 1, 1, 12, 16), (3, 3, 2, 513, 37),
                      (2, 8, 316, 513, 300), (16, 8, 316, 513, 300),
                      (5, 3, 9, 40, 300), (13, 1, 23, 12, 128),
                      (100, 3, 9, 2048, 512), (256, 8, 2, 513, 300)]


def _cond_cluster_inputs(gen, B, S, T, F, H):
    return _cond_inputs(gen, torch.bfloat16, B, S, T, F, H)


@pytest.mark.parametrize('B,S,T,F,H', COND_CLUSTER_CASES)
def test_cluster_cond_fwd_matches_plain(gen, B, S, T, F, H):
    args = _cond_cluster_inputs(gen, B, S, T, F, H)
    before = kb.blstm_fullfused_cond_fwd.launches
    got = kb.blstm_fullfused_cond_fwd(*args, with_cell=True)
    assert kb.blstm_fullfused_cond_fwd.launches == before + 1
    want = kb.blstm_fullfused_cond_fwd_plain(*args, with_cell=True)
    for g, w in zip(got, want):
        assert g.shape == (B, S, T, 2 * H) and g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=CLUSTER_FWD_ATOL, rtol=0)
    h_only, c_none = kb.blstm_fullfused_cond_fwd(*args)
    assert c_none is None
    torch.testing.assert_close(h_only, got[0], atol=0, rtol=0)


@pytest.mark.parametrize('B,S,T,F,H', COND_CLUSTER_CASES)
def test_cluster_cond_bwd_matches_plain_and_repeats(gen, B, S, T, F, H):
    """dx, daux and the weight gradients against the plain version (dx and
    daux rounded to bf16 once, after the directions and speakers are
    summed); two launches give the same bits."""
    args = _cond_cluster_inputs(gen, B, S, T, F, H)
    h, c = kb.blstm_fullfused_cond_fwd(*args, with_cell=True)
    dh = torch.randn(B, S, T, 2 * H, generator=gen, device='cuda').to(
        torch.bfloat16)
    before = kb.blstm_fullfused_cond_bwd.launches
    got = kb.blstm_fullfused_cond_bwd(*args, h, c, dh)
    again = kb.blstm_fullfused_cond_bwd(*args, h, c, dh)
    assert kb.blstm_fullfused_cond_bwd.launches == before + 2
    shapes = [(B, T, F), (B, S, F), (2, F, 4 * H), (2, H, 4 * H), (2, 4 * H)]
    for g, a, shape in zip(got, again, shapes):
        assert g.shape == shape and g.dtype == torch.float32
        assert torch.equal(g, a)
    want = kb.blstm_fullfused_cond_bwd_plain(*args, h, c, dh)
    assert _rel_err(got, want) <= CLUSTER_BWD_RTOL


def test_cluster_cond_strided_xs_reads_in_place(gen):
    """The conditioned pair's bf16 route reads xs and dh with any batch and
    time strides (slices of wider tensors), giving the bits of contiguous
    inputs."""
    B, S, T, F, H = 5, 3, 11, 37, 37
    xs, aux, w_ih_t, w_hh_t, bias = _cond_cluster_inputs(gen, B, S, T, F, H)
    wide = torch.zeros(B, T + 1, F + 5, device='cuda', dtype=torch.bfloat16)
    wide[:, 1:, 3:F + 3] = xs
    xv = wide[:, 1:, 3:F + 3]
    got = kb.blstm_fullfused_cond_fwd(xv, aux, w_ih_t, w_hh_t, bias,
                                      with_cell=True)
    want = kb.blstm_fullfused_cond_fwd(xs, aux, w_ih_t, w_hh_t, bias,
                                       with_cell=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    h, c = want
    wide_dh = torch.randn(B, S, T + 2, 3 * H, generator=gen,
                          device='cuda').to(torch.bfloat16)
    dh = wide_dh[:, :, 1:T + 1, :2 * H]
    got = kb.blstm_fullfused_cond_bwd(xv, aux, w_ih_t, w_hh_t, bias, h, c, dh)
    want = kb.blstm_fullfused_cond_bwd(xs, aux, w_ih_t, w_hh_t, bias, h, c,
                                       dh.contiguous())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cluster_cond_capacity_is_that_of_the_kernel_that_runs(gen):
    """The conditioned forward's geometry asks
    cudaOccupancyMaxActiveClusters about the conditioned instance, at the
    row tile, chunk, threads and shared bytes it picks (its aux rows
    included): at birnn0's 128 rows of a request of batch 16 it fits the
    card in one wave, at 2048 rows every wave fits. The backward's walk is
    the fully fused one at the same rows."""
    device = torch.device('cuda', torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for rows in (16, 128, 2048):
        geo = kb._geometry('fwd_cond', rows, 513, 300, device, 'cond')
        assert geo.kind == 'fwd_cond'
        held = kb._cluster_slots('fwd_cond', device, geo.cluster,
                                 geo.row_tile, geo.chunk, geo.threads,
                                 geo.shared, route='cond')
        assert held is not None and held * geo.cluster <= sms
        assert geo.clusters_per_wave == min(held, geo.clusters)
        if rows <= 128:
            assert geo.waves == 1


# The spill pair's bf16 route (the fully fused forward writing the c
# boundaries, the walk rebuilding c itself), (B, T, F, H): H 16 on a cluster
# of 4, H 37 with CTAs that own no unit, H 300 as served and trained and
# H 512 on a 16-CTA cluster; T 1, 7, 8, 9, 37 and 316 (a spill block's
# edges and a short last block); 1 to 2048 rows (the flagship's batch 256,
# more than one wave; 300 rows at H 512 too).
SPILL_CLUSTER_CASES = [(1, 1, 12, 16), (13, 7, 513, 37), (13, 8, 40, 300),
                       (16, 9, 513, 300), (5, 37, 20, 300),
                       (128, 316, 513, 300), (300, 37, 2048, 512),
                       (2048, 9, 320, 300)]


@pytest.mark.parametrize('B,T,F,H', SPILL_CLUSTER_CASES)
def test_cluster_spill_fwd_matches_plain_and_fullfused(gen, B, T, F, H):
    """h and the boundaries against the plain version; h bit for bit the
    fully fused forward's, and each boundary slot its saved c at that step
    of the walk (slot 0 zero); without boundaries the same h."""
    x, w_ih_t, w_hh_t, bias, *_ = _fullfused_bwd_inputs(gen, torch.bfloat16,
                                                        B, T, F, H)
    before = kb.blstm_fullfused_spill_fwd.launches
    h, cb = kb.blstm_fullfused_spill_fwd(x, w_ih_t, w_hh_t, bias,
                                         with_boundaries=True)
    assert kb.blstm_fullfused_spill_fwd.launches == before + 1
    want = kb.blstm_fullfused_spill_fwd_plain(x, w_ih_t, w_hh_t, bias,
                                              with_boundaries=True)
    assert cb.shape == (2, -(-T // kb.SPILL_BLOCK), B, H)
    for g, w in zip((h, cb), want):
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=CLUSTER_FWD_ATOL, rtol=0)
    h_ff, c_ff = kb.blstm_fullfused_fwd(x, w_ih_t, w_hh_t, bias,
                                        with_cell=True)
    assert torch.equal(h, h_ff)
    assert not cb[:, 0].any()
    S = kb.SPILL_BLOCK
    for k in range(1, cb.shape[1]):
        assert torch.equal(cb[0, k], c_ff[:, S * k - 1, :H])
        assert torch.equal(cb[1, k], c_ff[:, T - S * k, H:])
    served, none = kb.blstm_fullfused_spill_fwd(x, w_ih_t, w_hh_t, bias)
    assert none is None and torch.equal(served, h)


@pytest.mark.parametrize('B,T,F,H', SPILL_CLUSTER_CASES)
def test_cluster_spill_bwd_matches_plain_and_repeats(gen, B, T, F, H):
    """dx and the weight gradients against the plain version (c rebuilt
    from the bf16 boundaries, dx rounded per direction); two launches give
    the same bits."""
    x, w_ih_t, w_hh_t, bias, *_, dh = _fullfused_bwd_inputs(
        gen, torch.bfloat16, B, T, F, H)
    h, cb = kb.blstm_fullfused_spill_fwd(x, w_ih_t, w_hh_t, bias,
                                         with_boundaries=True)
    args = (x, w_ih_t, w_hh_t, bias, h, cb, dh)
    before = kb.blstm_fullfused_spill_bwd.launches
    got = kb.blstm_fullfused_spill_bwd(*args)
    again = kb.blstm_fullfused_spill_bwd(*args)
    assert kb.blstm_fullfused_spill_bwd.launches == before + 2
    shapes = [(B, T, F), (2, F, 4 * H), (2, H, 4 * H), (2, 4 * H)]
    for g, a, shape in zip(got, again, shapes):
        assert g.shape == shape and g.dtype == torch.float32
        assert torch.equal(g, a)
    want = kb.blstm_fullfused_spill_bwd_plain(*args)
    assert _rel_err(got, want) <= CLUSTER_BWD_RTOL


def test_cluster_spill_strided_inputs_read_in_place(gen):
    """The spill pair's bf16 route reads x and dh with any batch and time
    strides (slices of wider tensors), giving the bits of contiguous
    inputs."""
    B, T, F, H = 6, 19, 24, 37
    x, w_ih_t, w_hh_t, bias, *_ = _fullfused_bwd_inputs(gen, torch.bfloat16,
                                                        B, T, F, H)
    wide_x = torch.zeros(B, T + 1, 2 * F, device='cuda', dtype=torch.bfloat16)
    wide_x[:, 1:, 3:F + 3] = x
    xv = wide_x[:, 1:, 3:F + 3]
    got = kb.blstm_fullfused_spill_fwd(xv, w_ih_t, w_hh_t, bias,
                                       with_boundaries=True)
    want = kb.blstm_fullfused_spill_fwd(x, w_ih_t, w_hh_t, bias,
                                        with_boundaries=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    h, cb = want
    wide_dh = torch.randn(B, T + 3, 3 * H, generator=gen,
                          device='cuda').to(torch.bfloat16)
    dh = wide_dh[:, 1:T + 1, :2 * H]
    got = kb.blstm_fullfused_spill_bwd(xv, w_ih_t, w_hh_t, bias, h, cb, dh)
    want = kb.blstm_fullfused_spill_bwd(x, w_ih_t, w_hh_t, bias, h, cb,
                                        dh.contiguous())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cluster_spill_capacity_is_that_of_the_kernel_that_runs(gen):
    """The spill walk's geometry (kind 'bwd_spill') asks
    cudaOccupancyMaxActiveClusters about the spill instance of the walk
    (``tssep_spill_walk_slots``), at the row tile, threads and shared bytes
    it picks, its cache of rebuilt c included: at the flagship's 16 and 128
    rows one wave, at 2048 every wave fits the card."""
    device = torch.device('cuda', torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    assert kb._SLOT_QUERIES['bwd_spill', 'spill'] == 'tssep_spill_walk_slots'
    for rows, F in ((16, 513), (128, 513), (128, 320), (2048, 513)):
        geo = kb._geometry('bwd_spill', rows, F, 300, device, 'spill')
        assert geo.kind == 'bwd_spill'
        held = kb._cluster_slots('bwd_spill', device, geo.cluster,
                                 geo.row_tile, geo.chunk, geo.threads,
                                 geo.shared, route='spill')
        assert held is not None and held * geo.cluster <= sms
        assert geo.clusters_per_wave == min(held, geo.clusters)
        if rows <= 128:
            assert geo.waves == 1


# The one-direction pair's bf16 route (the gate-input form of
# csrc/blstm_cluster_*.cuh on a grid of one direction), (B, T, H): H 16 on
# a cluster of 4, H 37 with CTAs that own no unit and gate columns only
# 2-byte aligned, H 300 as served and trained (16 rows, T 316), at 128
# rows (fullfuse=False), 256 rows (one wave on 24-row tiles) and 2048
# (more than one wave), H 512 on 16-CTA clusters at 300 rows (more than one
# wave); T 1, 2, 9, 37 and 316.
UNI_CASES = [(1, 1, 16), (13, 2, 37), (5, 37, 300), (16, 316, 300),
             (128, 37, 300), (256, 9, 300), (2048, 2, 300), (300, 9, 512)]


def _uni_inputs(gen, B, T, H):
    xg = torch.randn(B, T, 4 * H, generator=gen, device='cuda').to(
        torch.bfloat16)
    w_hh_t = _uniform(gen, (H, 4 * H), H ** -0.5, torch.bfloat16)
    return xg, w_hh_t


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('B,T,H', UNI_CASES)
def test_cluster_lstm_fwd_matches_plain(gen, B, T, H, reverse):
    """h and c against the plain version, in both directions; without c
    the same h; one launch a call."""
    xg, w_hh_t = _uni_inputs(gen, B, T, H)
    before = kb.lstm_fwd.launches
    got = kb.lstm_fwd(xg, w_hh_t, reverse=reverse, with_cell=True)
    assert kb.lstm_fwd.launches == before + 1
    want = kb.lstm_fwd_plain(xg, w_hh_t, reverse=reverse, with_cell=True)
    for g, w in zip(got, want):
        assert g.shape == (B, T, H) and g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(),
                                   atol=CLUSTER_FWD_ATOL, rtol=0)
    h_only, c_none = kb.lstm_fwd(xg, w_hh_t, reverse=reverse)
    assert c_none is None
    assert torch.equal(h_only, got[0])


@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('B,T,H', UNI_CASES)
def test_cluster_lstm_bwd_matches_plain_and_repeats(gen, B, T, H, reverse):
    """dxg and dW_hh against the plain version, dh in float32, in both
    directions; two launches give the same bits."""
    xg, w_hh_t = _uni_inputs(gen, B, T, H)
    h, c = kb.lstm_fwd(xg, w_hh_t, reverse=reverse, with_cell=True)
    dh = torch.randn(B, T, H, generator=gen, device='cuda')
    before = kb.lstm_bwd.launches
    got = kb.lstm_bwd(xg, w_hh_t, h, c, dh, reverse=reverse)
    again = kb.lstm_bwd(xg, w_hh_t, h, c, dh, reverse=reverse)
    assert kb.lstm_bwd.launches == before + 2
    assert got[0].shape == (B, T, 4 * H) and got[0].dtype == torch.bfloat16
    assert got[1].shape == (H, 4 * H) and got[1].dtype == torch.float32
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    want = kb.lstm_bwd_plain(xg, w_hh_t, h, c, dh, reverse=reverse)
    assert _rel_err(got, want) <= CLUSTER_BWD_RTOL


@pytest.mark.parametrize('B,T,H', [(13, 2, 37), (16, 316, 300),
                                   (256, 9, 300)])
def test_cluster_lstm_pair_is_the_bidi_pairs_halves(gen, B, T, H):
    """Each direction alone on its half of the bidi layer's xg (a strided
    view): h and c are the bidi forward's halves bit for bit, and dxg the
    bidi backward's halves (the same per-element arithmetic and sum orders;
    the row tile does not change a column's sum); dW_hh^T agrees at
    CLUSTER_BWD_RTOL, bit for bit only where the weight sums cut the rows
    alike."""
    xg, w_hh_t = _bidi_inputs(gen, B, T, H)
    G = 4 * H
    h2, c2 = kb.blstm_bidi_fwd(xg, w_hh_t, with_cell=True)
    dh = torch.randn(B, T, 2 * H, generator=gen, device='cuda')
    dxg2, dw2 = kb.blstm_bidi_bwd(xg, w_hh_t, h2, c2, dh)
    for d in range(2):
        xd, wd = xg[..., d * G:(d + 1) * G], w_hh_t[d]
        h, c = kb.lstm_fwd(xd, wd, reverse=d == 1, with_cell=True)
        assert torch.equal(h, h2[..., d * H:(d + 1) * H])
        assert torch.equal(c, c2[..., d * H:(d + 1) * H])
        dxg, dw = kb.lstm_bwd(xd, wd, h, c, dh[..., d * H:(d + 1) * H],
                              reverse=d == 1)
        assert torch.equal(dxg, dxg2[..., d * G:(d + 1) * G])
        assert _rel_err([dw], [dw2[d]]) <= CLUSTER_BWD_RTOL


def test_cluster_lstm_strided_inputs_read_in_place(gen):
    """The one-direction pair's bf16 route reads xg and dh with any batch
    and time strides (slices of wider tensors), giving the bits of
    contiguous inputs."""
    B, T, H = 6, 11, 37
    xg, w_hh_t = _uni_inputs(gen, B, T, H)
    wide = torch.zeros(B, T + 1, 5 * H, device='cuda', dtype=torch.bfloat16)
    wide[:, 1:, H:] = xg
    xv = wide[:, 1:, H:]
    got = kb.lstm_fwd(xv, w_hh_t, reverse=True, with_cell=True)
    want = kb.lstm_fwd(xg, w_hh_t, reverse=True, with_cell=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    h, c = want
    wide_dh = torch.randn(B, T + 3, 3 * H, generator=gen, device='cuda')
    dh = wide_dh[:, 1:T + 1, H:2 * H]
    got = kb.lstm_bwd(xv, w_hh_t, h, c, dh, reverse=True)
    want = kb.lstm_bwd(xg, w_hh_t, h, c, dh.contiguous(), reverse=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize('kind', ['fwd_xg', 'bwd'])
def test_cluster_lstm_capacity_is_that_of_the_kernel_that_runs(gen, kind):
    """The one-direction pair's geometry asks
    cudaOccupancyMaxActiveClusters about the gate-input forward, or the
    walk that takes dh in float32, compiled in its own sources
    (``tssep_lstm_fwd_slots``, ``tssep_lstm_walk_slots``), at the plan it
    picks: at birnn2's 16, 128 and 256 rows one wave of one cluster per
    row tile, where the bidi plan at 256 rows needs two."""
    device = torch.device('cuda', torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for rows in (16, 128, 256):
        geo = kb._geometry(kind, rows, 4 * 300, 300, device, 'uni',
                           directions=1)
        held = kb._cluster_slots(kind, device, geo.cluster, geo.row_tile,
                                 geo.chunk, geo.threads, geo.shared,
                                 route='uni')
        assert held is not None and held * geo.cluster <= sms
        assert geo.clusters == geo.tiles
        assert geo.clusters_per_wave == min(held, geo.clusters)
        assert geo.waves == 1
