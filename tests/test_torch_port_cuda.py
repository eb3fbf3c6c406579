"""The port's CUDA kernels against their plain versions, on the card.

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
                                     (70, 9, 513, 300)])
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
                                     (70, 9, 513, 300)])
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
