"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA card with the CUDA toolkit; skips elsewhere. This file
imports no JAX, so it also runs where JAX is missing, without the suite's
conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances as in ``chip_smoke.py``: float32 1e-4 (the same sums in another
order), bfloat16 3e-2 (h is rounded to bf16 before each recurrent product,
so an f32 sum order that differs flips a rounding now and then, one bf16
ulp each).
"""

import pytest
import torch

from tssep_tpu_torch.kernels import blstm as kb

ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}

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
