// lstm_bwd: the backward of lstm_fwd, one direction of an LSTM layer from
// given gate inputs xg. Replaces the TPU kernel `_bwd_kernel`
// (tssep_tpu/kernels/blstm.py:82, launched by `_lstm_core_bwd` :267). Like
// that kernel it produces dxg in the storage type and dW_hh in f32, from xg,
// the saved h and c and the f32 cotangent of h; dW_ih, the bias gradient and
// dx stay products outside the kernel, as in the JAX package. Two launches
// (blstm_bwd_common.cuh, on a grid of one direction): the serial walk writes
// dxg and the f32 gate gradients, and a tiled product sums h_prev^T dg over
// batch and time, with no atomics. The TPU kernel accumulated dW_hh in VMEM
// across its sequential grid; Hopper blocks carry nothing, hence the second
// pass.
//
// Bound on an H100 at birnn2 at batch 256 (256 rows, T 316, H 300): bytes
// and operations are close, half those of blstm_bidi_bwd (one direction):
// 0.06 TFLOP of gate recompute on bf16 operands, 0.12 TFLOP (dh, dW_hh) on
// f32 ones (1.7 ms at 67 TFLOP/s). This first design is bound by its serial
// chain of 316 steps instead.
#include "blstm_bwd_common.cuh"

// xg (B, T, 4H) with strides (xg_sb, xg_st, 1); w_hh_t (H, 4H) and w_hh
// (4H, H) in the storage type; h, c (B, T, H) from the forward with strides
// (s_sb, s_st, 1); dh (B, T, H) f32 with strides (d_sb, d_st, 1); reverse as
// the forward walked. Writes the workspace dg (B, T, 4H) f32, dxg (B, T, 4H)
// in the storage type and dw (H, 4H) f32 = dW_hh^T, all contiguous. Returns
// a cudaError_t.
extern "C" int tssep_lstm_bwd(const void* xg, long long xg_sb, long long xg_st,
                              const void* w_hh_t, const void* w_hh, const void* h, const void* c,
                              long long s_sb, long long s_st, const void* dh, long long d_sb,
                              long long d_st, void* dg, void* dxg, void* dw, int B, int T, int H,
                              int reverse, int bf16, int bt, void* stream) {
  return tssep::backward<false, false>(bf16, bt, xg, xg_sb, xg_st, 0, nullptr, 1, nullptr,
                                       nullptr, nullptr, w_hh_t, w_hh, h, c, s_sb, s_st, dh, d_sb,
                                       d_st, dg, dxg, dw, nullptr, B, T, H, stream, 1, reverse);
}
