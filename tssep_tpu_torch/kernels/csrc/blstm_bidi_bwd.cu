// blstm_bidi_bwd: the backward of one bidirectional LSTM layer's two
// recurrences from given gate inputs xg (blstm_bidi_fwd). Replaces the TPU
// kernel `_bi_bwd_kernel` (tssep_tpu/kernels/blstm.py:424), which the
// flagship's training step runs through `_layer_bwd` (:697) for the ts_vad
// stacked layer birnn2, and which `_bi_core_bwd` (:555) launches too. Like
// that kernel it produces dxg in the storage type and dW_hh in f32; dW_ih,
// the bias gradient and dx stay products outside the kernel, as in the JAX
// package. Two launches (blstm_bwd_common.cuh): the serial walk writes dxg
// and the f32 gate gradients, and a tiled product sums h_prev^T dg over
// batch and time, with no atomics.
//
// Bound on an H100 at birnn2 at batch 256 (256 rows, T 316, H 300): bytes
// and operations are close. The gate recompute is 0.15 TFLOP on bf16
// operands, dh and dW_hh 0.29 TFLOP on f32 ones (4.4 ms at 67 TFLOP/s); it
// must read xg, h, c and dh (f32) and write dxg, about 1.0 GB (0.3 ms). This
// first design is bound by its serial chain of 316 steps instead.
#include "blstm_bwd_common.cuh"

// xg (B, T, 8H) with strides (xg_sb, xg_st, 1); w_hh_t (2, H, 4H) and w_hh
// (2, 4H, H) in the storage type; h, c (B, T, 2H) from the forward with
// strides (s_sb, s_st, 1); dh (B, T, 2H) f32 with strides (d_sb, d_st, 1).
// Writes the workspace dg (2, B, T, 4H) f32, dxg (B, T, 8H) in the storage
// type and dw (2, H, 4H) f32 = dW_hh^T per direction, all contiguous.
// Returns a cudaError_t.
extern "C" int tssep_blstm_bidi_bwd(const void* xg, long long xg_sb, long long xg_st,
                                    const void* w_hh_t, const void* w_hh, const void* h,
                                    const void* c, long long s_sb, long long s_st, const void* dh,
                                    long long d_sb, long long d_st, void* dg, void* dxg, void* dw,
                                    int B, int T, int H, int bf16, int bt, void* stream) {
  return tssep::backward<false>(bf16, bt, xg, xg_sb, xg_st, 0, nullptr, nullptr, nullptr,
                                w_hh_t, w_hh, h, c, s_sb, s_st, dh, d_sb, d_st, dg, dxg, dw,
                                nullptr, B, T, H, stream);
}
