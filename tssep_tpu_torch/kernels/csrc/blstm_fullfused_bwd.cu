// blstm_fullfused_bwd: the backward of one bidirectional LSTM layer whose
// input projection ran inside the recurrence (blstm_fullfused_fwd).
// Replaces the TPU kernel `_ff_bwd_kernel` (tssep_tpu/kernels/blstm.py:861,
// launched by `_ff_layer_bwd` :1074), which the flagship's training step runs
// for pre_net, birnn0 and birnn1. Like that kernel it recomputes the gates
// from x and the saved h and c, and produces dx, dW_ih, dW_hh and the bias
// gradient; here as three launches (blstm_bwd_common.cuh): the serial walk
// writes the f32 gate gradients, and two tiled products form the sums over
// batch and time and dx, with no atomics. The reverse direction reads
// everything in original time order, as its forward wrote it.
//
// Bound on an H100 at the flagship's birnn0 at batch 256 (2048 rows, T 316,
// F 513, H 300): operations. The gate recompute is 2.5 TFLOP on bf16
// operands, the gradient products (dh, dW, dx) 5.1 TFLOP on f32 ones, about
// 79 ms at 67 TFLOP/s; the bytes it must move (x, h, c, dh, dx) are about
// 4 GB, 1.2 ms. This first design runs every product on the CUDA cores and
// streams the weights from L2 every step of the walk.
#include "blstm_bwd_common.cuh"

// x (B, T, F) with strides (x_sb, x_st, 1); w_ih_t (2, F, 4H) and w_ih
// (2, 4H, F), w_hh_t (2, H, 4H) and w_hh (2, 4H, H), all in the storage type;
// bias (2, 4H) f32; h, c (B, T, 2H) from the forward with strides
// (s_sb, s_st, 1); dh (B, T, 2H) in the storage type with strides
// (d_sb, d_st, 1). Writes the workspace dg (2, B, T, 4H) f32, dw
// (2, F + H + 1, 4H) f32 = [dW_ih^T; dW_hh^T; db] per direction, and dx
// (B, T, F) f32, contiguous. Returns a cudaError_t.
extern "C" int tssep_blstm_fullfused_bwd(const void* x, long long x_sb, long long x_st, int F,
                                         const void* w_ih_t, const void* w_ih, const void* bias,
                                         const void* w_hh_t, const void* w_hh, const void* h,
                                         const void* c, long long s_sb, long long s_st,
                                         const void* dh, long long d_sb, long long d_st,
                                         void* dg, void* dw, void* dx, int B, int T, int H,
                                         int bf16, int bt, void* stream) {
  return tssep::backward<true, false>(bf16, bt, x, x_sb, x_st, F, nullptr, 1, w_ih_t, w_ih,
                                      bias, w_hh_t, w_hh, h, c, s_sb, s_st, dh, d_sb, d_st, dg,
                                      nullptr, dw, dx, B, T, H, stream);
}
