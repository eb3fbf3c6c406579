// blstm_fullfused_bwd: the backward of one bidirectional LSTM layer whose
// input projection ran inside the recurrence (blstm_fullfused_fwd).
// Replaces the TPU kernel `_ff_bwd_kernel` (tssep_tpu/kernels/blstm.py:861,
// launched by `_ff_layer_bwd` :1074), which the flagship's training step runs
// for pre_net, birnn0 and birnn1. Like that kernel it starts from x and the
// saved h and c, and produces dx, dW_ih, dW_hh and the bias gradient, with
// no atomics: the same bits every run. The reverse direction reads
// everything in original time order, as its forward wrote it.
//
// Bound on an H100 at the flagship's birnn0 at batch 256 (2048 rows, T 316,
// F 513, H 300): operations. The gate pre-activations are 2.5 TFLOP on bf16
// operands; dh, the weight sums and dx 5.1 TFLOP, which the bf16 route runs
// as 10.2 TFLOP of exact bf16 products (the f32 gate gradients split in two
// terms); the bytes it must move (x, h, c, dh, dx) are about 4 GB, 1.2 ms.
//
// Two routes, by storage type:
// - bf16, the trained one: the Hopper design of blstm_cluster_bwd.cuh (the
//   gate pre-activations as one tensor-core product before the walk, a walk
//   that carries only dh and dc with W_hh split over a thread-block cluster,
//   the weight sums and dx on the tensor cores).
// - f32, the tests' and checks' mode: the first design
//   (blstm_bwd_common.cuh), a walk that recomputes every gate and streams
//   the weights from L2, then tiled f32 products on the CUDA cores.
#include "blstm_bwd_common.cuh"
#include "blstm_cluster_bwd.cuh"

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

// The bf16 route. x (B, T, F) with strides (x_sb, x_st, 1); w_ih_t
// (2, F, 4H) and w_hh_t (2, H, 4H) bf16; bias (2, 4H) f32; wp: the CTA
// slices of W_hh^T in the walk's fragment order (kernels/blstm.py
// `_pack_walk`); h, c (B, T, 2H) bf16 with strides (s_sb, s_st, 1); dh
// (B, T, 2H) bf16 with strides (d_sb, d_st, 1). Writes the workspace dg
// (2, B, T, 4H) f32, dw (2, F + H + 1, 4H) f32 = [dW_ih^T; dW_hh^T; db] and
// dx (B, T, F) f32. The walk runs in clusters of C CTAs of `threads`
// threads, U units each, `nact` of them owning any, bt rows a tile. The
// weight sums cut the
// B T rows into `splits` ranges (their partials in dx's memory, which must
// hold (splits - 1) x 2 (F + H + 1) 4H floats). `parts` picks the launches
// (1 gates, 2 walk, 4 weight sums, 8 dx; 15 all), so that each can be timed
// alone. Returns a cudaError_t.
extern "C" int tssep_blstm_fullfused_bwd_cluster(
    const void* x, long long x_sb, long long x_st, int F, const void* w_ih_t,
    const void* w_hh_t, const void* bias, const void* wp, const void* h, const void* c,
    long long s_sb, long long s_st, const void* dh, long long d_sb, long long d_st, void* dg,
    void* dw, void* dx, int B, int T, int H, int C, int U, int nact, int bt, int threads,
    int splits, int parts, void* stream) {
  return tssep::tc::projection_backward<false>(
      x, x_sb, x_st, F, w_ih_t, w_hh_t, bias, wp, h, c, s_sb, s_st, nullptr, 0, dh, d_sb, d_st,
      dg, dw, dx, B, T, H, C, U, nact, bt, threads, splits, parts,
      static_cast<cudaStream_t>(stream));
}

// Clusters of C CTAs of the walk at row tile bt, each of `threads` threads
// and `smem` shared bytes, that the card holds at once, into `slots`.
// Returns a cudaError_t.
extern "C" int tssep_cluster_walk_slots(int C, int bt, int threads, int smem, int* slots) {
  using namespace tssep::tc;
  return cluster_slots(walk_kernel<__nv_bfloat16>(bt), threads, (size_t)smem, C, slots);
}
