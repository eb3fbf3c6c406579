// lstm_bwd: the backward of lstm_fwd, one direction of an LSTM layer from
// given gate inputs xg. Replaces the TPU kernel `_bwd_kernel`
// (tssep_tpu/kernels/blstm.py:82, launched by `_lstm_core_bwd` :267). Like
// that kernel it produces dxg in the storage type and dW_hh in f32, from xg,
// the saved h and c and the f32 cotangent of h; dW_ih, the bias gradient and
// dx stay products outside the kernel, as in the JAX package. No atomics:
// the same bits every run.
//
// Bound on an H100 at birnn2 at batch 256 (256 rows, T 316, H 300): half
// that of blstm_bidi_bwd (one direction): 0.06 TFLOP of gate recompute on
// bf16 operands, 0.12 TFLOP (dh, dW_hh) on f32 ones, which the bf16 route
// runs as 0.24 TFLOP of exact bf16 products (the f32 gate gradients split in
// two terms): 0.3 ms at the bf16 peak. At the trained 16 rows the serial
// chain of 316 steps bounds it.
//
// Two routes, by storage type:
// - bf16, the trained one: the gate-input form of the Hopper design of
//   blstm_cluster_bwd.cuh launched for one direction, three launches: the
//   gate pre-activations h_prev W_hh^T + xg as one tensor-core product, a
//   walk that carries only dh and dc with W_hh split over a thread-block
//   cluster and writes dxg, and the weight sums dW_hh^T = h_prev^T dg on the
//   tensor cores.
// - f32, the tests' and checks' mode: the first design
//   (blstm_bwd_common.cuh) on a grid of one direction, a serial walk that
//   writes dxg and the f32 gate gradients, then a tiled product of
//   h_prev^T dg on the CUDA cores.
#include "blstm_bwd_common.cuh"
#include "blstm_cluster_bwd.cuh"

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

// The bf16 route. xg (B, T, 4H) bf16 with strides (xg_sb, xg_st, 1); w_hh_t
// (H, 4H) bf16; wp: the CTA slices of W_hh^T in the walk's fragment order
// (kernels/blstm.py `_pack_walk` of (1, H, 4H)); h, c (B, T, H) bf16 with
// strides (s_sb, s_st, 1); dh (B, T, H) f32 with strides (d_sb, d_st, 1);
// reverse as the forward walked. Writes the workspace dg (B, T, 4H) f32,
// dxg (B, T, 4H) bf16 and dw (H, 4H) f32 = dW_hh^T, all contiguous. The
// walk runs in clusters of C CTAs of `threads` threads, U units each,
// `nact` of them owning any, bt rows a tile. The weight sums cut the B T
// rows into `splits` ranges, their partials in ws, which must hold
// (splits - 1) x H 4H floats. `parts` picks the launches (1 gates, 2 walk,
// 4 weight sums; 7 all), so that each can be timed alone. Returns a
// cudaError_t.
extern "C" int tssep_lstm_bwd_cluster(
    const void* xg, long long xg_sb, long long xg_st, const void* w_hh_t, const void* wp,
    const void* h, const void* c, long long s_sb, long long s_st, const void* dh, long long d_sb,
    long long d_st, void* dg, void* dxg, void* dw, void* ws, int B, int T, int H, int reverse,
    int C, int U, int nact, int bt, int threads, int splits, int parts, void* stream) {
  return tssep::tc::gate_input_backward<1>(xg, xg_sb, xg_st, w_hh_t, wp, h, c, s_sb, s_st, dh,
                                           d_sb, d_st, dg, dxg, dw, ws, B, T, H, reverse ? 1 : 0, C,
                                           U, nact, bt, threads, splits, parts,
                                           static_cast<cudaStream_t>(stream));
}

// Clusters of C CTAs of this source's gate-input walk (dh in f32) at row
// tile bt, each of `threads` threads and `smem` shared bytes, that the card
// holds at once, into `slots`. Returns a cudaError_t.
extern "C" int tssep_lstm_walk_slots(int C, int bt, int threads, int smem, int* slots) {
  using namespace tssep::tc;
  return cluster_slots(walk_kernel<float>(bt), threads, (size_t)smem, C, slots);
}
