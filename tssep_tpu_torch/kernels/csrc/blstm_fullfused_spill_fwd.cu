// blstm_fullfused_spill_fwd: the fully fused bidirectional layer
// (blstm_fullfused_fwd) that saves, besides h, only the c carry entering
// every `spill`'th step of each walk, rounded to the storage type, and no c
// sequence. Replaces the TPU kernel `_ffs_fwd_kernel`
// (tssep_tpu/kernels/blstm.py:1228, launched by `_ffs_fwd_impl` :1431),
// which the JAX package runs for every fully fused layer under
// TSSEP_PALLAS_SPILL=1. That kernel stored the carry entering every time
// block and kept every SPILL_BLOCK / TIME_BLOCK'th; here each walk writes
// the carry at steps 0, spill, 2 spill, .. of its own order, slot 0 the zero
// state, and the sequence needs no time padding: the last block is short.
// A served layer passes no boundary buffer and writes h only.
//
// Bound on an H100: as the fully fused forward (operations, 2.5 TFLOP for
// birnn0 at 2048 rows, 2.6 ms on the tensor cores; at the served 16-128
// rows its serial chain of T steps); the boundaries are 1/8 of the c
// sequence it no longer writes.
//
// Two routes, by storage type:
// - bf16, the served and trained one: the fully fused forward's Hopper
//   design (blstm_cluster_fwd.cuh, projection form), whose consumers write
//   the boundaries where they update c. Without a boundary buffer it is the
//   very launch of blstm_fullfused_fwd without c, so h has the same bits.
// - f32, the tests' and checks' mode: the first design (blstm_common.cuh),
//   one block per (row tile, direction), CUDA-core products with both
//   weight matrices streamed from L2 every step.
#include "blstm_cluster_fwd.cuh"
#include "blstm_common.cuh"

// x (B, T, F) with strides (x_sb, x_st, 1); w_ih_t (2, F, 4H); bias (2, 4H)
// f32; w_hh_t (2, H, 4H); h_out (B, T, 2H) with strides (o_sb, o_st, 1);
// cb_out (2, ceil(T / spill), B, H) contiguous, or null. bf16 selects the
// storage type (0 float, 1 bf16), bt the batch tile (4 or 16). Returns a
// cudaError_t.
extern "C" int tssep_blstm_fullfused_spill_fwd(const void* x, long long x_sb, long long x_st,
                                               int F, const void* w_ih_t, const void* bias,
                                               const void* w_hh_t, void* h_out, void* cb_out,
                                               long long o_sb, long long o_st, int B, int T,
                                               int H, int spill, int bf16, int bt, void* stream) {
  return tssep::dispatch<true, false>(bf16, bt, x, x_sb, x_st, F, nullptr, 1, w_ih_t, bias,
                                      w_hh_t, h_out, nullptr, o_sb, o_st, B, T, H, stream, 2, 0,
                                      cb_out, spill);
}

// The bf16 route. x (B, T, F) bf16 with strides (x_sb, x_st, 1); wih_p,
// whh_p, bias_p: the CTA slices of W_ih^T, W_hh^T and b in fragment order
// (kernels/blstm.py `_pack_fwd`); h_out (B, T, 2H) bf16 with strides
// (o_sb, o_st, 1); cb_out (2, ceil(T / spill), B, H) bf16 contiguous, or
// null. Geometry as tssep_blstm_fullfused_fwd_cluster's (kind 'fwd').
// Returns a cudaError_t.
extern "C" int tssep_blstm_fullfused_spill_fwd_cluster(
    const void* x, long long x_sb, long long x_st, int F, const void* wih_p,
    const void* whh_p, const void* bias_p, void* h_out, void* cb_out, long long o_sb,
    long long o_st, int B, int T, int H, int spill, int C, int U, int nact, int bt, int tc,
    int kx, void* stream) {
  if (cb_out != nullptr && spill < 1) return (int)cudaErrorInvalidValue;
  tssep::tc::FwdArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.x_sb = x_sb;
  a.x_st = x_st;
  a.wih = static_cast<const uint4*>(wih_p);
  a.whh = static_cast<const uint4*>(whh_p);
  a.bias = static_cast<const float*>(bias_p);
  a.cols = nullptr;
  a.aux = nullptr;
  a.divS = tssep::tc::make_fastdiv(1);
  a.h_out = static_cast<__nv_bfloat16*>(h_out);
  a.c_out = nullptr;
  a.o_sb = o_sb;
  a.o_st = o_st;
  a.cb = static_cast<__nv_bfloat16*>(cb_out);
  a.spill = spill;
  a.B = B;
  a.T = T;
  a.F = F;
  a.H = H;
  a.U = U;
  a.nact = nact;
  a.KH = (H + 15) / 16 * 16;
  a.KF = (F + 15) / 16 * 16;
  a.KX = kx;
  return tssep::tc::cluster_fwd<false>(a, C, bt, tc, static_cast<cudaStream_t>(stream));
}
