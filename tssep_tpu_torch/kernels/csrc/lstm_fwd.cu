// lstm_fwd: one direction of an LSTM layer from precomputed input gates xg.
// Replaces the TPU kernel `_fwd_kernel` (tssep_tpu/kernels/blstm.py:52,
// launched by `_core_fwd_impl` :217), which `lstm_fused` runs for a
// unidirectional layer (RNNP typ='lstm') and, with TSSEP_PALLAS_BIDI=0, for
// each direction of a bidirectional layer that is not fully fused. As in the
// JAX package the projection x @ W_ih^T + b stays one matrix product outside
// the kernel; the TPU ran the reverse direction on a time-flipped copy of xg,
// this kernel reads xg in place and walks t = T-1 .. 0 (reverse = 1).
//
// The body is the bidi forward's (blstm_common.cuh) on a grid of one
// direction: one block per batch tile, thread j owns hidden unit j.
//
// Bound on an H100 at the flagship's birnn2 (16 or 256 rows, T 316, H 300):
// bytes. It must read xg (4H per row and step) and write h, about 0.25 GB in
// bf16 at 256 rows, 0.07 ms at 3.35 TB/s; its 0.06 TFLOP would take 0.06 ms
// on the tensor cores. Like the bidi forward it is bound by its serial chain
// of 316 steps instead, each streaming W_hh^T (720 KB in bf16) from L2.
#include "blstm_common.cuh"

// xg (B, T, 4H) with strides (xg_sb, xg_st, 1); w_hh_t (H, 4H); h_out, c_out
// (B, T, H) with strides (o_sb, o_st, 1), c_out may be null. reverse walks
// t = T-1 .. 0. bf16 selects the storage type (0 float, 1 bf16), bt the batch
// tile (4 or 16). Returns a cudaError_t.
extern "C" int tssep_lstm_fwd(const void* xg, long long xg_sb, long long xg_st,
                              const void* w_hh_t, void* h_out, void* c_out, long long o_sb,
                              long long o_st, int B, int T, int H, int reverse, int bf16, int bt,
                              void* stream) {
  return tssep::dispatch<false, false>(bf16, bt, xg, xg_sb, xg_st, 0, nullptr, 1, nullptr,
                                       nullptr, w_hh_t, h_out, c_out, o_sb, o_st, B, T, H, stream,
                                       1, reverse);
}
