// lstm_fwd: one direction of an LSTM layer from precomputed input gates xg.
// Replaces the TPU kernel `_fwd_kernel` (tssep_tpu/kernels/blstm.py:52,
// launched by `_core_fwd_impl` :217), which `lstm_fused` runs for a
// unidirectional layer (RNNP typ='lstm') and, with TSSEP_PALLAS_BIDI=0, for
// each direction of a bidirectional layer that is not fully fused. As in the
// JAX package the projection x @ W_ih^T + b stays one matrix product outside
// the kernel; the TPU ran the reverse direction on a time-flipped copy of xg,
// this kernel reads xg in place and walks t = T-1 .. 0 (reverse = 1). It also
// runs JAX's streaming scan (`_lstm_scan` with h0, c0, tssep_tpu/nn/rnnp.py:
// 130, called by tssep_tpu/eval/streaming.py): given a carried state, the walk
// starts from it instead of zeros, three launches a streamed layer and block.
//
// Bound on an H100 at the flagship's birnn2 (16 or 256 rows, T 316, H 300):
// bytes. It must read xg (4H per row and step) and write h, about 0.25 GB in
// bf16 at 256 rows, 0.07 ms at 3.35 TB/s; its 0.06 TFLOP would take 0.06 ms
// on the tensor cores. At the served 16 rows the serial chain of 316 steps
// bounds it, each a product with W_hh that waits for the previous step's h.
//
// Two routes, by storage type:
// - bf16, the served and trained one: the gate-input form of the Hopper
//   design of blstm_cluster_fwd.cuh launched for one direction (the bidi
//   forward's kernel on a grid of one direction, its reverse rule a flag):
//   W_hh^T split over a thread-block cluster and resident in shared memory,
//   tensor-core products, h exchanged through distributed shared memory, xg
//   copied ahead of the walk by producer warps.
// - f32, the tests' and checks' mode: the first design (blstm_common.cuh)
//   on a grid of one direction, one block per batch tile, thread j owning
//   hidden unit j, W_hh streamed from L2 every step.
#include "blstm_cluster_fwd.cuh"
#include "blstm_common.cuh"

// xg (B, T, 4H) with strides (xg_sb, xg_st, 1); w_hh_t (H, 4H); h_out, c_out
// (B, T, H) with strides (o_sb, o_st, 1), c_out may be null. reverse walks
// t = T-1 .. 0. bf16 selects the storage type (0 float, 1 bf16), bt the batch
// tile (4 or 16). h0, c0 (B, H) contiguous in the storage type: the carry the
// walk starts from (streaming), or both null for zeros. Returns a
// cudaError_t.
extern "C" int tssep_lstm_fwd(const void* xg, long long xg_sb, long long xg_st,
                              const void* w_hh_t, void* h_out, void* c_out, long long o_sb,
                              long long o_st, int B, int T, int H, int reverse, int bf16, int bt,
                              const void* h0, const void* c0, void* stream) {
  return tssep::dispatch<false, false>(bf16, bt, xg, xg_sb, xg_st, 0, nullptr, 1, nullptr,
                                       nullptr, w_hh_t, h_out, c_out, o_sb, o_st, B, T, H, stream,
                                       1, reverse, nullptr, 1, h0, c0);
}

// The bf16 route. xg (B, T, 4H) bf16 with strides (xg_sb, xg_st, 1); whh_p:
// the CTA slices of W_hh^T (1, H, 4H) in fragment order (kernels/blstm.py
// `_pack`, kind 'fwd'); cols (1, C, 4U) int32: the xg column of each CTA's
// local gate rows, -1 for a padded unit (`_xg_columns`, one direction);
// h_out, c_out (B, T, H) bf16 with strides (o_sb, o_st, 1), c_out may be
// null; reverse walks t = T-1 .. 0. C CTAs a cluster, each owning U units,
// the first `nact` of them owning any; bt rows a tile, tc steps a chunk. h0,
// c0 (B, H) bf16 contiguous: the carry the walk starts from, or both null
// for zeros. Returns a cudaError_t.
extern "C" int tssep_lstm_fwd_cluster(const void* xg, long long xg_sb, long long xg_st,
                                      const void* whh_p, const void* cols, void* h_out,
                                      void* c_out, long long o_sb, long long o_st, int B, int T,
                                      int H, int reverse, int C, int U, int nact, int bt, int tc,
                                      const void* h0, const void* c0, void* stream) {
  return tssep::tc::gate_input_fwd(xg, xg_sb, xg_st, whh_p, cols, h_out, c_out, o_sb, o_st, B,
                                   T, H, 1, reverse ? 1 : 0, C, U, nact, bt, tc,
                                   static_cast<cudaStream_t>(stream), h0, c0);
}

// Clusters of C CTAs of this source's gate-input forward at row tile bt and
// chunk tc, each of `threads` threads and `smem` shared bytes, that the card
// holds at once, into `slots`. Returns a cudaError_t.
extern "C" int tssep_lstm_fwd_slots(int C, int bt, int tc, int threads, int smem, int* slots) {
  using namespace tssep::tc;
  return cluster_slots(fwd_kernel<true>(bt, tc), threads, (size_t)smem, C, slots);
}
