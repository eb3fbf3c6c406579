// blstm_bidi_fwd: the two recurrences of one bidirectional LSTM layer,
// interleaved in one launch, from precomputed input gates xg. Replaces the
// TPU kernel `_bi_fwd_kernel` (tssep_tpu/kernels/blstm.py:374, launched by
// `_bi_core_fwd_impl` :520), which the flagship runs for the ts_vad stacked
// layer birnn2 (input width 8 x 320 = 2560). As in the JAX package the
// projection x @ W_ih^T + b stays one matrix product outside the kernel; the
// TPU kernel read a time-flipped copy of the reverse direction's gates, this
// one reads xg in place, walking t = T-1 .. 0 for the reverse direction.
//
// Bound on an H100 at the flagship shape (256 rows, T 316, H 300): bytes. It
// must read xg (2 x 4H per row and step) and write h, about 0.49 GB in bf16,
// 0.15 ms at 3.35 TB/s; its 0.12 TFLOP would take 0.12 ms on the tensor
// cores. At the served 16 rows what bounds it is the serial chain of 316
// steps, each a product with W_hh that waits for the previous step's h.
//
// Two routes, by storage type:
// - bf16, the served and trained one: the gate-input form of the Hopper
//   design of blstm_cluster_fwd.cuh (W_hh^T split over a thread-block
//   cluster and resident in shared memory, tensor-core products, h exchanged
//   through distributed shared memory, xg copied ahead of the walk into a
//   ring in shared memory by producer warps).
// - f32, the tests' and checks' mode: the first design (blstm_common.cuh),
//   one block per (row tile, direction), products on the CUDA cores with
//   W_hh streamed from L2 every step.
#include "blstm_cluster_fwd.cuh"
#include "blstm_common.cuh"

// xg (B, T, 8H) with strides (xg_sb, xg_st, 1), direction d's gates in
// columns [4H d, 4H (d + 1)); w_hh_t (2, H, 4H); h_out, c_out (B, T, 2H) with
// strides (o_sb, o_st, 1), c_out may be null. bf16 selects the storage type
// (0 float, 1 bf16), bt the batch tile (4 or 16). Returns a cudaError_t.
extern "C" int tssep_blstm_bidi_fwd(const void* xg, long long xg_sb, long long xg_st,
                                    const void* w_hh_t, void* h_out, void* c_out,
                                    long long o_sb, long long o_st, int B, int T, int H,
                                    int bf16, int bt, void* stream) {
  return tssep::dispatch<false, false>(bf16, bt, xg, xg_sb, xg_st, 0, nullptr, 1, nullptr,
                                       nullptr, w_hh_t, h_out, c_out, o_sb, o_st, B, T, H, stream);
}

// The bf16 route. xg (B, T, 8H) bf16 with strides (xg_sb, xg_st, 1); whh_p:
// the CTA slices of W_hh^T in fragment order (kernels/blstm.py `_pack`,
// kind 'fwd'); cols (2, C, 4U) int32: the xg column of each CTA's local gate
// rows, -1 for a padded unit (`_xg_columns`); h_out, c_out (B, T, 2H) bf16
// with strides (o_sb, o_st, 1), c_out may be null. C CTAs a cluster, each
// owning U units, the first `nact` of them owning any; bt rows a tile, tc
// steps a chunk. Returns a cudaError_t.
extern "C" int tssep_blstm_bidi_fwd_cluster(const void* xg, long long xg_sb, long long xg_st,
                                            const void* whh_p, const void* cols, void* h_out,
                                            void* c_out, long long o_sb, long long o_st, int B,
                                            int T, int H, int C, int U, int nact, int bt, int tc,
                                            void* stream) {
  return tssep::tc::gate_input_fwd(xg, xg_sb, xg_st, whh_p, cols, h_out, c_out, o_sb, o_st, B,
                                   T, H, 2, 0b10, C, U, nact, bt, tc,
                                   static_cast<cudaStream_t>(stream));
}

// Clusters of C CTAs of the gate-input forward at row tile bt and chunk tc,
// each of `threads` threads and `smem` shared bytes, that the card holds at
// once, into `slots`. Returns a cudaError_t.
extern "C" int tssep_bidi_fwd_slots(int C, int bt, int tc, int threads, int smem, int* slots) {
  using namespace tssep::tc;
  return cluster_slots(fwd_kernel<true>(bt, tc), threads, (size_t)smem, C, slots);
}
