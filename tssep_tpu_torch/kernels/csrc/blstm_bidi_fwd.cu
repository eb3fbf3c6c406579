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
// cores. This first design runs the recurrent product on the CUDA cores with
// W_hh streamed from L2 every step (blstm_common.cuh), so it is bound by the
// serial chain of 316 steps, not by either of those.
#include "blstm_common.cuh"

// xg (B, T, 8H) with strides (xg_sb, xg_st, 1), direction d's gates in
// columns [4H d, 4H (d + 1)); w_hh_t (2, H, 4H); h_out, c_out (B, T, 2H) with
// strides (o_sb, o_st, 1), c_out may be null. bf16 selects the storage type
// (0 float, 1 bf16), bt the batch tile (4 or 16). Returns a cudaError_t.
extern "C" int tssep_blstm_bidi_fwd(const void* xg, long long xg_sb, long long xg_st,
                                    const void* w_hh_t, void* h_out, void* c_out,
                                    long long o_sb, long long o_st, int B, int T, int H,
                                    int bf16, int bt, void* stream) {
  return tssep::dispatch<false>(bf16, bt, xg, xg_sb, xg_st, 0, nullptr, nullptr, w_hh_t, h_out,
                                c_out, o_sb, o_st, B, T, H, stream);
}
