// blstm_fullfused_cond_fwd: the flagship's first post-net layer (birnn0) with
// its 'mul' speaker conditioning formed inside the kernel. Replaces the TPU
// kernel `_ffc_fwd_kernel` (tssep_tpu/kernels/blstm.py:1656, launched by
// `_ffc_fwd_impl` :1858). Row b S + s of the layer is batch row b
// conditioned on speaker s: the block stages xs[b, t, :] * aux[b, s, :],
// rounded to the storage type, where the fully fused forward stages x_t
// (row_value in blstm_common.cuh), and runs the same recurrence. So the
// (B, S, T, F) conditioned tensor is never written: the kernel reads xs
// (B, T, F) and aux (B, S, F) instead. The rows keep the port's b-major
// order (row = b S + s), so h comes out as (B, S, T, 2H) with no transpose;
// the TPU kernel's s-major rows within a batch block were a Mosaic
// work-around.
//
// Bound on an H100 at the flagship's birnn0 (B 16 or 256, S 8, T 316, F 513,
// H 300): operations, 2 rows x 2 directions x (F + H) x 4H per row and step
// on the tensor cores, 0.16 ms at batch 16 and 2.6 ms at batch 256 in bf16.
// The bytes the conditioning saves, the (B, S, T, F) tensor (41.5 MB in bf16
// at batch 16), are small next to the weights every block streams from L2
// at every step (blstm_common.cuh), so this first design is no faster than
// the materialized product followed by blstm_fullfused_fwd.
#include "blstm_common.cuh"

// xs (B, T, F) with strides (x_sb, x_st, 1); aux (B S, F) contiguous;
// w_ih_t (2, F, 4H); bias (2, 4H) f32; w_hh_t (2, H, 4H); h_out, c_out
// (B S, T, 2H) with strides (o_sb, o_st, 1), c_out may be null. bf16 selects
// the storage type (0 float, 1 bf16), bt the batch tile in rows (4 or 16).
// Returns a cudaError_t.
extern "C" int tssep_blstm_fullfused_cond_fwd(const void* xs, long long x_sb, long long x_st,
                                              int F, const void* aux, int S,
                                              const void* w_ih_t, const void* bias,
                                              const void* w_hh_t, void* h_out, void* c_out,
                                              long long o_sb, long long o_st, int B, int T,
                                              int H, int bf16, int bt, void* stream) {
  return tssep::dispatch<true, true>(bf16, bt, xs, x_sb, x_st, F, aux, S, w_ih_t, bias, w_hh_t,
                                     h_out, c_out, o_sb, o_st, B * S, T, H, stream);
}
