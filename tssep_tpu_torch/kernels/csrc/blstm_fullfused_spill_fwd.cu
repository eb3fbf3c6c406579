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
// birnn0 at 2048 rows, 2.6 ms on the tensor cores); the boundaries are 1/8
// of the c sequence it no longer writes. Same design (blstm_common.cuh),
// bound by its serial chain of 316 steps.
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
