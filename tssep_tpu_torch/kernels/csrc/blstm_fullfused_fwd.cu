// blstm_fullfused_fwd: one bidirectional LSTM layer with the input projection
// x_t @ W_ih^T + b computed inside the recurrence, so no (B, T, 8H) gate
// tensor is ever written. Replaces the TPU kernel `_ff_fwd_kernel`
// (tssep_tpu/kernels/blstm.py:797, launched by `_ff_fwd_impl` :1005). That
// kernel read the reverse direction through a mirrored block map and
// re-zeroed its state at the first real frame of a time-padded sequence; here
// each reverse block walks t = T-1 .. 0 over the unpadded x, which gives the
// same result with neither a flipped copy nor padding.
//
// Bound on an H100 at the flagship widths (T 316, H 300, F 513 or 320,
// 2048 rows): operations, 2.5 TFLOP for birnn0, which the tensor cores could
// do in 2.6 ms. This first design runs the products on the CUDA cores and
// streams both weight matrices from L2 every step (blstm_common.cuh); it is
// right before it is fast. Splitting the gate columns over a thread-block
// cluster and moving the products to wgmma is the next step.
#include "blstm_common.cuh"

// x (B, T, F) with strides (x_sb, x_st, 1); w_ih_t (2, F, 4H); bias (2, 4H)
// f32; w_hh_t (2, H, 4H); h_out, c_out (B, T, 2H) with strides (o_sb, o_st, 1),
// c_out may be null. bf16 selects the storage type (0 float, 1 bf16), bt the
// batch tile (4 or 16). Returns a cudaError_t.
extern "C" int tssep_blstm_fullfused_fwd(const void* x, long long x_sb, long long x_st, int F,
                                         const void* w_ih_t, const void* bias,
                                         const void* w_hh_t, void* h_out, void* c_out,
                                         long long o_sb, long long o_st, int B, int T, int H,
                                         int bf16, int bt, void* stream) {
  return tssep::dispatch<true>(bf16, bt, x, x_sb, x_st, F, w_ih_t, bias, w_hh_t, h_out, c_out,
                               o_sb, o_st, B, T, H, stream);
}
