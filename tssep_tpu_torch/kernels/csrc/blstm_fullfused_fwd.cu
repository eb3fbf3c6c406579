// blstm_fullfused_fwd: one bidirectional LSTM layer with the input projection
// x_t @ W_ih^T + b computed inside the recurrence, so no (B, T, 8H) gate
// tensor is ever written. Replaces the TPU kernel `_ff_fwd_kernel`
// (tssep_tpu/kernels/blstm.py:797, launched by `_ff_fwd_impl` :1005). That
// kernel read the reverse direction through a mirrored block map and
// re-zeroed its state at the first real frame of a time-padded sequence; here
// each reverse walk runs t = T-1 .. 0 over the unpadded x, which gives the
// same result with neither a flipped copy nor padding.
//
// Bound on an H100 at the flagship widths (T 316, H 300, F 513 or 320,
// 2048 rows): operations, 2.5 TFLOP for birnn0, which the tensor cores could
// do in 2.6 ms; at the served 16-128 rows the serial chain of T steps, each
// a product with W_hh that waits for the previous step's h, bounds it.
//
// Two routes, by storage type:
// - bf16, the served and trained one: the Hopper design of
//   blstm_cluster_fwd.cuh (W_hh^T split over a thread-block cluster and
//   resident in shared memory, tensor-core products, h exchanged through
//   distributed shared memory, the input projection computed ahead of the
//   walk by producer warps).
// - f32, the tests' and checks' mode: the first design (blstm_common.cuh),
//   one block per (row tile, direction), products on the CUDA cores with
//   both weight matrices streamed from L2 every step.
#include "blstm_cluster_fwd.cuh"
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
  return tssep::dispatch<true, false>(bf16, bt, x, x_sb, x_st, F, nullptr, 1, w_ih_t, bias,
                                      w_hh_t, h_out, c_out, o_sb, o_st, B, T, H, stream);
}

// The bf16 route. x (B, T, F) bf16 with strides (x_sb, x_st, 1); wih_p,
// whh_p, bias_p: the CTA slices of W_ih^T, W_hh^T and b in fragment order
// (kernels/blstm.py `_pack_fwd`); h_out, c_out (B, T, 2H) bf16 with strides
// (o_sb, o_st, 1), c_out may be null. C CTAs a cluster, each owning U
// units, the first `nact` of them owning any; bt rows a tile, tc steps a
// chunk, F staged kx columns at a time. Returns a cudaError_t.
extern "C" int tssep_blstm_fullfused_fwd_cluster(
    const void* x, long long x_sb, long long x_st, int F, const void* wih_p,
    const void* whh_p, const void* bias_p, void* h_out, void* c_out, long long o_sb,
    long long o_st, int B, int T, int H, int C, int U, int nact, int bt, int tc, int kx,
    void* stream) {
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
  a.c_out = static_cast<__nv_bfloat16*>(c_out);
  a.o_sb = o_sb;
  a.o_st = o_st;
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

// Clusters of C CTAs of the forward at row tile bt and chunk tc, each of
// `threads` threads and `smem` shared bytes, that the card holds at once,
// into `slots`. Returns a cudaError_t.
extern "C" int tssep_cluster_fwd_slots(int C, int bt, int tc, int threads, int smem,
                                       int* slots) {
  using namespace tssep::tc;
  return cluster_slots(fwd_kernel<false>(bt, tc), threads, (size_t)smem, C, slots);
}
