// blstm_fullfused_bwd: the backward of one bidirectional LSTM layer whose
// input projection ran inside the recurrence (blstm_fullfused_fwd).
// Replaces the TPU kernel `_ff_bwd_kernel` (tssep_tpu/kernels/blstm.py:861,
// launched by `_ff_layer_bwd` :1074), which the flagship's training step runs
// for pre_net, birnn0 and birnn1. Like that kernel it starts from x and the
// saved h and c, and produces dx, dW_ih, dW_hh and the bias gradient, with
// no atomics: the same bits every run. The reverse direction reads
// everything in original time order, as its forward wrote it.
//
// Bound on an H100 at the flagship's birnn0 at batch 256 (2048 rows, T 316,
// F 513, H 300): operations. The gate pre-activations are 2.5 TFLOP on bf16
// operands; dh, the weight sums and dx 5.1 TFLOP, which the bf16 route runs
// as 10.2 TFLOP of exact bf16 products (the f32 gate gradients split in two
// terms); the bytes it must move (x, h, c, dh, dx) are about 4 GB, 1.2 ms.
//
// Two routes, by storage type:
// - bf16, the trained one: the Hopper design of blstm_cluster_bwd.cuh (the
//   gate pre-activations as one tensor-core product before the walk, a walk
//   that carries only dh and dc with W_hh split over a thread-block cluster,
//   the weight sums and dx on the tensor cores).
// - f32, the tests' and checks' mode: the first design
//   (blstm_bwd_common.cuh), a walk that recomputes every gate and streams
//   the weights from L2, then tiled f32 products on the CUDA cores.
#include "blstm_bwd_common.cuh"
#include "blstm_cluster_bwd.cuh"

// x (B, T, F) with strides (x_sb, x_st, 1); w_ih_t (2, F, 4H) and w_ih
// (2, 4H, F), w_hh_t (2, H, 4H) and w_hh (2, 4H, H), all in the storage type;
// bias (2, 4H) f32; h, c (B, T, 2H) from the forward with strides
// (s_sb, s_st, 1); dh (B, T, 2H) in the storage type with strides
// (d_sb, d_st, 1). Writes the workspace dg (2, B, T, 4H) f32, dw
// (2, F + H + 1, 4H) f32 = [dW_ih^T; dW_hh^T; db] per direction, and dx
// (B, T, F) f32, contiguous. Returns a cudaError_t.
extern "C" int tssep_blstm_fullfused_bwd(const void* x, long long x_sb, long long x_st, int F,
                                         const void* w_ih_t, const void* w_ih, const void* bias,
                                         const void* w_hh_t, const void* w_hh, const void* h,
                                         const void* c, long long s_sb, long long s_st,
                                         const void* dh, long long d_sb, long long d_st,
                                         void* dg, void* dw, void* dx, int B, int T, int H,
                                         int bf16, int bt, void* stream) {
  return tssep::backward<true, false>(bf16, bt, x, x_sb, x_st, F, nullptr, 1, w_ih_t, w_ih,
                                      bias, w_hh_t, w_hh, h, c, s_sb, s_st, dh, d_sb, d_st, dg,
                                      nullptr, dw, dx, B, T, H, stream);
}

// The bf16 route. x (B, T, F) with strides (x_sb, x_st, 1); w_ih_t
// (2, F, 4H) and w_hh_t (2, H, 4H) bf16; bias (2, 4H) f32; wp: the CTA
// slices of W_hh^T in the walk's fragment order (kernels/blstm.py
// `_pack_walk`); h, c (B, T, 2H) bf16 with strides (s_sb, s_st, 1); dh
// (B, T, 2H) bf16 with strides (d_sb, d_st, 1). Writes the workspace dg
// (2, B, T, 4H) f32, dw (2, F + H + 1, 4H) f32 = [dW_ih^T; dW_hh^T; db] and
// dx (B, T, F) f32. The walk runs in clusters of C CTAs of `threads`
// threads, U units each, `nact` of them owning any, bt rows a tile. The
// weight sums cut the
// B T rows into `splits` ranges (their partials in dx's memory, which must
// hold (splits - 1) x 2 (F + H + 1) 4H floats). `parts` picks the launches
// (1 gates, 2 walk, 4 weight sums, 8 dx; 15 all), so that each can be timed
// alone. Returns a cudaError_t.
extern "C" int tssep_blstm_fullfused_bwd_cluster(
    const void* x, long long x_sb, long long x_st, int F, const void* w_ih_t,
    const void* w_hh_t, const void* bias, const void* wp, const void* h, const void* c,
    long long s_sb, long long s_st, const void* dh, long long d_sb, long long d_st, void* dg,
    void* dw, void* dx, int B, int T, int H, int C, int U, int nact, int bt, int threads,
    int splits, int parts, void* stream_) {
  using namespace tssep::tc;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long rows = (long long)B * T;
  Rows r;
  r.x = static_cast<const __nv_bfloat16*>(x);
  r.x_sb = x_sb;
  r.x_st = x_st;
  r.h = static_cast<const __nv_bfloat16*>(h);
  r.s_sb = s_sb;
  r.s_st = s_st;
  r.B = B;
  r.T = T;
  r.F = F;
  r.H = H;
  r.rows = rows;
  r.divT = make_fastdiv((uint32_t)T);
  r.aux = nullptr;
  r.divS = make_fastdiv(1);
  if (splits < 1 || (long long)(splits - 1) * 2 * (F + H + 1) * 4 * H > rows * F)
    return (int)cudaErrorInvalidValue;
  int err = 0;
  if (parts & 1) {
    GatesOp<false> op;
    op.rows = r;
    op.w_ih_t = static_cast<const __nv_bfloat16*>(w_ih_t);
    op.w_hh_t = static_cast<const __nv_bfloat16*>(w_hh_t);
    op.bias = static_cast<const float*>(bias);
    op.dg = static_cast<float*>(dg);
    op.M = rows;
    op.N = 4 * H;
    op.K = F + H;
    err = launch_gemm(op, (int)rows, 4 * H, 2, stream);
    if (err != 0) return err;
  }
  if (parts & 2) {
    WalkArgs a;
    a.wp = static_cast<const uint4*>(wp);
    a.dg = static_cast<float*>(dg);
    a.c = static_cast<const __nv_bfloat16*>(c);
    a.s_sb = s_sb;
    a.s_st = s_st;
    a.dh = dh;
    a.d_sb = d_sb;
    a.d_st = d_st;
    a.dxg = nullptr;
    a.g_sb = a.g_st = 0;
    a.B = B;
    a.T = T;
    a.H = H;
    a.U = U;
    a.nact = nact;
    a.KH = (H + 15) / 16 * 16;
    err = cluster_walk<__nv_bfloat16>(a, C, bt, threads, stream);
    if (err != 0) return err;
  }
  if (parts & 4) {
    WgradOp<> op;
    op.rows = r;
    op.dg = static_cast<const float*>(dg);
    op.out = static_cast<float*>(dw);
    op.ws = static_cast<float*>(dx);  // dx is written only after the sums
    op.K = rows;
    op.kps = ((rows + splits - 1) / splits + kGK - 1) / kGK * kGK;
    op.M = F + H + 1;
    op.N = 4 * H;
    err = launch_gemm(op, F + H + 1, 4 * H, 2 * splits, stream);
    if (err != 0) return err;
    if (splits > 1) {
      const long long n = 2LL * op.M * op.N;
      splitk_add_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
          static_cast<float*>(dw), static_cast<const float*>(dx), n, splits - 1);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
  }
  if (parts & 8) {
    DxOp op;
    op.dg = static_cast<const float*>(dg);
    op.w_ih_t = static_cast<const __nv_bfloat16*>(w_ih_t);
    op.dx = static_cast<float*>(dx);
    op.M = rows;
    op.N = F;
    op.K = 4 * H;
    err = launch_gemm(op, (int)rows, F, 1, stream);
  }
  return err;
}

// Clusters of C CTAs of the walk at row tile bt, each of `threads` threads
// and `smem` shared bytes, that the card holds at once, into `slots`.
// Returns a cudaError_t.
extern "C" int tssep_cluster_walk_slots(int C, int bt, int threads, int smem, int* slots) {
  using namespace tssep::tc;
  return cluster_slots(walk_kernel<__nv_bfloat16>(bt), threads, (size_t)smem, C, slots);
}
