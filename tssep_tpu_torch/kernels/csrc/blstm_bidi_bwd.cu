// blstm_bidi_bwd: the backward of one bidirectional LSTM layer's two
// recurrences from given gate inputs xg (blstm_bidi_fwd). Replaces the TPU
// kernel `_bi_bwd_kernel` (tssep_tpu/kernels/blstm.py:424), which the
// flagship's training step runs through `_layer_bwd` (:697) for the ts_vad
// stacked layer birnn2, and which `_bi_core_bwd` (:555) launches too. Like
// that kernel it produces dxg in the storage type and dW_hh in f32; dW_ih,
// the bias gradient and dx stay products outside the kernel, as in the JAX
// package. No atomics: the same bits every run.
//
// Bound on an H100 at birnn2 at batch 256 (256 rows, T 316, H 300): the
// gate recompute is 0.12 TFLOP on bf16 operands, dh and dW_hh 0.23 TFLOP on
// f32 ones, which the bf16 route runs as 0.47 TFLOP of exact bf16 products
// (the f32 gate gradients split in two terms): 0.6 ms at the bf16 peak. It
// must read xg, h, c and dh (f32) and write dxg, about 1.2 GB (0.35 ms). At
// the trained 16 rows the serial chain of 316 steps bounds it.
//
// Two routes, by storage type:
// - bf16, the trained one: the gate-input form of the Hopper design of
//   blstm_cluster_bwd.cuh, three launches: the gate pre-activations
//   h_prev W_hh^T + xg as one tensor-core product, a walk that carries only
//   dh and dc with W_hh split over a thread-block cluster and writes dxg, and
//   the weight sums dW_hh^T = h_prev^T dg on the tensor cores.
// - f32, the tests' and checks' mode: the first design
//   (blstm_bwd_common.cuh), a serial walk that writes dxg and the f32 gate
//   gradients, then a tiled product of h_prev^T dg on the CUDA cores.
#include "blstm_bwd_common.cuh"
#include "blstm_cluster_bwd.cuh"

// xg (B, T, 8H) with strides (xg_sb, xg_st, 1); w_hh_t (2, H, 4H) and w_hh
// (2, 4H, H) in the storage type; h, c (B, T, 2H) from the forward with
// strides (s_sb, s_st, 1); dh (B, T, 2H) f32 with strides (d_sb, d_st, 1).
// Writes the workspace dg (2, B, T, 4H) f32, dxg (B, T, 8H) in the storage
// type and dw (2, H, 4H) f32 = dW_hh^T per direction, all contiguous.
// Returns a cudaError_t.
extern "C" int tssep_blstm_bidi_bwd(const void* xg, long long xg_sb, long long xg_st,
                                    const void* w_hh_t, const void* w_hh, const void* h,
                                    const void* c, long long s_sb, long long s_st, const void* dh,
                                    long long d_sb, long long d_st, void* dg, void* dxg, void* dw,
                                    int B, int T, int H, int bf16, int bt, void* stream) {
  return tssep::backward<false, false>(bf16, bt, xg, xg_sb, xg_st, 0, nullptr, 1, nullptr,
                                       nullptr, nullptr, w_hh_t, w_hh, h, c, s_sb, s_st, dh, d_sb,
                                       d_st, dg, dxg, dw, nullptr, B, T, H, stream);
}

// The bf16 route. xg (B, T, 8H) bf16 with strides (xg_sb, xg_st, 1); w_hh_t
// (2, H, 4H) bf16; wp: the CTA slices of W_hh^T in the walk's fragment order
// (kernels/blstm.py `_pack_walk`); h, c (B, T, 2H) bf16 with strides
// (s_sb, s_st, 1); dh (B, T, 2H) f32 with strides (d_sb, d_st, 1). Writes
// the workspace dg (2, B, T, 4H) f32, dxg (B, T, 8H) bf16 and dw (2, H, 4H)
// f32 = dW_hh^T per direction, all contiguous. The walk runs in clusters of
// C CTAs of `threads` threads, U units each, `nact` of them owning any, bt
// rows a tile. The weight sums cut the B T rows into `splits` ranges, their
// partials in ws, which must hold (splits - 1) x 2 H 4H floats. `parts`
// picks the launches (1 gates, 2 walk, 4 weight sums; 7 all), so that each
// can be timed alone. Returns a cudaError_t.
extern "C" int tssep_blstm_bidi_bwd_cluster(
    const void* xg, long long xg_sb, long long xg_st, const void* w_hh_t, const void* wp,
    const void* h, const void* c, long long s_sb, long long s_st, const void* dh, long long d_sb,
    long long d_st, void* dg, void* dxg, void* dw, void* ws, int B, int T, int H, int C, int U,
    int nact, int bt, int threads, int splits, int parts, void* stream_) {
  using namespace tssep::tc;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const long long rows = (long long)B * T;
  if (splits < 1 || (splits > 1 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  Rows r;
  r.x = static_cast<const __nv_bfloat16*>(xg);
  r.x_sb = xg_sb;
  r.x_st = xg_st;
  r.h = static_cast<const __nv_bfloat16*>(h);
  r.s_sb = s_sb;
  r.s_st = s_st;
  r.B = B;
  r.T = T;
  r.F = 0;
  r.H = H;
  r.rows = rows;
  r.divT = make_fastdiv((uint32_t)T);
  r.aux = nullptr;
  r.divS = make_fastdiv(1);
  int err = 0;
  if (parts & 1) {
    GatesOp<true> op;
    op.rows = r;
    op.w_ih_t = nullptr;
    op.w_hh_t = static_cast<const __nv_bfloat16*>(w_hh_t);
    op.bias = nullptr;
    op.dg = static_cast<float*>(dg);
    op.M = rows;
    op.N = 4 * H;
    op.K = H;
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
    a.dxg = static_cast<__nv_bfloat16*>(dxg);
    a.g_sb = (long long)T * 8 * H;
    a.g_st = 8 * H;
    a.B = B;
    a.T = T;
    a.H = H;
    a.U = U;
    a.nact = nact;
    a.KH = (H + 15) / 16 * 16;
    err = cluster_walk<float>(a, C, bt, threads, stream);
    if (err != 0) return err;
  }
  if (parts & 4) {
    WgradOp<> op;
    op.rows = r;
    op.dg = static_cast<const float*>(dg);
    op.out = static_cast<float*>(dw);
    op.ws = static_cast<float*>(ws);
    op.K = rows;
    op.kps = ((rows + splits - 1) / splits + kGK - 1) / kGK * kGK;
    op.M = H;
    op.N = 4 * H;
    err = launch_gemm(op, H, 4 * H, 2 * splits, stream);
    if (err != 0) return err;
    if (splits > 1) {
      const long long n = 2LL * op.M * op.N;
      splitk_add_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
          static_cast<float*>(dw), static_cast<const float*>(ws), n, splits - 1);
      err = (int)cudaGetLastError();
    }
  }
  return err;
}

// Clusters of C CTAs of the gate-input form's walk (dh in f32) at row tile
// bt, each of `threads` threads and `smem` shared bytes, that the card holds
// at once, into `slots`. Returns a cudaError_t.
extern "C" int tssep_bidi_walk_slots(int C, int bt, int threads, int smem, int* slots) {
  using namespace tssep::tc;
  return cluster_slots(walk_kernel<float>(bt), threads, (size_t)smem, C, slots);
}
