// blstm_fullfused_cond_bwd: the backward of blstm_fullfused_cond_fwd, the
// 'mul'-conditioned first post-net layer. Replaces the TPU kernel
// `_ffc_bwd_kernel` (tssep_tpu/kernels/blstm.py:1707, launched by
// `_ffc_layer_bwd` :1949). It returns what that function returns: dx summed
// over the speakers, daux, and dW_ih, db, dW_hh per direction. Every launch
// forms the conditioned rows xs[b, t] * aux[b, s] on the fly, as the
// forward does, so the (B, S, T, F) tensor is never written.
//
// The last two launches of both routes split dcond = sum_d dg[d] W_ih,d,
// the f32 workspace (B S, T, F), into dx and daux, each output summing in a
// fixed order (no atomics):
//   dx[b, t]   = round(sum_s dcond[b S + s, t] * aux[b, s]),
//   daux[b, s] = round(sum_t dcond[b S + s, t] * xs[b, t]),
// rounded to the storage type once, after both directions are summed, as
// `_ffc_layer_bwd` rounds (dxa + dxb) and daux (:2028-2029). The TPU kernel
// kept the daux and weight sums in VMEM scratch across its sequential grid;
// Hopper blocks carry nothing, hence the separate passes and the workspace.
//
// Bound on an H100 at birnn0 of a training step (B 16 or 256, S 8, T 316,
// F 513, H 300): operations, as for the fully fused backward over B S rows
// (the gate recompute on bf16 operands, dh, the weight sums and dcond on
// f32 ones, which the bf16 route runs as two-term bf16 splits): 0.80 ms at
// batch 16 at the bf16 tensor-core peak. The split adds 2 x B S T F
// multiply-adds and reads dcond twice (83 MB at batch 16, ~0.05 ms).
//
// Two routes, by storage type:
// - bf16, the trained one: the conditioned form of the Hopper design of
//   blstm_cluster_bwd.cuh, five launches: the gate pre-activations as one
//   tensor-core product over the conditioned rows, the clustered walk (W_hh
//   split over a thread-block cluster) that carries only dh and dc, the
//   weight sums [cond_x | h_prev | 1]^T dg on the tensor cores, dcond as one
//   tensor-core product with both directions in its K, and the split.
// - f32, the tests' and checks' mode: the first design
//   (blstm_bwd_common.cuh), a serial walk that recomputes every gate and
//   streams the weights from L2, then tiled f32 products on the CUDA cores.
#include "blstm_bwd_common.cuh"
#include "blstm_cluster_bwd.cuh"

namespace tssep {
namespace {

// dx (B, T, F) f32, one thread per element.
template <typename T>
__global__ void __launch_bounds__(256)
cond_dx_kernel(const float* __restrict__ dcond, const T* __restrict__ aux,
               float* __restrict__ dx, int B, int S, int steps, int F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * steps * F) return;
  const int f = (int)(i % F);
  const long long bt = i / F;
  const int t = (int)(bt % steps);
  const int b = (int)(bt / steps);
  float acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const long long r = (long long)b * S + s;
    acc += dcond[(r * steps + t) * F + f] * to_f32(aux[r * F + f]);
  }
  dx[i] = to_f32(from_f32<T>(acc));
}

// daux (B S, F) f32, one thread per element; xs (B, T, F) with strides
// (x_sb, x_st, 1).
template <typename T>
__global__ void __launch_bounds__(256)
cond_daux_kernel(const float* __restrict__ dcond, const T* __restrict__ xs, long long x_sb,
                 long long x_st, float* __restrict__ daux, int rows, int S, int steps, int F) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * F) return;
  const int f = (int)(i % F);
  const long long r = i / F;
  const T* x = xs + (r / S) * x_sb + f;
  const float* d = dcond + r * steps * F + f;
  float acc = 0.f;
  for (int t = 0; t < steps; ++t) acc += d[(long long)t * F] * to_f32(x[t * x_st]);
  daux[i] = to_f32(from_f32<T>(acc));
}

template <typename T>
int cond_split(const void* dcond, const void* xs, long long x_sb, long long x_st, const void* aux,
               void* dx, void* daux, int B, int S, int steps, int F, cudaStream_t stream) {
  const long long n_dx = (long long)B * steps * F;
  cond_dx_kernel<T><<<(unsigned)((n_dx + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dcond), static_cast<const T*>(aux), static_cast<float*>(dx), B,
      S, steps, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_daux = (long long)B * S * F;
  cond_daux_kernel<T><<<(unsigned)((n_daux + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dcond), static_cast<const T*>(xs), x_sb, x_st,
      static_cast<float*>(daux), B * S, S, steps, F);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tssep

// xs (B, T, F) with strides (x_sb, x_st, 1); aux (B S, F) contiguous;
// w_ih_t (2, F, 4H) and w_ih (2, 4H, F), w_hh_t (2, H, 4H) and w_hh
// (2, 4H, H), all in the storage type; bias (2, 4H) f32; h, c (B S, T, 2H)
// from the forward with strides (s_sb, s_st, 1); dh (B S, T, 2H) in the
// storage type with strides (d_sb, d_st, 1). Writes the workspaces dg
// (2, B S, T, 4H) and dcond (B S, T, F), f32; dw (2, F + H + 1, 4H) f32 =
// [dW_ih^T; dW_hh^T; db] per direction; dx (B, T, F) and daux (B S, F) f32,
// rounded to the storage type; all contiguous. Returns a cudaError_t.
extern "C" int tssep_blstm_fullfused_cond_bwd(
    const void* xs, long long x_sb, long long x_st, int F, const void* aux, int S,
    const void* w_ih_t, const void* w_ih, const void* bias, const void* w_hh_t, const void* w_hh,
    const void* h, const void* c, long long s_sb, long long s_st, const void* dh, long long d_sb,
    long long d_st, void* dg, void* dcond, void* dw, void* dx, void* daux, int B, int T, int H,
    int bf16, int bt, void* stream) {
  int err = tssep::backward<true, true>(bf16, bt, xs, x_sb, x_st, F, aux, S, w_ih_t, w_ih, bias,
                                        w_hh_t, w_hh, h, c, s_sb, s_st, dh, d_sb, d_st, dg,
                                        nullptr, dw, dcond, B * S, T, H, stream);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return tssep::cond_split<__nv_bfloat16>(dcond, xs, x_sb, x_st, aux, dx, daux, B, S, T, F, st);
  return tssep::cond_split<float>(dcond, xs, x_sb, x_st, aux, dx, daux, B, S, T, F, st);
}

// The bf16 route. xs (B, T, F) bf16 with strides (x_sb, x_st, 1); aux
// (B S, F) bf16 contiguous; w_ih_t (2, F, 4H) and w_hh_t (2, H, 4H) bf16;
// bias (2, 4H) f32; wp: the CTA slices of W_hh^T in the walk's fragment order
// (kernels/blstm.py `_pack_walk`); h, c (B S, T, 2H) bf16 with strides
// (s_sb, s_st, 1); dh (B S, T, 2H) bf16 with strides (d_sb, d_st, 1). Writes
// the workspaces dg (2, B S, T, 4H) and dcond (B S, T, F), f32; dw
// (2, F + H + 1, 4H) f32 = [dW_ih^T; dW_hh^T; db]; dx (B, T, F) and daux
// (B S, F) f32, rounded to bf16. The walk runs in clusters of C CTAs of
// `threads` threads, U units each, `nact` of them owning any, bt rows (of
// the B S) a tile. The weight sums cut the B S T rows into `splits` ranges
// (their partials in dcond's memory, which must hold (splits - 1) x
// 2 (F + H + 1) 4H floats). `parts` picks the launches (1 gates, 2 walk,
// 4 weight sums, 8 dcond, 16 the split into dx and daux; 31 all), so that
// each can be timed alone. Returns a cudaError_t.
extern "C" int tssep_blstm_fullfused_cond_bwd_cluster(
    const void* xs, long long x_sb, long long x_st, int F, const void* aux, int S,
    const void* w_ih_t, const void* w_hh_t, const void* bias, const void* wp, const void* h,
    const void* c, long long s_sb, long long s_st, const void* dh, long long d_sb, long long d_st,
    void* dg, void* dcond, void* dw, void* dx, void* daux, int B, int T, int H, int C, int U,
    int nact, int bt, int threads, int splits, int parts, void* stream_) {
  using namespace tssep::tc;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int BS = B * S;
  const long long rows = (long long)BS * T;
  if (S < 1 || splits < 1 || (long long)(splits - 1) * 2 * (F + H + 1) * 4 * H > rows * F)
    return (int)cudaErrorInvalidValue;
  RowsT<true> r;
  r.x = static_cast<const __nv_bfloat16*>(xs);
  r.x_sb = x_sb;
  r.x_st = x_st;
  r.h = static_cast<const __nv_bfloat16*>(h);
  r.s_sb = s_sb;
  r.s_st = s_st;
  r.aux = static_cast<const __nv_bfloat16*>(aux);
  r.B = BS;
  r.T = T;
  r.F = F;
  r.H = H;
  r.rows = rows;
  r.divT = make_fastdiv((uint32_t)T);
  r.divS = make_fastdiv((uint32_t)S);
  int err = 0;
  if (parts & 1) {
    GatesOp<false, true> op;
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
    a.B = BS;
    a.T = T;
    a.H = H;
    a.U = U;
    a.nact = nact;
    a.KH = (H + 15) / 16 * 16;
    err = cluster_walk<__nv_bfloat16>(a, C, bt, threads, stream);
    if (err != 0) return err;
  }
  if (parts & 4) {
    WgradOp<true> op;
    op.rows = r;
    op.dg = static_cast<const float*>(dg);
    op.out = static_cast<float*>(dw);
    op.ws = static_cast<float*>(dcond);  // dcond is written only after the sums
    op.K = rows;
    op.kps = ((rows + splits - 1) / splits + kGK - 1) / kGK * kGK;
    op.M = F + H + 1;
    op.N = 4 * H;
    err = launch_gemm(op, F + H + 1, 4 * H, 2 * splits, stream);
    if (err != 0) return err;
    if (splits > 1) {
      const long long n = 2LL * op.M * op.N;
      splitk_add_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
          static_cast<float*>(dw), static_cast<const float*>(dcond), n, splits - 1);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
  }
  if (parts & 8) {
    DcondOp op;
    op.dg = static_cast<const float*>(dg);
    op.w_ih_t = static_cast<const __nv_bfloat16*>(w_ih_t);
    op.out = static_cast<float*>(dcond);
    op.M = rows;
    op.N = F;
    op.G = 4 * H;
    err = launch_gemm(op, (int)rows, F, 1, stream);
    if (err != 0) return err;
  }
  if (parts & 16)
    err = tssep::cond_split<__nv_bfloat16>(dcond, xs, x_sb, x_st, aux, dx, daux, B, S, T, F,
                                           stream);
  return err;
}
