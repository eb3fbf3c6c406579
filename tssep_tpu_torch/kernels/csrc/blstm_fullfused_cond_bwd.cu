// blstm_fullfused_cond_bwd: the backward of blstm_fullfused_cond_fwd, the
// 'mul'-conditioned first post-net layer. Replaces the TPU kernel
// `_ffc_bwd_kernel` (tssep_tpu/kernels/blstm.py:1707, launched by
// `_ffc_layer_bwd` :1949). It returns what that function returns: dx summed
// over the speakers, daux, and dW_ih, db, dW_hh per direction.
//
// Five launches on one stream. The first three are the fully fused
// backward's (blstm_bwd_common.cuh) over the B S conditioned rows, each of
// which forms its rows xs[b, t] * aux[b, s] on the fly, as the forward does:
// the walk writes the f32 gate gradients; one tiled product sums
// [cond_x | h_prev | 1]^T dg into dW_ih^T, dW_hh^T and db; and one more
// gives dcond = sum_d dg[d] W_ih,d, the two directions summed in f32. Then
// cond_dx_kernel and cond_daux_kernel split dcond, each output summing in a
// fixed order (no atomics):
//   dx[b, t]   = round(sum_s dcond[b S + s, t] * aux[b, s]),
//   daux[b, s] = round(sum_t dcond[b S + s, t] * xs[b, t]),
// rounded to the storage type once, after both directions are summed, as
// `_ffc_layer_bwd` rounds (dxa + dxb) and daux (:2028-2029). The TPU kernel
// kept the daux and weight sums in VMEM scratch across its sequential grid;
// Hopper blocks carry nothing, hence the separate passes and the f32 dcond
// workspace (B S, T, F).
//
// Bound on an H100 at birnn0 of a training step (B 16 or 256, S 8, T 316,
// F 513, H 300): operations, as for the fully fused backward (the gate
// recompute on storage-type operands, dh, the weight sums and dcond on f32
// ones): 4.9 ms at batch 16 and 78 ms at batch 256. The split adds
// 2 x B S T F multiply-adds and reads dcond twice.
#include "blstm_bwd_common.cuh"

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
int split(const void* dcond, const void* xs, long long x_sb, long long x_st, const void* aux,
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
    return tssep::split<__nv_bfloat16>(dcond, xs, x_sb, x_st, aux, dx, daux, B, S, T, F, st);
  return tssep::split<float>(dcond, xs, x_sb, x_st, aux, dx, daux, B, S, T, F, st);
}
