// Shared body of the two backward BLSTM kernels (blstm_fullfused_bwd.cu and
// blstm_bidi_bwd.cu). Three grid kernels, launched one after the other on
// one stream:
//
// 1. blstm_bwd_walk_kernel, the serial part. One block per (batch tile of BT
//    rows, direction), as in the forward (blstm_common.cuh): thread j owns
//    hidden unit j, its four gates, for the BT rows. The block walks its
//    direction's time backward. At each step it recomputes the gates from
//    the saved h_prev and c_prev (streaming W_hh^T, and W_ih^T in the fused
//    form, from L2 as the forward does), forms the gate gradients in f32,
//    writes them to a workspace dg (2, B, T, 4H), and carries
//    dh = dgates W_hh and dc = dc * f to the next step. dh and dc stay in
//    shared memory; only the step's dgates are exchanged between threads.
// 2. wgrad_kernel, the sums over batch and time that the TPU kernel kept in
//    VMEM scratch across its sequential grid. Blocks on Hopper run in no
//    order and carry nothing, so they are a second pass: a tiled product
//    out[d] = A_d^T dg[d], with A_d = [x | h_prev | 1] gathered row by row,
//    gives dW_ih^T, dW_hh^T and db in one launch. Each output tile sums all
//    B*T rows itself in a fixed order: no atomics, the same bits every run.
// 3. dx_kernel (fused form only): dx = sum_d round(dg[d] W_ih,d), each
//    direction's product rounded to the storage type and the two summed in
//    f32, as the TPU kernel wrote dx per direction in the storage type.
//
// All products run on the CUDA cores in f32 (the TPU backward's products
// take f32 operands too); the tiled ones are the classic 64 x 64 shared-
// memory tiling with 4 x 4 outputs per thread. Moving them to wgmma is the
// next step, not this one.
#pragma once

#include <type_traits>

#include "blstm_common.cuh"

namespace tssep {
namespace {

// Adds sum_k src[k, r] * w[k * ld] to acc[r]: one column of a (K, ld)
// matrix against the (K, BT) f32 tile in shared memory.
template <typename T, int BT>
__device__ __forceinline__ void accumulate1(float (&acc)[BT], const float* src,
                                            const T* __restrict__ w, int K, int ld) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float wk = to_f32(w[(size_t)k * ld]);
    const float4* s4 = reinterpret_cast<const float4*>(src + k * BT);
#pragma unroll
    for (int q = 0; q < BT / 4; ++q) {
      const float4 v = s4[q];
      acc[4 * q + 0] = fmaf(wk, v.x, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(wk, v.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(wk, v.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(wk, v.w, acc[4 * q + 3]);
    }
  }
}

// FUSED: `in` is x (B, T, F) with strides (in_sb, in_st, 1); the gates are
//        bias (2, 4H) f32 + x_t W_ih^T (w_ih_t (2, F, 4H)) + h_prev W_hh^T.
// else:  `in` is xg (B, T, 8H) with strides (in_sb, in_st, 1), direction d's
//        gate inputs in columns [4H d, 4H (d + 1)); dxg (B, T, 8H),
//        contiguous, receives the gate gradients rounded to T.
// Both:  w_hh_t (2, H, 4H) for the gates, w_hh (2, 4H, H) for dh; h and c
//        (B, T, 2H) from the forward, strides (s_sb, s_st, 1); dh (B, T, 2H)
//        in TD, strides (d_sb, d_st, 1); dg (2, B, T, 4H) f32, contiguous.
//        Direction 0 walked t = 0 .. T-1 forward, so its step before t is
//        t - 1; direction 1 walked T-1 .. 0, so its step before t is t + 1.
template <typename T, typename TD, int BT, bool FUSED>
__global__ void __launch_bounds__(512)
blstm_bwd_walk_kernel(const T* __restrict__ in, long long in_sb, long long in_st, int F,
                      const T* __restrict__ w_ih_t, const float* __restrict__ bias,
                      const T* __restrict__ w_hh_t, const T* __restrict__ w_hh,
                      const T* __restrict__ h, const T* __restrict__ c, long long s_sb,
                      long long s_st, const TD* __restrict__ dh, long long d_sb, long long d_st,
                      float* __restrict__ dg, T* __restrict__ dxg, int B, int steps, int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* hp_s = smem;               // (H, BT): h_prev of the step
  float* dh_s = hp_s + H * BT;      // (H, BT): carried dh, own thread only
  float* dc_s = dh_s + H * BT;      // (H, BT): carried dc, own thread only
  float* dg_s = dc_s + H * BT;      // (4H, BT): the step's gate gradients
  float* x_s = dg_s + 4 * H * BT;   // (F, BT): x_t, FUSED only

  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int j = threadIdx.x;
  const int G = 4 * H;
  const bool active = j < H;
  const T* whh_t = w_hh_t + (size_t)dir * H * G + j;
  const T* whh = w_hh + (size_t)dir * G * H + j;

  for (int i = threadIdx.x; i < 2 * H * BT; i += blockDim.x) dh_s[i] = 0.f;  // dh_s, dc_s

  for (int s = steps - 1; s >= 0; --s) {
    const int t = dir ? steps - 1 - s : s;
    const int tp = dir ? t + 1 : t - 1;
    const bool has_prev = s > 0;
    // stage h_prev (and x_t), coalesced along the feature axis; rows past B
    // and the state before the first step read as zeros
    for (int i = threadIdx.x; i < H * BT; i += blockDim.x) {
      const int r = i / H;
      const int k = i - r * H;
      const int b = b0 + r;
      hp_s[k * BT + r] =
          (has_prev && b < B) ? to_f32(h[b * s_sb + tp * s_st + dir * H + k]) : 0.f;
    }
    if constexpr (FUSED) {
      for (int i = threadIdx.x; i < F * BT; i += blockDim.x) {
        const int r = i / F;
        const int k = i - r * F;
        const int b = b0 + r;
        x_s[k * BT + r] = b < B ? to_f32(in[b * in_sb + t * in_st + k]) : 0.f;
      }
    }
    __syncthreads();  // hp_s and x_s are complete

    if (active) {
      float acc[4][BT];
      if constexpr (FUSED) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float bv = bias[dir * G + g * H + j];
#pragma unroll
          for (int r = 0; r < BT; ++r) acc[g][r] = bv;
        }
        accumulate<T, BT>(acc, x_s, w_ih_t + (size_t)dir * F * G + j, F, G, H);
      } else {
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const int b = b0 + r;
          const T* p = in + b * in_sb + t * in_st + dir * G + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[g][r] = b < B ? to_f32(p[g * H]) : 0.f;
        }
      }
      accumulate<T, BT>(acc, hp_s, whh_t, H, G, H);

#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const int b = b0 + r;
        const bool real = b < B;
        const long long so = b * s_sb + t * s_st + dir * H + j;
        const float ct = real ? to_f32(c[so]) : 0.f;
        const float cp =
            (real && has_prev) ? to_f32(c[b * s_sb + tp * s_st + dir * H + j]) : 0.f;
        const float dhv =
            dh_s[j * BT + r] + (real ? to_f32(dh[b * d_sb + t * d_st + dir * H + j]) : 0.f);
        const float ig = sigmoid_f(acc[0][r]);
        const float fg = sigmoid_f(acc[1][r]);
        const float gg = tanhf(acc[2][r]);
        const float og = sigmoid_f(acc[3][r]);
        const float tc = tanhf(ct);
        const float dcv = dc_s[j * BT + r] + dhv * og * (1.f - tc * tc);
        const float dgv[4] = {dcv * gg * ig * (1.f - ig), dcv * cp * fg * (1.f - fg),
                              dcv * ig * (1.f - gg * gg), dhv * tc * og * (1.f - og)};
        dc_s[j * BT + r] = dcv * fg;
#pragma unroll
        for (int g = 0; g < 4; ++g) dg_s[(g * H + j) * BT + r] = dgv[g];
        if (real) {
          float* p = dg + (((size_t)dir * B + b) * steps + t) * G + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) p[g * H] = dgv[g];
          if constexpr (!FUSED) {
            T* q = dxg + ((size_t)b * steps + t) * 2 * G + dir * G + j;
#pragma unroll
            for (int g = 0; g < 4; ++g) q[g * H] = from_f32<T>(dgv[g]);
          }
        }
      }
    }
    __syncthreads();  // dg_s is complete; hp_s and x_s are no longer read

    if (active && has_prev) {
      float acc1[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc1[r] = 0.f;
      accumulate1<T, BT>(acc1, dg_s, whh, G, H);  // dh_prev[j] = sum_g dg[g] W_hh[g, j]
#pragma unroll
      for (int r = 0; r < BT; ++r) dh_s[j * BT + r] = acc1[r];
    }
    // No barrier here: the next step writes hp_s and x_s, which nobody reads
    // now, and rewrites dg_s only after its own first barrier.
  }
}

constexpr int GM = 64, GN = 64, GK = 16;  // tile of the two products, 256 threads

// out[d] (M, N) = sum over the B*T rows k = (b, t) of A_d(k, m) dg[d](k, n),
// N = 4H, M = F + H + with_bias:
//   m < F:          x[b, t, m]                       (F = 0 for the bidi form)
//   m < F + H:      h[b, t_prev, d H + m - F], zero at the walk's first step
//   m == F + H:     1, so that row F + H of out is db = sum_k dg.
template <typename T>
__global__ void __launch_bounds__(256)
wgrad_kernel(const T* __restrict__ x, long long x_sb, long long x_st, int F,
             const T* __restrict__ h, long long s_sb, long long s_st, int H, int with_bias,
             const float* __restrict__ dg, float* __restrict__ out, int B, int steps) {
  __shared__ __align__(16) float As[GK][GM];
  __shared__ __align__(16) float Bs[GK][GN];
  const int d = blockIdx.z;
  const int m0 = blockIdx.y * GM;
  const int n0 = blockIdx.x * GN;
  const int M = F + H + with_bias;
  const int N = 4 * H;
  const long long K = (long long)B * steps;
  const float* dgd = dg + (size_t)d * K * N;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};

  for (long long k0 = 0; k0 < K; k0 += GK) {
    for (int e = tid; e < GK * GM; e += 256) {
      const int kk = e / GM, mm = e % GM;
      const long long k = k0 + kk;
      const int m = m0 + mm;
      float v = 0.f;
      if (k < K && m < M) {
        const int b = (int)(k / steps);
        const int t = (int)(k - (long long)b * steps);
        if (m < F) {
          v = to_f32(x[b * x_sb + t * x_st + m]);
        } else if (m < F + H) {
          const int tp = d ? t + 1 : t - 1;
          if (tp >= 0 && tp < steps) v = to_f32(h[b * s_sb + tp * s_st + d * H + (m - F)]);
        } else {
          v = 1.f;
        }
      }
      As[kk][mm] = v;
    }
    for (int e = tid; e < GK * GN; e += 256) {
      const int kk = e / GN, nn = e % GN;
      const long long k = k0 + kk;
      const int n = n0 + nn;
      Bs[kk][nn] = (k < K && n < N) ? dgd[k * N + n] : 0.f;
    }
    __syncthreads();
    // the tile's 16 rows are summed on their own and then added in: over
    // B*T (up to 647k) rows that keeps the f32 rounding error ~4x smaller
    // than one running sum
    float part[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][q] = fmaf(av[i], bw[q], part[i][q]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] += part[i][q];
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      if (m < M && n < N) out[((size_t)d * M + m) * N + n] = acc[i][q];
    }
  }
}

// dx (K, F) f32 = sum_d round_T(dg[d] (K, N) @ w_ih[d] (N, F)), N = 4H,
// w_ih (2, 4H, F) in T: the torch layout of weight_ih_l0.
template <typename T>
__global__ void __launch_bounds__(256)
dx_kernel(const float* __restrict__ dg, const T* __restrict__ w_ih, float* __restrict__ dx,
          long long K, int F, int N) {
  __shared__ float As[GK][GM + 1];  // As[g][k]; +1 spreads the transposing stores over banks
  __shared__ __align__(16) float Bs[GK][GN];
  const long long k0 = (long long)blockIdx.x * GM;
  const int f0 = blockIdx.y * GN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float total[4][4] = {};

  for (int d = 0; d < 2; ++d) {
    const float* dgd = dg + (size_t)d * K * N;
    const T* w = w_ih + (size_t)d * N * F;
    float acc[4][4] = {};
    for (int g0 = 0; g0 < N; g0 += GK) {
      for (int e = tid; e < GK * GM; e += 256) {
        const int kk = e / GK, gg = e % GK;  // gg fastest: dg rows are contiguous in g
        const long long k = k0 + kk;
        const int g = g0 + gg;
        As[gg][kk] = (k < K && g < N) ? dgd[k * N + g] : 0.f;
      }
      for (int e = tid; e < GK * GN; e += 256) {
        const int gg = e / GN, ff = e % GN;
        const int g = g0 + gg, f = f0 + ff;
        Bs[gg][ff] = (g < N && f < F) ? to_f32(w[(size_t)g * F + f]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int gg = 0; gg < GK; ++gg) {
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[gg][tx * 4]);
        const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = As[gg][ty * 4 + i];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a, bw[q], acc[i][q]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) total[i][q] += to_f32(from_f32<T>(acc[i][q]));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long k = k0 + ty * 4 + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int f = f0 + tx * 4 + q;
      if (k < K && f < F) dx[k * F + f] = total[i][q];
    }
  }
}

// Launches the walk on `stream`; returns the launch's cudaError_t.
template <typename T, int BT, bool FUSED>
int launch_walk(const void* in, long long in_sb, long long in_st, int F, const void* w_ih_t,
                const void* bias, const void* w_hh_t, const void* w_hh, const void* h,
                const void* c, long long s_sb, long long s_st, const void* dh, long long d_sb,
                long long d_st, void* dg, void* dxg, int B, int steps, int H,
                cudaStream_t stream) {
  using TD = typename std::conditional<FUSED, T, float>::type;
  const dim3 grid((B + BT - 1) / BT, 2);
  const int threads = ((H + 31) / 32) * 32;
  const size_t smem = sizeof(float) * BT * (7 * H + (FUSED ? F : 0));
  auto kernel = blstm_bwd_walk_kernel<T, TD, BT, FUSED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(in), in_sb, in_st, F, static_cast<const T*>(w_ih_t),
      static_cast<const float*>(bias), static_cast<const T*>(w_hh_t),
      static_cast<const T*>(w_hh), static_cast<const T*>(h), static_cast<const T*>(c), s_sb,
      s_st, static_cast<const TD*>(dh), d_sb, d_st, static_cast<float*>(dg),
      static_cast<T*>(dxg), B, steps, H);
  return (int)cudaGetLastError();
}

// Everything after the walk: the weight and bias sums, and dx (FUSED).
template <typename T, bool FUSED>
int launch_sums(const void* x, long long x_sb, long long x_st, int F, const void* w_ih,
                const void* h, long long s_sb, long long s_st, const void* dg, void* dw,
                void* dx, int B, int steps, int H, cudaStream_t stream) {
  const int M = F + H + (FUSED ? 1 : 0);
  const dim3 wgrid((4 * H + GN - 1) / GN, (M + GM - 1) / GM, 2);
  wgrad_kernel<T><<<wgrid, 256, 0, stream>>>(
      static_cast<const T*>(x), x_sb, x_st, F, static_cast<const T*>(h), s_sb, s_st, H,
      FUSED ? 1 : 0, static_cast<const float*>(dg), static_cast<float*>(dw), B, steps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !FUSED) return (int)err;
  const long long K = (long long)B * steps;
  const dim3 xgrid((unsigned)((K + GM - 1) / GM), (F + GN - 1) / GN);
  dx_kernel<T><<<xgrid, 256, 0, stream>>>(static_cast<const float*>(dg),
                                          static_cast<const T*>(w_ih), static_cast<float*>(dx),
                                          K, F, 4 * H);
  return (int)cudaGetLastError();
}

// One layer's backward: the walk, then the sums. bf16 picks the storage
// type (0 float, 1 bf16), bt the tile height (4 or 16).
template <bool FUSED>
int backward(int bf16, int bt, const void* in, long long in_sb, long long in_st, int F,
             const void* w_ih_t, const void* w_ih, const void* bias, const void* w_hh_t,
             const void* w_hh, const void* h, const void* c, long long s_sb, long long s_st,
             const void* dh, long long d_sb, long long d_st, void* dg, void* dxg, void* dw,
             void* dx, int B, int steps, int H, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  int err = (int)cudaErrorInvalidValue;
#define TSSEP_WALK(T, BT)                                                                    \
  err = launch_walk<T, BT, FUSED>(in, in_sb, in_st, F, w_ih_t, bias, w_hh_t, w_hh, h, c, s_sb, \
                                  s_st, dh, d_sb, d_st, dg, dxg, B, steps, H, stream)
  if (bf16) {
    if (bt == 16) TSSEP_WALK(__nv_bfloat16, 16);
    if (bt == 4) TSSEP_WALK(__nv_bfloat16, 4);
  } else {
    if (bt == 16) TSSEP_WALK(float, 16);
    if (bt == 4) TSSEP_WALK(float, 4);
  }
#undef TSSEP_WALK
  if (err != cudaSuccess) return err;
  // the fused form's x is `in`; the bidi form has no x rows in its sums
  if (bf16)
    return launch_sums<__nv_bfloat16, FUSED>(in, in_sb, in_st, FUSED ? F : 0, w_ih, h, s_sb,
                                             s_st, dg, dw, dx, B, steps, H, stream);
  return launch_sums<float, FUSED>(in, in_sb, in_st, FUSED ? F : 0, w_ih, h, s_sb, s_st, dg,
                                   dw, dx, B, steps, H, stream);
}

}  // namespace
}  // namespace tssep
