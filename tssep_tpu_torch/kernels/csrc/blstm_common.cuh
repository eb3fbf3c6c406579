// Shared body of the five forward LSTM kernels (blstm_fullfused_fwd.cu,
// blstm_fullfused_cond_fwd.cu, blstm_fullfused_spill_fwd.cu,
// blstm_bidi_fwd.cu and lstm_fwd.cu): one bidirectional LSTM layer, or one
// direction of it, gate order i, f, g, o (torch layout), carries and
// accumulation in f32, streamed tensors in the storage type T (float or
// bf16).
//
// Work split: one block per (batch tile of BT rows, direction). Thread j owns
// hidden unit j, all four of its gates, for the BT rows of the tile, so the
// cell update needs no exchange between threads: only the new h is shared,
// through shared memory, before the next step. The block walks the time axis
// itself (the reverse direction from T-1 down to 0), so a sequence of any
// length needs no padding and the reverse direction reads its input in place.
//
// What bounds it on an H100: W_hh^T (H x 4H) and, in the fused form, W_ih^T
// (F x 4H) do not fit in one SM's 227 KB of shared memory (720 KB and 1.2 MB
// in bf16 at the flagship widths), so every block streams them from the 50 MB
// L2, where they stay resident, once per step. The products run on the CUDA
// cores in f32. Each weight value read is used BT times from registers (BT
// rows), so a wider tile moves fewer L2 bytes per FLOP but gives fewer blocks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tssep {
namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// Element k of input row b at time t. Plain: in[b, t, k]. COND ('mul'
// conditioning formed on the fly): row b = b_x S + s is speaker s of batch
// row b_x, in[b_x, t, k] * aux[b, k] with aux (B S, F) contiguous, the
// product rounded to T as the materialized xs[:, None] * aux[:, :, None]
// is (one rounding: the product of two bf16 values is exact in f32).
template <typename T, bool COND>
__device__ __forceinline__ float row_value(const T* __restrict__ in, long long in_sb,
                                           long long in_st, const T* __restrict__ aux, int S,
                                           int F, int b, int t, int k) {
  if constexpr (COND) {
    const float xv = to_f32(in[(b / S) * in_sb + t * in_st + k]);
    return to_f32(from_f32<T>(xv * to_f32(aux[(size_t)b * F + k])));
  } else {
    return to_f32(in[b * in_sb + t * in_st + k]);
  }
}

// Stages the input rows b0 .. b0 + BT - 1 at time t into x_s (F, BT) f32,
// coalesced along k; rows past B read as zeros and are never stored.
template <typename T, int BT, bool COND>
__device__ __forceinline__ void load_rows(float* x_s, const T* __restrict__ in, long long in_sb,
                                          long long in_st, const T* __restrict__ aux, int S,
                                          int F, int b0, int B, int t) {
  for (int i = threadIdx.x; i < F * BT; i += blockDim.x) {
    const int r = i / F;
    const int k = i - r * F;
    const int b = b0 + r;
    x_s[k * BT + r] = b < B ? row_value<T, COND>(in, in_sb, in_st, aux, S, F, b, t, k) : 0.f;
  }
}

// Adds sum_k src[k, r] * w[k * G + g * H] to acc[g][r]: one column of the
// gate matrix for each of the four gates, all BT rows. src is (K, BT) f32 in
// shared memory; w points at column j of a (K, 4H) matrix in global memory.
template <typename T, int BT>
__device__ __forceinline__ void accumulate(float (&acc)[4][BT], const float* src,
                                           const T* __restrict__ w, int K, int G, int H) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const T* wk = w + (size_t)k * G;
    const float w0 = to_f32(wk[0]);
    const float w1 = to_f32(wk[H]);
    const float w2 = to_f32(wk[2 * H]);
    const float w3 = to_f32(wk[3 * H]);
    const float4* s4 = reinterpret_cast<const float4*>(src + k * BT);
#pragma unroll
    for (int q = 0; q < BT / 4; ++q) {
      const float4 v = s4[q];
      const float vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[0][4 * q + e] = fmaf(w0, vr[e], acc[0][4 * q + e]);
        acc[1][4 * q + e] = fmaf(w1, vr[e], acc[1][4 * q + e]);
        acc[2][4 * q + e] = fmaf(w2, vr[e], acc[2][4 * q + e]);
        acc[3][4 * q + e] = fmaf(w3, vr[e], acc[3][4 * q + e]);
      }
    }
  }
}

// FUSED: `in` is x (B, T, F) with strides (in_sb, in_st, 1); the gates start
//        from bias (2, 4H) f32 plus x_t @ W_ih^T computed here (w_ih_t is
//        (2, F, 4H)). With COND the B rows are B / S batch rows times S
//        speakers, `in` is xs (B / S, T, F) and aux (B, F) (row_value).
// else:  `in` is xg (B, T, 8H) with strides (in_sb, in_st, 1): direction d's
//        precomputed input gates are columns [4H d, 4H (d + 1)).
// All:   w_hh_t (2, H, 4H); h_out, c_out (B, T, 2H) with strides
//        (out_sb, out_st, 1), forward direction in [0, H), reverse in [H, 2H),
//        both in original time order. c_out may be null.
// One direction (gridDim.y == 1): the same with 4H gate columns, w_hh_t
//        (1, H, 4H) and outputs (B, T, H); rev0 = 1 walks it in reverse.
// Spill:  cb_out (ndir, ceil(steps / spill), B, H), contiguous, receives the
//        c carry entering every spill'th step of each walk, rounded to T
//        (slot 0 is the initial state); null writes none.
// State:  h0, c0 (ndir, B, H), contiguous, in T: the carry each walk starts
//        from (a streaming session's state, JAX `_lstm_scan`'s h0, c0); null
//        starts from zeros, the launch of every layer that is not streamed.
template <typename T, int BT, bool FUSED, bool COND>
__global__ void __launch_bounds__(512)
blstm_fwd_kernel(const T* __restrict__ in, long long in_sb, long long in_st, int F,
                 const T* __restrict__ aux, int S, const T* __restrict__ w_ih_t,
                 const float* __restrict__ bias,
                 const T* __restrict__ w_hh_t, T* __restrict__ h_out, T* __restrict__ c_out,
                 long long out_sb, long long out_st, int B, int steps, int H, int rev0,
                 T* __restrict__ cb_out, int spill, const T* __restrict__ h0,
                 const T* __restrict__ c0) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* h_s = smem;            // (H, BT): h of the previous step, rounded to T
  float* c_s = h_s + H * BT;    // (H, BT): c, f32; only its own thread reads it
  float* x_s = c_s + H * BT;    // (F, BT): x_t of the tile, FUSED only

  const int dir = blockIdx.y;
  const bool rev = dir + rev0 == 1;
  const int b0 = blockIdx.x * BT;
  const int j = threadIdx.x;
  const int G = 4 * H;
  const bool active = j < H;
  const T* whh = w_hh_t + (size_t)dir * H * G + j;

  for (int i = threadIdx.x; i < 2 * H * BT; i += blockDim.x) smem[i] = 0.f;
  if (h0 != nullptr) {
    __syncthreads();  // the zeros are in place; rows past B keep them
    for (int i = threadIdx.x; i < H * BT; i += blockDim.x) {
      const int k = i / BT, b = b0 + i - k * BT;
      if (b < B) {
        h_s[i] = to_f32(h0[((size_t)dir * B + b) * H + k]);
        c_s[i] = to_f32(c0[((size_t)dir * B + b) * H + k]);
      }
    }
  }

  for (int s = 0; s < steps; ++s) {
    const int t = rev ? steps - 1 - s : s;
    if constexpr (FUSED) load_rows<T, BT, COND>(x_s, in, in_sb, in_st, aux, S, F, b0, B, t);
    __syncthreads();  // x_s and the previous step's h_s are complete

    if (cb_out != nullptr && active && s % spill == 0) {
      const int nblk = (steps + spill - 1) / spill;
      T* cb = cb_out + ((size_t)(dir * nblk + s / spill) * B + b0) * H + j;
#pragma unroll
      for (int r = 0; r < BT; ++r)
        if (b0 + r < B) cb[(size_t)r * H] = from_f32<T>(c_s[j * BT + r]);
    }

    float acc[4][BT];
    if (active) {
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
      accumulate<T, BT>(acc, h_s, whh, H, G, H);
    }
    __syncthreads();  // every thread is done reading h_s and x_s

    if (active) {
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float ig = sigmoid_f(acc[0][r]);
        const float fg = sigmoid_f(acc[1][r]);
        const float gg = tanhf(acc[2][r]);
        const float og = sigmoid_f(acc[3][r]);
        const float c = fg * c_s[j * BT + r] + ig * gg;
        const T hq = from_f32<T>(og * tanhf(c));
        c_s[j * BT + r] = c;
        h_s[j * BT + r] = to_f32(hq);  // the recurrent product reads h in T
        const int b = b0 + r;
        if (b < B) {
          const long long o = b * out_sb + t * out_st + dir * H + j;
          h_out[o] = hq;
          if (c_out != nullptr) c_out[o] = from_f32<T>(c);
        }
      }
    }
  }
}

// Launches one layer (ndir directions) on `stream`; returns the launch's
// cudaError_t.
template <typename T, int BT, bool FUSED, bool COND>
int launch(const void* in, long long in_sb, long long in_st, int F, const void* aux, int S,
           const void* w_ih_t, const void* bias, const void* w_hh_t, void* h_out, void* c_out,
           long long out_sb, long long out_st, int B, int steps, int H, void* stream, int ndir,
           int rev0, void* cb_out, int spill, const void* h0, const void* c0) {
  const dim3 grid((B + BT - 1) / BT, ndir);
  const int threads = ((H + 31) / 32) * 32;
  const size_t smem = sizeof(float) * BT * (2 * H + (FUSED ? F : 0));
  auto kernel = blstm_fwd_kernel<T, BT, FUSED, COND>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), in_sb, in_st, F, static_cast<const T*>(aux), S,
      static_cast<const T*>(w_ih_t), static_cast<const float*>(bias),
      static_cast<const T*>(w_hh_t), static_cast<T*>(h_out), static_cast<T*>(c_out), out_sb,
      out_st, B, steps, H, rev0, static_cast<T*>(cb_out), spill, static_cast<const T*>(h0),
      static_cast<const T*>(c0));
  return (int)cudaGetLastError();
}

// Picks the storage type (0 float, 1 bf16) and the tile height (4 or 16).
// Both directions unless ndir is 1 (then rev0 picks the direction); cb_out,
// spill, h0 and c0 as for blstm_fwd_kernel.
template <bool FUSED, bool COND>
int dispatch(int bf16, int bt, const void* in, long long in_sb, long long in_st, int F,
             const void* aux, int S, const void* w_ih_t, const void* bias, const void* w_hh_t,
             void* h_out, void* c_out, long long out_sb, long long out_st, int B, int steps,
             int H, void* stream, int ndir = 2, int rev0 = 0, void* cb_out = nullptr,
             int spill = 1, const void* h0 = nullptr, const void* c0 = nullptr) {
#define TSSEP_LAUNCH(T, BT)                                                                 \
  return launch<T, BT, FUSED, COND>(in, in_sb, in_st, F, aux, S, w_ih_t, bias, w_hh_t, h_out, \
                                    c_out, out_sb, out_st, B, steps, H, stream, ndir, rev0,   \
                                    cb_out, spill, h0, c0)
  if (bf16) {
    if (bt == 16) TSSEP_LAUNCH(__nv_bfloat16, 16);
    if (bt == 4) TSSEP_LAUNCH(__nv_bfloat16, 4);
  } else {
    if (bt == 16) TSSEP_LAUNCH(float, 16);
    if (bt == 4) TSSEP_LAUNCH(float, 4);
  }
#undef TSSEP_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace tssep
