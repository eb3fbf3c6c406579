// blstm_fullfused_spill_bwd: the backward of blstm_fullfused_spill_fwd, from
// x, the saved h, the c boundaries and the cotangent of h, with no saved c
// sequence. Replaces the TPU kernel `_ffs_bwd_kernel`
// (tssep_tpu/kernels/blstm.py:1280, launched by `_ffs_layer_bwd` :1522) and
// computes its function: dx (each direction rounded to the storage type,
// the two summed in f32), dW_ih, dW_hh and db.
//
// Bound on an H100 at birnn0 of a training step at batch 256 (2048 rows,
// T 316, F 513, H 300): operations, those of the fully fused backward (the
// gate pre-activations on storage-type operands, 2.5 TFLOP; dh, the weight
// sums and dx 5.1 TFLOP, which the bf16 route runs as 10.2 TFLOP of exact
// bf16 products, the f32 gate gradients split in two terms).
//
// Two routes, by storage type:
// - bf16, the trained one: the fully fused backward's Hopper design
//   (blstm_cluster_bwd.cuh), the same four launches, with the walk in its
//   spill form: it reads no c but rebuilds c entering each spill block from
//   the block's boundary and the gate pre-activations of the first launch,
//   each thread for its own (unit, row) elements, into shared memory. So
//   the route needs no cells workspace and no launch more than the fully
//   fused backward.
// - f32, the tests' and checks' mode: the first design, below.
//
// The first design. The TPU kernel walked spill blocks in a sequential
// grid, four phases per block in VMEM. Phases 1 and 4 are parallel over
// every (row, step), so on Hopper each is one grid over all B T rows; four
// steps on one stream:
// 1. gates_kernel: every gate pre-activation at once, a tiled product
//    [x | h_prev | 1] [W_ih^T; W_hh^T; b] into an f32 workspace
//    (2, B, T, 4H). h_prev is the saved h, in the storage type, as the
//    forward's recurrent product read it.
// 2. cell_rebuild_kernel: c rebuilt inside each spill block from that
//    block's stored, rounded boundary, c = f c + i g in f32: parallel over
//    (direction, block, row, unit), serial over at most `spill` steps,
//    elementwise only. Written to an f32 workspace (2, B, T, H).
// 3. spill_walk_kernel: the reverse walk, one block per (batch tile,
//    direction) as in blstm_bwd_common.cuh, carrying dh and dc. Its only
//    product is dh = dgates W_hh; the gates come from step 1, so the serial
//    chain streams one weight matrix per step where the fully fused
//    backward's walk streams three. The dgates overwrite the gate workspace.
// 4. the fully fused backward's sums (blstm_bwd_common.cuh): wgrad_kernel
//    for [dW_ih^T; dW_hh^T; db] and dx_kernel for dx.
// Every product runs on the CUDA cores in f32 there (79 ms of operations
// at 67 TFLOP/s for the shape above).
// No atomics in either route: the same bits every run.
#include "blstm_bwd_common.cuh"
#include "blstm_cluster_bwd.cuh"

namespace tssep {
namespace {

// gates[d] (K, N) f32 = A_d (K, M) [W_ih^T; W_hh^T; b]_d (M, N), K = B T
// rows k = (b, t), N = 4H, M = F + H + 1, A_d = [x | h_prev | 1] (a_value).
template <typename T>
__global__ void __launch_bounds__(256)
gates_kernel(const T* __restrict__ x, long long x_sb, long long x_st, int F,
             const T* __restrict__ w_ih_t, const float* __restrict__ bias,
             const T* __restrict__ w_hh_t, const T* __restrict__ h, long long s_sb,
             long long s_st, int H, float* __restrict__ gates, int B, int steps) {
  __shared__ float As[GK][GM + 1];  // As[m][k]; +1 spreads the transposing stores over banks
  __shared__ __align__(16) float Bs[GK][GN];
  const int d = blockIdx.z;
  const long long k0 = (long long)blockIdx.x * GM;
  const int n0 = blockIdx.y * GN;
  const int M = F + H + 1;
  const int N = 4 * H;
  const long long K = (long long)B * steps;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};

  for (int m0 = 0; m0 < M; m0 += GK) {
    for (int e = tid; e < GK * GM; e += 256) {
      const int kk = e / GK, mm = e % GK;  // mm fastest: x rows are contiguous in m
      const long long k = k0 + kk;
      const int m = m0 + mm;
      float v = 0.f;
      if (k < K && m < M) {
        const int b = (int)(k / steps);
        const int t = (int)(k - (long long)b * steps);
        v = a_value<T, false>(x, x_sb, x_st, F, nullptr, 1, h, s_sb, s_st, H, d, d == 1, b, t,
                              m, steps);
      }
      As[mm][kk] = v;
    }
    for (int e = tid; e < GK * GN; e += 256) {
      const int mm = e / GN, nn = e % GN;
      const int m = m0 + mm, n = n0 + nn;
      float v = 0.f;
      if (m < M && n < N) {
        if (m < F)
          v = to_f32(w_ih_t[((size_t)d * F + m) * N + n]);
        else if (m < F + H)
          v = to_f32(w_hh_t[((size_t)d * H + (m - F)) * N + n]);
        else
          v = bias[d * N + n];
      }
      Bs[mm][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < GK; ++mm) {
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[mm][tx * 4]);
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = As[mm][ty * 4 + i];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a, bw[q], acc[i][q]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long k = k0 + ty * 4 + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      if (k < K && n < N) gates[((size_t)d * K + k) * N + n] = acc[i][q];
    }
  }
}

// cells (2, B, T, H) f32: c after each step, rebuilt from the boundaries cb
// (2, nblk, B, H) in T. One thread per (direction, block, row, unit), unit
// fastest; direction 1 walked t = T-1 .. 0.
template <typename T>
__global__ void __launch_bounds__(256)
cell_rebuild_kernel(const float* __restrict__ gates, const T* __restrict__ cb,
                    float* __restrict__ cells, int B, int steps, int H, int spill) {
  const int nblk = (steps + spill - 1) / spill;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2LL * nblk * B * H) return;
  const int j = (int)(i % H);
  long long r = i / H;
  const int b = (int)(r % B);
  r /= B;
  const int blk = (int)(r % nblk);
  const int d = (int)(r / nblk);
  const size_t row = (size_t)d * B + b;
  const int G = 4 * H;
  float c = to_f32(cb[i]);
  const int end = min(steps, (blk + 1) * spill);
  for (int s = blk * spill; s < end; ++s) {
    const int t = d ? steps - 1 - s : s;
    const float* g = gates + (row * steps + t) * G + j;
    c = sigmoid_f(g[H]) * c + sigmoid_f(g[0]) * tanhf(g[2 * H]);
    cells[(row * steps + t) * H + j] = c;
  }
}

// The reverse walk: one block per (batch tile of BT rows, direction), thread
// j owns unit j. gates (2, B, T, 4H) holds the pre-activations and receives
// the gate gradients; cells from cell_rebuild_kernel; c_prev at a block's
// first step is its stored boundary, as the rebuild started from it. dh
// (B, T, 2H) in T with strides (d_sb, d_st, 1); w_hh (2, 4H, H).
template <typename T, int BT>
__global__ void __launch_bounds__(512)
spill_walk_kernel(const T* __restrict__ w_hh, const T* __restrict__ cb,
                  const T* __restrict__ dh, long long d_sb, long long d_st,
                  float* __restrict__ gates, const float* __restrict__ cells, int B, int steps,
                  int H, int spill) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* dh_s = smem;              // (H, BT): carried dh, own thread only
  float* dc_s = dh_s + H * BT;     // (H, BT): carried dc, own thread only
  float* dg_buf = dc_s + H * BT;   // 2 x (4H, BT): the step's gate gradients,
                                   // alternating so one barrier a step will do

  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int j = threadIdx.x;
  const int G = 4 * H;
  const bool active = j < H;
  const int nblk = (steps + spill - 1) / spill;
  const T* whh = w_hh + (size_t)dir * G * H + j;

  if (active) {
#pragma unroll
    for (int r = 0; r < BT; ++r) dh_s[j * BT + r] = dc_s[j * BT + r] = 0.f;
  }

  for (int s = steps - 1; s >= 0; --s) {
    const int t = dir ? steps - 1 - s : s;
    const int tp = dir ? t + 1 : t - 1;
    const bool first_in_block = s % spill == 0;
    float* dg_s = dg_buf + (s & 1) * G * BT;
    if (active) {
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const int b = b0 + r;
        const bool real = b < B;
        const size_t row = (size_t)dir * B + (real ? b : 0);
        float* gp = gates + (row * steps + t) * G + j;
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) pre[g] = real ? gp[g * H] : 0.f;
        const float ct = real ? cells[(row * steps + t) * H + j] : 0.f;
        float cp = 0.f;
        if (real)
          cp = first_in_block
                   ? to_f32(cb[((size_t)(dir * nblk + s / spill) * B + b) * H + j])
                   : cells[(row * steps + tp) * H + j];
        const float dhv =
            dh_s[j * BT + r] + (real ? to_f32(dh[b * d_sb + t * d_st + dir * H + j]) : 0.f);
        const float ig = sigmoid_f(pre[0]);
        const float fg = sigmoid_f(pre[1]);
        const float gg = tanhf(pre[2]);
        const float og = sigmoid_f(pre[3]);
        const float tc = tanhf(ct);
        const float dcv = dc_s[j * BT + r] + dhv * og * (1.f - tc * tc);
        const float dgv[4] = {dcv * gg * ig * (1.f - ig), dcv * cp * fg * (1.f - fg),
                              dcv * ig * (1.f - gg * gg), dhv * tc * og * (1.f - og)};
        dc_s[j * BT + r] = dcv * fg;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          dg_s[(g * H + j) * BT + r] = dgv[g];
          if (real) gp[g * H] = dgv[g];
        }
      }
    }
    __syncthreads();  // dg_s is complete

    if (active && s > 0) {
      float acc1[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc1[r] = 0.f;
      accumulate1<T, BT>(acc1, dg_s, whh, G, H);  // dh_prev[j] = sum_g dg[g] W_hh[g, j]
#pragma unroll
      for (int r = 0; r < BT; ++r) dh_s[j * BT + r] = acc1[r];
    }
    // No barrier here: the next step writes the other half of dg_buf, and
    // this half only after the next step's barrier.
  }
}

template <typename T, int BT>
int launch_spill_walk(const void* w_hh, const void* cb, const void* dh, long long d_sb,
                      long long d_st, void* gates, const void* cells, int B, int steps, int H,
                      int spill, cudaStream_t stream) {
  const dim3 grid((B + BT - 1) / BT, 2);
  const int threads = ((H + 31) / 32) * 32;
  const size_t smem = sizeof(float) * BT * 10 * H;
  auto kernel = spill_walk_kernel<T, BT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(w_hh), static_cast<const T*>(cb), static_cast<const T*>(dh), d_sb,
      d_st, static_cast<float*>(gates), static_cast<const float*>(cells), B, steps, H, spill);
  return (int)cudaGetLastError();
}

template <typename T>
int spill_backward(int bt, const void* x, long long x_sb, long long x_st, int F,
                   const void* w_ih_t, const void* w_ih, const void* bias, const void* w_hh_t,
                   const void* w_hh, const void* h, long long s_sb, long long s_st,
                   const void* cb, const void* dh, long long d_sb, long long d_st, void* gates,
                   void* cells, void* dw, void* dx, int B, int steps, int H, int spill,
                   cudaStream_t stream) {
  const long long K = (long long)B * steps;
  const dim3 ggrid((unsigned)((K + GM - 1) / GM), (4 * H + GN - 1) / GN, 2);
  gates_kernel<T><<<ggrid, 256, 0, stream>>>(
      static_cast<const T*>(x), x_sb, x_st, F, static_cast<const T*>(w_ih_t),
      static_cast<const float*>(bias), static_cast<const T*>(w_hh_t), static_cast<const T*>(h),
      s_sb, s_st, H, static_cast<float*>(gates), B, steps);
  int err = (int)cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long n = 2LL * ((steps + spill - 1) / spill) * B * H;
  cell_rebuild_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(gates), static_cast<const T*>(cb), static_cast<float*>(cells), B,
      steps, H, spill);
  err = (int)cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = (int)cudaErrorInvalidValue;
  if (bt == 16)
    err = launch_spill_walk<T, 16>(w_hh, cb, dh, d_sb, d_st, gates, cells, B, steps, H, spill,
                                   stream);
  if (bt == 4)
    err = launch_spill_walk<T, 4>(w_hh, cb, dh, d_sb, d_st, gates, cells, B, steps, H, spill,
                                  stream);
  if (err != cudaSuccess) return err;

  return launch_sums<T, true, false>(x, x_sb, x_st, F, nullptr, 1, w_ih, h, s_sb, s_st, gates,
                                     dw, dx, B, steps, H, stream);
}

}  // namespace
}  // namespace tssep

// x (B, T, F) with strides (x_sb, x_st, 1); w_ih_t (2, F, 4H) and w_ih
// (2, 4H, F), w_hh_t (2, H, 4H) and w_hh (2, 4H, H), all in the storage type;
// bias (2, 4H) f32; h (B, T, 2H) from the forward with strides
// (s_sb, s_st, 1); cb (2, ceil(T / spill), B, H) in the storage type,
// contiguous; dh (B, T, 2H) in the storage type with strides (d_sb, d_st, 1).
// Writes the workspaces gates (2, B, T, 4H) and cells (2, B, T, H), f32; dw
// (2, F + H + 1, 4H) f32 = [dW_ih^T; dW_hh^T; db] per direction; dx
// (B, T, F) f32; all contiguous. Returns a cudaError_t.
extern "C" int tssep_blstm_fullfused_spill_bwd(
    const void* x, long long x_sb, long long x_st, int F, const void* w_ih_t, const void* w_ih,
    const void* bias, const void* w_hh_t, const void* w_hh, const void* h, long long s_sb,
    long long s_st, const void* cb, const void* dh, long long d_sb, long long d_st, void* gates,
    void* cells, void* dw, void* dx, int B, int T, int H, int spill, int bf16, int bt,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return tssep::spill_backward<__nv_bfloat16>(bt, x, x_sb, x_st, F, w_ih_t, w_ih, bias,
                                                w_hh_t, w_hh, h, s_sb, s_st, cb, dh, d_sb, d_st,
                                                gates, cells, dw, dx, B, T, H, spill, st);
  return tssep::spill_backward<float>(bt, x, x_sb, x_st, F, w_ih_t, w_ih, bias, w_hh_t, w_hh, h,
                                      s_sb, s_st, cb, dh, d_sb, d_st, gates, cells, dw, dx, B, T,
                                      H, spill, st);
}

// The bf16 route. x (B, T, F) with strides (x_sb, x_st, 1); w_ih_t
// (2, F, 4H) and w_hh_t (2, H, 4H) bf16; bias (2, 4H) f32; wp: the CTA
// slices of W_hh^T in the walk's fragment order (kernels/blstm.py
// `_pack_walk`); h (B, T, 2H) bf16 with strides (s_sb, s_st, 1); cb
// (2, ceil(T / spill), B, H) bf16 contiguous; dh (B, T, 2H) bf16 with
// strides (d_sb, d_st, 1). Writes the workspace dg (2, B, T, 4H) f32, dw
// (2, F + H + 1, 4H) f32 = [dW_ih^T; dW_hh^T; db] and dx (B, T, F) f32.
// The walk runs in clusters of C CTAs of `threads` threads, U units each,
// `nact` of them owning any, bt rows a tile (kernels/blstm.py geometry kind
// 'bwd_spill'). The weight sums cut the B T rows into `splits` ranges
// (their partials in dx's memory). `parts` picks the launches (1 gates,
// 2 walk, 4 weight sums, 8 dx; 15 all), so that each can be timed alone.
// Returns a cudaError_t.
extern "C" int tssep_blstm_fullfused_spill_bwd_cluster(
    const void* x, long long x_sb, long long x_st, int F, const void* w_ih_t,
    const void* w_hh_t, const void* bias, const void* wp, const void* h, long long s_sb,
    long long s_st, const void* cb, const void* dh, long long d_sb, long long d_st, void* dg,
    void* dw, void* dx, int B, int T, int H, int spill, int C, int U, int nact, int bt,
    int threads, int splits, int parts, void* stream) {
  return tssep::tc::projection_backward<true>(
      x, x_sb, x_st, F, w_ih_t, w_hh_t, bias, wp, h, nullptr, s_sb, s_st, cb, spill, dh, d_sb,
      d_st, dg, dw, dx, B, T, H, C, U, nact, bt, threads, splits, parts,
      static_cast<cudaStream_t>(stream));
}

// Clusters of C CTAs of the spill walk at row tile bt, each of `threads`
// threads and `smem` shared bytes, that the card holds at once, into
// `slots`. Returns a cudaError_t.
extern "C" int tssep_spill_walk_slots(int C, int bt, int threads, int smem, int* slots) {
  using namespace tssep::tc;
  return cluster_slots(walk_kernel<__nv_bfloat16, true>(bt), threads, (size_t)smem, C, slots);
}
