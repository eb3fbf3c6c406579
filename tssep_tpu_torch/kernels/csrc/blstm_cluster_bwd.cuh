// The Hopper design of the bidirectional LSTM backward (bf16 storage), in three
// forms:
// - projection: the fully fused backward. Replaces, with
//   blstm_fullfused_bwd.cu, the TPU kernel `_ff_bwd_kernel`
//   (tssep_tpu/kernels/blstm.py:861). Four launches on one stream (1-4).
// - conditioned projection: the backward of the 'mul'-conditioned layer,
//   whose row b is xs row b / S times aux row b (template parameter COND of
//   the rows that steps 1 and 3 read: each conditioned value formed as the
//   forward staged it, rounded to bf16 once). Replaces, with
//   blstm_fullfused_cond_bwd.cu, the TPU kernel `_ffc_bwd_kernel` (:1707).
//   Steps 1-3 as the projection form's over the B S rows; step 4 is dcond
//   (DcondOp), which blstm_fullfused_cond_bwd.cu then splits into dx and
//   daux.
// - spill: the backward of the spill forward, from h and the c carry
//   entering every spill'th step instead of the c sequence. Replaces, with
//   blstm_fullfused_spill_bwd.cu, the TPU kernel `_ffs_bwd_kernel` (:1280).
//   The projection form's four launches, the walk in its spill form
//   (template parameter SPILL): it rebuilds each spill block's c from the
//   block's boundary and the pre-activations of step 1 as it enters the
//   block.
// - gate inputs: the backward of the walk from gate inputs xg. Replaces,
//   with blstm_bidi_bwd.cu, the TPU kernel `_bi_bwd_kernel` (:424). Three
//   launches (1-3): the gate product sums over h_prev alone (K = H) and adds
//   xg in its epilogue where the other form adds the bias, the walk also
//   writes dxg (B, T, 8H) in the storage type from its f32 gate gradients
//   and takes dh in f32, the weight sums are dW_hh^T alone, and there is no
//   dx (dx, dW_ih and db are products of dxg outside the kernels).
//
// 1. gates: every gate pre-activation at once, [x | h_prev] [W_ih^T; W_hh^T]
//    + b for all (row, step) and both directions, on the tensor cores (bf16
//    operands, f32 sums, as the forward formed them and as JAX's backward
//    recomputes them), into the f32 workspace dg (2, B, T, 4H).
// 2. walk: the serial part, carrying only dh and dc. One cluster of C CTAs
//    per (row tile, direction); CTA r owns the hidden units [r U, r U + U)
//    as in the forward (blstm_cluster.cuh). At each step a CTA reads its
//    units' pre-activations from dg, forms the f32 gate gradients and
//    writes them over them, then multiplies them by its slice of W_hh
//    (resident in shared memory, the same 90 KB as the forward's at H 300)
//    on the tensor cores: a partial dh_prev over all H units from its own 4U
//    gate rows. The f32 gate gradients enter the bf16 products as the split
//    hi + lo (both products exact, summed in f32: relative error ~2^-18).
//    Each CTA sends the partial of CTA p's units to p through distributed
//    shared memory (st.async, counted in bytes on p's mbarrier); p adds the
//    C partials in CTA order, so every run gives the same bits. Bytes a CTA
//    sends per step: H x BT x 4 (19 KB at H 300, BT 16), against
//    4U x BT x 4 x (C - 1) (72 KB) had the gate gradients been gathered
//    instead. The split gate gradients are double-buffered, so one barrier
//    a step suffices.
// 3. wgrad: [dW_ih^T; dW_hh^T; db] = [x | h_prev | 1]^T dg per direction,
//    on the tensor cores with dg split as above; each output tile sums its
//    B T rows itself in a fixed order (no atomics). Where the output's tiles
//    would leave most of a second wave of SMs idle, the rows are cut into
//    ranges whose partial sums go to a workspace (the projection form: the
//    dx buffer, written only by step 4) and are added in range order by a
//    second pass.
// 4. dx: sum over the directions of round_bf16(dg_d W_ih,d), each
//    direction's product rounded to bf16 and the two summed in f32, as the
//    TPU kernel wrote dx per direction in the storage type; dg split as
//    above. Conditioned form: dcond = dg_0 W_ih,0 + dg_1 W_ih,1 as one
//    product with both directions in its K (8H), summed in f32 and not
//    rounded, as `_ffc_layer_bwd` keeps both directions' dx in f32 and
//    rounds once after the sum over the speakers.
//
// The walk's geometry (C, U, BT, threads) comes from `cluster_geometry` in
// kernels/blstm.py (kind 'bwd', for every form but spill, whose kind
// 'bwd_spill' adds the rebuilt c to its shared memory); `walk_shared_bytes`
// is its `_walk_shared`.
#pragma once

#include <type_traits>

#include "blstm_cluster.cuh"

namespace tssep {
namespace {
namespace tc {

// ---- tiled tensor-core product -------------------------------------------
//
// out (M, N) = A (M, K) B (K, N) over 128 x 128 tiles of 8 warps (2 x 4, each
// 64 x 32: 4 x 4 m16n8 tiles, fragments by ldmatrix), K in blocks of 32, the
// next block's elements loaded into registers while the current one is
// multiplied. An operation Op gives the elements (`a`, `b`: bf16 as stored,
// or f32 to split into A_TERMS or B_TERMS = 2 bf16 terms; zero outside the
// matrix), says which index runs along memory (A_K_FAST, B_K_FAST) so
// that loads are coalesced, gives each CTA its K range (`k_begin`,
// `k_end`), and stores the result (`store`, once per pass; PASSES > 1 runs
// the whole product again for each pass, as dx does per direction). Where
// A's rows come from the (B, T) rows of x and h, a table of row offsets in
// shared memory (A_TABLE 1: the tile's M rows, computed once; 2: each K
// block's rows, computed a block ahead) spares each element the division by
// T.

constexpr int kGM = 128, kGN = 128, kGK = 32, kGS = kGK + 8;

// Where row k = (b, t) of one direction's [x | h_prev] starts: x at `x`,
// h_prev at `h`, or -1 where the row or its h_prev does not exist; in the
// conditioned form aux row b at `a`.
struct RowPtr {
  long long x, h, a;
};

template <int TERMS>
using Elem = typename std::conditional<(TERMS > 1), float, __nv_bfloat16>::type;

// A conditioned element as loaded, bf16 x and aux, kept apart in registers
// until the element is stored to shared memory (`value`), so that the
// product waits for neither load: the next block's loads stay in flight
// behind the current block's products.
struct BfPair {
  __nv_bfloat16 x, a;
};

// An element as loaded, as it enters the tile: the conditioned pair's
// product rounded to bf16 once (the product of two bf16 values is exact in
// f32); anything else as it is.
__device__ __forceinline__ float value(float v) { return v; }
__device__ __forceinline__ __nv_bfloat16 value(__nv_bfloat16 v) { return v; }
__device__ __forceinline__ __nv_bfloat16 value(BfPair p) {
  unsigned short r;  // the exact product rounded to nearest once, as the forward's
  asm("mul.rn.bf16 %0, %1, %2;\n"
      : "=h"(r)
      : "h"(__bfloat16_as_ushort(p.x)), "h"(__bfloat16_as_ushort(p.a)));
  return __ushort_as_bfloat16(r);
}

// Element v of a tile into its term planes p[0], p[plane] (i: its index).
template <int TERMS>
__device__ __forceinline__ void put(Elem<TERMS> v, __nv_bfloat16* p, int i, int plane) {
  static_assert(TERMS == 1 || TERMS == 2, "one bf16 term, or the two-term split");
  if constexpr (TERMS == 2) {
    split(v, p[i], p[plane + i]);
  } else {
    p[i] = v;
  }
}

template <class Op>
__global__ void __launch_bounds__(256, Op::MIN_BLOCKS) tc_gemm_kernel(const Op op) {
  constexpr int PA = Op::A_TERMS, PB = Op::B_TERMS;
  constexpr int TAB = Op::A_TABLE;
  __shared__ __align__(16) __nv_bfloat16 As[PA][kGM * kGS];
  __shared__ __align__(16) __nv_bfloat16 Bs[PB][kGN * kGS];
  __shared__ RowPtr tab[TAB == 1 ? kGM : 2 * kGK];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q = lane >> 2, tq = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
  // the (row, column) of this thread's i'th element of each tile
  const int a_r = Op::A_K_FAST ? tid / kGK : tid % kGM;
  const int a_c = Op::A_K_FAST ? tid % kGK : tid / kGM;
  const int b_r = Op::B_K_FAST ? tid / kGK : tid % kGN;
  const int b_c = Op::B_K_FAST ? tid % kGK : tid / kGN;
  constexpr int A_DR = Op::A_K_FAST ? 256 / kGK : 0, A_DC = Op::A_K_FAST ? 0 : 256 / kGM;
  constexpr int B_DR = Op::B_K_FAST ? 256 / kGK : 0, B_DC = Op::B_K_FAST ? 0 : 256 / kGN;
  const long long kb = op.k_begin(z), K = op.k_end(z);  // this CTA's K range

  if constexpr (TAB == 1) {
    for (int i = tid; i < kGM; i += 256) tab[i] = op.row_ptr(z, m0 + i);
  }
  for (int pass = 0; pass < Op::PASSES; ++pass) {
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

    if constexpr (TAB == 2) {
      if (tid < kGK) tab[((kb / kGK) & 1) * kGK + tid] = op.row_ptr(z, kb + tid);
    }
    __syncthreads();
    decltype(op.a(z, pass, 0LL, 0LL, RowPtr{})) ra[16];  // Elem<PA>, or pairs (value)
    Elem<PB> rb[16];
    auto load = [&](long long k0) {
      const RowPtr* t = TAB == 2 ? tab + ((k0 / kGK) & 1) * kGK : tab;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = a_r + i * A_DR, c = a_c + i * A_DC;
        ra[i] = op.a(z, pass, m0 + r, k0 + c, t[TAB == 1 ? r : (TAB == 2 ? c : 0)]);
        rb[i] = op.b(z, pass, k0 + b_c + i * B_DC, n0 + b_r + i * B_DR);
      }
    };
    load(kb);
    for (long long k0 = kb; k0 < K; k0 += kGK) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int ai = (a_r + i * A_DR) * kGS + a_c + i * A_DC;
        const int bi = (b_r + i * B_DR) * kGS + b_c + i * B_DC;
        put<PA>(value(ra[i]), As[0], ai, kGM * kGS);
        put<PB>(rb[i], Bs[0], bi, kGN * kGS);
      }
      if constexpr (TAB == 2) {  // the rows of the block after the next load
        if (tid < kGK) tab[((k0 / kGK + 1) & 1) * kGK + tid] = op.row_ptr(z, k0 + kGK + tid);
      }
      __syncthreads();
      if (k0 + kGK < K) load(k0 + kGK);
      // ldmatrix: lane l addresses row l % 8 of matrix l / 8
      const int lr = lane & 7, lm = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < kGK; kk += 16) {
        uint32_t bf[PB][4][2];
#pragma unroll
        for (int p = 0; p < PB; ++p)
#pragma unroll
          for (int j = 0; j < 4; j += 2) {  // n-tiles j, j + 1: b0, b1 of each
            uint32_t r[4];
            ldsm_x4(r, &Bs[p][(wn * 32 + (j + (lm >> 1)) * 8 + lr) * kGS + kk + 8 * (lm & 1)]);
            bf[p][j][0] = r[0];
            bf[p][j][1] = r[1];
            bf[p][j + 1][0] = r[2];
            bf[p][j + 1][1] = r[3];
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int p = 0; p < PA; ++p) {
            uint32_t r[4];  // rows 0-7 / 8-15, columns 0-7 / 8-15 of the m-tile
            ldsm_x4(r, &As[p][(wm * 64 + i * 16 + lr + 8 * (lm & 1)) * kGS + kk + 8 * (lm >> 1)]);
            const uint4 af = make_uint4(r[0], r[1], r[2], r[3]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int pb = 0; pb < PB; ++pb) mma(acc[i][j], af, bf[pb][j][0], bf[pb][j][1]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          op.store(z, pass, m0 + wm * 64 + i * 16 + q + (r >= 2 ? 8 : 0),
                   n0 + wn * 32 + j * 8 + 2 * tq + (r & 1), acc[i][j][r]);
  }
}

template <class Op>
int launch_gemm(const Op& op, int M, int N, int Z, cudaStream_t stream) {
  const dim3 grid((N + kGN - 1) / kGN, (M + kGM - 1) / kGM, Z);
  tc_gemm_kernel<Op><<<grid, 256, 0, stream>>>(op);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ __nv_bfloat16 bf16_zero() { return __float2bfloat16(0.f); }

// The (B, T) rows of one direction's [x | h_prev | 1] (h_prev zero before
// the walk's first step). In the gate-input form F is 0, x is xg and only
// the pointer to a row's xg is read (GatesOp's epilogue). With COND (the
// conditioned form) x is xs, row b's x part is bf16(xs[b / S, t] * aux[b])
// and aux is (B, F) contiguous; an element is then loaded as the pair
// (x, aux), (h, 1) or (1, 1), whose product `value` forms.
template <bool COND>
struct RowsT {
  using Loaded = typename std::conditional<COND, BfPair, __nv_bfloat16>::type;
  const __nv_bfloat16* x;
  long long x_sb, x_st;
  const __nv_bfloat16* h;
  long long s_sb, s_st;
  const __nv_bfloat16* aux;
  int B, T, F, H;
  long long rows;
  FastDiv divT, divS;

  __device__ __forceinline__ RowPtr ptr(int d, long long k) const {
    if (k >= rows) return RowPtr{-1, -1, -1};
    const int b = (int)divT.div((uint32_t)k), t = (int)k - b * T;
    const int tp = d ? t + 1 : t - 1;
    const int xb = COND ? (int)divS.div((uint32_t)b) : b;
    return RowPtr{xb * x_sb + t * x_st,
                  (tp >= 0 && tp < T) ? b * s_sb + tp * s_st + d * H : -1,
                  COND ? (long long)b * F : 0};
  }
  // element m of the row at r; m == F + H is the bias column
  __device__ __forceinline__ Loaded at(const RowPtr& r, int m) const {
    const __nv_bfloat16 one = __float2bfloat16(1.f);
    __nv_bfloat16 v, w = one;
    if (m < F) {
      v = x[r.x + m];
      if constexpr (COND) w = aux[r.a + m];
    } else if (m < F + H) {
      v = r.h >= 0 ? h[r.h + m - F] : bf16_zero();
    } else {
      v = one;
    }
    if constexpr (COND) {
      return BfPair{v, w};
    } else {
      return v;
    }
  }
  __device__ __forceinline__ static Loaded zero() {
    if constexpr (COND) {
      return BfPair{bf16_zero(), bf16_zero()};
    } else {
      return bf16_zero();
    }
  }
};
using Rows = RowsT<false>;

// dg[d] (B T, 4H) = [x | h_prev] [W_ih^T; W_hh^T] + b; with XG (the
// gate-input form, F = 0) h_prev W_hh^T + xg[d], xg added in the epilogue;
// with COND x is the conditioned rows (RowsT).
template <bool XG, bool COND = false>
struct GatesOp {
  static constexpr bool A_K_FAST = true, B_K_FAST = false;
  // two CTAs an SM (at most 128 registers a thread): the loads of one hide
  // behind the other's products, 1.4x at birnn0's 128 rows
  static constexpr int A_TERMS = 1, B_TERMS = 1, PASSES = 1, A_TABLE = 1, MIN_BLOCKS = 2;
  RowsT<COND> rows;
  const __nv_bfloat16* w_ih_t;  // (2, F, 4H)
  const __nv_bfloat16* w_hh_t;  // (2, H, 4H)
  const float* bias;            // (2, 4H); null with XG
  float* dg;
  long long M;
  int N, K;

  __device__ __forceinline__ long long k_begin(int) const { return 0; }
  __device__ __forceinline__ long long k_end(int) const { return K; }
  __device__ __forceinline__ RowPtr row_ptr(int d, long long m) const { return rows.ptr(d, m); }
  __device__ __forceinline__ typename RowsT<COND>::Loaded a(int, int, long long m, long long k,
                                                          const RowPtr& r) const {
    return (m < M && k < K) ? rows.at(r, (int)k) : RowsT<COND>::zero();
  }
  __device__ __forceinline__ __nv_bfloat16 b(int d, int, long long k, int n) const {
    if (k >= K || n >= N) return bf16_zero();
    const int F = rows.F;
    return k < F ? w_ih_t[((size_t)d * F + k) * N + n]
                 : w_hh_t[((size_t)d * rows.H + (k - F)) * N + n];
  }
  __device__ __forceinline__ void store(int d, int, long long m, int n, float v) const {
    if (m >= M || n >= N) return;
    if constexpr (XG) {
      v += __bfloat162float(rows.x[rows.ptr(d, m).x + (long long)d * N + n]);
    } else {
      v += bias[d * N + n];
    }
    dg[((size_t)d * M + m) * N + n] = v;
  }
};

// out[d] (M, 4H) = [x | h_prev | 1]^T dg[d], M = F + H + 1 (projection
// form) or H (gate-input form: dW_hh^T alone). With `splits` > 1 the B T
// rows are cut into that many ranges of `kps` rows (blockIdx.z = 2 split +
// d): split 0 writes out, split s > 0 the partial ws[s - 1], and
// splitk_add_kernel then adds the partials to out in split order. With COND
// x is the conditioned rows (RowsT).
template <bool COND = false>
struct WgradOp {
  static constexpr bool A_K_FAST = false, B_K_FAST = false;
  static constexpr int A_TERMS = 1, B_TERMS = 2, PASSES = 1, A_TABLE = 2, MIN_BLOCKS = 1;
  RowsT<COND> rows;
  const float* dg;
  float* out;
  float* ws;
  long long K, kps;
  int M, N;

  __device__ __forceinline__ long long k_begin(int z) const { return (z >> 1) * kps; }
  __device__ __forceinline__ long long k_end(int z) const {
    return k_begin(z) + kps < K ? k_begin(z) + kps : K;
  }
  __device__ __forceinline__ RowPtr row_ptr(int z, long long k) const {
    return rows.ptr(z & 1, k);
  }
  __device__ __forceinline__ typename RowsT<COND>::Loaded a(int, int, long long m, long long k,
                                                          const RowPtr& r) const {
    return (m < M && k < K) ? rows.at(r, (int)m) : RowsT<COND>::zero();
  }
  __device__ __forceinline__ float b(int z, int, long long k, int n) const {
    return (k < K && n < N) ? dg[((size_t)(z & 1) * K + k) * N + n] : 0.f;
  }
  __device__ __forceinline__ void store(int z, int, long long m, int n, float v) const {
    if (m >= M || n >= N) return;
    const int split = z >> 1;
    float* dst = split == 0 ? out : ws + (size_t)(split - 1) * 2 * M * N;
    dst[((size_t)(z & 1) * M + m) * N + n] = v;
  }
};

// out[i] += ws[0][i] + .. + ws[parts - 1][i], one at a time in that order.
__global__ void splitk_add_kernel(float* __restrict__ out, const float* __restrict__ ws,
                                  long long n, int parts) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = out[i];
  for (int p = 0; p < parts; ++p) v += ws[p * n + i];
  out[i] = v;
}

// dx (B T, F) = round_bf16(dg[0] W_ih,0) + round_bf16(dg[1] W_ih,1), one pass
// per direction; each element is written by the same thread in both passes.
struct DxOp {
  static constexpr bool A_K_FAST = true, B_K_FAST = true;
  static constexpr int A_TERMS = 2, B_TERMS = 1, PASSES = 2, A_TABLE = 0, MIN_BLOCKS = 1;
  const float* dg;              // (2, M, K)
  const __nv_bfloat16* w_ih_t;  // (2, N, K): W_ih,d (K, N) transposed
  float* dx;
  long long M;
  int N, K;

  __device__ __forceinline__ long long k_begin(int) const { return 0; }
  __device__ __forceinline__ long long k_end(int) const { return K; }
  __device__ __forceinline__ RowPtr row_ptr(int, long long) const { return RowPtr{-1, -1}; }
  __device__ __forceinline__ float a(int, int d, long long m, long long k, const RowPtr&) const {
    return (m < M && k < K) ? dg[((size_t)d * M + m) * K + k] : 0.f;
  }
  __device__ __forceinline__ __nv_bfloat16 b(int, int d, long long k, int n) const {
    return (k < K && n < N) ? w_ih_t[((size_t)d * N + n) * K + k] : bf16_zero();
  }
  __device__ __forceinline__ void store(int, int d, long long m, int n, float v) const {
    if (m >= M || n >= N) return;
    const float r = __bfloat162float(__float2bfloat16(v));
    float* p = dx + m * N + n;
    *p = d == 0 ? r : *p + r;
  }
};

// dcond (M, N) = dg[0] W_ih,0 + dg[1] W_ih,1, the conditioned form's step 4:
// one pass over K = 2G (the directions' G = 4H gate columns end to end), dg
// split as in DxOp, summed in f32 and not rounded.
struct DcondOp {
  static constexpr bool A_K_FAST = true, B_K_FAST = true;
  static constexpr int A_TERMS = 2, B_TERMS = 1, PASSES = 1, A_TABLE = 0, MIN_BLOCKS = 1;
  const float* dg;              // (2, M, G)
  const __nv_bfloat16* w_ih_t;  // (2, N, G): W_ih,d (G, N) transposed
  float* out;                   // (M, N)
  long long M;
  int N, G;

  __device__ __forceinline__ long long k_begin(int) const { return 0; }
  __device__ __forceinline__ long long k_end(int) const { return 2LL * G; }
  __device__ __forceinline__ RowPtr row_ptr(int, long long) const { return RowPtr{-1, -1, -1}; }
  __device__ __forceinline__ float a(int, int, long long m, long long k, const RowPtr&) const {
    if (m >= M || k >= 2LL * G) return 0.f;
    const int d = k >= G, kk = (int)k - d * G;
    return dg[((size_t)d * M + m) * G + kk];
  }
  __device__ __forceinline__ __nv_bfloat16 b(int, int, long long k, int n) const {
    if (k >= 2LL * G || n >= N) return bf16_zero();
    const int d = k >= G, kk = (int)k - d * G;
    return w_ih_t[((size_t)d * N + n) * G + kk];
  }
  __device__ __forceinline__ void store(int, int, long long m, int n, float v) const {
    if (m < M && n < N) out[m * N + n] = v;
  }
};

// ---- the walk ------------------------------------------------------------

struct WalkArgs {
  const uint4* wp;          // (2, C, KH/16, U/4, 32) fragments of W_hh^T's CTA slices
  float* dg;                // (2, B, T, 4H): pre-activations in, gate gradients out
  const __nv_bfloat16* c;   // (B, T, 2H), strides (s_sb, s_st, 1)
  long long s_sb, s_st;
  const void* dh;           // (B, T, 2H) of the walk's DH type, strides (d_sb, d_st, 1)
  long long d_sb, d_st;
  __nv_bfloat16* dxg;       // gate-input form: (B, T, 8H) strides (g_sb, g_st, 1); else null
  long long g_sb, g_st;
  int B, T, H, U, nact, KH;
  // spill form (no c): (2, ceil(T / spill), B, H) contiguous, the c carry
  // entering every spill'th step of each walk
  const __nv_bfloat16* cb = nullptr;
  int spill = 0;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int kWalkMaxThreads = 512, kWalkEpt = 4;
constexpr int kSpillMax = 8;  // the spill form's longest block

// The walk's shared bytes; `cache` c values per (unit, row) in the spill
// form (spill + 1: a block's entering carry and its c after each step), 0
// otherwise.
inline size_t walk_shared_bytes(int MT, int KH, int U, int nact, int BT, int cache = 0) {
  return (size_t)MT * (KH / 16) * 512 + (size_t)8 * nact * U * BT + (size_t)8 * BT * (4 * U + 8) +
         16 + (size_t)4 * cache * U * BT;
}

// DH: the type of dh, bf16 (projection form) or float (gate-input form).
// SPILL: c is not read but rebuilt, entering each spill block of the walk
// (its last step, the walk going backward), from the block's boundary in cb
// and the pre-activations in dg, which the walk has not yet overwritten
// there: c = sigmoid(f) c + sigmoid(i) tanh(g) in f32 through the block's
// steps, as the TPU kernel's phase 2 (tssep_tpu/kernels/blstm.py:1322-1332).
// Each thread rebuilds its own (unit, row) elements into its own slots of a
// shared cache, so the rebuild needs no barrier, no cluster traffic and no
// workspace.
template <int NB, typename DH, bool SPILL = false>
__global__ void __launch_bounds__(kWalkMaxThreads, 1) cluster_walk_kernel(const WalkArgs a) {
  constexpr int BT = NB * 8;
  const int cta = (int)cluster_rank();
  const int C = gridDim.x;
  const int dir = blockIdx.z;
  const bool rev = dir == 1;
  const int b0 = blockIdx.y * BT;
  const int U = a.U, MT = U / 4, KSH = a.KH / 16, H = a.H, G = 4 * H;
  const int MS = 4 * U + 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nwarps = blockDim.x / 32, nthr = blockDim.x;
  const int q = lane >> 2, tq = lane & 3;
  const DH* dh = static_cast<const DH*>(a.dh);

  extern __shared__ __align__(16) unsigned char smem[];
  uint4* wp_s = reinterpret_cast<uint4*>(smem);
  float* recv = reinterpret_cast<float*>(wp_s + (size_t)KSH * MT * 32);  // (2, nact, U, BT)
  // (2 steps, hi and lo, BT, MS): the split gate gradients
  __nv_bfloat16* bst = reinterpret_cast<__nv_bfloat16*>(recv + 2 * a.nact * U * BT);
  uint64_t* rbar = reinterpret_cast<uint64_t*>(bst + 4 * BT * MS);
  // spill form: (spill + 1, U BT) the c values of the current block, slot j
  // c after the block's step j - 1 (slot 0 its boundary), element e of
  // this CTA at e
  float* ccache = reinterpret_cast<float*>(rbar + 2);

  const bool active = cta < a.nact;
  if (active) {
    const uint4* src = a.wp + (size_t)(dir * C + cta) * KSH * MT * 32;
    for (int i = tid; i < KSH * MT * 32; i += nthr) wp_s[i] = src[i];
  }
  if (tid == 0) {
    mbar_init(&rbar[0], 1);
    mbar_init(&rbar[1], 1);
    fence_mbar_init();
  }
  __syncthreads();
  cluster_sync();

  if (active) {
    // this thread's (unit, row) elements: e = tid + i nthr, unit e % U, row e / U
    int eu[kWalkEpt], en[kWalkEpt];
    bool ev[kWalkEpt];  // a real unit and a real row
#pragma unroll
    for (int i = 0; i < kWalkEpt; ++i) {
      const int e = tid + i * nthr;
      eu[i] = e % U;
      en[i] = e / U;
      ev[i] = e < U * BT && U * cta + eu[i] < H && b0 + en[i] < a.B;
    }
    float pre[kWalkEpt][4], cv[kWalkEpt], cpv[kWalkEpt], dhv[kWalkEpt], dc[kWalkEpt];
    auto fetch = [&](int s) {
      const int t = rev ? a.T - 1 - s : s, tp = rev ? t + 1 : t - 1;
#pragma unroll
      for (int i = 0; i < kWalkEpt; ++i) {
        const int b = b0 + en[i], ug = U * cta + eu[i];
        if (ev[i]) {
          const float* g = a.dg + (((size_t)dir * a.B + b) * a.T + t) * G + ug;
#pragma unroll
          for (int k = 0; k < 4; ++k) pre[i][k] = g[k * H];
          if constexpr (!SPILL) {
            const long long so = b * a.s_sb + dir * H + ug;
            cv[i] = __bfloat162float(a.c[so + t * a.s_st]);
            cpv[i] = s > 0 ? __bfloat162float(a.c[so + tp * a.s_st]) : 0.f;
          }
          dhv[i] = to_f32(dh[b * a.d_sb + t * a.d_st + dir * H + ug]);
        }
      }
    };
#pragma unroll
    for (int i = 0; i < kWalkEpt; ++i) dc[i] = 0.f;
    fetch(a.T - 1);
    // bytes a step's partials bring: every CTA's, for this CTA's units
    const int own = H - U * cta < U ? H - U * cta : U;
    const uint32_t rbytes = (uint32_t)a.nact * own * BT * 4;

    const int UB = U * BT;
    const int nblk = SPILL ? (a.T + a.spill - 1) / a.spill : 0;

    for (int it = 0; it < a.T; ++it) {
      const int s = a.T - 1 - it;  // walk step, walked backward
      const int t = rev ? a.T - 1 - s : s;
      if constexpr (SPILL) {
        // before the wait for the peers' partials, which it does not need
        const int s0 = s - s % a.spill;
        if (s == a.T - 1 || s - s0 == a.spill - 1) {
          const int n = s - s0 + 1;  // the block's steps (a short last block has fewer)
          // one element at a time, every load of its block issued before
          // the serial update uses the first: one L2 latency a block, not
          // one a step (the element's numbers are recomputed, so that the
          // register arrays above keep constant indices)
#pragma unroll 1
          for (int i = 0; i < kWalkEpt; ++i) {
            const int e = tid + i * nthr, u = e % U, b = b0 + e / U, ug = U * cta + u;
            if (e >= UB || ug >= H || b >= a.B) continue;
            const float* g = a.dg + ((size_t)dir * a.B + b) * a.T * G + ug;
            float pf[kSpillMax], pi[kSpillMax], pg[kSpillMax];
#pragma unroll
            for (int j = 0; j < kSpillMax; ++j) {
              if (j < n) {
                const float* gj = g + (size_t)(rev ? a.T - 1 - s0 - j : s0 + j) * G;
                pf[j] = gj[H];
                pi[j] = gj[0];
                pg[j] = gj[2 * H];
              }
            }
            float cr = __bfloat162float(
                a.cb[(((size_t)dir * nblk + s0 / a.spill) * a.B + b) * H + ug]);
            ccache[e] = cr;
#pragma unroll
            for (int j = 0; j < kSpillMax; ++j) {
              if (j < n) {
                cr = sigmoid(pf[j]) * cr + sigmoid(pi[j]) * tanhf(pg[j]);
                ccache[(j + 1) * UB + e] = cr;
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kWalkEpt; ++i) {
          if (!ev[i]) continue;
          const int e = tid + i * nthr;
          cv[i] = ccache[(s - s0 + 1) * UB + e];
          cpv[i] = ccache[(s - s0) * UB + e];
        }
      }
      // dh carried from the later step: the C partials, added in CTA order
      float carry[kWalkEpt];
#pragma unroll
      for (int i = 0; i < kWalkEpt; ++i) carry[i] = 0.f;
      if (it > 0) {
        if (tid == 0) mbar_expect(&rbar[(it - 1) & 1], rbytes);
        mbar_wait(&rbar[(it - 1) & 1], ((it - 1) >> 1) & 1);
        const float* rb = recv + (size_t)((it - 1) & 1) * a.nact * U * BT;
        for (int p = 0; p < a.nact; ++p)
#pragma unroll
          for (int i = 0; i < kWalkEpt; ++i)
            if (tid + i * nthr < U * BT)
              carry[i] += rb[((size_t)p * U + eu[i]) * BT + en[i]];
      }
#pragma unroll
      for (int i = 0; i < kWalkEpt; ++i) {
        if (tid + i * nthr >= U * BT) continue;
        float dgv[4] = {0.f, 0.f, 0.f, 0.f};
        if (ev[i]) {
          const float ig = sigmoid(pre[i][0]), fg = sigmoid(pre[i][1]);
          const float gg = tanhf(pre[i][2]), og = sigmoid(pre[i][3]);
          const float dh_t = carry[i] + dhv[i];
          const float tc = tanhf(cv[i]);
          const float dcv = dc[i] + dh_t * og * (1.f - tc * tc);
          dgv[0] = dcv * gg * ig * (1.f - ig);
          dgv[1] = dcv * cpv[i] * fg * (1.f - fg);
          dgv[2] = dcv * ig * (1.f - gg * gg);
          dgv[3] = dh_t * tc * og * (1.f - og);
          dc[i] = dcv * fg;
          float* g = a.dg + (((size_t)dir * a.B + b0 + en[i]) * a.T + t) * G + U * cta + eu[i];
#pragma unroll
          for (int k = 0; k < 4; ++k) g[k * H] = dgv[k];
          if (a.dxg != nullptr) {  // JAX's dgates.astype(dxg_ref.dtype)
            __nv_bfloat16* gx =
                a.dxg + (b0 + en[i]) * a.g_sb + t * a.g_st + dir * G + U * cta + eu[i];
#pragma unroll
            for (int k = 0; k < 4; ++k) gx[k * H] = __float2bfloat16(dgv[k]);
          }
        }
        // the B operand of dh_prev: row n, local gate row 16 (u / 4) + 4 g + u % 4
        const int m = 16 * (eu[i] >> 2) + (eu[i] & 3);
        __nv_bfloat16* bs = bst + (it & 1) * 2 * BT * MS + en[i] * MS + m;
#pragma unroll
        for (int k = 0; k < 4; ++k) split(dgv[k], bs[4 * k], bs[BT * MS + 4 * k]);
      }
      if (s == 0) break;  // no step before the first: dh_prev is not needed
      fetch(s - 1);
      // this step's half of bst is complete; the partials just added are read,
      // so peers may refill their buffer once this CTA's partials reach them;
      // every thread is past the product of two steps ago, which read the
      // half the next step writes
      named_sync(1, nthr);
      const __nv_bfloat16* bsr = bst + (it & 1) * 2 * BT * MS;

      // partial dh_prev (KH x BT) = W_hh^T slice (KH x 4U) . dgates (4U x BT)
      for (int mt = warp; mt < KSH; mt += nwarps) {
        float acc[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[nb][r] = 0.f;
        const uint4* wa = wp_s + (size_t)mt * MT * 32 + lane;
        for (int ks = 0; ks < MT; ++ks) {
          const uint4 w = wa[ks * 32];
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            const __nv_bfloat16* p = bsr + (nb * 8 + q) * MS + ks * 16 + 2 * tq;
            mma(acc[nb], w, ld32(p), ld32(p + 8));
            mma(acc[nb], w, ld32(p + BT * MS), ld32(p + BT * MS + 8));
          }
        }
        // row j of the partial goes to the CTA that owns unit j, 16 bytes a
        // store: lane pairs (tq, tq ^ 1) swap halves, so that the even lane
        // holds row q, columns 2 tq .. 2 tq + 3, and the odd one row q + 8,
        // columns 2 tq - 2 .. 2 tq + 1
        const bool odd = tq & 1;
        const int j = 16 * mt + q + (odd ? 8 : 0);
        const int p = j / U, ul = j - p * U;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const float x0 = __shfl_xor_sync(kFullMask, odd ? acc[nb][0] : acc[nb][2], 1);
          const float x1 = __shfl_xor_sync(kFullMask, odd ? acc[nb][1] : acc[nb][3], 1);
          if (j >= H) continue;
          const float v0 = odd ? x0 : acc[nb][0], v1 = odd ? x1 : acc[nb][1];
          const float v2 = odd ? acc[nb][2] : x0, v3 = odd ? acc[nb][3] : x1;
          const float* dst = recv + (((size_t)(it & 1) * a.nact + cta) * U + ul) * BT + nb * 8 +
                             2 * (tq & 2);
          st_async_f32x4(map_rank(smem_addr(dst), p), v0, v1, v2, v3,
                         map_rank(smem_addr(&rbar[it & 1]), p));
        }
      }
    }
  }
  cluster_sync();
}

using WalkKernel = void (*)(WalkArgs);

// The instance of cluster_walk_kernel for row tile BT, dh of type DH and
// the spill form or not, or null.
template <typename DH, bool SPILL = false>
inline WalkKernel walk_kernel(int BT) {
  if (BT == 8) return cluster_walk_kernel<1, DH, SPILL>;
  if (BT == 16) return cluster_walk_kernel<2, DH, SPILL>;
  if (BT == 24) return cluster_walk_kernel<3, DH, SPILL>;
  if (BT == 32) return cluster_walk_kernel<4, DH, SPILL>;
  return nullptr;
}

template <typename DH, bool SPILL = false>
inline int cluster_walk(const WalkArgs& a, int C, int BT, int threads, cudaStream_t stream) {
  const int MT = a.U / 4;
  if (threads > kWalkMaxThreads || threads % 32 != 0 || a.U % 4 != 0 || a.nact > C ||
      a.U * BT > kWalkEpt * threads ||
      (SPILL && (a.cb == nullptr || a.spill < 1 || a.spill > kSpillMax)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = walk_shared_bytes(MT, a.KH, a.U, a.nact, BT, SPILL ? a.spill + 1 : 0);
  const dim3 grid(C, (a.B + BT - 1) / BT, 2);
  return launch_clusters(walk_kernel<DH, SPILL>(BT), grid, threads, smem, C, stream, a);
}

// The projection form's four launches on one stream (1 gates, 2 walk,
// 4 weight sums, 8 dx: the bits of `parts`), for the fully fused backward
// (blstm_fullfused_bwd.cu: the walk reads the c sequence c) and, with SPILL,
// the spill backward (blstm_fullfused_spill_bwd.cu: the walk rebuilds c
// from the boundaries cb, every spill'th step). Arguments as those entry
// points document them. Returns a cudaError_t.
template <bool SPILL>
int projection_backward(const void* x, long long x_sb, long long x_st, int F,
                        const void* w_ih_t, const void* w_hh_t, const void* bias, const void* wp,
                        const void* h, const void* c, long long s_sb, long long s_st,
                        const void* cb, int spill, const void* dh, long long d_sb,
                        long long d_st, void* dg, void* dw, void* dx, int B, int T, int H, int C,
                        int U, int nact, int bt, int threads, int splits, int parts,
                        cudaStream_t stream) {
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
    a.cb = static_cast<const __nv_bfloat16*>(cb);
    a.spill = spill;
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
    err = cluster_walk<__nv_bfloat16, SPILL>(a, C, bt, threads, stream);
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

}  // namespace tc
}  // namespace
}  // namespace tssep
