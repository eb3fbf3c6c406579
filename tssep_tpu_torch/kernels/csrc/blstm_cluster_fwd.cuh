// The Hopper design of the bidirectional LSTM forward (bf16 storage), in three
// forms chosen by template parameters XG and COND:
// - projection (XG false): the fully fused forward, x_t W_ih^T + b computed
//   inside the kernel, so no (B, T, 8H) gate tensor is ever written.
//   Replaces, with blstm_fullfused_fwd.cu, the TPU kernel `_ff_fwd_kernel`
//   (tssep_tpu/kernels/blstm.py:797).
// - conditioned projection (COND true): the projection form over the 'mul'-
//   conditioned rows, row b = xs row b / S times aux row b, the product
//   formed where x is staged, so the (B, S, T, F) tensor is never written.
//   Replaces, with blstm_fullfused_cond_fwd.cu, the TPU kernel
//   `_ffc_fwd_kernel` (:1656).
// - gate inputs (XG true): the walk from gate inputs xg (B, T, 8H) computed
//   outside. Replaces, with blstm_bidi_fwd.cu, the TPU kernel
//   `_bi_fwd_kernel` (tssep_tpu/kernels/blstm.py:374).
// The projection form also runs the spill forward (blstm_fullfused_spill_fwd.cu,
// replacing `_ffs_fwd_kernel` :1228): given a boundary buffer (FwdArgs::cb)
// instead of c, the consumers write the c carry entering every spill'th step
// of their walk where they update c; without one it is the fully fused launch.
//
// What bounds the layer on an H100 is its serial chain: T steps, each a
// product with W_hh that needs the previous step's h. The design keeps that
// chain short:
// - One cluster of C CTAs per (row tile of BT rows, direction). CTA r owns
//   the hidden units [r U, r U + U), all four gates of each
//   (blstm_cluster.cuh), and keeps its slice of W_hh^T (H x 4U bf16, 90 KB
//   at H 300 and C 8) in shared memory for the whole walk.
// - The recurrent product runs on the tensor cores, the weight slice as the
//   M side (gates^T = W h^T), so a row tile of 8-32 rows fills N. h is
//   rounded to bf16 before the product, as JAX's h.astype(whh.dtype); c stays
//   in f32, in registers of the thread that updates it.
// - The new h of a CTA's units goes to every CTA of the cluster through
//   distributed shared memory (st.async), into the other half of a double
//   buffer; one mbarrier per half counts the bytes that have arrived. A CTA
//   sends as soon as its units are updated and waits only at the start of
//   the next step; one barrier of its consumer warps between the product and
//   the sends keeps peers from overwriting a half that it still reads.
// - The gate inputs are off the chain: producer warps fill, a chunk of TC
//   steps ahead of the walk, a two-chunk ring of f32 gate inputs in shared
//   memory, in the consumers' accumulator layout; named barriers pass the
//   ring's halves between the two roles.
//   - Projection form: the producers compute x W_ih^T + b on the tensor
//     cores. The W_ih^T slice (154 KB at F 513 and C 8) does not fit beside
//     W_hh^T, so each producer lane streams its fragments from L2 per chunk,
//     16 bytes a load straight into registers, 8 in flight. A cp.async or
//     TMA ring would need shared memory that the 24- and 32-row tiles do not
//     have left; at one step a chunk (those tiles) the stream is bound by L2
//     bandwidth, not latency: a two-stage register pipeline gained nothing.
//   - Conditioned form: as the projection form, but each staged value is
//     bf16(x * aux), the exact product rounded once, as the materialized
//     product; x comes from xs row b / S, aux from the tile's aux rows, read
//     once for all of F into shared memory before the walk (2 BT KF bytes),
//     so the staging reads no more from L2 than the projection form's. The
//     product is a second pass over each staged row, 16 aligned bytes of x
//     and of aux a load and two values an instruction, not a value at a
//     time beside x's unaligned pieces.
//   - Gate-input form: the producers copy the CTA's 4U gate columns of xg
//     for each row and step, every load of a chunk in flight at once. The
//     column of each local gate row comes from a table the host builds
//     (kernels/blstm.py `_xg_columns`), so any H and any xg strides work
//     (the columns of one gate are 2-byte aligned only where H is odd). With
//     no x staging and no W_ih stream, the chunk is longer (up to 8 steps,
//     64 row-steps), so the loads of a chunk have several steps to land.
// The reverse direction walks t = T-1 .. 0 over x (or xg) in place; no time
// padding, no flipped copy. The launch geometry (C, U, BT, TC, the x block
// KX) comes from `cluster_geometry` in kernels/blstm.py ('fwd', 'fwd_cond' and
// 'fwd_xg'); the shared-memory formula below is the same as its `_fwd_shared`.
#pragma once

#include "blstm_cluster.cuh"

namespace tssep {
namespace {
namespace tc {

struct FwdArgs {
  const __nv_bfloat16* x;  // (B, T, F), strides (x_sb, x_st, 1); or xg (B, T, 8H)
  long long x_sb, x_st;
  const uint4* wih;        // (2, C, U/4, KF/16, 32) fragments of W_ih^T slices
  const uint4* whh;        // (2, C, U/4, KH/16, 32) fragments of W_hh^T slices
  const float* bias;       // (2, C, 4U) in local gate-row order
  const int* cols;         // gate inputs: (2, C, 4U) xg column of each local gate row, -1 padding
  const __nv_bfloat16* aux;  // conditioned: (B, F) contiguous, one row per layer row
  FastDiv divS;            // conditioned: layer row b reads x row b / S
  __nv_bfloat16* h_out;    // (B, T, 2H), strides (o_sb, o_st, 1)
  __nv_bfloat16* c_out;    // the same, or null
  long long o_sb, o_st;
  // spill form: (2, ceil(T / spill), B, H) contiguous, the c carry
  // entering every spill'th step of each walk; or null
  __nv_bfloat16* cb = nullptr;
  int spill = 0;
  int B, T, F, H;          // B: the layer's rows
  int U, nact;             // units per CTA; CTAs that own units
  int KH, KF, KX;          // H and F rounded up to 16; F's block per staging
};

constexpr int kFwdRing = 2;          // chunks in the ring
constexpr int kFwdMaxThreads = 640;  // 2 roles x at most 10 m-tiles x 32
constexpr int kXBatch = 2;           // 16-byte x loads in flight per row per producer lane
constexpr int kWBatch = 8;           // W_ih^T fragments in flight per producer lane

// Barrier ids: 1 consumers, 2 + slot ring half full, 4 + slot ring half
// empty, 6 producers.
constexpr int kBarCons = 1, kBarFull = 2, kBarEmpty = 4, kBarProd = 6;

// The W_hh^T slice, two h buffers, the ring, the staged x rows (projection
// forms only), the tile's aux rows (conditioned form: KA = KF, else 0) and
// two mbarriers.
inline size_t fwd_shared_bytes(int MT, int KH, int BT, int TC, int KX, bool xg, int KA) {
  return (size_t)MT * (KH / 16) * 512 + (size_t)4 * BT * (KH + 8) +
         (size_t)kFwdRing * TC * MT * (BT / 8) * 512 + (xg ? 0 : (size_t)2 * TC * BT * (KX + 8)) +
         (size_t)2 * BT * KA + 16;
}

// bf16(x * a) of two pairs of bf16 values (the bits of each pair in one
// word), one instruction: the exact product rounded to nearest once, the
// rounding of the materialized product (a product of two bf16 values is
// exact in f32).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t x, uint32_t a) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(x), "r"(a));
  return r;
}

template <int NB, int TC, bool XG, bool COND>
__global__ void __launch_bounds__(kFwdMaxThreads, 1) cluster_fwd_kernel(const FwdArgs a) {
  static_assert(!(XG && COND), "the conditioned form is a projection form");
  constexpr int BT = NB * 8;
  constexpr int NC = TC * NB;  // n-tiles of one chunk
  const int cta = (int)cluster_rank();
  const int C = gridDim.x;
  const int dir = blockIdx.z;
  const bool rev = dir == 1;
  const int b0 = blockIdx.y * BT;
  const int MT = a.U / 4;
  const int KSH = a.KH / 16, KSF = a.KF / 16;
  const int HS = a.KH + 8, XS = a.KX + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = lane >> 2, tq = lane & 3;
  const int nthr = blockDim.x;

  extern __shared__ __align__(16) unsigned char smem[];
  uint4* whh_s = reinterpret_cast<uint4*>(smem);
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(whh_s + (size_t)MT * KSH * 32);
  float4* ring = reinterpret_cast<float4*>(hbuf + 2 * BT * HS);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(ring + (size_t)kFwdRing * TC * MT * NB * 32);
  __nv_bfloat16* aux_s = xs + (XG ? 0 : TC * BT * XS);  // conditioned: (BT, KF)
  uint64_t* hbar = reinterpret_cast<uint64_t*>(aux_s + (COND ? BT * a.KF : 0));

  const bool active = cta < a.nact;
  for (int i = threadIdx.x; i < BT * HS; i += nthr)  // both halves: h_{-1} = 0 and pads
    reinterpret_cast<uint32_t*>(hbuf)[i] = 0u;
  if (active) {
    const uint4* src = a.whh + (size_t)(dir * C + cta) * MT * KSH * 32;
    for (int i = threadIdx.x; i < MT * KSH * 32; i += nthr) whh_s[i] = src[i];
    if constexpr (COND) {
      // the tile's aux rows, zero past F and past the last row
      for (int i = threadIdx.x; i < BT * a.KF; i += nthr) {
        const int n = i / a.KF, k = i - n * a.KF;
        aux_s[i] = (b0 + n < a.B && k < a.F) ? a.aux[(size_t)(b0 + n) * a.F + k]
                                             : __float2bfloat16(0.f);
      }
    }
  }
  if (threadIdx.x == 0) {
    mbar_init(&hbar[0], 1);
    mbar_init(&hbar[1], 1);
    fence_mbar_init();
  }
  __syncthreads();
  cluster_sync();  // every peer's buffers and barriers are ready

  if (active && warp < MT) {
    // ---- consumer: warp `mt` owns m-tile mt, units u0 .. u0 + 3 ----------
    const int mt = warp;
    const bool hi = q >= 4;
    const int u0 = a.U * cta + 4 * mt;
    const int u = u0 + (q & 3);
    const uint4* wa = whh_s + (size_t)mt * KSH * 32 + lane;
    // bytes a step's h brings: every group of 4 units, BT rows, 8 bytes each
    const uint32_t hbytes = (uint32_t)((a.H + 3) / 4) * BT * 8;
    float creg[NB];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) creg[nb] = 0.f;
    // spill form: slot k of cb is c after walk step k spill - 1 (slot 0 the
    // zero state), each (unit, row) written by the lane that updates it
    const int nblk = a.cb != nullptr ? (a.T + a.spill - 1) / a.spill : 0;
    __nv_bfloat16* cbd = a.cb + (size_t)dir * nblk * a.B * a.H;
    if (a.cb != nullptr && u < a.H) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int b = b0 + nb * 8 + 2 * tq + (hi ? 1 : 0);
        if (b < a.B) cbd[(size_t)b * a.H + u] = __float2bfloat16(0.f);
      }
    }

    for (int s = 0; s < a.T; ++s) {
      const int t = rev ? a.T - 1 - s : s;
      const int tau = s % TC, slot = (s / TC) % kFwdRing;
      if (tau == 0) named_sync(kBarFull + slot, nthr);
      if (s > 0) {
        if (threadIdx.x == 0) mbar_expect(&hbar[s & 1], hbytes);
        mbar_wait(&hbar[s & 1], ((s - 1) >> 1) & 1);
      }

      float acc[NB][4], acc2[NB][4];
      const float4* rs = ring + ((size_t)(slot * TC + tau) * MT + mt) * NB * 32 + lane;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float4 v = rs[nb * 32];
        acc[nb][0] = v.x; acc[nb][1] = v.y; acc[nb][2] = v.z; acc[nb][3] = v.w;
#pragma unroll
        for (int r = 0; r < 4; ++r) acc2[nb][r] = 0.f;
      }
      if (tau == TC - 1 || s == a.T - 1) named_arrive(kBarEmpty + slot, nthr);

      // gates += W_hh^T slice . h_prev^T, two sums over alternate k-steps
      const __nv_bfloat16* hb = hbuf + (s & 1) * BT * HS + q * HS + 2 * tq;
      int ks = 0;
      for (; ks + 1 < KSH; ks += 2) {
        const uint4 w0 = wa[ks * 32], w1 = wa[(ks + 1) * 32];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const __nv_bfloat16* p = hb + nb * 8 * HS + ks * 16;
          mma(acc[nb], w0, ld32(p), ld32(p + 8));
          mma(acc2[nb], w1, ld32(p + 16), ld32(p + 24));
        }
      }
      if (ks < KSH) {
        const uint4 w0 = wa[ks * 32];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const __nv_bfloat16* p = hb + nb * 8 * HS + ks * 16;
          mma(acc[nb], w0, ld32(p), ld32(p + 8));
        }
      }
      // every consumer warp is done reading this half before any peer can be
      // sent the h that lets it overwrite the half
      named_sync(kBarCons, MT * 32);

      // cell update: lane q < 4 takes column 2 tq, lane q + 4 column 2 tq + 1
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float v0 = acc[nb][0] + acc2[nb][0], v1 = acc[nb][1] + acc2[nb][1];
        const float v2 = acc[nb][2] + acc2[nb][2], v3 = acc[nb][3] + acc2[nb][3];
        const float r0 = __shfl_xor_sync(kFullMask, hi ? v0 : v1, 16);
        const float r1 = __shfl_xor_sync(kFullMask, hi ? v2 : v3, 16);
        const float ig = hi ? r0 : v0, gg = hi ? r1 : v2;
        const float fg = hi ? v1 : r0, og = hi ? v3 : r1;
        const float c = sigmoid(fg) * creg[nb] + sigmoid(ig) * tanhf(gg);
        creg[nb] = c;
        const __nv_bfloat16 hq = __float2bfloat16(sigmoid(og) * tanhf(c));
        const int n = nb * 8 + 2 * tq + (hi ? 1 : 0);
        const int b = b0 + n;
        if (u < a.H && b < a.B) {
          const long long o = b * a.o_sb + t * a.o_st + dir * a.H + u;
          a.h_out[o] = hq;
          if (a.c_out != nullptr) a.c_out[o] = __float2bfloat16(c);
          if (a.cb != nullptr && (s + 1) % a.spill == 0 && s + 1 < a.T)
            cbd[((size_t)((s + 1) / a.spill) * a.B + b) * a.H + u] = __float2bfloat16(c);
        }
        // units u0 .. u0 + 3 of row n, from the lanes with the same tq and hi
        const uint32_t bits = __bfloat16_as_ushort(hq);
        const uint64_t p0 = __shfl_sync(kFullMask, bits, (lane & 19) | 0);
        const uint64_t p1 = __shfl_sync(kFullMask, bits, (lane & 19) | 4);
        const uint64_t p2 = __shfl_sync(kFullMask, bits, (lane & 19) | 8);
        const uint64_t p3 = __shfl_sync(kFullMask, bits, (lane & 19) | 12);
        if (s + 1 < a.T && u0 < a.H) {
          const uint64_t packet = p0 | (p1 << 16) | (p2 << 32) | (p3 << 48);
          const uint32_t local = smem_addr(hbuf + ((s + 1) & 1) * BT * HS + n * HS + u0);
          const uint32_t bar = smem_addr(&hbar[(s + 1) & 1]);
          for (int p = q & 3; p < a.nact; p += 4)
            st_async_u64(map_rank(local, p), packet, map_rank(bar, p));
        }
      }
    }
  } else if (active && XG) {
    // ---- producer, gate inputs: thread i of the 8U producer threads copies
    // local gate row m = i % 4U of tile rows n = r0 + 2 k (r0 = i / 4U) for
    // each step of a chunk ----------------------------------------------------
    const int i = threadIdx.x - MT * 32;
    const int m = i % (4 * a.U), r0 = i / (4 * a.U);
    const int col = a.cols[(size_t)(dir * C + cta) * 4 * a.U + m];
    const __nv_bfloat16* xr = a.x + (long long)(b0 + r0) * a.x_sb + col;
    const int nrows = col < 0 ? 0 : (a.B - b0 - r0 + 1) / 2;  // of this thread's rows, those < B
    // (m, n) in the ring: lane 4 (m % 8) + n % 8 / 2 of m-tile m / 16, n-tile
    // n / 8, value 2 (m % 16 / 8) + n % 2 (the m16n8 accumulator layout);
    // with n = r0 + 2 k that is n-tile k / 4, lane part k % 4, value part r0
    const int mm = m % 16;
    float* ringr = reinterpret_cast<float*>(ring) + (m / 16) * NB * 128 + 16 * (mm % 8) +
                   2 * (mm / 8) + r0;
    constexpr int RK = BT / 2;  // this thread's rows of the tile
    const int nchunks = (a.T + TC - 1) / TC;
    for (int j = 0; j < nchunks; ++j) {
      const int slot = j % kFwdRing;
      if (j >= kFwdRing) named_sync(kBarEmpty + slot, nthr);
      float v[TC][RK];
#pragma unroll
      for (int tau = 0; tau < TC; ++tau) {
        const int s = j * TC + tau;
        const __nv_bfloat16* xt = xr + (long long)(rev ? a.T - 1 - s : s) * a.x_st;
#pragma unroll
        for (int k = 0; k < RK; ++k)
          v[tau][k] = (s < a.T && k < nrows) ? __bfloat162float(__ldg(xt + 2 * k * a.x_sb)) : 0.f;
      }
#pragma unroll
      for (int tau = 0; tau < TC; ++tau)
#pragma unroll
        for (int k = 0; k < RK; ++k)
          ringr[(size_t)(slot * TC + tau) * MT * NB * 128 + (k / 4) * 128 + 4 * (k % 4)] =
              v[tau][k];
      named_arrive(kBarFull + slot, nthr);
    }
    // take the consumers' last releases, so no barrier is left half-arrived
    for (int j = (nchunks > kFwdRing ? nchunks - kFwdRing : 0); j < nchunks; ++j)
      named_sync(kBarEmpty + j % kFwdRing, nthr);
  } else if (active) {
    // ---- producer: warp MT + mt computes m-tile mt of each chunk ---------
    const int mt = warp - MT;
    const int pthr = MT * 32;
    const int nchunks = (a.T + TC - 1) / TC;
    const uint4* wsrc = a.wih + (size_t)((dir * C + cta) * MT + mt) * KSF * 32 + lane;
    const float* bsrc = a.bias + (size_t)(dir * C + cta) * 4 * a.U + 16 * mt;
    const float bq = bsrc[q], bq8 = bsrc[q + 8];

    for (int j = 0; j < nchunks; ++j) {
      const int slot = j % kFwdRing;
      if (j >= kFwdRing) named_sync(kBarEmpty + slot, nthr);
      float acc[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;

      for (int kx0 = 0; kx0 < a.KF; kx0 += a.KX) {
        named_sync(kBarProd, pthr);  // the previous block's reads are done
        // stage x rows n (step j TC + n / BT, row b0 + n % BT), columns
        // kx0 .. kx0 + KX: warp mt takes rows mt, mt + MT, .., two at a time,
        // each read in 16-byte aligned pieces (a row may start at any
        // element) and written to shared memory value by value; columns past
        // F and rows past B or T are zero. Conditioned form: row b reads x
        // row b / S, and a second pass multiplies the staged row by aux row
        // b, 16 aligned bytes of each at a time.
        constexpr int NX = TC * BT;
        for (int n0 = mt; n0 < NX; n0 += 2 * MT) {
          const uint4* base[2];
          int nn[2], off[2], len[2], nch[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            nn[r] = n0 + r * MT;
            const int s = j * TC + nn[r] / BT, b = b0 + nn[r] % BT;
            const bool real = nn[r] < NX && s < a.T && b < a.B;
            const int t = rev ? a.T - 1 - s : s;
            const int xb = COND ? (int)a.divS.div((uint32_t)b) : b;
            len[r] = real ? (a.F - kx0 < a.KX ? a.F - kx0 : a.KX) : 0;
            const __nv_bfloat16* src = a.x + (real ? xb * a.x_sb + t * a.x_st + kx0 : 0);
            const uintptr_t at = reinterpret_cast<uintptr_t>(src);
            base[r] = reinterpret_cast<const uint4*>(at & ~uintptr_t(15));
            off[r] = (int)(at & 15) / 2;
            nch[r] = len[r] > 0 ? (off[r] + len[r] + 7) / 8 : 0;
            if (nn[r] < NX)
              for (int k = len[r] + lane; k < a.KX; k += 32) xs[nn[r] * XS + k] = __float2bfloat16(0.f);
          }
          const int most = nch[0] > nch[1] ? nch[0] : nch[1];
          for (int c0 = lane; c0 < most; c0 += 32 * kXBatch) {
            uint4 v[2][kXBatch];
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int i = 0; i < kXBatch; ++i)
                if (c0 + 32 * i < nch[r]) v[r][i] = __ldg(base[r] + c0 + 32 * i);
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int i = 0; i < kXBatch; ++i) {
                const int c = c0 + 32 * i;
                if (c >= nch[r]) continue;
                const uint32_t w[4] = {v[r][i].x, v[r][i].y, v[r][i].z, v[r][i].w};
                unsigned short* dst = reinterpret_cast<unsigned short*>(xs) + nn[r] * XS;
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                  const int k = 8 * c - off[r] + e;
                  if (k >= 0 && k < len[r])
                    dst[k] = (unsigned short)(w[e / 2] >> (16 * (e % 2)));
                }
              }
          }
          if constexpr (COND) {
            __syncwarp();  // the row's values, written by any lane, are in place
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              uint4* xr = reinterpret_cast<uint4*>(xs + nn[r] * XS);
              const uint4* ar = reinterpret_cast<const uint4*>(aux_s + (nn[r] % BT) * a.KF + kx0);
              for (int c = lane; c < (len[r] + 7) / 8; c += 32) {
                uint4 v = xr[c];
                const uint4 w = ar[c];
                v.x = mul_bf16x2(v.x, w.x);
                v.y = mul_bf16x2(v.y, w.y);
                v.z = mul_bf16x2(v.z, w.z);
                v.w = mul_bf16x2(v.w, w.w);
                xr[c] = v;
              }
            }
          }
        }
        named_sync(kBarProd, pthr);
        const int kss = (a.KF - kx0 < a.KX ? a.KF - kx0 : a.KX) / 16;
        const uint4* wk = wsrc + (size_t)(kx0 / 16) * 32;
        for (int ks0 = 0; ks0 < kss; ks0 += kWBatch) {
          uint4 w[kWBatch];
#pragma unroll
          for (int i = 0; i < kWBatch; ++i)
            if (ks0 + i < kss) w[i] = __ldg(wk + (ks0 + i) * 32);
#pragma unroll
          for (int i = 0; i < kWBatch; ++i) {
            if (ks0 + i < kss) {
              const __nv_bfloat16* xp = xs + q * XS + (ks0 + i) * 16 + 2 * tq;
#pragma unroll
              for (int n = 0; n < NC; ++n)
                mma(acc[n], w[i], ld32(xp + n * 8 * XS), ld32(xp + n * 8 * XS + 8));
            }
          }
        }
      }
      // + bias, into the ring in the consumers' fragment order
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int tau = n / NB, nb = n % NB;
        ring[((size_t)(slot * TC + tau) * MT + mt) * NB * 32 + nb * 32 + lane] =
            make_float4(acc[n][0] + bq, acc[n][1] + bq, acc[n][2] + bq8, acc[n][3] + bq8);
      }
      named_arrive(kBarFull + slot, nthr);
    }
    // take the consumers' last releases, so no barrier is left half-arrived
    for (int j = (nchunks > kFwdRing ? nchunks - kFwdRing : 0); j < nchunks; ++j)
      named_sync(kBarEmpty + j % kFwdRing, nthr);
  }
  cluster_sync();  // no CTA exits while a peer may still write to it
}

using FwdKernel = void (*)(FwdArgs);

// The instance of cluster_fwd_kernel for row tile BT and chunk TC, or null:
// the projection forms take TC BT <= 32, the gate-input form TC BT <= 64.
template <bool XG, bool COND = false>
inline FwdKernel fwd_kernel(int BT, int TC) {
#define TSSEP_CLUSTER_FWD(NB_, TC_) \
  if (BT == 8 * NB_ && TC == TC_) return cluster_fwd_kernel<NB_, TC_, XG, COND>
  TSSEP_CLUSTER_FWD(1, 1);
  TSSEP_CLUSTER_FWD(1, 2);
  TSSEP_CLUSTER_FWD(1, 4);
  TSSEP_CLUSTER_FWD(2, 1);
  TSSEP_CLUSTER_FWD(2, 2);
  TSSEP_CLUSTER_FWD(3, 1);
  TSSEP_CLUSTER_FWD(4, 1);
  if constexpr (XG) {
    TSSEP_CLUSTER_FWD(1, 8);
    TSSEP_CLUSTER_FWD(2, 4);
    TSSEP_CLUSTER_FWD(3, 2);
    TSSEP_CLUSTER_FWD(4, 2);
  }
#undef TSSEP_CLUSTER_FWD
  return nullptr;
}

// One layer, both directions, clusters of C CTAs. Returns a cudaError_t.
template <bool XG, bool COND = false>
inline int cluster_fwd(const FwdArgs& a, int C, int BT, int TC, cudaStream_t stream) {
  const int MT = a.U / 4;
  const int threads = 2 * MT * 32;
  if (threads > kFwdMaxThreads || a.U % 4 != 0 || a.nact > C || BT % 8 != 0 ||
      (COND && a.aux == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_shared_bytes(MT, a.KH, BT, TC, a.KX, XG, COND ? a.KF : 0);
  const dim3 grid(C, (a.B + BT - 1) / BT, 2);
  return launch_clusters(fwd_kernel<XG, COND>(BT, TC), grid, threads, smem, C, stream, a);
}

}  // namespace tc
}  // namespace
}  // namespace tssep
