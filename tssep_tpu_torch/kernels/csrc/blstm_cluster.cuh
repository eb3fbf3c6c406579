// Building blocks of the Hopper design of the fully fused pair
// (blstm_cluster_fwd.cuh, blstm_cluster_bwd.cuh): bf16 tensor-core products
// (mma.sync m16n8k16, f32 sums), thread-block clusters whose CTAs exchange
// through distributed shared memory and signal with mbarriers, named
// barriers between warp roles, and the cluster launch.
//
// Layout shared with the Python side (kernels/blstm.py, `_fragments`): an
// A operand is stored as fragments, one uint4 per lane per 16 x 16 tile,
// holding the eight bf16 values that lane's four A registers take in
// mma.sync.m16n8k16.row.col, so that a warp loads a tile with one 16-byte
// load per lane. Lane l = 4 q + t holds rows q and q + 8 and columns
// 2t, 2t + 1, 2t + 8, 2t + 9. A B operand B[k][n] is kept as rows n with k
// contiguous (a 32-bit load gives the two k values of a register), rows
// padded to a stride of 16 a + 8 elements, which puts the eight rows a warp
// reads at once in different banks.
//
// A CTA's data reaches its peers by st.async: each store signals the
// receiver's mbarrier with its byte count (complete_tx), and the receiver
// arrives once per phase with the bytes it expects (expect_tx), so a step
// needs no fence and no remote arrive.
//
// Gate rows inside a CTA that owns hidden units [u0, u0 + U) (U a multiple
// of 4): local row m = 16 mt + 4 g + r is gate g (i, f, g, o) of unit
// u0 + 4 mt + r. In the accumulator of an m16n8 tile, the lane with q < 4
// then holds the i and g rows of unit 4 mt + q and the lane q + 4 (lane
// ^ 16) its f and o rows, for the same two columns: one exchange of two
// values gives each of them all four gates of one (unit, column).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tssep {
namespace {
namespace tc {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void mma(float (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// f32 value as the two-term bf16 split hi + lo: hi = bf16(v), lo = bf16(v - hi),
// relative error <= 2^-18. A product of either term with a bf16 value is
// exact in f32.
__device__ __forceinline__ void split(float v, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; register i gets matrix i in the mma fragment
// layout (lane 4 q + t: row q, columns 2t, 2t + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// ---- barriers -------------------------------------------------------------

// Named barrier `id` (1..15) over `n` threads, a multiple of 32.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address of the same shared-memory location in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Stores into the shared memory of a CTA of the cluster (`addr`, from
// map_rank) and counts the bytes on that CTA's mbarrier at `bar` (also from
// map_rank).
__device__ __forceinline__ void st_async_u64(uint32_t addr, uint64_t v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u64 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "l"(v), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void st_async_f32x4(uint32_t addr, float a, float b, float c, float d,
                                               uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This CTA's one arrival on its mbarrier for the current phase, with the
// bytes the phase is to receive.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits, with acquire at cluster scope, for the completion of the phase of
// this CTA's mbarrier whose parity is `parity`. A phase that has not
// completed after about 2^36 cycles (tens of seconds) is a fault: the kernel
// traps, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  const long long start = clock64();
  for (uint32_t i = 1; !done; ++i) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && (i & 1023) == 0 && clock64() - start > (1ll << 36)) __trap();
  }
}

// ---- host -----------------------------------------------------------------

// n / d and n % d for n < 2^31 by one multiply-high (Granlund and
// Montgomery): the time steps of a flattened (B, T) row index.
struct FastDiv {
  uint32_t d, mul, shift;
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return static_cast<uint32_t>((static_cast<uint64_t>(__umulhi(n, mul)) + n) >> shift);
  }
};

inline FastDiv make_fastdiv(uint32_t d) {
  uint32_t shift = 0;
  while ((1ull << shift) < d) ++shift;
  const uint64_t mul = ((1ull << 32) * ((1ull << shift) - d)) / d + 1;
  return FastDiv{d, static_cast<uint32_t>(mul), shift};
}

// Readies `kernel` for `smem` dynamic shared bytes and clusters of
// `cluster` CTAs along x, and fills `cfg` (its one attribute in `attr`) for
// a grid `grid` of `threads` threads a CTA. Returns a cudaError_t.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, dim3 grid, int threads, size_t smem, int cluster,
                           cudaStream_t stream, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

// Clusters of `cluster` CTAs of `kernel` (`threads` threads, `smem` shared
// bytes each) that the card holds at once, into `slots`
// (cudaOccupancyMaxActiveClusters). Returns a cudaError_t.
template <typename Kernel>
int cluster_slots(Kernel kernel, int threads, size_t smem, int cluster, int* slots) {
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, dim3(cluster, 1, 2), threads, smem, cluster,
                                   nullptr, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(slots, kernel, &cfg);
}

// Launches `kernel` as clusters of `cluster` CTAs along x, after checking
// that one such cluster fits on the card. Returns a cudaError_t.
template <typename Kernel, typename Args>
int launch_clusters(Kernel kernel, dim3 grid, int threads, size_t smem, int cluster,
                    cudaStream_t stream, const Args& args) {
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, grid, threads, smem, cluster, stream, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace
}  // namespace tssep
