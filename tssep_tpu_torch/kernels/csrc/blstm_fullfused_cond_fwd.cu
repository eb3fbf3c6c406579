// blstm_fullfused_cond_fwd: the flagship's first post-net layer (birnn0) with
// its 'mul' speaker conditioning formed inside the kernel. Replaces the TPU
// kernel `_ffc_fwd_kernel` (tssep_tpu/kernels/blstm.py:1656, launched by
// `_ffc_fwd_impl` :1858). Row b S + s of the layer is batch row b
// conditioned on speaker s: the kernel stages xs[b, t, :] * aux[b, s, :],
// rounded to the storage type once, where the fully fused forward stages
// x_t, and runs the same recurrence. So the (B, S, T, F) conditioned tensor
// is never written: the kernel reads xs (B, T, F) and aux (B, S, F) instead.
// The rows keep the port's b-major order (row = b S + s), so h comes out as
// (B, S, T, 2H) with no transpose; the TPU kernel's s-major rows within a
// batch block were a Mosaic work-around.
//
// Bound on an H100 at the flagship's birnn0 (B 16 or 256, S 8, T 316, F 513,
// H 300): operations, 2 rows x 2 directions x (F + H) x 4H per row and step
// on the tensor cores, 0.16 ms at batch 16 and 2.6 ms at batch 256 in bf16.
// At the served 128 rows the serial chain of T steps, each a product with
// W_hh that waits for the previous step's h, bounds it, as it bounds the
// fully fused forward.
//
// Two routes, by storage type:
// - bf16, the served and trained one: the conditioned form of the Hopper
//   design of blstm_cluster_fwd.cuh (template parameter COND): W_hh^T split
//   over a thread-block cluster and resident in shared memory, tensor-core
//   products, h exchanged through distributed shared memory, and the input
//   projection computed ahead of the walk by producer warps, which form the
//   conditioned rows as they stage x, from the tile's aux rows kept in shared
//   memory. It does the work of blstm_fullfused_fwd at B S rows, minus the
//   write and read of the materialized product.
// - f32, the tests' and checks' mode: the first design (blstm_common.cuh),
//   one block per (row tile, direction), products on the CUDA cores with
//   both weight matrices streamed from L2 every step.
#include "blstm_cluster_fwd.cuh"
#include "blstm_common.cuh"

// xs (B, T, F) with strides (x_sb, x_st, 1); aux (B S, F) contiguous;
// w_ih_t (2, F, 4H); bias (2, 4H) f32; w_hh_t (2, H, 4H); h_out, c_out
// (B S, T, 2H) with strides (o_sb, o_st, 1), c_out may be null. bf16 selects
// the storage type (0 float, 1 bf16), bt the batch tile in rows (4 or 16).
// Returns a cudaError_t.
extern "C" int tssep_blstm_fullfused_cond_fwd(const void* xs, long long x_sb, long long x_st,
                                              int F, const void* aux, int S,
                                              const void* w_ih_t, const void* bias,
                                              const void* w_hh_t, void* h_out, void* c_out,
                                              long long o_sb, long long o_st, int B, int T,
                                              int H, int bf16, int bt, void* stream) {
  return tssep::dispatch<true, true>(bf16, bt, xs, x_sb, x_st, F, aux, S, w_ih_t, bias, w_hh_t,
                                     h_out, c_out, o_sb, o_st, B * S, T, H, stream);
}

// The bf16 route. xs (B, T, F) bf16 with strides (x_sb, x_st, 1); aux
// (B S, F) bf16 contiguous; wih_p, whh_p, bias_p: the CTA slices of W_ih^T,
// W_hh^T and b in fragment order (kernels/blstm.py `_pack_fwd`); h_out,
// c_out (B S, T, 2H) bf16 with strides (o_sb, o_st, 1), c_out may be null.
// C CTAs a cluster, each owning U units, the first `nact` of them owning
// any; bt rows (of the B S) a tile, tc steps a chunk, F staged kx columns at
// a time. Returns a cudaError_t.
extern "C" int tssep_blstm_fullfused_cond_fwd_cluster(
    const void* xs, long long x_sb, long long x_st, int F, const void* aux, int S,
    const void* wih_p, const void* whh_p, const void* bias_p, void* h_out, void* c_out,
    long long o_sb, long long o_st, int B, int T, int H, int C, int U, int nact, int bt, int tc,
    int kx, void* stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  tssep::tc::FwdArgs a;
  a.x = static_cast<const __nv_bfloat16*>(xs);
  a.x_sb = x_sb;
  a.x_st = x_st;
  a.wih = static_cast<const uint4*>(wih_p);
  a.whh = static_cast<const uint4*>(whh_p);
  a.bias = static_cast<const float*>(bias_p);
  a.cols = nullptr;
  a.aux = static_cast<const __nv_bfloat16*>(aux);
  a.divS = tssep::tc::make_fastdiv((uint32_t)S);
  a.h_out = static_cast<__nv_bfloat16*>(h_out);
  a.c_out = static_cast<__nv_bfloat16*>(c_out);
  a.o_sb = o_sb;
  a.o_st = o_st;
  a.B = B * S;
  a.T = T;
  a.F = F;
  a.H = H;
  a.U = U;
  a.nact = nact;
  a.KH = (H + 15) / 16 * 16;
  a.KF = (F + 15) / 16 * 16;
  a.KX = kx;
  return tssep::tc::cluster_fwd<false, true>(a, C, bt, tc, static_cast<cudaStream_t>(stream));
}

// Clusters of C CTAs of the conditioned forward at row tile bt and chunk tc,
// each of `threads` threads and `smem` shared bytes, that the card holds at
// once, into `slots`. Returns a cudaError_t.
extern "C" int tssep_cond_fwd_slots(int C, int bt, int tc, int threads, int smem, int* slots) {
  using namespace tssep::tc;
  return cluster_slots(fwd_kernel<false, true>(bt, tc), threads, (size_t)smem, C, slots);
}
