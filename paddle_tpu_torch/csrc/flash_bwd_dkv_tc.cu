// Flash-attention dK/dV backward on the Hopper tensor cores (sm_90a), bf16,
// with a plain C interface loaded through ctypes by
// paddle_tpu_torch/kernels/attention.py.
//
// Replaces: the Pallas kernel _flash_bwd_dkv_kernel, launched by
// _flash_train_bwd in paddle_tpu/kernels/attention.py, for bf16 inputs with
// 16 <= D <= 64, D % 16 == 0 (kernels/attention.py's bwd_route; the rest
// takes flash_bwd.cu's flash_bwd_dkv). It computes what that SIMT kernel
// computes, with the same masking contract, for one key tile over every
// query tile:
//   s  = (q . k) * scale        the scale applied to the float32 product
//   p  = exp(s - lse)           masked scores are the finite -1e30
//   dv = sum_q p do
//   dp = do . v
//   ds = p (dp - dvec)          dvec = sum_d(do * o), from the wrapper
//   dk = scale * sum_q ds q     the scale applied once, to the float32 sum
//   - a masked key (kv mask, or causal: key > query) scores -1e30, so a row
//     whose keys are all masked (lse ~= -1e30) gives p = 1 for every key,
//     as the plain version and the JAX kernels do; a query past Tq
//     contributes nothing (p = 0); key rows past Tk are not written;
//   - the kv mask [B, Tk] is indexed by bh / h; causal is top-left aligned,
//     and the query tiles wholly before a key tile are skipped only without
//     a kv mask (there p is exactly 0 on them; with a mask, a row whose
//     visible keys are all masked has p = 1 on every key).
//
// Layout: q, do [B*H, Tq, D], k, v [B*H, Tk, D], contiguous bf16 at 16-byte
// aligned bases; lse, dvec [B*H, Tq] float32; dk, dv [B*H, Tk, D] bf16.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): 8 D flops a
// kept score (four products), against q, do, k, v, dk, dv, lse and dvec
// read or written once. At the training shape [4*8, 4096, 4096, 64] that
// is 2.75e11 flops = 0.278 ms against 101 MB = 0.030 ms: the tensor cores
// bound it. The SIMT kernel runs float32 FMAs at ~1.4% of that. This one
// runs the products on wgmma m64n64k16 with float32 accumulators:
//   - one warpgroup (128 threads) owns a tile of 64 keys of one head; the
//     grid is one block per (key tile, bh), the key tiles of a head
//     adjacent, so that head's Q and dO stream from L2. The block owns its
//     dk and dv rows: no atomics, no second pass;
//   - K and V [64, D] sit in shared memory, loaded once; the Q and dO
//     tiles of 64 queries, with their 64 lse and dvec values, sit in a
//     ring of 3 stages filled with cp.async (zero-filled past Tq and past
//     D): the copies of query tile t + 1 land while tile t computes. Every
//     tile is in the 128-byte swizzle that wgmma's descriptors read
//     (igemm_tc.cuh), D < 64 zero-padded;
//   - S^T = K Q^T and dP^T = V dO^T: both operands K-major in shared
//     memory (wgmma_nn_n64), keys the M of the product;
//   - dV += P^T dO and dK += dS^T Q: A is P^T or dS^T converted to bf16 in
//     registers (the accumulator layout of S^T is the A-fragment layout),
//     B is dO or Q [queries, D] read MN-major (wgmma_rt_n64);
//   - dS^T goes in as two bf16 terms, hi = bf16(ds) and lo = bf16(ds - hi),
//     two products summed in float32 (five products a tile, not four):
//     where p is not small, as in a row whose keys are all masked (p = 1),
//     |ds| = |dp - dvec| is undamped, and the 2^-9 rounding of one bf16
//     term, summed over the queries, would part dk from the plain version's
//     float32 products by more than its gate;
//   - the products of tile t are S^T and dP^T of t, and, committed behind
//     them, dV and dK of tile t - 1: P and dS of tile t are computed on
//     the CUDA cores while the tensor cores run the accumulation of t - 1.
//     The first tile is peeled off the loop, so every iteration has the
//     same two wgmma groups and ptxas keeps them asynchronous;
//   - p = ex2(s * scale * log2 e - lse * log2 e), one FFMA and one MUFU a
//     score where the tile needs no mask; the 64 lse and dvec of a tile are
//     read from shared memory by accumulator column.
// Left for later work: D = 128 (dK and dV of 128 columns need another split
// of the registers), two consumer warpgroups sharing a Q/dO tile, TMA with
// a producer warp.

#include <limits.h>
#include <math.h>

#include "igemm_tc.cuh"

namespace {

using namespace igemm_tc;

constexpr int kKeys = 64;        // keys of a block: the M of every product
constexpr int kQueries = 64;     // queries of a streamed tile
constexpr int kThreads = 128;    // one warpgroup
constexpr int kStages = 3;       // the Q/dO ring
constexpr int kTile = 64 * kRowBytes;   // bytes of a [64, 64] bf16 tile
constexpr float kMaskValue = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// the shared memory of a block: K, V, the Q and dO rings, then the lse and
// dvec rings, plus room to align the tiles to a swizzle atom
constexpr int kQOff = 2 * kTile;
constexpr int kDoOff = kQOff + kStages * kTile;
constexpr int kLseOff = kDoOff + kStages * kTile;
constexpr int kDvecOff = kLseOff + kStages * kQueries * 4;
constexpr int kSmemBytes = kDvecOff + kStages * kQueries * 4 + kAtomBytes;

// P and dS of one query tile on the accumulator fragments: s[4j + 2r + e]
// and dp[...] are key rows[r], query q0 + 8j + 2 quad + e. Leaves p in s
// and ds = p (dp - dvec) in dp. `full`: no key or query of the tile is
// masked, past its end or in a causal future.
__device__ __forceinline__ void p_and_ds(float (&s)[32], float (&dp)[32],
                                         const float* lse_t,
                                         const float* dvec_t, bool full,
                                         int q0, int tq, const int (&rows)[2],
                                         const bool (&key_ok)[2], int causal,
                                         int quad, float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * quad;
    const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
    const float2 g2 = *reinterpret_cast<const float2*>(dvec_t + c);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float lse = e ? l2.y : l2.x;
      const float dvec = e ? g2.y : g2.x;
      const float lse_log2 = lse * kLog2e;
      const int qi = q0 + c + e;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + e;
        float p;
        if (full) {
          p = ex2(fmaf(s[i], scale_log2, -lse_log2));
        } else {
          const bool masked = !key_ok[r] || (causal && rows[r] > qi);
          // a masked score is -1e30, and s - lse is taken in float32 as
          // the plain version takes it (0 where lse ~= -1e30)
          const float x = masked ? (kMaskValue - lse) * kLog2e
                                 : fmaf(s[i], scale_log2, -lse_log2);
          p = qi < tq ? ex2(x) : 0.f;
        }
        s[i] = p;
        dp[i] = p * (dp[i] - dvec);
      }
    }
  }
}

// Block = (key tile, bh), key tiles fastest. D <= 64, padded to 64.
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dvec,
                            const uint8_t* __restrict__ mask,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int h, int tq,
                            int tk, int d, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  // the swizzle is a function of address bits [4, 10): align to 1024
  const uint32_t base = (raw + kAtomBytes - 1) & ~(uint32_t)(kAtomBytes - 1);
  const uint32_t k_s = base;
  const uint32_t v_s = base + kTile;
  float* lse_s = reinterpret_cast<float*>(smem_raw + (base - raw) + kLseOff);
  float* dvec_s =
      reinterpret_cast<float*>(smem_raw + (base - raw) + kDvecOff);

  const int n_kt = (tk + kKeys - 1) / kKeys;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x - bh * n_kt) * kKeys;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quad = lane & 3;
  // the two keys this thread holds in every accumulator
  const int row0 = k0 + warp * 16 + (lane >> 2);
  const int rows[2] = {row0, row0 + 8};

  const __nv_bfloat16* qb = q + (size_t)bh * tq * d;
  const __nv_bfloat16* dob = dout + (size_t)bh * tq * d;
  const float* lseb = lse + (size_t)bh * tq;
  const float* dvecb = dvec + (size_t)bh * tq;
  const uint8_t* mb = mask ? mask + (size_t)(bh / h) * tk : nullptr;

  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    key_ok[r] = rows[r] < tk && (mb == nullptr || mb[rows[r]] != 0);
  // every key of the tile exists and is kept
  const bool keys_full = __syncthreads_and(key_ok[0] && key_ok[1]);

  const int n_qt = (tq + kQueries - 1) / kQueries;
  // causal without a mask: the query tiles before this key tile see none
  // of its keys (p = 0 there). A key tile past the last query still runs
  // that last tile, whose p is all 0, so every block runs the same code.
  const int lo = (causal && mb == nullptr) ? min(k0 / kQueries, n_qt - 1)
                                           : 0;
  const float scale_log2 = scale * kLog2e;

  auto q_tile = [&](int t) { return base + kQOff + (t % kStages) * kTile; };
  auto do_tile = [&](int t) { return base + kDoOff + (t % kStages) * kTile; };
  // query tile t into its stage: Q, dO, and its lse and dvec (zero past Tq)
  auto load_queries = [&](int t) {
    const int q0 = t * kQueries;
    load_tile_64(q_tile(t), qb + (size_t)q0 * d, tq - q0, d);
    load_tile_64(do_tile(t), dob + (size_t)q0 * d, tq - q0, d);
    const int i = threadIdx.x & (kQueries - 1);
    const bool is_lse = threadIdx.x < kQueries;
    float* dst = (is_lse ? lse_s : dvec_s) + (t % kStages) * kQueries + i;
    const float* src = is_lse ? lseb : dvecb;
    const bool ok = q0 + i < tq;
    cp_async4(smem_addr(dst), ok ? src + q0 + i : src, ok ? 4 : 0);
  };
  // Query tile t lands: wait for its copies, make them visible to wgmma and
  // to every thread, then start the copies of tile t + 1 into the stage of
  // tile t - 2 (whose products were all waited for before this barrier).
  auto arrive = [&](int t) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < n_qt) load_queries(t + 1);
    cp_async_commit();
  };
  auto tile_full = [&](int t) {
    const int q0 = t * kQueries;
    return keys_full && q0 + kQueries <= tq &&
           !(causal && q0 < k0 + kKeys - 1);
  };

  float acc_dk[32], acc_dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  load_tile_64(k_s, k + ((size_t)bh * tk + k0) * d, tk - k0, d);
  load_tile_64(v_s, v + ((size_t)bh * tk + k0) * d, tk - k0, d);
  load_queries(lo);
  cp_async_commit();

  float s[32], dp[32];
  // P^T and dS^T (as hi + lo) of the previous tile
  uint32_t pa[4][4], dsa[4][4], dsl[4][4];

  // the first tile: S^T and dP^T, then P and dS (dK and dV still zero)
  arrive(lo);
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
  product_nn_64(s, k_s, q_tile(lo));
  product_nn_64(dp, v_s, do_tile(lo));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  p_and_ds(s, dp, lse_s + (lo % kStages) * kQueries,
           dvec_s + (lo % kStages) * kQueries, tile_full(lo),
           lo * kQueries, tq, rows, key_ok, causal, quad, scale_log2);
  to_fragments(pa, s);
  to_fragments_split(dsa, dsl, dp);

  // tile t: S^T and dP^T of t run with dV and dK of t - 1 behind them,
  // and P and dS of t are computed while those do
  for (int t = lo + 1; t < n_qt; ++t) {
    arrive(t);
    fence_regs(s);
    fence_regs(dp);
    fence_regs(acc_dk);
    fence_regs(acc_dv);
    fence_frags(pa);
    fence_frags(dsa);
    fence_frags(dsl);
    wgmma_fence();
    product_nn_64(s, k_s, q_tile(t));
    product_nn_64(dp, v_s, do_tile(t));
    wgmma_commit();
    product_rt_64(acc_dv, pa, do_tile(t - 1));
    product_rt_64(acc_dk, dsa, q_tile(t - 1));
    product_rt_64(acc_dk, dsl, q_tile(t - 1));
    wgmma_commit();
    wgmma_wait<1>();      // S^T and dP^T are done; dV, dK may still run
    fence_regs(s);
    fence_regs(dp);
    p_and_ds(s, dp, lse_s + (t % kStages) * kQueries,
             dvec_s + (t % kStages) * kQueries, tile_full(t),
             t * kQueries, tq, rows, key_ok, causal, quad, scale_log2);
    wgmma_wait<0>();      // dV and dK of tile t - 1 are in the sums
    fence_regs(acc_dk);
    fence_regs(acc_dv);
    fence_frags(pa);
    fence_frags(dsa);
    fence_frags(dsl);
    to_fragments(pa, s);
    to_fragments_split(dsa, dsl, dp);
  }

  // dV and dK of the last tile
  fence_regs(acc_dk);
  fence_regs(acc_dv);
  fence_frags(pa);
  fence_frags(dsa);
  fence_frags(dsl);
  wgmma_fence();
  product_rt_64(acc_dv, pa, do_tile(n_qt - 1));
  product_rt_64(acc_dk, dsa, q_tile(n_qt - 1));
  product_rt_64(acc_dk, dsl, q_tile(n_qt - 1));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc_dk);
  fence_regs(acc_dv);

  // epilogue: dk = scale * sum_q ds q, dv as summed; keys past Tk and
  // columns past d are not written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= tk) continue;
    const size_t off = ((size_t)bh * tk + rows[r]) * d;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + quad * 2;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
            __floats2bfloat162_rn(acc_dk[4 * j + 2 * r] * scale,
                                  acc_dk[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
            __floats2bfloat162_rn(acc_dv[4 * j + 2 * r],
                                  acc_dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). bf16 only; mask may
// be null. Launches on `stream`, allocates nothing and does not
// synchronize. Refuses (cudaErrorInvalidValue) what the kernel does not
// take: D not a multiple of 16 in 16..64, a base not 16-byte aligned.
extern "C" int flash_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* dvec, const void* mask, void* dk,
                                void* dv, int bh, int h, int tq, int tk,
                                int d, float scale, int causal,
                                void* stream) {
  if (bh < 1 || h < 1 || tq < 1 || tk < 1 || d < 16 || d > 64 ||
      d % 16 != 0 || bh % h != 0 ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
        (uintptr_t)dk | (uintptr_t)dv) % 16))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((tk + kKeys - 1) / kKeys) * bh;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_tc_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), h, tq, tk, d, scale, causal);
  return (int)cudaGetLastError();
}
