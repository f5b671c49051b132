// Flash-attention dQ backward on the Hopper tensor cores (sm_90a), bf16,
// with a plain C interface loaded through ctypes by
// paddle_tpu_torch/kernels/attention.py.
//
// Replaces: the Pallas kernel _flash_bwd_dq_kernel, launched by
// _flash_train_bwd in paddle_tpu/kernels/attention.py, for bf16 inputs with
// 16 <= D <= 64, D % 16 == 0 (kernels/attention.py's bwd_route; the rest
// takes flash_bwd.cu's flash_bwd_dq). It computes what that SIMT kernel
// computes, with the same masking contract, for one query tile over every
// key tile:
//   s  = (q . k) * scale        the scale applied to the float32 product
//   p  = exp(s - lse)           masked scores are the finite -1e30
//   dp = do . v
//   ds = p (dp - dvec)          dvec = sum_d(do * o), from the wrapper
//   dq = scale * sum_k ds k     the scale applied once, to the float32 sum
//   - a masked key (kv mask, or causal: key > query) scores -1e30, so a row
//     whose keys are all masked (lse ~= -1e30) gives p = 1 for every key,
//     as the plain version and the JAX kernels do; a key past Tk
//     contributes nothing (p = 0, set explicitly); query rows past Tq are
//     not written;
//   - the kv mask [B, Tk] is indexed by bh / h; causal is top-left aligned,
//     and the key tiles wholly after a query tile are skipped only without
//     a kv mask (there p is exactly 0 on them; with a mask, a row whose
//     visible keys are all masked has p = 1 on every key).
//
// Layout: q, do [B*H, Tq, D], k, v [B*H, Tk, D], contiguous bf16 at 16-byte
// aligned bases; lse, dvec [B*H, Tq] float32; dq [B*H, Tq, D] bf16.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): 6 D flops a
// kept score (q.k, do.v, ds.k), against q, do, k, v, dq, lse and dvec read
// or written once. At the training shape [4*8, 4096, 4096, 64] that is
// 2.06e11 flops = 0.209 ms against ~85 MB = 0.025 ms: the tensor cores
// bound it. The SIMT kernel runs float32 FMAs at ~1.3% of that. This one
// runs the products on wgmma m64n64k16 with float32 accumulators, and
// executes 8 D flops a score (dS goes in as two terms, below):
//   - one warpgroup (128 threads) owns a tile of 64 queries of one head;
//     the grid is one block per (query tile, bh), the query tiles of a head
//     adjacent, so that head's K and V stream from L2. The block owns its
//     dq rows: no atomics, no second pass;
//   - Q and dO [64, D] sit in shared memory, loaded once; the K and V tiles
//     of 64 keys, with the tile's mask bytes, sit in a ring of 3 stages
//     filled with cp.async (zero-filled past Tk and past D): the copies of
//     key tile t + 1 land while tile t computes. Every tile is in the
//     128-byte swizzle that wgmma's descriptors read (igemm_tc.cuh), D < 64
//     zero-padded. A thread's two query rows give it its two lse and dvec
//     values, held in registers;
//   - S = Q K^T and dP = dO V^T: both operands K-major in shared memory
//     (wgmma_nn_n64), queries the M of the product;
//   - dQ += dS K: A is dS converted to bf16 in registers (the accumulator
//     layout of S is the A-fragment layout), B is the K tile [keys, D] read
//     MN-major (wgmma_rt_n64): the K tile is read both ways, as the dK/dV
//     kernel reads its Q tile;
//   - dS goes in as two bf16 terms, hi = bf16(ds) and lo = bf16(ds - hi),
//     two products summed in float32 (four products a tile, not three):
//     where p is not small, as in a row whose keys are all masked (p = 1),
//     |ds| = |dp - dvec| is undamped, and the 2^-9 rounding of one bf16
//     term, summed over the keys, would part dq from the plain version's
//     float32 products by more than its gate;
//   - the products of tile t are S and dP of t, and, committed behind them,
//     dQ of tile t - 1: P and dS of tile t are computed on the CUDA cores
//     while the tensor cores run the accumulation of t - 1. The first tile
//     is peeled off the loop, so every iteration has the same two wgmma
//     groups and ptxas keeps them asynchronous;
//   - p = ex2(s * scale * log2 e - lse * log2 e), one FFMA and one MUFU a
//     score where the tile needs no mask. The mask bytes of key tile t + 1
//     are loaded into a register while tile t computes and stored into
//     the ring at the barrier of tile t + 1, whose predicate also tells
//     whether every key of that tile is kept.
// Left for later work: D = 128 (dQ of 128 columns needs another split of
// the registers), two consumer warpgroups sharing a K/V tile, TMA with a
// producer warp.

#include <limits.h>
#include <math.h>

#include "igemm_tc.cuh"

namespace {

using namespace igemm_tc;

constexpr int kQueries = 64;     // queries of a block: the M of every product
constexpr int kKeys = 64;        // keys of a streamed tile
constexpr int kThreads = 128;    // one warpgroup
constexpr int kStages = 3;       // the K/V ring
constexpr int kTile = 64 * kRowBytes;   // bytes of a [64, 64] bf16 tile
constexpr float kMaskValue = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// the shared memory of a block: Q, dO, the K and V rings, then the ring of
// the key tiles' mask bytes, plus room to align the tiles to a swizzle atom
constexpr int kKOff = 2 * kTile;
constexpr int kVOff = kKOff + kStages * kTile;
constexpr int kKeptOff = kVOff + kStages * kTile;
constexpr int kSmemBytes = kKeptOff + kStages * kKeys + kAtomBytes;

// P and dS of one key tile on the accumulator fragments: s[4j + 2r + e]
// and dp[...] are query rows[r], key k0 + 8j + 2 quad + e. Leaves p in s
// and ds = p (dp - dvec) in dp. `kept_t`: the tile's 64 bytes, 1 where the
// key exists and the kv mask keeps it. `full`: every key of the tile is
// kept and none is in a causal future.
__device__ __forceinline__ void p_and_ds(float (&s)[32], float (&dp)[32],
                                         const uint8_t* kept_t, bool full,
                                         int k0, int tk, const int (&rows)[2],
                                         const float (&lse)[2],
                                         const float (&dvec)[2], int causal,
                                         int quad, float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * quad;
    const uchar2 kept2 = *reinterpret_cast<const uchar2*>(kept_t + c);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + c + e;
      const bool kept = (e ? kept2.y : kept2.x) != 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + e;
        const float lse_log2 = lse[r] * kLog2e;
        float p;
        if (full) {
          p = ex2(fmaf(s[i], scale_log2, -lse_log2));
        } else {
          const bool masked = !kept || (causal && key > rows[r]);
          // a masked score is -1e30, and s - lse is taken in float32 as
          // the plain version takes it (0 where lse ~= -1e30)
          const float x = masked ? (kMaskValue - lse[r]) * kLog2e
                                 : fmaf(s[i], scale_log2, -lse_log2);
          p = key < tk ? ex2(x) : 0.f;
        }
        s[i] = p;
        dp[i] = p * (dp[i] - dvec[r]);
      }
    }
  }
}

// Block = (query tile, bh), query tiles fastest. D <= 64, padded to 64.
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ dvec,
                           const uint8_t* __restrict__ mask,
                           __nv_bfloat16* __restrict__ dq, int h, int tq,
                           int tk, int d, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  // the swizzle is a function of address bits [4, 10): align to 1024
  const uint32_t base = (raw + kAtomBytes - 1) & ~(uint32_t)(kAtomBytes - 1);
  const uint32_t q_s = base;
  const uint32_t do_s = base + kTile;
  uint8_t* kept_s = smem_raw + (base - raw) + kKeptOff;

  const int n_qt = (tq + kQueries - 1) / kQueries;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - bh * n_qt) * kQueries;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quad = lane & 3;
  // the two queries this thread holds in every accumulator
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int rows[2] = {row0, row0 + 8};

  const __nv_bfloat16* kb = k + (size_t)bh * tk * d;
  const __nv_bfloat16* vb = v + (size_t)bh * tk * d;
  const uint8_t* mb = mask ? mask + (size_t)(bh / h) * tk : nullptr;

  // the rows' lse and dvec (0 past Tq: those rows are not written)
  float lse_r[2], dvec_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < tq;
    lse_r[r] = ok ? lse[(size_t)bh * tq + rows[r]] : 0.f;
    dvec_r[r] = ok ? dvec[(size_t)bh * tq + rows[r]] : 0.f;
  }

  const int n_kt_all = (tk + kKeys - 1) / kKeys;
  // causal without a mask: the key tiles after this query tile's last
  // query see none of its queries (p = 0 there)
  const int n_kt = (causal && mb == nullptr)
                       ? min(n_kt_all, (min(q0 + kQueries, tq) - 1) / kKeys + 1)
                       : n_kt_all;
  const float scale_log2 = scale * kLog2e;

  auto k_tile = [&](int t) { return base + kKOff + (t % kStages) * kTile; };
  auto v_tile = [&](int t) { return base + kVOff + (t % kStages) * kTile; };
  auto kept_tile = [&](int t) { return kept_s + (t % kStages) * kKeys; };
  auto load_keys = [&](int t) {
    const int k0 = t * kKeys;
    load_tile_64(k_tile(t), kb + (size_t)k0 * d, tk - k0, d);
    load_tile_64(v_tile(t), vb + (size_t)k0 * d, tk - k0, d);
  };
  // Thread i < 64 carries the mask byte of key i of the next tile, loaded
  // a tile ahead so that no thread waits on it (1 without a mask).
  uint8_t mask_byte = 1;
  auto fetch_mask = [&](int t) {
    const int key = t * kKeys + threadIdx.x;
    mask_byte = 1;
    if (mb != nullptr && threadIdx.x < kKeys && key < tk) mask_byte = mb[key];
  };
  // Key tile t lands: store its mask bytes, wait for its copies, make them
  // visible to wgmma and to every thread, then start the copies of tile
  // t + 1 into the stage of tile t - 2 (whose products were all waited for
  // before this barrier). Returns whether every key of tile t is kept.
  auto arrive = [&](int t) {
    const bool kept = t * kKeys + (int)threadIdx.x < tk && mask_byte != 0;
    if (threadIdx.x < kKeys) kept_tile(t)[threadIdx.x] = kept;
    cp_async_wait<0>();
    fence_proxy_async();
    const bool keys_full =
        __syncthreads_and(threadIdx.x >= kKeys || kept) != 0;
    if (t + 1 < n_kt) {
      load_keys(t + 1);
      fetch_mask(t + 1);
    }
    cp_async_commit();
    return keys_full && !(causal && t * kKeys + kKeys - 1 > q0);
  };

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  load_tile_64(q_s, q + ((size_t)bh * tq + q0) * d, tq - q0, d);
  load_tile_64(do_s, dout + ((size_t)bh * tq + q0) * d, tq - q0, d);
  load_keys(0);
  fetch_mask(0);
  cp_async_commit();

  float s[32], dp[32];
  // dS (as hi + lo) of the previous tile
  uint32_t dsa[4][4], dsl[4][4];

  // the first tile: S and dP, then P and dS (dQ still zero)
  bool full = arrive(0);
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
  product_nn_64(s, q_s, k_tile(0));
  product_nn_64(dp, do_s, v_tile(0));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  p_and_ds(s, dp, kept_tile(0), full, 0, tk, rows, lse_r, dvec_r, causal,
           quad, scale_log2);
  to_fragments_split(dsa, dsl, dp);

  // tile t: S and dP of t run with dQ of t - 1 behind them, and P and dS
  // of t are computed while that does
  for (int t = 1; t < n_kt; ++t) {
    full = arrive(t);
    fence_regs(s);
    fence_regs(dp);
    fence_regs(acc);
    fence_frags(dsa);
    fence_frags(dsl);
    wgmma_fence();
    product_nn_64(s, q_s, k_tile(t));
    product_nn_64(dp, do_s, v_tile(t));
    wgmma_commit();
    product_rt_64(acc, dsa, k_tile(t - 1));
    product_rt_64(acc, dsl, k_tile(t - 1));
    wgmma_commit();
    wgmma_wait<1>();      // S and dP are done; dQ may still run
    fence_regs(s);
    fence_regs(dp);
    p_and_ds(s, dp, kept_tile(t), full, t * kKeys, tk, rows, lse_r, dvec_r,
             causal, quad, scale_log2);
    wgmma_wait<0>();      // dQ of tile t - 1 is in the sum
    fence_regs(acc);
    fence_frags(dsa);
    fence_frags(dsl);
    to_fragments_split(dsa, dsl, dp);
  }

  // dQ of the last tile
  fence_regs(acc);
  fence_frags(dsa);
  fence_frags(dsl);
  wgmma_fence();
  product_rt_64(acc, dsa, k_tile(n_kt - 1));
  product_rt_64(acc, dsl, k_tile(n_kt - 1));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: dq = scale * sum_k ds k, rounded once to bf16; queries past
  // Tq and columns past d are not written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= tq) continue;
    __nv_bfloat16* out = dq + ((size_t)bh * tq + rows[r]) * d;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + quad * 2;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                  acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). bf16 only; mask may
// be null. Launches on `stream`, allocates nothing and does not
// synchronize. Refuses (cudaErrorInvalidValue) what the kernel does not
// take: D not a multiple of 16 in 16..64, a base not 16-byte aligned, a
// grid past INT_MAX blocks.
extern "C" int flash_bwd_dq_tc(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* dvec, const void* mask, void* dq,
                               int bh, int h, int tq, int tk, int d,
                               float scale, int causal, void* stream) {
  if (bh < 1 || h < 1 || tq < 1 || tk < 1 || d < 16 || d > 64 ||
      d % 16 != 0 || bh % h != 0 ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
        (uintptr_t)dq) % 16))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((tq + kQueries - 1) / kQueries) * bh;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_tc_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(dq), h,
      tq, tk, d, scale, causal);
  return (int)cudaGetLastError();
}
