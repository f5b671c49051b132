// Flash-attention forward on the Hopper tensor cores (sm_90a), bf16, with a
// plain C interface loaded through ctypes by
// paddle_tpu_torch/kernels/attention.py.
//
// Replaces: the Pallas kernel _flash_fwd_kernel, launched by
// _flash_call_fwd in paddle_tpu/kernels/attention.py, for bf16 inputs with
// D a multiple of 16 up to 128 and Tq >= 16 (kernels/attention.py's
// fwd_route; the rest takes csrc/flash_fwd.cu). It computes what
// flash_fwd.cu computes, with the same masking contract:
//   - scores are float32: s = (q . k) * scale, the scale applied to the
//     float32 accumulator (q * scale is never rounded to bf16);
//   - a masked key scores the finite -1e30 and the running max starts at
//     -1e30; a key past the end of a ragged last tile scores -inf (p = 0);
//     l is clamped at 1e-30. A row whose keys are all masked returns the
//     uniform mean of V with lse ~= -1e30, as the serving path's padded
//     rows need;
//   - l is summed from the float32 p, before p is rounded to bf16 for the
//     P.V product, so the lse the backward kernels consume stays float32;
//   - the kv mask [B, Tk] is indexed by bh / h; causal is top-left aligned,
//     and a K/V tile wholly in a row tile's future is skipped only without
//     a kv mask (with one, a row whose visible keys are all masked averages
//     over every key, as the plain version does).
//
// Layout: q [B*H, Tq, D], k and v [B*H, Tk, D], contiguous bf16 at 16-byte
// aligned bases, 16 <= D <= 128, D % 16 == 0; o [B*H, Tq, D] bf16, lse
// [B*H, Tq] float32.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s):
//   - training, [4*8, 4096, 4096, 64], every key kept: 4 D flops a score,
//     1.37e11 flops = 0.139 ms against 67 MB of q, k, v and o = 0.020 ms:
//     the tensor cores bound it;
//   - BERT-base, [32*12, 128, 128, 64] with padding: 25 MB = 7.5 us against
//     1.6e9 flops = 1.6 us; the serving encoder, [64*8, 64, 64, 64]: 17 MB
//     = ~4 us against 0.5 us of flops. Memory and the launch bound these.
// The SIMT kernel (flash_fwd.cu) runs float32 FMAs at ~1% of the first
// bound. This one runs both products on wgmma, keeps every load
// asynchronous and overlaps the products with the softmax:
//   - one warpgroup (128 threads) owns a 64-row Q tile; the grid is one
//     block per (Q tile, bh), Q tiles of a head adjacent, so that the
//     blocks of a head share its K/V in L2. At D <= 64 the kernel is held
//     to 128 registers, so that 4 blocks share an SM;
//   - Q [64, D] sits in shared memory, loaded once; K tiles of 64 keys sit
//     in a ring of 2 stages and V tiles in a ring of 3, filled with
//     cp.async (16 bytes a thread, zero-filled past the ragged edges): the
//     copies of tile t + 1 land while tile t computes;
//   - every tile is stored in the 128-byte swizzle that wgmma's shared
//     memory descriptors read (rows of 64 bf16, 16-byte chunk c of row r at
//     c ^ (r & 7); D > 64 as two such column blocks; D < 64 zero-padded),
//     so the loads and the products are free of bank conflicts;
//   - S = Q K^T is wgmma m64n64k16 with both operands K-major in shared
//     memory, one k16 step per 16 columns of the padded D;
//   - O += P V is wgmma m64n{64,128}k16 with P converted to bf16 in
//     registers and fed as the A operand (the accumulator layout of S is
//     wgmma's A-fragment layout), and V [keys, D] read MN-major (the
//     transpose bit) from the same swizzled layout;
//   - the products of tile t are S(t) and, committed behind it, P V of
//     tile t - 1: the softmax of tile t runs on the CUDA cores while P V
//     runs on the tensor cores. Tile 0 is peeled off the loop, so every
//     iteration has the same two wgmma groups and ptxas keeps them
//     asynchronous (a group committed under a branch made it serialize
//     every wgmma);
//   - the online softmax runs on the float32 accumulator fragments in base
//     2: a thread holds 2 rows x 16 keys of S, a row lives in 4 lanes (two
//     shuffles for the max), p = ex2(s * scale * log2 e - m) is one FFMA
//     and one MUFU where every key of the tile counts (the kv mask's 64
//     bytes of a tile are read once a warp and shared by ballot), and the
//     row sum stays a per-thread partial until the epilogue;
//   - the epilogue writes o / max(l, 1e-30) in bf16 and
//     lse = m ln 2 + ln max(l, 1e-30) in float32 once per row.
// Left for later work: TMA with a producer warp, two consumer warpgroups
// sharing a K/V tile, and o written through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;       // query rows of a block: wgmma's M
constexpr int kKeys = 64;       // keys of a K/V tile: the N of S = Q K^T
constexpr int kThreads = 128;   // one warpgroup
constexpr float kMaskValue = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// -- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with src_bytes 0 the destination is zeroed
// and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Writes made through the generic proxy (cp.async) become visible to
// wgmma, which reads shared memory through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B from shared memory,
// both K-major (no transpose).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (the accumulator
// layout), B from shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A from registers (the accumulator
// layout), B from shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// -- the kernel ----------------------------------------------------------

// A swizzled tile: [DP / 64 column blocks][rows][64 bf16]; a row is 128
// bytes, 8 rows (1024 bytes) one swizzle atom.
constexpr int kRowBytes = 128;
constexpr int kAtomBytes = 8 * kRowBytes;
// the masked score in the base-2 domain the softmax runs in: -1e30 * log2 e
constexpr float kMaskLog2 = kMaskValue * kLog2e;

// 2^x, one MUFU instruction (relative error ~2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Stage rows [0, 64) of a row-major [*, d] bf16 matrix whose first row is
// `src` (`nvalid` rows valid) into the tile at shared address `dst`. Rows at
// or past `nvalid` and columns at or past d are zero.
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int nvalid, int d) {
  constexpr int kChunks = DP / 8;   // 16-byte chunks of a padded row
#pragma unroll
  for (int it = 0; it < 64 * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks;
    const int cc = i % kChunks;
    const uint32_t s = dst + (cc >> 3) * (64 * kRowBytes) + r * kRowBytes +
                       (((cc & 7) ^ (r & 7)) << 4);
    const bool ok = r < nvalid && cc * 8 < d;
    cp_async16(s, ok ? src + (size_t)r * d + cc * 8 : src, ok ? 16 : 0);
  }
}

// Bit o: key k0 + o exists (k0 + o < tk) and the kv mask keeps it. The
// mask is one row per batch entry, the same for every query row: each warp
// reads the tile's 64 bytes once and shares them by ballot.
__device__ __forceinline__ uint64_t kept_keys(const uint8_t* mb, int k0,
                                              int tk, int lane) {
  const int a = k0 + lane;
  const int b = a + 32;
  const bool ka = a < tk && (mb == nullptr || mb[a] != 0);
  const bool kb = b < tk && (mb == nullptr || mb[b] != 0);
  return static_cast<uint64_t>(__ballot_sync(0xffffffffu, ka)) |
         (static_cast<uint64_t>(__ballot_sync(0xffffffffu, kb)) << 32);
}

// S = Q K^T for one K tile: every k16 step of the padded width (the zero
// columns past d add zeros; a chain without branches stays pipelined).
template <int DP>
__device__ __forceinline__ void qk_product(float (&s)[32], uint32_t q_s,
                                           uint32_t k_s) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk >> 2) * (64 * kRowBytes) + (kk & 3) * 32;
    wgmma_ss_n64(s, make_desc(q_s + off, 16, kAtomBytes),
                 make_desc(k_s + off, 16, kAtomBytes), kk > 0);
  }
}

// O += P V for one V tile: P from registers, V [keys, D] MN-major.
template <int DP>
__device__ __forceinline__ void pv_product(float (&acc_o)[DP / 2],
                                           const uint32_t (&pa)[4][4],
                                           uint32_t v_s) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv =
        make_desc(v_s + kk * 2 * kAtomBytes, 64 * kRowBytes, kAtomBytes);
    if constexpr (DP == 64)
      wgmma_rs_n64(acc_o, pa[kk], dv);
    else
      wgmma_rs_n128(acc_o, pa[kk], dv);
  }
}

// Keeps P's registers, which a running P V reads, from being rewritten or
// reused before the wait that retires it.
__device__ __forceinline__ void fence_pa(uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(pa[kk][x])::"memory");
}

// P in bf16, as wgmma's A fragments: k16 step kk takes s[8kk .. 8kk+7]
// (the m64nN accumulator layout is the A-fragment layout).
__device__ __forceinline__ void to_fragments(uint32_t (&pa)[4][4],
                                             const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const __nv_bfloat162 h2 =
          __floats2bfloat162_rn(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
      pa[kk][x] = *reinterpret_cast<const uint32_t*>(&h2);
    }
  }
}

// The online softmax of one tile on the S fragments, base 2:
// s[4j + 2r + e] is row rows[r], key k0 + 8j + 2 quad + e. Leaves
// p = 2^(s scale log2 e - m) in s, updates the running max m_i and the
// per-thread partial sums l_i (from the float32 p), and returns in corr
// the factor that rescales what O holds. `kept` bit o: key k0 + o exists
// and is kept; `full`: every key of the tile counts for every row.
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], float (&m_i)[2], float (&l_i)[2], float (&corr)[2],
    uint64_t kept, bool full, int k0, int tk, int causal,
    const int (&rows)[2], int quad, float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m_new;
    if (full) {
      float mx = s[2 * r];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_new = fmaxf(m_i[r], mx * scale_log2);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s[4 * j + 2 * r + e] =
              ex2(fmaf(s[4 * j + 2 * r + e], scale_log2, -m_new));
    } else {
      float mx = kMaskLog2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int off = j * 8 + quad * 2 + e;
          float x = s[4 * j + 2 * r + e] * scale_log2;
          if (!((kept >> off) & 1) || (causal && k0 + off > rows[r]))
            x = kMaskLog2;
          if (k0 + off >= tk) x = -INFINITY;   // past the end: no weight
          s[4 * j + 2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_new = fmaxf(m_i[r], mx);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s[4 * j + 2 * r + e] = ex2(s[4 * j + 2 * r + e] - m_new);
    }
    corr[r] = ex2(m_i[r] - m_new);
    m_i[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) sum += s[4 * (i >> 1) + 2 * r + (i & 1)];
    l_i[r] = l_i[r] * corr[r] + sum;
  }
}

// DP: D padded to 64 or 128. Block = (Q tile, bh), Q tiles fastest.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 4 : 1)
    flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const uint8_t* __restrict__ mask,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int h, int tq, int tk, int d,
                        float scale, int causal) {
  constexpr int kTile = 64 * DP * 2;        // bytes of a 64-row tile
  constexpr int kOut = DP / 2;              // O accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of address bits [4, 10): align to 1024
  const uint32_t base = (smem_addr(smem_raw) + kAtomBytes - 1) &
                        ~(uint32_t)(kAtomBytes - 1);
  const uint32_t q_s = base;
  // K tiles in a ring of 2 (tile t at k_s + (t % 2) kTile), V tiles in a
  // ring of 3 (v_s + (t % 3) kTile): P V of tile t - 1 runs behind S of
  // tile t while the copies of tile t + 1 land
  const uint32_t k_s = base + kTile;
  const uint32_t v_s = k_s + 2 * kTile;

  const int n_qt = (tq + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - bh * n_qt) * kRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quad = lane & 3;
  // the two rows this thread holds in every accumulator
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int rows[2] = {row0, row0 + 8};

  const __nv_bfloat16* qb = q + ((size_t)bh * tq + q0) * d;
  const __nv_bfloat16* kb = k + (size_t)bh * tk * d;
  const __nv_bfloat16* vb = v + (size_t)bh * tk * d;
  const uint8_t* mb = mask ? mask + (size_t)(bh / h) * tk : nullptr;

  // keys this block needs: causal without a mask stops at its last row
  const int k_end = (causal && mb == nullptr) ? min(tk, q0 + kRows) : tk;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  const float scale_log2 = scale * kLog2e;

  // Tile `t` lands: wait for its copies, make them visible to wgmma and to
  // every thread, then start the copies of tile t + 1: K into tile t - 1's
  // stage (its S was waited for before this barrier), V into tile t - 2's
  // (its P V too).
  auto arrive = [&](int t) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < n_tiles) {
      const int k1 = (t + 1) * kKeys;
      load_tile<DP>(k_s + ((t + 1) % 2) * kTile, kb + (size_t)k1 * d,
                    tk - k1, d);
      load_tile<DP>(v_s + ((t + 1) % 3) * kTile, vb + (size_t)k1 * d,
                    tk - k1, d);
    }
    cp_async_commit();
  };
  auto tile_kind = [&](int k0, bool& full) {
    const uint64_t kept = kept_keys(mb, k0, tk, lane);
    full = kept == ~0ull && !(causal && k0 + kKeys - 1 > q0);
    return kept;
  };

  load_tile<DP>(q_s, qb, tq - q0, d);
  load_tile<DP>(k_s, kb, tk, d);
  load_tile<DP>(v_s, vb, tk, d);
  cp_async_commit();

  float acc_o[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc_o[i] = 0.f;
  // the running max in the base-2 domain (score * scale * log2 e) and the
  // per-thread partial row sums
  float m_i[2] = {kMaskLog2, kMaskLog2};
  float l_i[2] = {0.f, 0.f};
  float corr[2];
  float s[32];
  uint32_t pa[4][4];   // P of the previous tile, bf16 A fragments
  bool full;

  // tile 0: S, then its softmax (O is still zero)
  arrive(0);
  fence_regs(s);
  wgmma_fence();
  qk_product<DP>(s, q_s, k_s);
  wgmma_commit();
  uint64_t kept = tile_kind(0, full);
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile(s, m_i, l_i, corr, kept, full, 0, tk, causal, rows, quad,
               scale_log2);
  to_fragments(pa, s);

  // tile it: S of tile it runs with P V of tile it - 1 behind it, and the
  // softmax of tile it runs while P V does
  for (int it = 1; it < n_tiles; ++it) {
    const int k0 = it * kKeys;
    arrive(it);
    fence_regs(s);
    fence_regs(acc_o);
    fence_pa(pa);
    wgmma_fence();
    qk_product<DP>(s, q_s, k_s + (it % 2) * kTile);
    wgmma_commit();
    pv_product<DP>(acc_o, pa, v_s + ((it - 1) % 3) * kTile);
    wgmma_commit();
    kept = tile_kind(k0, full);
    wgmma_wait<1>();      // S is done; P V may still run
    fence_regs(s);
    softmax_tile(s, m_i, l_i, corr, kept, full, k0, tk, causal, rows, quad,
                 scale_log2);
    wgmma_wait<0>();      // P V of tile it - 1 is in O
    fence_regs(acc_o);
    fence_pa(pa);
#pragma unroll
    for (int i = 0; i < kOut; ++i) acc_o[i] *= corr[(i >> 1) & 1];
    to_fragments(pa, s);
  }

  // O += P V of the last tile
  fence_regs(acc_o);
  fence_pa(pa);
  wgmma_fence();
  pv_product<DP>(acc_o, pa, v_s + ((n_tiles - 1) % 3) * kTile);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc_o);

  // epilogue: the row sums from the 4 lanes of each row; lse back from
  // base 2: m ln 2 + ln l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = fmaxf(l, 1e-30f);
    const float inv = 1.f / l_safe;
    const int row = rows[r];
    if (row < tq) {
      __nv_bfloat16* orow = o + ((size_t)bh * tq + row) * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = j * 8 + quad * 2;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc_o[4 * j + 2 * r] * inv,
                                    acc_o[4 * j + 2 * r + 1] * inv);
      }
      if (quad == 0)
        lse[(size_t)bh * tq + row] = m_i[r] / kLog2e + logf(l_safe);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* o, void* lse, int bh, int h, int tq, int tk, int d,
           float scale, int causal, cudaStream_t stream) {
  // Q, 2 K and 3 V tiles, plus room to align the base to 1024 bytes
  constexpr int smem = 64 * DP * 2 * 6 + kAtomBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((tq + kRows - 1) / kRows) * bh;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_fwd_tc_kernel<DP><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), h, tq, tk, d, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). bf16 only; mask may
// be null. Launches on `stream`, allocates nothing and does not
// synchronize. Refuses (cudaErrorInvalidValue) what the kernel does not
// take: D not a multiple of 16 in 16..128, a base not 16-byte aligned.
extern "C" int flash_fwd_tc(const void* q, const void* k, const void* v,
                            const void* mask, void* o, void* lse, int bh,
                            int h, int tq, int tk, int d, float scale,
                            int causal, void* stream) {
  if (bh < 1 || h < 1 || tq < 1 || tk < 1 || d < 16 || d > 128 ||
      d % 16 != 0 || bh % h != 0 ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch<64>(q, k, v, mask, o, lse, bh, h, tq, tk, d, scale, causal,
                      s);
  return launch<128>(q, k, v, mask, o, lse, bh, h, tq, tk, d, scale, causal,
                     s);
}
