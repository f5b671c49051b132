// Tensor-core pieces of the conv kernels' implicit GEMM, for Hopper
// (sm_90a): the 128-byte-swizzled tile layout that wgmma's shared-memory
// descriptors read, the descriptors, the bf16 wgmma wrappers (both operands
// in shared memory, or A from registers, with the conversion of float32
// accumulators into A fragments), the [64, 64] tile loads and products the
// attention backward kernels share, a cp.async ring of stages, and the
// base-2 exponent an attention kernel's softmax takes.
// conv_kxk_dw_tc.cu, conv_kxk_fwd_tc.cu, flash_bwd_dq_tc.cu and
// flash_bwd_dkv_tc.cu build on it; the SIMT core (igemm.cuh) stays beside
// it for float32.
//
// The layout: a tile is a set of 64-column blocks, each [rows][64 bf16],
// one 128-byte row per row; the 16-byte chunk c of row r sits at
// c ^ (r & 7). Eight rows (1024 bytes) are one swizzle atom. A tile whose
// rows run along K and whose columns run along M (or N) is "MN-major": the
// wgmma reads it through its transpose bit, 16 rows (one k16 step, 2048
// bytes) at a time, with the stride byte offset one atom (1024 bytes) and
// the leading byte offset one 64-column block. A tile whose rows run along
// M (or N) and whose 64 columns run along K is "K-major": the wgmma reads
// it as it is (transpose bit 0), a k16 step 32 bytes further along each
// row, with the stride byte offset one atom.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace igemm_tc {

constexpr int kRowBytes = 128;              // one row of a 64-column block
constexpr int kAtomBytes = 8 * kRowBytes;   // one swizzle atom
constexpr int kStepBytes = 16 * kRowBytes;  // one k16 step of an MN-major tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `c` (0..7) of row `r` in a 64-column block.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return r * kRowBytes + (((c ^ r) & 7) << 4);
}

// 16 bytes global -> shared; with src_bytes 0 the destination is zeroed
// and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; with src_bytes 0 the destination is zeroed.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Writes made through the generic proxy (cp.async, st.shared) become
// visible to wgmma, which reads shared memory through the async proxy.
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

// The descriptor of k16 step `kk` of an MN-major tile at `tile`.
__device__ __forceinline__ uint64_t mn_major_desc(uint32_t tile, int kk) {
  return make_desc(tile + kk * kStepBytes, 64 * kRowBytes, kAtomBytes);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both operands MN-major in
// shared memory (both transpose bits set); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_tt_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], both operands MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_tt_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], N = 64 or 128 by the size of `d`.
__device__ __forceinline__ void wgmma_tt(float (&d)[32], uint64_t da,
                                        uint64_t db, int scale_d) {
  wgmma_tt_n64(d, da, db, scale_d);
}
__device__ __forceinline__ void wgmma_tt(float (&d)[64], uint64_t da,
                                        uint64_t db, int scale_d) {
  wgmma_tt_n128(d, da, db, scale_d);
}

// The descriptor of k16 step `kk` (0..3) of a K-major 64-column block at
// `tile`; the leading byte offset is unused in the swizzled K-major form.
__device__ __forceinline__ uint64_t k_major_desc(uint32_t tile, int kk) {
  return make_desc(tile + kk * 32, 16, kAtomBytes);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A K-major and B MN-major in
// shared memory (only B's transpose bit set); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_nt_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A K-major and B MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_nt_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x N] (+)= A[64 x 16] B[16 x N] with A K-major, N = 64 or 128 by the
// size of `d`.
__device__ __forceinline__ void wgmma_nt(float (&d)[32], uint64_t da,
                                        uint64_t db, int scale_d) {
  wgmma_nt_n64(d, da, db, scale_d);
}
__device__ __forceinline__ void wgmma_nt(float (&d)[64], uint64_t da,
                                        uint64_t db, int scale_d) {
  wgmma_nt_n128(d, da, db, scale_d);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both operands K-major in shared
// memory (no transpose bit); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_nn_n64(float (&d)[32], uint64_t da,
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

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers, four bf16x2 in
// the m64 accumulator layout (row w*16 + lane/4 (+8), columns 2*(lane%4)
// (+8)), B MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rt_n64(float (&d)[32],
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

// Keeps A-fragment registers, which a running wgmma reads, from being
// rewritten or reused before the wait that retires it.
__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(f[kk][x])::"memory");
}

// x in bf16, as wgmma_rt_n64's A fragments: k16 step kk takes
// x[8kk .. 8kk+7] (the m64n64 accumulator layout is the A-fragment layout).
__device__ __forceinline__ void to_fragments(uint32_t (&f)[4][4],
                                             const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h2 =
          __floats2bfloat162_rn(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
      f[kk][i] = *reinterpret_cast<const uint32_t*>(&h2);
    }
  }
}

// x as two sets of A fragments, hi = bf16(x) and lo = bf16(x - hi): a
// product of hi and one of lo, summed in float32, carries ~16 bits of x
// where hi alone carries 8.
__device__ __forceinline__ void to_fragments_split(uint32_t (&hi)[4][4],
                                                   uint32_t (&lo)[4][4],
                                                   const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = x[8 * kk + 2 * i], b = x[8 * kk + 2 * i + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
      const float2 back = __bfloat1622float2(h2);
      const __nv_bfloat162 l2 = __floats2bfloat162_rn(a - back.x, b - back.y);
      hi[kk][i] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[kk][i] = *reinterpret_cast<const uint32_t*>(&l2);
    }
  }
}

// Stage rows [0, 64) of a row-major [*, d] bf16 matrix (d <= 64) whose
// first row is `src` (`nvalid` rows valid) into the K-major [64, 64] tile
// at `dst`, through cp.async by the block's one warpgroup (128 threads).
// Rows at or past `nvalid` and columns at or past d are zero.
__device__ __forceinline__ void load_tile_64(uint32_t dst,
                                             const __nv_bfloat16* src,
                                             int nvalid, int d) {
#pragma unroll
  for (int it = 0; it < 64 * 8 / 128; ++it) {
    const int i = threadIdx.x + it * 128;
    const int r = i >> 3;
    const int c = i & 7;
    const bool ok = r < nvalid && c * 8 < d;
    cp_async16(dst + swizzled(r, c), ok ? src + (size_t)r * d + c * 8 : src,
               ok ? 16 : 0);
  }
}

// X[64 x 64] = A B^T: A and B [64, 64] tiles, both K-major in shared
// memory; every k16 step of the padded width (zero columns add zeros).
__device__ __forceinline__ void product_nn_64(float (&x)[32], uint32_t a_s,
                                              uint32_t b_s) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_nn_n64(x, k_major_desc(a_s, kk), k_major_desc(b_s, kk), kk > 0);
}

// acc[64 x 64] += F B: F [64, 64] as A fragments in registers
// (to_fragments), B a [64, 64] tile MN-major in shared memory.
__device__ __forceinline__ void product_rt_64(float (&acc)[32],
                                              const uint32_t (&f)[4][4],
                                              uint32_t b_s) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rt_n64(acc, f[kk], mn_major_desc(b_s, kk));
}

// 2^x, one MUFU instruction (relative error ~2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A ring of STAGES equal stages of STAGE_BYTES each in dynamic shared
// memory, its base aligned to a swizzle atom (the swizzle is a function of
// address bits [4, 10)). Tile t lives in stage t % STAGES.
template <int STAGES, int STAGE_BYTES>
struct Ring {
  // bytes to request: the stages plus room to align the base
  static constexpr int kSmemBytes = STAGES * STAGE_BYTES + kAtomBytes;
  uint32_t base;

  __device__ __forceinline__ explicit Ring(const void* smem)
      : base((smem_addr(smem) + kAtomBytes - 1) &
             ~static_cast<uint32_t>(kAtomBytes - 1)) {}
  __device__ __forceinline__ uint32_t stage(int t) const {
    return base + (t % STAGES) * STAGE_BYTES;
  }
};

}  // namespace igemm_tc
