// KxK convolution weight gradient on the Hopper tensor cores (sm_90a), bf16,
// with a plain C interface loaded through ctypes by
// paddle_tpu_torch/kernels/conv_fused.py.
//
// Replaces: the Pallas kernel _convkxk_dw (pallas_call at
// paddle_tpu/kernels/conv_fused.py:506) for bf16 inputs with C and O
// multiples of 64 at 16-byte aligned bases (conv_fused.py's dw_route; the
// rest, float32 among it, takes conv_kxk_dw in conv_kxk.cu). It computes
// what conv_kxk_dw computes, as a GEMM over the unpadded NHWC tensors:
//
//   dw[m = (kh, kw, c), o] = sum_{k = (n, oh, ow)}
//       x[n, oh*sh - ph0 + kh*dh, ow*sw - pw0 + kw*dw, c] * dy[k, o]
//
// M = KH*KW*C, N = O, K = N*OH*OW; a tap in the padding reads 0. dy is
// the cotangent fold of igemm::Fold: g, set to 0 where the saved output
// (mask) is not > 0, then __fmul_rn by scale[o], then rounded to bf16.
// The sum is float32, cast once to the output type (the weight's).
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): ResNet-50's
// 3x3 weight gradients at batch 256 move x and g once (~205 MB at stage 1,
// 61 us) against 2*M*N*K flops (~57-60 us): both bounds sit near 50-77 us.
// The SIMT kernel (conv_kxk.cu) runs float32 FMAs at ~1% of that. This
// one runs the product on wgmma:
//   - both operands are MN-major tiles in shared memory, in the 128-byte
//     swizzle of igemm_tc.cuh. For one position k and one tap, 64 channels
//     are one contiguous 128-byte row of x, so the A tile (x^T) is stored
//     [64 positions][64 channels] a chunk; the B tile (dy) is
//     [64 positions][BN columns of O], each row a contiguous slice of g.
//     wgmma reads both through its transpose bits;
//   - a block owns BM = 128 rows of M (two 64-row chunks, each one tap and
//     64 channels, one a consumer warpgroup) by BN = 128 columns of O (64
//     when O is not a multiple of 128), and walks its K range 64 positions
//     a stage, each warpgroup holding an m64 x BN float32 accumulator. It
//     is held to 128 registers, so that two blocks share an SM and one's
//     barrier and copies overlap the other's products (a deeper ring did
//     not help);
//   - stages sit in a ring of 3, filled with 16-byte cp.async by all 256
//     threads: the copies of stage t + 2 are issued right behind the
//     wgmma of stage t. A tap in the padding, a position past the end of
//     the block's K range and an M chunk past M are zero-filled (src-size
//     0), for both operands, so no stale shared memory reaches a product;
//   - with a mask or a scale, the raw g tile and the saved output's tile
//     are copied in; each thread folds the 16-byte pieces it copied
//     itself, in place, and a proxy fence and a barrier hand the stage to
//     wgmma;
//   - K is split over gridDim.z (kernels/tiles.py's split_k_tc): each
//     split writes its float32 partial tile to a [splits, M, N] workspace,
//     and igemm::splitk_reduce adds the splits in order and applies the
//     epilogue's cast: no atomics, so the result does not depend on block
//     order. With one split the kernel stores through the epilogue itself.
// Left for later work: TMA with a producer warp, a wgmma kept in flight
// across stages, and reuse of the g tile across the taps of a block.

#include "igemm.cuh"
#include "igemm_tc.cuh"

namespace {

using igemm_tc::cp_async16;
using igemm_tc::kRowBytes;
using igemm_tc::swizzled;

constexpr int kThreads = 256;   // two consumer warpgroups
constexpr int kBM = 128;        // rows of M a block: two 64-row chunks
constexpr int kBK = 64;         // positions a stage
constexpr int kStages = 3;
// one 64-column block of a stage's tile: [kBK positions][64 bf16]
constexpr int kBlockBytes = kBK * kRowBytes;

struct Geo {
  int n, h, w, c, o, kh, kw, oh, ow, sh, sw, ph, pw, dh, dw;
};

// Tag of the split-K reduction, so that a profile names it with this
// kernel.
struct conv_kxk_dw_tc_split {};

// A position k = (n, oh, ow), stepped kBK positions at a time.
struct Pos {
  int n, y, x;
  __device__ __forceinline__ void set(int k, const Geo& g) {
    const int hw = g.oh * g.ow;
    n = k / hw;
    const int r = k - n * hw;
    y = r / g.ow;
    x = r - y * g.ow;
  }
  // kBK = dn * OH*OW + dy * OW + dx, with dy < OH and dx < OW
  __device__ __forceinline__ void step(int dn, int dy, int dx,
                                       const Geo& g) {
    x += dx;
    if (x >= g.ow) { x -= g.ow; ++y; }
    y += dy;
    if (y >= g.oh) { y -= g.oh; ++n; }
    n += dn;
  }
};

// The fold of two bf16 values of g (a 32-bit word, the lower one first)
// beside the two of the saved output: where(mask > 0, g, 0) * scale,
// rounded to bf16. Without a mask, `has_mask` is false; without a scale,
// the scales are 1 (an exact product).
__device__ __forceinline__ uint32_t fold2(uint32_t gw, uint32_t mw,
                                         bool has_mask, float s0, float s1) {
  float lo = __uint_as_float(gw << 16);
  float hi = __uint_as_float(gw & 0xffff0000u);
  if (has_mask) {
    if (!(__uint_as_float(mw << 16) > 0.f)) lo = 0.f;
    if (!(__uint_as_float(mw & 0xffff0000u) > 0.f)) hi = 0.f;
  }
  const uint32_t rl =
      __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(lo, s0)));
  const uint32_t rh =
      __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(hi, s1)));
  return rl | (rh << 16);
}

template <int BN, bool FOLD>
struct Tiles {
  static constexpr int kA = 2 * kBlockBytes;            // x^T: two M chunks
  static constexpr int kB = BN / 64 * kBlockBytes;      // dy
  static constexpr int kStage = kA + (FOLD ? 2 : 1) * kB;   // + the mask
  using Ring = igemm_tc::Ring<kStages, kStage>;
  // the B tile's 16-byte pieces: PB a row, BN / 32 a thread
  static constexpr int kPB = BN / 8;
  static constexpr int kBLoads = kBK * kPB / kThreads;
};

template <int BN, bool FOLD>
__global__ void __launch_bounds__(kThreads, 2)
    conv_kxk_dw_tc_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ gr,
                          const __nv_bfloat16* __restrict__ mask,
                          const float* __restrict__ scale, Geo g, int M,
                          int K, int k_per_split, igemm::Epilogue ep,
                          float* __restrict__ partial) {
  using T = Tiles<BN, FOLD>;
  extern __shared__ uint8_t smem_raw[];
  const typename T::Ring ring(smem_raw);
  // the ring's base as a generic pointer, for the fold's loads and stores
  uint8_t* const smem_gen =
      smem_raw + (ring.base - igemm_tc::smem_addr(smem_raw));

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const int steps = (ke - kb + kBK - 1) / kBK;

  // A: this thread copies 16-byte piece (q & 7) of M chunk (q >> 3) of the
  // block, at rows r0 + 16 j: one tap and 8 channels of 4 positions
  const int q = tid & 15;
  const int r0 = tid >> 4;
  const int mc = blockIdx.x * 2 + (q >> 3);
  const bool chunk_ok = mc * 64 < M;
  const int tap = chunk_ok ? mc * 64 / g.c : 0;
  const int c0 = mc * 64 - tap * g.c + (q & 7) * 8;
  const int ky = tap / g.kw;
  const int offh = ky * g.dh - g.ph;
  const int offw = (tap - ky * g.kw) * g.dw - g.pw;
  const int hw = g.oh * g.ow;
  const int dn = kBK / hw;
  const int dy = (kBK - dn * hw) / g.ow;
  const int dx = kBK - dn * hw - dy * g.ow;
  Pos pos[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) pos[j].set(kb + r0 + 16 * j, g);

  // B (and the mask): piece pb of rows rb0 + (kThreads / kPB) j
  const int pb = tid % T::kPB;
  const int rb0 = tid / T::kPB;
  constexpr int kRowStep = kThreads / T::kPB;

  // the fold's per-column scale: this thread's 8 columns are fixed
  float sc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    sc[i] = (FOLD && scale != nullptr) ? scale[n0 + pb * 8 + i] : 1.f;

  // Issue the copies of stage t (stages are issued in order: the A rows'
  // positions step once a stage).
  auto load = [&](int t) {
    const uint32_t sa = ring.stage(t);
    const uint32_t sb = sa + T::kA;
    const int kt = kb + t * kBK;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 16 * j;
      const int ih = pos[j].y * g.sh + offh;
      const int iw = pos[j].x * g.sw + offw;
      const bool ok = chunk_ok && kt + r < ke && ih >= 0 && ih < g.h &&
                      iw >= 0 && iw < g.w;
      const __nv_bfloat16* src =
          ok ? x + ((static_cast<size_t>(pos[j].n) * g.h + ih) * g.w + iw) *
                       g.c + c0
             : x;
      cp_async16(sa + (q >> 3) * kBlockBytes + swizzled(r, q & 7), src,
                 ok ? 16 : 0);
      pos[j].step(dn, dy, dx, g);
    }
#pragma unroll
    for (int j = 0; j < T::kBLoads; ++j) {
      const int r = rb0 + kRowStep * j;
      const bool ok = kt + r < ke;
      const size_t off =
          ok ? static_cast<size_t>(kt + r) * g.o + n0 + pb * 8 : 0;
      const uint32_t d = (pb >> 3) * kBlockBytes + swizzled(r, pb & 7);
      cp_async16(sb + d, gr + off, ok ? 16 : 0);
      if (FOLD && mask != nullptr)
        cp_async16(sb + T::kB + d, mask + off, ok ? 16 : 0);
    }
  };

  // The fold of stage t on the pieces this thread copied (its own copies
  // have landed): where(mask > 0, g, 0) * scale, rounded to bf16, in place.
  const bool has_mask = mask != nullptr;
  auto fold = [&](int t) {
    uint8_t* const b = smem_gen + (ring.stage(t) - ring.base) + T::kA;
#pragma unroll
    for (int j = 0; j < T::kBLoads; ++j) {
      const int r = rb0 + kRowStep * j;
      const uint32_t d = (pb >> 3) * kBlockBytes + swizzled(r, pb & 7);
      uint4 gv = *reinterpret_cast<const uint4*>(b + d);
      const uint4 mv = has_mask
                           ? *reinterpret_cast<const uint4*>(b + T::kB + d)
                           : make_uint4(0, 0, 0, 0);
      gv.x = fold2(gv.x, mv.x, has_mask, sc[0], sc[1]);
      gv.y = fold2(gv.y, mv.y, has_mask, sc[2], sc[3]);
      gv.z = fold2(gv.z, mv.z, has_mask, sc[4], sc[5]);
      gv.w = fold2(gv.w, mv.w, has_mask, sc[6], sc[7]);
      *reinterpret_cast<uint4*>(b + d) = gv;
    }
  };

  constexpr int kAcc = BN / 2;   // m64 x BN float32 over 128 threads
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // the first kStages - 1 stages in flight, one copy group each
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < steps) load(t);
    igemm_tc::cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    // stage t's copies (this thread's) have landed
    igemm_tc::cp_async_wait<kStages - 2>();
    if constexpr (FOLD) fold(t);
    igemm_tc::fence_proxy_async();
    __syncthreads();                  // every copy of stage t, for wgmma;
                                      // every wgmma of stage t - 1 done
    const uint32_t sa = ring.stage(t) + wg * kBlockBytes;
    const uint32_t sb = ring.stage(t) + T::kA;
    igemm_tc::fence_regs(acc);
    igemm_tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      igemm_tc::wgmma_tt(acc, igemm_tc::mn_major_desc(sa, kk),
                         igemm_tc::mn_major_desc(sb, kk), 1);
    igemm_tc::wgmma_commit();
    // stage t + kStages - 1 goes where stage t - 1 was, whose products
    // every warpgroup waited for before the barrier above
    if (t + kStages - 1 < steps) load(t + kStages - 1);
    igemm_tc::cp_async_commit();
    igemm_tc::wgmma_wait<0>();
    igemm_tc::fence_regs(acc);
  }

  // the accumulator: row w*16 + lane/4 + 8 r, column 8 j + 2 (lane % 4) + e
  // holds acc[4 j + 2 r + e]
  const int mchunk = blockIdx.x * 2 + wg;
  if (mchunk * 64 >= M) return;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int mrow = mchunk * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = mrow + 8 * r;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      const float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
      if (partial != nullptr) {
        *reinterpret_cast<float2*>(
            partial + (static_cast<size_t>(blockIdx.z) * M + m) * g.o + n) =
            make_float2(v0, v1);
      } else {
        ep.store(m, n, v0);
        ep.store(m, n + 1, v1);
      }
    }
  }
}

template <int BN, bool FOLD>
int launch_tc(const void* x, const void* gr, const void* mask,
           const float* scale, const igemm::Epilogue& ep, const Geo& g,
           int M, int K, int splits, int k_per_split, float* workspace,
           cudaStream_t s) {
  constexpr int smem = Tiles<BN, FOLD>::Ring::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      conv_kxk_dw_tc_kernel<BN, FOLD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* partial = splits > 1 ? workspace : nullptr;
  dim3 grid((M + kBM - 1) / kBM, g.o / BN, splits);
  conv_kxk_dw_tc_kernel<BN, FOLD><<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gr),
      static_cast<const __nv_bfloat16*>(mask), scale, g, M, K, k_per_split,
      ep, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(M) * g.o;
  igemm::splitk_reduce<conv_kxk_dw_tc_split>
      <<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
          workspace, splits, M, g.o, ep);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_bn(const void* x, const void* gr, const void* mask,
              const float* scale, const igemm::Epilogue& ep, const Geo& g,
              int M, int K, int splits, int k_per_split, float* workspace,
              cudaStream_t s) {
  if (mask != nullptr || scale != nullptr)
    return launch_tc<BN, true>(x, gr, mask, scale, ep, g, M, K, splits,
                               k_per_split, workspace, s);
  return launch_tc<BN, false>(x, gr, mask, scale, ep, g, M, K, splits,
                              k_per_split, workspace, s);
}

}  // namespace

// Same arguments as conv_kxk_dw (conv_kxk.cu); geo: 15 ints (n, h, w, c,
// o, kh, kw, oh, ow, sh, sw, ph0, pw0, dh, dw). Returns the first
// cudaError_t (0 on success). Launches on `stream`, allocates nothing and
// does not synchronize. Refuses (cudaErrorInvalidValue), and computes
// nothing, what it does not take: inputs (x, g, mask) other than bf16, C or
// O not a multiple of 64, a base of x, g or mask off 16 bytes, a K step
// that is not a multiple of 64, splits that do not cover K.
extern "C" int conv_kxk_dw_tc(const void* x, const void* gr, const void* mask,
                              const float* scale, int mask_dt, void* out,
                              float* workspace, const int* geo, int in_dt,
                              int out_dt, int splits, int k_per_split,
                              void* stream) {
  const Geo g{geo[0], geo[1], geo[2],  geo[3],  geo[4],
              geo[5], geo[6], geo[7],  geo[8],  geo[9],
              geo[10], geo[11], geo[12], geo[13], geo[14]};
  const long long m = static_cast<long long>(g.kh) * g.kw * g.c;
  const long long k = static_cast<long long>(g.n) * g.oh * g.ow;
  const bool bad =
      in_dt != igemm::BF16 || (mask != nullptr && mask_dt != igemm::BF16) ||
      (out_dt != igemm::BF16 && out_dt != igemm::F32) || g.c <= 0 ||
      g.o <= 0 || g.c % 64 != 0 || g.o % 64 != 0 || m <= 0 || k <= 0 ||
      m > (1 << 30) || k > (1 << 30) ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gr) |
        reinterpret_cast<uintptr_t>(mask)) % 16) != 0 ||
      k_per_split <= 0 || k_per_split % kBK != 0 || splits < 1 ||
      splits > 65535 || static_cast<long long>(splits) * k_per_split < k ||
      static_cast<long long>(splits - 1) * k_per_split >= k ||
      (splits > 1 && workspace == nullptr);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const igemm::Epilogue ep{nullptr, nullptr, nullptr, out, 0, out_dt, 0,
                           g.o};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = static_cast<int>(m), K = static_cast<int>(k);
  if (g.o % 128 == 0)
    return launch_bn<128>(x, gr, mask, scale, ep, g, M, K, splits,
                          k_per_split, workspace, s);
  return launch_bn<64>(x, gr, mask, scale, ep, g, M, K, splits, k_per_split,
                       workspace, s);
}
