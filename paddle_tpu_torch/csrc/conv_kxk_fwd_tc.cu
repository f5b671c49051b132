// KxK convolution forward on the Hopper tensor cores (sm_90a), bf16, with
// the conv's epilogue, and a plain C interface loaded through ctypes by
// paddle_tpu_torch/kernels/conv_fused.py.
//
// Replaces: the Pallas kernel _convkxk (pallas_call at
// paddle_tpu/kernels/conv_fused.py:241) for bf16 x and w with C and O
// multiples of 64 at a 16-byte aligned x (conv_fused.py's kxk_fwd_route;
// the rest, float32 among it, takes conv_kxk_fwd in conv_kxk.cu). It
// computes what conv_kxk_fwd computes, as a GEMM over the unpadded NHWC x
// and the weight laid out [KH, KW, C, O]:
//
//   out[m = (n, oh, ow), o] = epilogue( sum_{k = (kh, kw, c)}
//       x[n, oh*sh - ph0 + kh*dh, ow*sw - pw0 + kw*dw, c] * wk[kh, kw, c, o] )
//
// M = N*OH*OW, N = O, K = KH*KW*C; a tap in the padding reads 0. The sum
// is float32; the epilogue is igemm::Epilogue::store's chain in its order
// (scale, bias, residual, relu, one cast to the output type).
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): ResNet-50's
// 3x3 forwards at batch 256 move x, w and out once in 49-77 us, against
// 2*M*N*K flops in 43-57 us: both bounds sit near each other. The SIMT
// kernel (conv_kxk.cu) runs float32 FMAs at ~2.5% of that. This one runs
// the product on wgmma:
//   - a block owns BM = 128 output positions (two 64-row chunks, one a
//     consumer warpgroup) by BN = 128 columns of O (64 when O is not a
//     multiple of 128), and walks K one (tap, 64-channel block) a stage:
//     KH*KW*C/64 stages. No split-K: every ResNet-50 shape has >= 392
//     blocks, about three waves of 132 SMs;
//   - the A tile is [128 positions][64 channels]: each row one contiguous
//     128-byte slice x[n, ih, iw, c0:c0+64], stored in the 128-byte
//     swizzle of igemm_tc.cuh. That is K-major, read with A's transpose
//     bit 0. The B tile is wk[kh, kw, c0:c0+64, o0:o0+BN], 64 rows of BN
//     contiguous O values: MN-major, read through B's transpose bit;
//   - each thread decodes its 4 rows' (n, oh*sh - ph0, ow*sw - pw0) once,
//     before the K loop; a stage only adds (kh*dh, kw*dw) and c0, stepped
//     without a division. A tap in the padding and a position >= M are
//     zero-filled (src-size 0), so no stale shared memory reaches a
//     product; B never runs past O (O is a multiple of BN);
//   - stages sit in a ring of 3, filled with 16-byte cp.async by all 256
//     threads: the copies of stage t + 2 are issued right behind the
//     wgmma of stage t. It is held to 128 registers, so that two blocks
//     share an SM;
//   - the blocks of one M block's N tiles are neighbours in the grid, so
//     its x rows come from L2 after the first; wk (at most 4.7 MB in
//     ResNet-50) stays in L2;
//   - the epilogue runs on the accumulator fragments: each thread applies
//     the chain to its column pairs and stores them as bf16x2 or float2.
//
// The same kernel computes a strided conv's input gradient without a fold
// by phases (conv_kxk_dx_phase_tc below; the Pallas _convkxk_dx, pallas_call
// at paddle_tpu/kernels/conv_fused.py:425, takes the dilated g instead):
// dx's rows a + sh*i and columns b + sw*j (conv_fused.py's dx_phases, its
// "tc_phase" route) are the stride-1 forward conv of g itself with the taps
// that reach them, flipped, C and O swapped, so no product reads a zero
// between g's rows. Its instantiation with kPhase set maps output row m =
// (n, i, j) to dx's pixel (n, a + sh*i, b + sw*j) in the epilogue, decoded
// once a thread row; the rest of the kernel is the forward's, and the
// instantiations without it compile as before.
// Left for later work: TMA with a producer warp, a wgmma kept in flight
// across stages, an epilogue overlapped with the next tile's loads, and
// one launch over every phase.

#include "igemm.cuh"
#include "igemm_tc.cuh"

namespace {

using igemm_tc::cp_async16;
using igemm_tc::kRowBytes;
using igemm_tc::swizzled;

constexpr int kThreads = 256;   // two consumer warpgroups
constexpr int kBM = 128;        // output positions a block
constexpr int kBK = 64;         // channels a stage
constexpr int kStages = 3;
// one 64-row block of 64 bf16 columns
constexpr int kBlockBytes = 64 * kRowBytes;
// the rows of A a thread copies: kBM * 8 pieces over kThreads
constexpr int kARows = kBM * 8 / kThreads;
// "outside the problem": a row coordinate that fails every bounds check
constexpr int kFar = -(1 << 28);
// the largest window origin, stride or tap reach the C entry takes, so
// that no coordinate sum leaves int
constexpr int kReach = 1 << 22;

struct Geo {
  int n, h, w, c, o, kh, kw, oh, ow, sh, sw, ph, pw, dh, dw;
};

// Where a phase of a strided dx writes: dx is [n, h, w, C], the phase's
// output row (n, i, j) is dx's pixel (n, a + sh*i, b + sw*j).
struct PhaseOut {
  int h, w, a, b, sh, sw;
};

template <int BN>
struct Tiles {
  static constexpr int kA = kBM * kRowBytes;           // x: K-major
  static constexpr int kB = BN / 64 * kBlockBytes;     // wk: MN-major
  static constexpr int kStage = kA + kB;
  using Ring = igemm_tc::Ring<kStages, kStage>;
  // the B tile's 16-byte pieces: PB a row, BN / 32 a thread
  static constexpr int kPB = BN / 8;
  static constexpr int kBLoads = kBK * kPB / kThreads;
};

// The epilogue chain of igemm::Epilogue::store on two neighbouring
// columns (n even) at element i of the output, stored as one bf16x2 or
// float2.
__device__ __forceinline__ void store_at(const igemm::Epilogue& ep,
                                         long long i, int n, float v0,
                                         float v1) {
  if (ep.scale != nullptr) {
    v0 = __fmul_rn(v0, ep.scale[n]);
    v1 = __fmul_rn(v1, ep.scale[n + 1]);
  }
  if (ep.bias != nullptr) {
    v0 = __fadd_rn(v0, ep.bias[n]);
    v1 = __fadd_rn(v1, ep.bias[n + 1]);
  }
  if (ep.residual != nullptr) {
    v0 = __fadd_rn(v0, igemm::load_any(ep.residual, i, ep.res_dt));
    v1 = __fadd_rn(v1, igemm::load_any(ep.residual, i + 1, ep.res_dt));
  }
  if (ep.relu) {
    if (v0 < 0.f) v0 = 0.f;
    if (v1 < 0.f) v1 = 0.f;
  }
  if (ep.out_dt == igemm::BF16)
    *reinterpret_cast<__nv_bfloat162*>(
        static_cast<__nv_bfloat16*>(ep.out) + i) =
        __floats2bfloat162_rn(v0, v1);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(ep.out) + i) =
        make_float2(v0, v1);
}

// store_at on row m of a contiguous [M, ldo] output.
__device__ __forceinline__ void store_pair(const igemm::Epilogue& ep, int m,
                                           int n, float v0, float v1) {
  store_at(ep, static_cast<long long>(m) * ep.ldo + n, n, v0, v1);
}

template <int BN, bool kPhase>
__global__ void __launch_bounds__(kThreads, 2)
    conv_kxk_fwd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ wk, Geo g,
                           int M, igemm::Epilogue ep, PhaseOut po) {
  using T = Tiles<BN>;
  extern __shared__ uint8_t smem_raw[];
  const typename T::Ring ring(smem_raw);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n_tiles = g.o / BN;
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int steps = g.kh * g.kw * (g.c / kBK);

  // A: this thread copies 16-byte piece q (8 channels) of rows
  // r0 + 32 j; each row's pixel index and window origin, decoded once
  // (pixel indices in unsigned arithmetic: a window origin in the padding
  // wraps, and adding the tap's offset wraps back wherever a copy reads)
  const int q = tid & 7;
  const int r0 = tid >> 3;
  unsigned pix[kARows];
  int ih0[kARows], iw0[kARows];
#pragma unroll
  for (int j = 0; j < kARows; ++j) {
    const int m = m0 + r0 + 32 * j;
    if (m < M) {
      const int hw = g.oh * g.ow;
      const int n = m / hw;
      const int r = m - n * hw;
      const int y = r / g.ow;
      ih0[j] = y * g.sh - g.ph;
      iw0[j] = (r - y * g.ow) * g.sw - g.pw;
      pix[j] = (static_cast<unsigned>(n) * g.h + ih0[j]) * g.w + iw0[j];
    } else {
      ih0[j] = kFar;
      iw0[j] = kFar;
      pix[j] = 0u;
    }
  }
  // the tap and channel block of the next stage to load
  int tap_h = 0, tap_w = 0, c0 = 0;

  // B: piece pb of rows rb0 + (kThreads / kPB) j
  const int pb = tid % T::kPB;
  const int rb0 = tid / T::kPB;
  constexpr int kRowStep = kThreads / T::kPB;

  // Issue the copies of stage t (stages are issued in order: the tap and
  // channel block step once a stage).
  auto load = [&](int t) {
    const uint32_t sa = ring.stage(t);
    const uint32_t sb = sa + T::kA;
    const int offh = tap_h * g.dh;
    const int offw = tap_w * g.dw;
    const unsigned dpix = static_cast<unsigned>(offh) * g.w + offw;
#pragma unroll
    for (int j = 0; j < kARows; ++j) {
      const int r = r0 + 32 * j;
      const bool ok =
          static_cast<unsigned>(ih0[j] + offh) < static_cast<unsigned>(g.h) &&
          static_cast<unsigned>(iw0[j] + offw) < static_cast<unsigned>(g.w);
      const __nv_bfloat16* src =
          ok ? x + static_cast<size_t>(pix[j] + dpix) * g.c + c0 + q * 8
             : x;
      cp_async16(sa + swizzled(r, q), src, ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < T::kBLoads; ++j) {
      const int r = rb0 + kRowStep * j;
      const __nv_bfloat16* src =
          wk + static_cast<long long>(t * kBK + r) * g.o + n0 + pb * 8;
      cp_async16(sb + (pb >> 3) * kBlockBytes + swizzled(r, pb & 7), src,
                 16);
    }
    c0 += kBK;
    if (c0 == g.c) {
      c0 = 0;
      if (++tap_w == g.kw) {
        tap_w = 0;
        ++tap_h;
      }
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
    igemm_tc::fence_proxy_async();
    __syncthreads();                  // every copy of stage t, for wgmma;
                                      // every wgmma of stage t - 1 done
    const uint32_t sa = ring.stage(t) + wg * kBlockBytes;
    const uint32_t sb = ring.stage(t) + T::kA;
    igemm_tc::fence_regs(acc);
    igemm_tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      igemm_tc::wgmma_nt(acc, igemm_tc::k_major_desc(sa, kk),
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
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int mrow = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = mrow + 8 * r;
    if (m >= M) continue;
    if constexpr (kPhase) {
      // dx's pixel of output row (n, i, j), once a row (a separate branch:
      // the forward's instantiations keep the SASS they had without it)
      const int hw = g.oh * g.ow;
      const int n = m / hw;
      const int rest = m - n * hw;
      const int i = rest / g.ow;
      const int pix = (n * po.h + po.a + po.sh * i) * po.w + po.b +
                      po.sw * (rest - i * g.ow);
      const long long base = static_cast<long long>(pix) * ep.ldo;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        store_at(ep, base + col, col, acc[4 * j + 2 * r],
                 acc[4 * j + 2 * r + 1]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        store_pair(ep, m, n0 + 8 * j + 2 * (lane & 3), acc[4 * j + 2 * r],
                   acc[4 * j + 2 * r + 1]);
    }
  }
}

template <int BN, bool kPhase>
int launch(const void* x, const void* wk, const igemm::Epilogue& ep,
           const Geo& g, int M, const PhaseOut& po, cudaStream_t s) {
  constexpr int smem = Tiles<BN>::Ring::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      conv_kxk_fwd_tc_kernel<BN, kPhase>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((M + kBM - 1) / kBM) *
                          static_cast<unsigned>(g.o / BN);
  conv_kxk_fwd_tc_kernel<BN, kPhase><<<blocks, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wk), g, M, ep, po);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPhase>
int launch_any(const void* x, const void* wk, const igemm::Epilogue& ep,
               const Geo& g, int M, const PhaseOut& po, cudaStream_t s) {
  if (g.o % 128 == 0) return launch<128, kPhase>(x, wk, ep, g, M, po, s);
  return launch<64, kPhase>(x, wk, ep, g, M, po, s);
}

Geo to_geo(const int* v) {
  return Geo{v[0], v[1], v[2],  v[3],  v[4],  v[5],  v[6], v[7],
             v[8], v[9], v[10], v[11], v[12], v[13], v[14]};
}

// What the kernel does not take at geometry g: the forward's checks of
// conv_kxk_fwd_tc below, but for the types and bases.
bool refuses(const Geo& g) {
  const long long m = static_cast<long long>(g.n) * g.oh * g.ow;
  const long long pixels = static_cast<long long>(g.n) * g.h * g.w;
  const long long blocks =
      (m + kBM - 1) / kBM * (g.o > 0 ? g.o / 64 : 0);
  return g.n < 0 || g.h <= 0 || g.w <= 0 || g.c <= 0 || g.o <= 0 ||
         g.c % 64 != 0 || g.o % 64 != 0 || g.kh <= 0 || g.kw <= 0 ||
         g.oh < 0 || g.ow < 0 || g.sh <= 0 || g.sw <= 0 || g.dh <= 0 ||
         g.dw <= 0 || m > (1 << 30) || pixels > (1 << 30) ||
         g.ph < -kReach || g.ph > kReach || g.pw < -kReach ||
         g.pw > kReach || static_cast<long long>(g.oh) * g.sh > kReach ||
         static_cast<long long>(g.ow) * g.sw > kReach ||
         static_cast<long long>(g.kh) * g.dh > kReach ||
         static_cast<long long>(g.kw) * g.dw > kReach ||
         static_cast<long long>(g.kh) * g.kw * g.c > (1 << 30) ||
         blocks > 0x7fffffffLL;
}

bool misaligned(const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) %
          16) != 0;
}

// One axis of a dx phase (conv_fused.py's dx_phases): of the k taps of
// dilation d over a low padding p, those whose products reach dx's
// positions a + s*i are the t with (a + p - t*d) divisible by s. Reads
// them from the largest down, as the phase conv's taps; returns their
// count, the phase conv's low padding (the least offset, negated) and its
// dilation d / gcd(s, d).
struct PhaseAxis {
  int taps, pad, dil;
};

PhaseAxis phase_axis(int a, int k, int s, int p, int d) {
  PhaseAxis ax{0, 0, 1};
  for (int t = k - 1; t >= 0; --t) {
    const long long r = static_cast<long long>(a) + p -
                        static_cast<long long>(t) * d;
    if (r % s != 0) continue;
    if (ax.taps++ == 0) ax.pad = static_cast<int>(-(r / s));
  }
  int x = s, y = d;
  while (y != 0) {
    const int t = x % y;
    x = y;
    y = t;
  }
  if (ax.taps > 0) ax.dil = d / x;
  return ax;
}

// Phase (a, b) of the dx of conv d (conv_fused.py's dx_phases): the
// stride-1 forward conv of g with the taps phase_axis finds on each axis,
// C and O swapped, whose output is dx's rows a + sh*i and columns b + sw*j.
Geo phase_geo(const Geo& d, int a, int b) {
  const PhaseAxis ah = phase_axis(a, d.kh, d.sh, d.ph, d.dh);
  const PhaseAxis aw = phase_axis(b, d.kw, d.sw, d.pw, d.dw);
  return Geo{d.n, d.oh, d.ow, d.o, d.c, ah.taps, aw.taps,
             (d.h - a + d.sh - 1) / d.sh, (d.w - b + d.sw - 1) / d.sw, 1, 1,
             ah.pad, aw.pad, ah.dil, aw.dil};
}

// Whether a phase launches a kernel: it has taps, and dx has positions in
// it.
bool runs(const Geo& p) {
  return p.n > 0 && p.kh > 0 && p.kw > 0 && p.oh > 0 && p.ow > 0;
}

}  // namespace

// Same arguments as conv_kxk_fwd (conv_kxk.cu); wk is the weight laid out
// [KH, KW, C, O]; geo: 15 ints (n, h, w, c, o, kh, kw, oh, ow, sh, sw,
// ph0, pw0, dh, dw). Returns the first cudaError_t (0 on success).
// Launches on `stream`, allocates nothing and does not synchronize.
// Refuses (cudaErrorInvalidValue), and computes nothing, what it does not
// take: x and w other than bf16, C or O not a multiple of 64, a base of
// x, wk or out off 16 bytes, an output or residual type other than bf16
// and float32, sizes past its 32-bit indices, strides, dilations or
// windows that reach past 2^22.
extern "C" int conv_kxk_fwd_tc(const void* x, const void* wk, void* out,
                               const float* scale, const float* bias,
                               const void* residual, int res_dt, int relu,
                               const int* geo, int in_dt, int out_dt,
                               void* stream) {
  const Geo g = to_geo(geo);
  const bool bad =
      in_dt != igemm::BF16 ||
      (out_dt != igemm::BF16 && out_dt != igemm::F32) ||
      (residual != nullptr && res_dt != igemm::BF16 &&
       res_dt != igemm::F32) ||
      refuses(g) || misaligned(x, wk, out);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const long long m = static_cast<long long>(g.n) * g.oh * g.ow;
  if (m == 0) return 0;
  const igemm::Epilogue ep{scale, bias, residual, out, res_dt, out_dt, relu,
                           g.o};
  return launch_any<false>(x, wk, ep, g, static_cast<int>(m), PhaseOut{},
                           static_cast<cudaStream_t>(stream));
}

// The input gradient of a conv without a fold, by phases: g [N, OH, OW, O]
// (bf16), dx [N, H, W, C] (bf16 or float32), dx_geo the conv's 15 ints (n,
// h, w, c, o, kh, kw, oh, ow, sh, sw, ph0, pw0, dh, dw), wk the taps of
// every phase that runs, [T_h, T_w, O, C] one after the other in the order
// (a, b) (conv_fused.py's phase_weights). Launches one
// conv_kxk_fwd_tc_kernel<BN, true> a phase that runs (phase_geo), in that
// order, on `stream`; allocates nothing and does not synchronize. Returns
// the first cudaError_t (0 on success).
// Refuses (cudaErrorInvalidValue), and computes nothing for, what
// conv_kxk_fwd_tc refuses at the conv's or at a phase's geometry, and a
// stride or kernel extent past 2^12 a dimension (kh*sh, kw*sw). The
// phases without taps are left to the caller (dx zero-filled there).
extern "C" int conv_kxk_dx_phase_tc(const void* g, const void* wk, void* dx,
                                    const int* dx_geo, int in_dt, int out_dt,
                                    void* stream) {
  const Geo d = to_geo(dx_geo);
  // the conv's geometry as the forward kernel sees a stride-1 dx: g as x
  const Geo as_dx{d.n, d.oh, d.ow, d.o, d.c, d.kh, d.kw, d.h, d.w, 1, 1,
                  0, 0, d.dh, d.dw};
  bool bad = in_dt != igemm::BF16 ||
             (out_dt != igemm::BF16 && out_dt != igemm::F32) ||
             refuses(as_dx) || d.sh <= 0 || d.sw <= 0 || d.ph < -kReach ||
             d.ph > kReach || d.pw < -kReach || d.pw > kReach ||
             static_cast<long long>(d.kh) * d.sh > 4096 ||
             static_cast<long long>(d.kw) * d.sw > 4096 ||
             misaligned(g, wk, dx);
  for (int a = 0; !bad && a < d.sh; ++a)
    for (int b = 0; !bad && b < d.sw; ++b) {
      const Geo p = phase_geo(d, a, b);
      bad = runs(p) && refuses(p);
    }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const igemm::Epilogue ep{nullptr, nullptr, nullptr, dx, 0, out_dt, 0, d.c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(wk);
  for (int a = 0; a < d.sh; ++a)
    for (int b = 0; b < d.sw; ++b) {
      const Geo p = phase_geo(d, a, b);
      if (!runs(p)) continue;
      const PhaseOut po{d.h, d.w, a, b, d.sh, d.sw};
      const int err = launch_any<true>(g, w, ep, p, p.n * p.oh * p.ow, po, s);
      if (err != 0) return err;
      w += static_cast<size_t>(p.kh) * p.kw * p.c * p.o;
    }
  return 0;
}
