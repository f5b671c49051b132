// Fused NHWC max pool, forward (window max plus its int32 argmax) and
// backward (the cotangent sent to the saved argmax), for Hopper (sm_90a),
// with a plain C interface loaded through ctypes by
// paddle_tpu_torch/kernels/pool_fused.py.
//
// Replaces: the Pallas kernels of paddle_tpu/kernels/pool_fused.py,
// _pool_fwd_impl (pallas_call at :110) and _pool_bwd_impl (at :184).
//
//   pool_fwd: out[n, i, j, c] = max over the (kh, kw) window, scanned in
//     (ki, kj) order with a float32 compare and a strict ">" against a
//     running max that starts at the type's most negative finite value
//     `neg` (the padding value): the first maximum wins a tie, padding,
//     NaN, -inf and `neg` itself are never chosen. idx is the chosen
//     element's flat position h * W + w in its unpadded H x W plane, or -1.
//   pool_bwd: dx[n, h, w, c] = the float32 sum, over the windows covering
//     (h, w) in (ki outer, kj inner) order, of g where the window's idx
//     names (h, w); rounded once to dx's type.
//
// The TPU kernels walk one padded row per grid step and carry the running
// max (forward) or a padded dx row (backward) across the kh revisits in
// VMEM scratch. Here nothing carries between blocks: every dx element is
// a gather of the <= kh * kw outputs whose window covers it, so there are
// no atomics and the sum order is fixed; the result is deterministic and
// equal bit for bit to the plain version's.
//
// What bounds it on the H100: bytes. The forward reads x once (a 3x3/s2
// window re-reads neighbouring rows, which the L2 serves) and writes out
// and idx; the backward reads g and idx and writes dx. There is no
// arithmetic to speak of. The backward has two kernels:
//
//   pool_bwd_kernel (the gather, any C and alignment): a thread owns one
//     dx position and a vector of channels and re-reads g and idx from
//     global memory for each window it finds (each up to kh * kw /
//     (sh * sw) times, from L2), decoding its position with 64-bit
//     division.
//   pool_bwd_tile_kernel (C a multiple of the 16-byte vector, aligned
//     bases): a persistent block of 1024 threads, one an SM, walks bands
//     of `bh` dx rows of one image (all W, all C). The g rows and the idx
//     rows a band's windows read are contiguous in NHWC, so each is one
//     bulk asynchronous copy (cp.async.bulk, the TMA's 1-D form) into
//     shared memory, completing on an mbarrier; a ring of two stages
//     keeps the next band's copies in flight while this band is summed.
//     The stores from registers want many warps in flight: at the stem
//     (bf16, batch 256; an H100 80GB HBM3 at 700 W) 1024 threads an SM
//     over 6-row bands ran 0.277 ms a call, 512 threads an SM (two
//     blocks of 256 over 2-row bands) 0.305 ms, and one block of 256
//     over 4-row bands 0.42 ms. The rows each band, dx row and dx column
//     needs come from the wrapper's table (`band_rows`), so the kernel
//     does no division by a stride. Each thread sums its pixel's 16
//     bytes of channels from shared memory in the fixed order and writes
//     them with one 16-byte store: a warp writes contiguous dx. Every
//     byte of g and idx crosses from DRAM about once (a band's halo rows
//     come again from the L2), and dx is written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>

namespace {

constexpr int BF16 = 1;            // the dtype code; 0 is float32
constexpr int THREADS = 256;

struct Geo {
  int n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw;
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                int* __restrict__ idx, Geo g, float neg) {
  const int cv = g.c / VEC;
  const long long total = (long long)g.n * g.oh * g.ow * cv;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int v = (int)(t % cv);
  long long r = t / cv;
  const int oj = (int)(r % g.ow);
  r /= g.ow;
  const int oi = (int)(r % g.oh);
  const int n = (int)(r / g.oh);
  float best[VEC];
  int arg[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    best[i] = neg;
    arg[i] = -1;
  }
  for (int ki = 0; ki < g.kh; ++ki) {
    const int h = oi * g.sh + ki - g.ph;
    // a padded tap holds `neg`, which never beats the running max
    if (h < 0 || h >= g.h) continue;
    for (int kj = 0; kj < g.kw; ++kj) {
      const int w = oj * g.sw + kj - g.pw;
      if (w < 0 || w >= g.w) continue;
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(
          x + (((long long)n * g.h + h) * g.w + w) * g.c + v * VEC);
      const int pos = h * g.w + w;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float f = to_f(p.v[i]);
        if (f > best[i]) {
          best[i] = f;
          arg[i] = pos;
        }
      }
    }
  }
  Pack<T, VEC> o;
  Pack<int, VEC> a;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    o.v[i] = from_f<T>(best[i]);
    a.v[i] = arg[i];
  }
  const long long off = (((long long)n * g.oh + oi) * g.ow + oj) * g.c +
                        v * VEC;
  *reinterpret_cast<Pack<T, VEC>*>(out + off) = o;
  *reinterpret_cast<Pack<int, VEC>*>(idx + off) = a;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
pool_bwd_kernel(const T* __restrict__ gy, const int* __restrict__ idx,
                T* __restrict__ dx, Geo g) {
  const int cv = g.c / VEC;
  const long long total = (long long)g.n * g.h * g.w * cv;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int v = (int)(t % cv);
  long long r = t / cv;
  const int w = (int)(r % g.w);
  r /= g.w;
  const int h = (int)(r % g.h);
  const int n = (int)(r / g.h);
  const int target = h * g.w + w;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  for (int ki = 0; ki < g.kh; ++ki) {
    const int num = h + g.ph - ki;          // = oi * sh for the window oi
    if (num < 0 || num % g.sh) continue;
    const int oi = num / g.sh;
    if (oi >= g.oh) continue;
    for (int kj = 0; kj < g.kw; ++kj) {
      const int numc = w + g.pw - kj;
      if (numc < 0 || numc % g.sw) continue;
      const int oj = numc / g.sw;
      if (oj >= g.ow) continue;
      const long long off = (((long long)n * g.oh + oi) * g.ow + oj) * g.c +
                            v * VEC;
      const Pack<int, VEC> a =
          *reinterpret_cast<const Pack<int, VEC>*>(idx + off);
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(gy + off);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (a.v[i] == target) acc[i] += to_f(p.v[i]);
    }
  }
  Pack<T, VEC> o;
#pragma unroll
  for (int i = 0; i < VEC; ++i) o.v[i] = from_f<T>(acc[i]);
  *reinterpret_cast<Pack<T, VEC>*>(
      dx + (((long long)n * g.h + h) * g.w + w) * g.c + v * VEC) = o;
}

// -- the tile backward -----------------------------------------------------

constexpr int TILE_THREADS = 1024;  // one block an SM: 64 registers each
constexpr int TILE_STAGES = 2;      // the ring of staged bands (s, s ^ 1)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

// one arrival that also announces the bytes the stage's copies will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The idx vector of a thread's channels from shared memory: VEC ints. For
// bf16 (VEC = 8, 32 bytes) the thread with vector v reads its two 16-byte
// halves starting with half (v >> 2) & 1, so the 8 threads of a
// quarter-warp, at a 32-byte stride, hit 8 different bank groups.
template <int VEC>
__device__ __forceinline__ Pack<int, VEC> load_idx(const int* p, int /*v*/) {
  return *reinterpret_cast<const Pack<int, VEC>*>(p);
}
template <>
__device__ __forceinline__ Pack<int, 8> load_idx<8>(const int* p, int v) {
  const int4* q = reinterpret_cast<const int4*>(p);
  const int first = (v >> 2) & 1;
  const int4 a = q[first], b = q[first ^ 1];
  const int4 lo = first ? b : a, hi = first ? a : b;
  return Pack<int, 8>{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

// tab: int2 [per_img + H + W] = (lo, end) of the output rows each band of
// an image stages, then of the output rows covering each dx row, then of
// the output columns covering each dx column (the wrapper's band_rows);
// stage_rows: the most rows a band stages; stage_bytes: the stride of the
// stages in the dynamic shared memory (the wrapper's tile_plan), at least
// stage_rows rows of g then of idx.
template <typename T, int VEC>
__global__ void __launch_bounds__(TILE_THREADS)
pool_bwd_tile_kernel(const T* __restrict__ gy, const int* __restrict__ idx,
                     T* __restrict__ dx, const int2* __restrict__ tab, Geo g,
                     int bh, int stage_rows, int stage_bytes) {
  __shared__ uint64_t bar[TILE_STAGES];
  extern __shared__ __align__(128) unsigned char stage0[];
  const int cv = g.c / VEC;
  const int row_el = g.ow * g.c;                   // one (n, oi) row of g
  const uint32_t g_row = row_el * (int)sizeof(T), i_row = row_el * 4;
  const uint32_t idx_at = stage_rows * g_row;      // idx rows in a stage
  const int per_img = (g.h + bh - 1) / bh;
  const int nbands = g.n * per_img;
  const int2* band_tab = tab;
  const int2* row_tab = tab + per_img;
  const int2* col_tab = row_tab + g.h;

  if (threadIdx.x == 0) {
    for (int i = 0; i < TILE_STAGES; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: the copies of band `band` into stage `s`
  auto issue = [&](int band, int s) {
    const int n = band / per_img;
    const int2 r = band_tab[band - n * per_img];
    const int rows = r.y - r.x;
    unsigned char* st = stage0 + s * stage_bytes;
    mbar_expect_tx(&bar[s], rows * (g_row + i_row));
    if (rows > 0) {
      const long long first = ((long long)n * g.oh + r.x) * row_el;
      bulk_load(st, gy + first, rows * g_row, &bar[s]);
      bulk_load(st + idx_at, idx + first, rows * i_row, &bar[s]);
    }
  };

  // a thread's units (pixel, channel vector) in a band: unit t, then every
  // TILE_THREADS-th, walked without division
  const int px0 = threadIdx.x / cv, v0 = threadIdx.x - px0 * cv;
  const int r0 = px0 / g.w, w0 = px0 - r0 * g.w;
  const int step_px = TILE_THREADS / cv, step_v = TILE_THREADS - step_px * cv;
  const int step_r = step_px / g.w, step_w = step_px - step_r * g.w;

  if (threadIdx.x == 0 && (int)blockIdx.x < nbands) issue(blockIdx.x, 0);
  int it = 0;
  for (int band = blockIdx.x; band < nbands; band += gridDim.x, ++it) {
    const int s = it & 1;
    // the other stage was last read in the previous band, which every
    // thread left at the barrier below
    if (threadIdx.x == 0 && band + (int)gridDim.x < nbands)
      issue(band + gridDim.x, s ^ 1);
    const int n = band / per_img, hb = band - n * per_img;
    const int h0 = hb * bh, rows_here = min(bh, g.h - h0);
    const int lo = band_tab[hb].x;
    const T* sg = reinterpret_cast<const T*>(stage0 + s * stage_bytes);
    const int* si =
        reinterpret_cast<const int*>(stage0 + s * stage_bytes + idx_at);
    T* dband = dx + ((long long)n * g.h + h0) * g.w * g.c;
    mbar_wait(&bar[s], (it >> 1) & 1);
    for (int r = r0, w = w0, v = v0; r < rows_here;) {
      const int h = h0 + r;
      const int target = h * g.w + w;
      const int2 ri = row_tab[h], ci = col_tab[w];
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
      // ki ascending is oi descending, kj ascending oj descending
      for (int oi = ri.y - 1; oi >= ri.x; --oi) {
        const int base = (oi - lo) * row_el + v * VEC;
        for (int oj = ci.y - 1; oj >= ci.x; --oj) {
          const int off = base + oj * g.c;
          const Pack<int, VEC> a = load_idx<VEC>(si + off, v);
          const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(
              sg + off);
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            if (a.v[i] == target) acc[i] += to_f(p.v[i]);
        }
      }
      Pack<T, VEC> o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) o.v[i] = from_f<T>(acc[i]);
      *reinterpret_cast<Pack<T, VEC>*>(
          dband + ((long long)r * g.w + w) * g.c + v * VEC) = o;
      v += step_v;
      w += step_w;
      if (v >= cv) {
        v -= cv;
        ++w;
      }
      r += step_r;
      if (w >= g.w) {
        w -= g.w;
        ++r;
      }
    }
    __syncthreads();
  }
}

Geo make_geo(const int* a) {
  return Geo{a[0], a[1], a[2], a[3], a[4], a[5],
             a[6], a[7], a[8], a[9], a[10], a[11]};
}

unsigned blocks(long long threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

template <typename T, int VEC>
int fwd(const void* x, void* out, void* idx, const Geo& g, float neg,
        cudaStream_t s) {
  const long long n = (long long)g.n * g.oh * g.ow * (g.c / VEC);
  if (n == 0) return 0;
  pool_fwd_kernel<T, VEC><<<blocks(n), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<int*>(idx),
      g, neg);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int bwd(const void* gy, const void* idx, void* dx, const Geo& g,
        cudaStream_t s) {
  const long long n = (long long)g.n * g.h * g.w * (g.c / VEC);
  if (n == 0) return 0;
  pool_bwd_kernel<T, VEC><<<blocks(n), THREADS, 0, s>>>(
      static_cast<const T*>(gy), static_cast<const int*>(idx),
      static_cast<T*>(dx), g);
  return (int)cudaGetLastError();
}

// What a launch of one tile kernel needs of its device, asked once per
// device: the SM count, the dynamic shared memory the kernel may take so
// far, and the blocks an SM holds at the last size asked for.
struct TileLaunch {
  int sms = 0, smem_set = 0, occ_smem = -1, per_sm = 0;
};
std::mutex tile_launch_mu;

template <typename T, int VEC>
int bwd_tile(const void* gy, const void* idx, void* dx, const void* tab,
             const Geo& g, int bh, int stage_rows, int stage_bytes,
             cudaStream_t s) {
  constexpr int MAX_DEVICES = 64;
  static TileLaunch cache[MAX_DEVICES];
  const long long row_bytes = (long long)g.ow * g.c * (sizeof(T) + 4);
  const long long smem = (long long)TILE_STAGES * stage_bytes;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(gy) | reinterpret_cast<uintptr_t>(idx) |
       reinterpret_cast<uintptr_t>(dx)) % 16 == 0;
  // the wrapper sizes the stages (tile_plan); here they are only checked
  // against the rows the kernel copies into each
  if (g.c % VEC || !aligned || bh < 1 || stage_rows < 1 ||
      stage_bytes % 16 || stage_bytes < stage_rows * row_bytes ||
      smem > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if ((long long)g.n * g.h * g.w * g.c == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(tile_launch_mu);
  TileLaunch& c = cache[dev];
  auto kern = pool_bwd_tile_kernel<T, VEC>;
  if (c.sms == 0) {
    err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  // a refusal is returned and cleared, so that no later launch reports it
  if (smem > c.smem_set) {  // past the device's opt-in limit: refused here
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    c.smem_set = (int)smem;
  }
  if (smem != c.occ_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, kern,
                                                        TILE_THREADS, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    c.occ_smem = (int)smem;
  }
  if (c.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long nbands = (long long)g.n * ((g.h + bh - 1) / bh);
  const long long most = (long long)c.sms * c.per_sm;
  kern<<<(unsigned)(nbands < most ? nbands : most), TILE_THREADS, smem, s>>>(
      static_cast<const T*>(gy), static_cast<const int*>(idx),
      static_cast<T*>(dx), static_cast<const int2*>(tab), g, bh, stage_rows,
      stage_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// geo: 12 ints (n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw); dt F32 or
// BF16; vec 1 or 16 bytes' worth of channels (the caller checks that c and
// the pointers allow it). Returns the cudaError_t of the launch.
extern "C" int pool_fwd(const void* x, void* out, void* idx, const int* geo,
                        int dt, int vec, float neg, void* stream) {
  const Geo g = make_geo(geo);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == BF16)
    return vec > 1 ? fwd<__nv_bfloat16, 8>(x, out, idx, g, neg, s)
                   : fwd<__nv_bfloat16, 1>(x, out, idx, g, neg, s);
  return vec > 1 ? fwd<float, 4>(x, out, idx, g, neg, s)
                 : fwd<float, 1>(x, out, idx, g, neg, s);
}

extern "C" int pool_bwd(const void* gy, const void* idx, void* dx,
                        const int* geo, int dt, int vec, void* stream) {
  const Geo g = make_geo(geo);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == BF16)
    return vec > 1 ? bwd<__nv_bfloat16, 8>(gy, idx, dx, g, s)
                   : bwd<__nv_bfloat16, 1>(gy, idx, dx, g, s);
  return vec > 1 ? bwd<float, 4>(gy, idx, dx, g, s)
                 : bwd<float, 1>(gy, idx, dx, g, s);
}

// The tile backward: tab, bh, stage_rows and stage_bytes as
// pool_bwd_tile_kernel takes them (the wrapper's table and plan); C a
// multiple of 16 bytes' worth of channels, 16-byte aligned gy, idx and dx
// and stages that hold stage_rows rows, else cudaErrorInvalidValue before
// any launch; stages past the shared memory the device lets a block take
// are refused by the runtime, also before any launch.
extern "C" int pool_bwd_tile(const void* gy, const void* idx, void* dx,
                             const int* geo, const void* tab, int bh,
                             int stage_rows, int stage_bytes, int dt,
                             void* stream) {
  const Geo g = make_geo(geo);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == BF16)
    return bwd_tile<__nv_bfloat16, 8>(gy, idx, dx, tab, g, bh, stage_rows,
                                      stage_bytes, s);
  return bwd_tile<float, 4>(gy, idx, dx, tab, g, bh, stage_rows, stage_bytes,
                            s);
}
