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
// VMEM scratch. Here every thread owns one output (forward) or one input
// (backward) position and a 16-byte vector of channels, and walks the
// window itself, so nothing carries between blocks. The backward is a
// gather: each dx element reads the <= kh * kw outputs whose window covers
// it, so there are no atomics and the sum order is fixed; the result is
// deterministic and equal bit for bit to the plain version's.
//
// What bounds it on the H100: bytes. The forward reads x once (a 3x3/s2
// window re-reads neighbouring rows, which the L2 serves) and writes out
// and idx; the backward reads g and idx (each up to kh * kw / (sh * sw)
// times, from L2) and writes dx. There is no arithmetic to speak of.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
