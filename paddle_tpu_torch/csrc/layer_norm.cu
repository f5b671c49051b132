// Row LayerNorm over x [N, D], forward only, for Hopper (sm_90a), with a
// plain C interface loaded through ctypes by
// paddle_tpu_torch/kernels/layer_norm.py.
//
// Replaces: the Pallas kernel that paddle_tpu/kernels/tiles.py's row_map
// builds (pallas_call at :468) for fused_layer_norm
// (paddle_tpu/kernels/layer_norm.py:27). For each row:
//
//   xf   = float32(x)
//   mean = sum(xf) / D
//   xc   = xf - mean
//   var  = sum(xc * xc) / D            (two passes, not E[x^2] - mean^2)
//   y    = xc * rsqrt(var + eps) * scale + bias, cast to x's type
//
// scale and bias are float32 [D]; a null pointer stands for ones (scale)
// or zeros (bias). Like the TPU kernel it has no backward.
//
// What bounds it on the H100: bytes. It reads x once from HBM and writes y
// once: 4 bytes an element in bf16, 8 in float32, against ~8 float32
// operations an element, far under the card's 67 TFLOP/s float32 rate.
// The TPU kernel holds a block of rows in VMEM; here one warp owns one row
// and every lane reads 16 bytes at a time (8 bf16/f16 or 4 float32 values)
// where D and the pointers allow it, neighbouring lanes on neighbouring
// addresses, so each warp load is one coalesced 512-byte transaction.
// Where the row fits (up to 8 such loads a lane: D <= 2048 in bf16, 1024
// in float32) the kernel keeps it in registers: every lane issues all its
// loads at once, then both sums and the output come from the registers, so
// each row is read once and the warp has all its loads in flight together.
// Wider rows take a streaming kernel that sweeps the row three times, the
// second and third reads from L1/L2. The mean and
// the variance are float32 sums reduced across the warp by shuffles. Eight
// warps a block (eight rows), N / 8 blocks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BF16 = 1;            // the dtype codes; 0 is float32
constexpr int F16 = 2;
constexpr int WARPS = 8;           // rows a block

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VEC float32 values of scale or bias from p (16-byte loads when VEC is a
// multiple of 4: the caller checked the pointers' alignment)
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k) {
      const float4 f = reinterpret_cast<const float4*>(p)[k];
      out[4 * k] = f.x;
      out[4 * k + 1] = f.y;
      out[4 * k + 2] = f.z;
      out[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = p[i];
  }
}

// y[c .. c+VEC) from the float32 values v of x there
template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* yr, int c, const float* v,
                                          float mean, float rstd,
                                          const float* scale,
                                          const float* bias) {
  float s[VEC], b[VEC];
  if (scale) load_f32<VEC>(scale + c, s);
  if (bias) load_f32<VEC>(bias + c, b);
  Pack<T, VEC> o;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float r = (v[i] - mean) * rstd;
    if (scale) r *= s[i];
    if (bias) r += b[i];
    o.v[i] = from_f<T>(r);
  }
  *reinterpret_cast<Pack<T, VEC>*>(yr + c) = o;
}

// The row in registers: lane l holds the packs at columns (j*32 + l)*VEC,
// j < PACKS, with PACKS * 32 * VEC >= D. With VEC > 1 the caller checked
// D % VEC == 0, so c < D covers the pack.
template <typename T, int VEC, int PACKS>
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y,
                  long long N, int D, float eps) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= N) return;                      // a whole warp leaves together
  const T* xr = x + row * D;
  float v[PACKS][VEC];
#pragma unroll
  for (int j = 0; j < PACKS; ++j) {
    const int c = (j * 32 + lane) * VEC;
    if (c < D) {
      const P p = *reinterpret_cast<const P*>(xr + c);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[j][i] = to_f(p.v[i]);
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < PACKS; ++j)
    if ((j * 32 + lane) * VEC < D) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) s += v[j][i];
    }
  const float mean = warp_sum(s) / (float)D;
  float q = 0.0f;
#pragma unroll
  for (int j = 0; j < PACKS; ++j)
    if ((j * 32 + lane) * VEC < D) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[j][i] - mean;
        q += d * d;
      }
    }
  const float rstd = rsqrtf(warp_sum(q) / (float)D + eps);
#pragma unroll
  for (int j = 0; j < PACKS; ++j) {
    const int c = (j * 32 + lane) * VEC;
    if (c < D) store_row<T, VEC>(y + row * D, c, v[j], mean, rstd, scale,
                                 bias);
  }
}

// Rows too wide for the registers: three sweeps over the row.
template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_stream_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, T* __restrict__ y,
                         long long N, int D, float eps) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= N) return;
  const T* xr = x + row * D;
  float s = 0.0f;
  for (int c = lane * VEC; c < D; c += 32 * VEC) {
    const P p = *reinterpret_cast<const P*>(xr + c);
#pragma unroll
    for (int i = 0; i < VEC; ++i) s += to_f(p.v[i]);
  }
  const float mean = warp_sum(s) / (float)D;
  float q = 0.0f;
  for (int c = lane * VEC; c < D; c += 32 * VEC) {
    const P p = *reinterpret_cast<const P*>(xr + c);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float d = to_f(p.v[i]) - mean;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)D + eps);
  for (int c = lane * VEC; c < D; c += 32 * VEC) {
    const P p = *reinterpret_cast<const P*>(xr + c);
    float v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f(p.v[i]);
    store_row<T, VEC>(y + row * D, c, v, mean, rstd, scale, bias);
  }
}

template <typename T, int VEC, int PACKS>
int launch(const void* x, const float* scale, const float* bias, void* y,
           long long N, int D, float eps, cudaStream_t s) {
  const unsigned blocks = (unsigned)((N + WARPS - 1) / WARPS);
  if constexpr (PACKS > 0)
    layer_norm_kernel<T, VEC, PACKS><<<blocks, WARPS * 32, 0, s>>>(
        static_cast<const T*>(x), scale, bias, static_cast<T*>(y), N, D,
        eps);
  else
    layer_norm_stream_kernel<T, VEC><<<blocks, WARPS * 32, 0, s>>>(
        static_cast<const T*>(x), scale, bias, static_cast<T*>(y), N, D,
        eps);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int run(const void* x, const float* scale, const float* bias, void* y,
        long long N, int D, float eps, cudaStream_t s) {
  if (N == 0 || D == 0) return 0;
  const int packs = (D + 32 * VEC - 1) / (32 * VEC);
  if (packs <= 1) return launch<T, VEC, 1>(x, scale, bias, y, N, D, eps, s);
  if (packs <= 2) return launch<T, VEC, 2>(x, scale, bias, y, N, D, eps, s);
  if (packs <= 4) return launch<T, VEC, 4>(x, scale, bias, y, N, D, eps, s);
  if (packs <= 8) return launch<T, VEC, 8>(x, scale, bias, y, N, D, eps, s);
  return launch<T, VEC, 0>(x, scale, bias, y, N, D, eps, s);
}

template <typename T>
int dispatch(int vec, const void* x, const float* scale, const float* bias,
             void* y, long long N, int D, float eps, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  return vec > 1 ? run<T, V>(x, scale, bias, y, N, D, eps, s)
                 : run<T, 1>(x, scale, bias, y, N, D, eps, s);
}

}  // namespace

// x and y [N, D] of type dt (0 float32, 1 bfloat16, 2 float16), scale and
// bias float32 [D] or null; vec 1, or 16 bytes' worth of columns a load
// (the caller checks that D and all four pointers allow it). Launches on
// `stream` and returns the cudaError_t of the launch.
extern "C" int layer_norm_fwd(const void* x, const float* scale,
                              const float* bias, void* y, long long N, int D,
                              float eps, int dt, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == BF16)
    return dispatch<__nv_bfloat16>(vec, x, scale, bias, y, N, D, eps, s);
  if (dt == F16) return dispatch<__half>(vec, x, scale, bias, y, N, D, eps, s);
  return dispatch<float>(vec, x, scale, bias, y, N, D, eps, s);
}
