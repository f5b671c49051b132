// Helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): float32 conversion of the input types, 16-byte unpacking,
// staging of row tiles into shared memory, and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kMaskValue = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T (4 float32 or 8 bfloat16) -> float32.
__device__ __forceinline__ void unpack16(const uint4& raw, float* out,
                                         const float*) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw, float* out,
                                         const __nv_bfloat16*) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Stage `rows` rows of a row-major [*, d] tile at `src` into shared memory
// as float32 times `mul`, row stride `stride` floats; rows at or past
// `nvalid` are zero. With `vec` (rows of d * sizeof(T) bytes, a multiple of
// 16, at a 16-byte aligned base) every thread moves 16 bytes per step;
// otherwise one element at a time. All threads of the block take part.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           float* dst, int rows, int nvalid,
                                           int d, int stride, float mul,
                                           int vec) {
  if (vec) {
    constexpr int ev = 16 / sizeof(T);
    const int per_row = d / ev;
    for (int c = threadIdx.x; c < rows * per_row; c += blockDim.x) {
      const int j = c / per_row;
      const int col = (c - j * per_row) * ev;
      float x[ev];
      if (j < nvalid) {
        unpack16(*reinterpret_cast<const uint4*>(src + (size_t)j * d + col),
                 x, src);
      } else {
#pragma unroll
        for (int e = 0; e < ev; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < ev; ++e) dst[j * stride + col + e] = x[e] * mul;
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int j = i / d;
    const int c = i - j * d;
    dst[j * stride + c] =
        j < nvalid ? to_float(src[(size_t)j * d + c]) * mul : 0.f;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

}  // namespace flash
