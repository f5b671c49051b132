// Embedding lookup fused with a sum or mean pool over the sequence, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes by
// paddle_tpu_torch/kernels/embedding_pool.py.
//
// Replaces: the Pallas kernel of paddle_tpu/kernels/embedding_pool.py,
// _seqpool_kernel run by _seqpool_fwd_impl (pallas_call at :101).
//
//   out[b, :] = sum over s = 0..S-1 of table[clamp(ids[b, s], 0, V-1), :],
//   a float32 sum taken in s order, divided by S for the mean, cast to the
//   table's type.
//
// The TPU kernel scalar-prefetches the ids and keeps eight row DMAs in
// flight into VMEM, then reduces a block of samples' rows at once. Here one
// warp owns one sample: each lane reads one id of the next 32 and clamps
// it, the ids go round the warp by shuffles, and every lane owns 16 bytes
// of columns, so a row is one coalesced read of the warp and the rows of
// the sample are summed in registers in s order. No [B*S, D] gather is
// ever written, as on the TPU. The ids are clamped by the caller too; the
// clamp here keeps an out-of-range id from reading outside the table.
//
// What bounds it on the H100: bytes, the table rows the ids name (rows
// named often come from L2) plus the ids and the output. With one warp a
// sample, a batch of a few hundred samples puts only a few warps on each
// SM, so the row reads' latency, not the memory rate, sets its time at
// the classifier's batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BF16 = 1;            // the dtype code; 0 is float32
constexpr int WARPS = 4;           // samples a block

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
__global__ void __launch_bounds__(WARPS * 32)
seqpool_kernel(const int* __restrict__ ids, const T* __restrict__ table,
               T* __restrict__ out, int B, int S, int V, int D, int mean) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;                        // a whole warp leaves together
  const int* row_ids = ids + (long long)b * S;
  const int chunks = (D + 32 * VEC - 1) / (32 * VEC);
  for (int ch = 0; ch < chunks; ++ch) {
    const int col = (ch * 32 + lane) * VEC;
    const bool active = col < D;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    for (int s0 = 0; s0 < S; s0 += 32) {
      int mine = 0;
      if (s0 + lane < S) mine = min(max(row_ids[s0 + lane], 0), V - 1);
      const int n = min(32, S - s0);
#pragma unroll 8
      for (int t = 0; t < n; ++t) {
        const int id = __shfl_sync(0xffffffffu, mine, t);
        if (active) {
          const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(
              table + (long long)id * D + col);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += to_f(p.v[i]);
        }
      }
    }
    if (active) {
      Pack<T, VEC> o;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        o.v[i] = from_f<T>(mean ? acc[i] / (float)S : acc[i]);
      *reinterpret_cast<Pack<T, VEC>*>(out + (long long)b * D + col) = o;
    }
  }
}

template <typename T, int VEC>
int run(const int* ids, const void* table, void* out, int B, int S, int V,
        int D, int mean, cudaStream_t s) {
  if (B == 0 || D == 0) return 0;
  seqpool_kernel<T, VEC><<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
      ids, static_cast<const T*>(table), static_cast<T*>(out), B, S, V, D,
      mean);
  return (int)cudaGetLastError();
}

}  // namespace

// ids int32 [B, S]; table [V, D] and out [B, D] of type dt (F32 or BF16);
// vec 1 or 16 bytes' worth of columns (the caller checks that D and the
// pointers allow it). Returns the cudaError_t of the launch.
extern "C" int seqpool(const int* ids, const void* table, void* out, int B,
                       int S, int V, int D, int mean, int dt, int vec,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dt == BF16)
    return vec > 1 ? run<__nv_bfloat16, 8>(ids, table, out, B, S, V, D, mean, s)
                   : run<__nv_bfloat16, 1>(ids, table, out, B, S, V, D, mean, s);
  return vec > 1 ? run<float, 4>(ids, table, out, B, S, V, D, mean, s)
                 : run<float, 1>(ids, table, out, B, S, V, D, mean, s);
}
