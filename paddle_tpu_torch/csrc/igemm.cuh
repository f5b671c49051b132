// Shared-memory tiled SIMT GEMM core of the conv kernels (brgemm.cu,
// conv_kxk.cu), for Hopper (sm_90a).
//
// out[M, N] = epilogue( sum_k A(m, k) * B(k, n) ) with a float32 sum.
// A and B are not arrays here but loaders: small structs that fetch one
// element as float, apply the input fold and return 0 outside the problem.
// A loader is a dense matrix for the 1x1 convs (brgemm.cu) or an implicit
// im2col gather of an NHWC activation for the KxK convs (conv_kxk.cu), so
// padding, strides and tile edges are bounds checks on unpadded tensors and
// nothing is materialised.
//
// Tiles: a block of 256 threads owns a BM x BN output tile (BM = 128, BN =
// 128 or 64) and walks K in steps of BK = 16: each step loads the A and B
// tiles into shared memory as float (the fold applied, then rounded to the
// operand's type, as the TPU kernels feed their MXU), and every thread adds
// the outer products of its 8 x TN outputs (rows ty + 16 i, columns
// tx + 16 j: a warp reads 16 consecutive B columns and two A rows, so the
// shared-memory reads are conflict-free). Sums are fmaf in k order.
//
// Split-K: a problem with few output tiles and a long K (the weight
// gradients: K = N*OH*OW up to 802,816) splits K over gridDim.z; each split
// writes its float32 partial tile to a workspace, and splitk_reduce adds the
// splits in order and applies the epilogue. No atomics: the result does not
// depend on block order.
//
// What bounds it on the H100: these are float32 FMAs on the SIMT units (67
// TFLOP/s), not the tensor cores (989 TFLOP/s in bf16), so every conv of
// ResNet-50 is far above the card's bound; a wgmma/TMA version is later
// work (see PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace igemm {

constexpr int THREADS = 256;
constexpr int BM = 128;
constexpr int BK = 16;
// dtype codes shared with the Python wrappers
constexpr int F32 = 0;
constexpr int BF16 = 1;
// "outside the problem" marker for a row coordinate: any bounds check fails
constexpr int FAR = -(1 << 28);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round a float to T's precision (the fold's cast to the dot dtype).
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_any(const void* p, long long i, int dt) {
  return dt == BF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                    : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_any(void* p, long long i, int dt,
                                          float v) {
  if (dt == BF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// The cotangent fold of a backward operand (epilogues.fold_cotangent):
// g -> where(mask > 0, g, 0) -> * scale[channel] -> rounded to the dot type.
// mask is the saved forward output, laid out as the folded operand.
struct Fold {
  const void* mask;
  const float* scale;
  int mask_dt;

  __device__ __forceinline__ bool active() const {
    return mask != nullptr || scale != nullptr;
  }
  template <typename T>
  __device__ __forceinline__ float apply(float g, long long idx,
                                         int ch) const {
    if (mask != nullptr && !(load_any(mask, idx, mask_dt) > 0.f)) g = 0.f;
    if (scale != nullptr) g = __fmul_rn(g, scale[ch]);
    return round_to<T>(g);
  }
};

// The forward epilogue chain on the float32 sum, in the contract's order:
// scale, bias, residual, relu; then the cast to the output type. Explicitly
// rounded intrinsics keep nvcc from contracting it into FMAs.
struct Epilogue {
  const float* scale;
  const float* bias;
  const void* residual;
  void* out;
  int res_dt, out_dt, relu, ldo;

  __device__ __forceinline__ void store(int m, int n, float acc) const {
    const long long i = static_cast<long long>(m) * ldo + n;
    if (scale != nullptr) acc = __fmul_rn(acc, scale[n]);
    if (bias != nullptr) acc = __fadd_rn(acc, bias[n]);
    if (residual != nullptr) acc = __fadd_rn(acc, load_any(residual, i, res_dt));
    if (relu && acc < 0.f) acc = 0.f;
    store_any(out, i, out_dt, acc);
  }
};

// Dense operands. A is [M, K] row-major (K_CONTIG, mode "nn") or [K, M]
// (mode "tn"); B is [K, N]. The fold's channel is the stored last dim.
template <typename T, bool KC>
struct DenseA {
  static constexpr bool K_CONTIG = KC;
  const T* a;
  Fold fold;
  int M, K;
  struct Fixed { int m; };
  struct Var { int k; };
  __device__ __forceinline__ Fixed fixed(int m) const {
    return {m < M ? m : -1};
  }
  __device__ __forceinline__ Var var(int k, int ke) const {
    return {k < ke ? k : -1};
  }
  __device__ __forceinline__ float load(const Fixed& f, const Var& v) const {
    if (f.m < 0 || v.k < 0) return 0.f;
    const long long i = KC ? static_cast<long long>(f.m) * K + v.k
                           : static_cast<long long>(v.k) * M + f.m;
    const float x = to_f(a[i]);
    return fold.active() ? fold.apply<T>(x, i, KC ? v.k : f.m) : x;
  }
};

template <typename T>
struct DenseB {
  const T* b;
  Fold fold;
  int N;
  struct Fixed { int n; };
  struct Var { int k; };
  __device__ __forceinline__ Fixed fixed(int n) const {
    return {n < N ? n : -1};
  }
  __device__ __forceinline__ Var var(int k, int ke) const {
    return {k < ke ? k : -1};
  }
  __device__ __forceinline__ float load(const Fixed& f, const Var& v) const {
    if (f.n < 0 || v.k < 0) return 0.f;
    const long long i = static_cast<long long>(v.k) * N + f.n;
    const float x = to_f(b[i]);
    return fold.active() ? fold.apply<T>(x, i, f.n) : x;
  }
};

// The tiled GEMM. Loaders: LA::K_CONTIG says which way A's elements lie
// contiguous in memory, so that neighbouring threads load neighbours:
// along k (each thread keeps A_LOADS rows and one k column) or along m
// (one row, A_LOADS k columns). B is contiguous along n. `partial` is the
// split-K workspace [splits, M, N], or null to apply the epilogue here.
template <int BN, class LA, class LB>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(LA la, LB lb, Epilogue ep, int M, int N, int K, int k_per_split,
            float* __restrict__ partial) {
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int A_LOADS = BM * BK / THREADS;
  constexpr int B_LOADS = BN * BK / THREADS;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * k_per_split;
  const int ke = min(K, kb + k_per_split);

  typename LA::Fixed fa[LA::K_CONTIG ? A_LOADS : 1];
  if constexpr (LA::K_CONTIG) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i)
      fa[i] = la.fixed(m0 + tid / BK + i * (THREADS / BK));
  } else {
    fa[0] = la.fixed(m0 + tid % BM);
  }
  const typename LB::Fixed fb = lb.fixed(n0 + tid % BN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    if constexpr (LA::K_CONTIG) {
      const typename LA::Var va = la.var(k0 + tid % BK, ke);
#pragma unroll
      for (int i = 0; i < A_LOADS; ++i)
        As[tid % BK][tid / BK + i * (THREADS / BK)] = la.load(fa[i], va);
    } else {
#pragma unroll
      for (int i = 0; i < A_LOADS; ++i) {
        const int kk = tid / BM + i * (THREADS / BM);
        As[kk][tid % BM] = la.load(fa[0], la.var(k0 + kk, ke));
      }
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int kk = tid / BN + i * (THREADS / BN);
      Bs[kk][tid % BN] = lb.load(fb, lb.var(k0 + kk, ke));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      if (partial != nullptr)
        partial[(static_cast<long long>(blockIdx.z) * M + m) * N + n] =
            acc[i][j];
      else
        ep.store(m, n, acc[i][j]);
    }
  }
}

// Tag: the GEMM's A loader, so a profile names the reduction of each
// kernel apart.
template <class Tag>
__global__ void splitk_reduce(const float* __restrict__ partial, int splits,
                              int M, int N, Epilogue ep) {
  const long long total = static_cast<long long>(M) * N;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s = __fadd_rn(s, partial[z * total + i]);
  ep.store(static_cast<int>(i / N), static_cast<int>(i % N), s);
}

// Launch the GEMM (and, with splits > 1, the reduction over `workspace`,
// splits * M * N floats). Returns the first CUDA error, 0 on success.
template <class LA, class LB>
int launch(const LA& la, const LB& lb, const Epilogue& ep, int M, int N,
           int K, int splits, int k_per_split, float* workspace,
           cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  float* partial = splits > 1 ? workspace : nullptr;
  if (N <= 64) {
    dim3 grid((M + BM - 1) / BM, (N + 63) / 64, splits);
    gemm_kernel<64, LA, LB><<<grid, THREADS, 0, stream>>>(
        la, lb, ep, M, N, K, k_per_split, partial);
  } else {
    dim3 grid((M + BM - 1) / BM, (N + 127) / 128, splits);
    gemm_kernel<128, LA, LB><<<grid, THREADS, 0, stream>>>(
        la, lb, ep, M, N, K, k_per_split, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(M) * N;
  splitk_reduce<LA><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                      stream>>>(workspace, splits, M, N, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace igemm
