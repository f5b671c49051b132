// Flash-attention backward for Hopper (sm_90a): the dQ sweep and the dK/dV
// sweep, with a plain C interface loaded through ctypes by
// paddle_tpu_torch/kernels/attention.py.
//
// Replaces: the Pallas kernels _flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel, launched by _flash_train_bwd in
// paddle_tpu/kernels/attention.py. Both recompute the probabilities from
// the forward's per-row logsumexp instead of storing the [Tq, Tk] matrix:
//   s  = (q * scale) . k           masked to the finite -1e30
//   p  = exp(s - lse)              keys past Tk get weight 0
//   dp = do . v
//   ds = p * (dp - dvec)           dvec = sum_d(do * o), from the wrapper
//   dq = scale * sum_k ds k        (flash_bwd_dq)
//   dv = sum_q p do,  dk = sum_q ds (q * scale)   (flash_bwd_dkv)
// with the JAX kernels' arithmetic kept: the mask value -1e30 is finite, so
// a row whose keys are all masked has lse ~= -1e30 (float32 absorbs log Tk)
// and p = exp(-1e30 + 1e30) = 1 for every key, as on the TPU. Training
// never has such rows (flash_attention_trainable declares them
// unsupported); the kernels match the arithmetic and nothing more.
// Causal masks future keys inside every tile and skips no tile, as the
// forward does. The kv mask [B, Tk] is indexed by bh / H.
//
// Layout: q, do [B*H, Tq, D]; k, v [B*H, Tk, D]; lse, dvec [B*H, Tq]
// float32; all contiguous; q/k/v/do float32 or bfloat16, D <= 128. dq, dk,
// dv come out in the input type, accumulated in float32.
//
// Design (simple and right first; the same scheme as flash_fwd.cu). The
// two sweeps own disjoint outputs, so neither needs atomics:
//   flash_bwd_dq: one block of four warps per (bh, tile of up to 16 query
//     rows); a warp owns up to 4 rows. q (scaled) and do stay in shared
//     memory; K and V pass through shared memory 32 keys at a time as
//     float32 with an odd row stride. Lane j scores key j against the
//     warp's rows (q.k and do.v), and the ds_j are broadcast by shuffle
//     while lane c accumulates dq columns c, c+32, ...
//   flash_bwd_dkv: one block of four warps per (bh, tile of up to 16
//     keys); a warp owns up to 4 keys. k and v stay in shared memory; q
//     (scaled), do, lse and dvec pass through 32 query rows at a time.
//     Lane i scores query i against the warp's keys, and p_i and ds_i are
//     broadcast by shuffle while lane c accumulates dk and dv columns c,
//     c+32, ...
//   In both, each shared-memory element a lane reads serves all the rows
//   its warp owns: shared-memory loads, not FMAs, bound this design.
//   Every output is a float32 sum in index order with one fmaf per term.
//   cuBLAS's float32 SIMT GEMMs sum the same way, and on the H100 the
//   plain version gave the same bits at every shape chip_smoke.py checks.
//
// What bounds it on the H100: per kept score the two sweeps do 14 * D
// flops (dq 6 D, dkv 8 D) against O(T * D) bytes, far above the ~295
// flops per byte where the tensor cores would be the limit at the training
// shape: it is bound by operations. Scalar float32 FMAs reading shared
// memory reach a few percent of the bf16 tensor-core peak; mma/wgmma tiles
// fed by TMA are the later fix.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kWarps = 4;          // warps per block
// rows (dq: queries, dkv: keys) a warp owns; past its last row a warp
// repeats that row (computed, never written), so the inner loops carry no
// branch
constexpr int kRowsPerWarp = 4;
constexpr int kMaxBlockRows = kWarps * kRowsPerWarp;
constexpr int kTile = 32;          // streamed rows per shared-memory tile

// DC = ceil(D / 32): output columns per lane.
template <typename T, int DC>
__global__ void flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, const uint8_t* __restrict__ mask,
    T* __restrict__ dq, int h, int tq, int tk, int d, float scale,
    int causal, int block_q, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int ks = d | 1;                 // odd stride: conflict-free row reads
  float* q_s = smem;                    // [block_q][d], scaled
  float* do_s = q_s + block_q * d;      // [block_q][d]
  float* k_s = do_s + block_q * d;      // [kTile][ks]
  float* v_s = k_s + kTile * ks;        // [kTile][ks]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * block_q;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rows = min(block_q, tq - q0);
  const int nrows = rows > warp ? (rows - warp + nwarps - 1) / nwarps : 0;
  int row[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
    row[r] = warp + min(r, max(nrows - 1, 0)) * nwarps;

  const size_t qoff = ((size_t)bh * tq + q0) * d;
  const T* kb = k + (size_t)bh * tk * d;
  const T* vb = v + (size_t)bh * tk * d;
  const uint8_t* mb = mask ? mask + (size_t)(bh / h) * tk : nullptr;

  stage_rows(q + qoff, q_s, rows, rows, d, d, scale, vec);
  stage_rows(dout + qoff, do_s, rows, rows, d, d, 1.f, vec);

  float acc[kRowsPerWarp][DC];
  float lse_r[kRowsPerWarp], dvec_r[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const size_t i = (size_t)bh * tq + q0 + row[r];
    lse_r[r] = nrows > 0 ? lse[i] : 0.f;
    dvec_r[r] = nrows > 0 ? dvec[i] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < tk; k0 += kTile) {
    const int nk = min(kTile, tk - k0);
    __syncthreads();  // the previous tile is consumed; q_s/do_s are written
    stage_rows(kb + (size_t)k0 * d, k_s, kTile, nk, d, ks, 1.f, vec);
    stage_rows(vb + (size_t)k0 * d, v_s, kTile, nk, d, ks, 1.f, vec);
    __syncthreads();
    if (nrows == 0) continue;           // the warp only helped to load

    const int key = k0 + lane;
    const bool in_range = lane < nk;
    const bool kv_ok = in_range && (mb == nullptr || mb[key] != 0);
    const float* kr = k_s + lane * ks;
    const float* vr = v_s + lane * ks;
    // the warp's rows share each K/V element read: one load of k and v
    // feeds the q.k and do.v products of all its rows
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float kc = kr[c], vc = vr[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = fmaf(q_s[row[r] * d + c], kc, s[r]);
        dp[r] = fmaf(do_s[row[r] * d + c], vc, dp[r]);
      }
    }
    float ds[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sm = (!kv_ok || (causal && key > q0 + row[r])) ? kMaskValue
                                                                   : s[r];
      const float p = in_range ? expf(sm - lse_r[r]) : 0.f;
      ds[r] = p * (dp[r] - dvec_r[r]);
    }
    for (int j = 0; j < nk; ++j) {
      float kj[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = c * 32 + lane;
        kj[c] = col < d ? k_s[j * ks + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float dsj = __shfl_sync(kFull, ds[r], j);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(dsj, kj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (r < nrows) {
      T* out = dq + qoff + (size_t)row[r] * d;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = c * 32 + lane;
        if (col < d) out[col] = from_float<T>(acc[r][c] * scale);
      }
    }
  }
}

template <typename T, int DC>
__global__ void flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, const uint8_t* __restrict__ mask,
    T* __restrict__ dk, T* __restrict__ dv, int h, int tq, int tk, int d,
    float scale, int causal, int block_k, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int qs = d | 1;                 // odd stride: conflict-free row reads
  float* k_s = smem;                    // [block_k][d]
  float* v_s = k_s + block_k * d;       // [block_k][d]
  float* q_s = v_s + block_k * d;       // [kTile][qs], scaled
  float* do_s = q_s + kTile * qs;       // [kTile][qs]
  float* lse_s = do_s + kTile * qs;     // [kTile]
  float* dvec_s = lse_s + kTile;        // [kTile]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * block_k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rows = min(block_k, tk - k0);
  const int nrows = rows > warp ? (rows - warp + nwarps - 1) / nwarps : 0;
  int row[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
    row[r] = warp + min(r, max(nrows - 1, 0)) * nwarps;

  const size_t koff = ((size_t)bh * tk + k0) * d;
  const T* qb = q + (size_t)bh * tq * d;
  const T* db = dout + (size_t)bh * tq * d;
  const float* lb = lse + (size_t)bh * tq;
  const float* vb = dvec + (size_t)bh * tq;
  const uint8_t* mb = mask ? mask + (size_t)(bh / h) * tk : nullptr;

  stage_rows(k + koff, k_s, rows, rows, d, d, 1.f, vec);
  stage_rows(v + koff, v_s, rows, rows, d, d, 1.f, vec);

  float acc_k[kRowsPerWarp][DC], acc_v[kRowsPerWarp][DC];
  bool key_ok[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    key_ok[r] = nrows > 0 && (mb == nullptr || mb[k0 + row[r]] != 0);
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  }

  for (int q0 = 0; q0 < tq; q0 += kTile) {
    const int nq = min(kTile, tq - q0);
    __syncthreads();  // the previous tile is consumed; k_s/v_s are written
    stage_rows(qb + (size_t)q0 * d, q_s, kTile, nq, d, qs, scale, vec);
    stage_rows(db + (size_t)q0 * d, do_s, kTile, nq, d, qs, 1.f, vec);
    if (threadIdx.x < kTile) {
      const bool ok = (int)threadIdx.x < nq;
      lse_s[threadIdx.x] = ok ? lb[q0 + threadIdx.x] : 0.f;
      dvec_s[threadIdx.x] = ok ? vb[q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    if (nrows == 0) continue;           // the warp only helped to load

    const int qi = q0 + lane;
    const bool in_range = lane < nq;
    const float* qr = q_s + lane * qs;
    const float* dr = do_s + lane * qs;
    const float lse_i = lse_s[lane];
    const float dvec_i = dvec_s[lane];
    // the warp's keys share each q/do element read
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float qc = qr[c], dc = dr[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = fmaf(qc, k_s[row[r] * d + c], s[r]);
        dp[r] = fmaf(dc, v_s[row[r] * d + c], dp[r]);
      }
    }
    float p[kRowsPerWarp], ds[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool masked = !key_ok[r] || (causal && k0 + row[r] > qi);
      const float sm = masked ? kMaskValue : s[r];
      p[r] = in_range ? expf(sm - lse_i) : 0.f;
      ds[r] = p[r] * (dp[r] - dvec_i);
    }
    for (int i = 0; i < nq; ++i) {
      float qrow[DC], drow[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = c * 32 + lane;
        qrow[c] = col < d ? q_s[i * qs + col] : 0.f;
        drow[c] = col < d ? do_s[i * qs + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pi = __shfl_sync(kFull, p[r], i);
        const float dsi = __shfl_sync(kFull, ds[r], i);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc_v[r][c] = fmaf(pi, drow[c], acc_v[r][c]);
          acc_k[r][c] = fmaf(dsi, qrow[c], acc_k[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (r < nrows) {
      T* ko = dk + koff + (size_t)row[r] * d;
      T* vo = dv + koff + (size_t)row[r] * d;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = c * 32 + lane;
        if (col < d) {
          ko[col] = from_float<T>(acc_k[r][c]);
          vo[col] = from_float<T>(acc_v[r][c]);
        }
      }
    }
  }
}

// Shared memory above 48 KB needs the opt-in attribute (D > 64 here).
template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int aligned16(const void* a, const void* b, const void* c, const void* e,
              int d) {
  return (d * (int)sizeof(T)) % 16 == 0 &&
         ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)e) % 16 ==
             0;
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dvec,
                      const void* mask, void* dq, int bh, int h, int tq,
                      int tk, int d, float scale, int causal,
                      cudaStream_t stream) {
  const int block_q = tq < kMaxBlockRows ? tq : kMaxBlockRows;
  const dim3 grid(bh, (tq + block_q - 1) / block_q);
  const dim3 block(kWarps * 32);
  const size_t smem =
      ((size_t)2 * block_q * d + (size_t)2 * kTile * (d | 1)) * sizeof(float);
  const int vec = aligned16<T>(q, k, v, dout, d);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  const float* gt = static_cast<const float*>(dvec);
  const uint8_t* mt = static_cast<const uint8_t*>(mask);
  T* ot = static_cast<T*>(dq);
  cudaError_t err = cudaSuccess;
#define FLASH_DQ_CASE(DC)                                                    \
  case DC:                                                                   \
    err = prepare(flash_bwd_dq_kernel<T, DC>, smem);                         \
    if (err != cudaSuccess) return err;                                      \
    flash_bwd_dq_kernel<T, DC><<<grid, block, smem, stream>>>(               \
        qt, kt, vt, dt, lt, gt, mt, ot, h, tq, tk, d, scale, causal, block_q, \
        vec);                                                                \
    break;
  switch ((d + 31) / 32) {
    FLASH_DQ_CASE(1)
    FLASH_DQ_CASE(2)
    FLASH_DQ_CASE(3)
    FLASH_DQ_CASE(4)
  }
#undef FLASH_DQ_CASE
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dvec,
                       const void* mask, void* dk, void* dv, int bh, int h,
                       int tq, int tk, int d, float scale, int causal,
                       cudaStream_t stream) {
  const int block_k = tk < kMaxBlockRows ? tk : kMaxBlockRows;
  const dim3 grid(bh, (tk + block_k - 1) / block_k);
  const dim3 block(kWarps * 32);
  const size_t smem = ((size_t)2 * block_k * d + (size_t)2 * kTile * (d | 1) +
                       2 * kTile) * sizeof(float);
  const int vec = aligned16<T>(q, k, v, dout, d);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  const float* gt = static_cast<const float*>(dvec);
  const uint8_t* mt = static_cast<const uint8_t*>(mask);
  T* kot = static_cast<T*>(dk);
  T* vot = static_cast<T*>(dv);
  cudaError_t err = cudaSuccess;
#define FLASH_DKV_CASE(DC)                                                   \
  case DC:                                                                   \
    err = prepare(flash_bwd_dkv_kernel<T, DC>, smem);                        \
    if (err != cudaSuccess) return err;                                      \
    flash_bwd_dkv_kernel<T, DC><<<grid, block, smem, stream>>>(              \
        qt, kt, vt, dt, lt, gt, mt, kot, vot, h, tq, tk, d, scale, causal,   \
        block_k, vec);                                                       \
    break;
  switch ((d + 31) / 32) {
    FLASH_DKV_CASE(1)
    FLASH_DKV_CASE(2)
    FLASH_DKV_CASE(3)
    FLASH_DKV_CASE(4)
  }
#undef FLASH_DKV_CASE
  return cudaGetLastError();
}

bool bad_args(int bh, int h, int tq, int tk, int d, int dtype) {
  return bh < 1 || h < 1 || tq < 1 || tk < 1 || d < 1 || d > 128 ||
         bh % h != 0 || (dtype != 0 && dtype != 1);
}

}  // namespace

// Each returns the cudaError_t of its launch (0 on success). dtype: 0 =
// float32, 1 = bfloat16. mask may be null. Launches on `stream`, allocates
// nothing and does not synchronize.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* dvec, const void* mask, void* dq,
                            int bh, int h, int tq, int tk, int d, float scale,
                            int causal, int dtype, void* stream) {
  if (bad_args(bh, h, tq, tk, d, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dq<float>(q, k, v, dout, lse, dvec, mask, dq, bh, h,
                                 tq, tk, d, scale, causal, s);
  return (int)launch_dq<__nv_bfloat16>(q, k, v, dout, lse, dvec, mask, dq,
                                       bh, h, tq, tk, d, scale, causal, s);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* dvec, const void* mask, void* dk,
                             void* dv, int bh, int h, int tq, int tk, int d,
                             float scale, int causal, int dtype,
                             void* stream) {
  if (bad_args(bh, h, tq, tk, d, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dkv<float>(q, k, v, dout, lse, dvec, mask, dk, dv, bh,
                                  h, tq, tk, d, scale, causal, s);
  return (int)launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, dvec, mask, dk,
                                        dv, bh, h, tq, tk, d, scale, causal,
                                        s);
}
