// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by paddle_tpu_torch/kernels/attention.py.
//
// Replaces: the Pallas kernel _flash_fwd_kernel, launched by
// _flash_call_fwd in paddle_tpu/kernels/attention.py. It computes the same
// function: o = softmax(q k^T * scale [masked]) v and the per-row
// logsumexp, with the JAX kernel's numerics kept exactly:
//   - scores in float32 after the upcast, the scale applied to q;
//   - masked scores are the FINITE -1e30 (not -inf) and the running max
//     starts at -1e30; l is clamped at 1e-30 before the division.
//   So a row whose keys are all masked returns the uniform mean of V with
//   lse ~= -1e30 instead of NaN. The serving path hits this: the Generator
//   pads a batch with all-pad source rows whose source mask is all False in
//   the encoder and in the cross-attention.
//   - causal: query i sees keys at positions <= i. Future keys are masked
//     with -1e30 inside every tile, and no tile is skipped, as on the
//     scan path of the JAX flash_attention; skipping tiles would change
//     the answer for a row whose visible keys are all masked.
// The kv mask [B, Tk] is indexed by bh / H inside the kernel, where the
// JAX wrapper had to materialize jnp.repeat(kv_mask, h).
//
// Layout: q [B*H, Tq, D], k and v [B*H, Tk, D], contiguous, float32 or
// bfloat16, D <= 128; o [B*H, Tq, D] in q's type, lse [B*H, Tq] float32.
//
// Design (simple and right first). One block of four warps per (bh, tile
// of up to 16 query rows); a warp owns up to 4 rows of the tile. K and V
// are staged through shared memory 32 keys at a time, converted to
// float32, all four warps loading 16 bytes a thread per step (one element
// at a time where rows are not 16-byte multiples), so that even a decode
// block, whose single row one warp computes, has 128 threads' loads in
// flight. The scaled q tile stays in shared memory. Lane j scores key j
// of the tile against the warp's rows (the row of K in shared memory has
// an odd stride, so the 32 lanes hit 32 banks; each K element read
// serves all of the warp's rows), a warp max and a warp sum give the
// online softmax update, and the P.V product broadcasts each p_j by
// shuffle while lane c accumulates output columns c, c+32, ... (each V
// element read again serves all rows). The running (m, l, acc) stay in
// float32 registers and o is written once.
//
// What bounds it on the H100: at decode (Tq = 1) the kernel reads the
// whole K/V cache of every (batch, head) once per token and layer and does
// 4*D flops per key, far below the ~295 flops per byte where the tensor
// cores would be the limit: it is bound by memory bandwidth, and its
// figure of merit is bytes moved over 3.35 TB/s. The design spends no
// effort on the tensor cores for that reason. bf16 calls with D a
// multiple of 16 and Tq >= 16 (the encoder, prefill, BERT and the training
// slice's forward) take csrc/flash_fwd_tc.cu, the tensor-core kernel,
// instead (kernels/attention.py's fwd_route); this one keeps float32
// (whose 1e-5 gates the tensor cores' input types cannot meet), decode
// and other head dims.
//
// Left for later work: split-K over the key axis for the
// Tq = 1 decode shape (one row per (bh) leaves three of the block's four
// warps idle while it computes, and most SMs idle at small batch), keeping
// K/V in bf16 in shared memory, and skipping K/V tiles that are fully
// masked.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockK = 32;        // keys per shared-memory tile: one per lane
constexpr int kWarps = 4;          // warps per block
constexpr int kRowsPerWarp = 4;    // query rows a warp owns from Tq = 16 on

// Stage keys k0 .. k0+kBlockK-1 of K and V into shared memory as float32;
// rows past the end (j >= nk) are zero. With `vec`, every thread moves 16
// bytes of K and 16 of V per step (rows of d * sizeof(T) bytes, a multiple
// of 16, at 16-byte aligned bases); otherwise one element at a time.
template <typename T>
__device__ __forceinline__ void load_kv_tile(const T* __restrict__ kb,
                                             const T* __restrict__ vb,
                                             float* k_s, float* v_s, int k0,
                                             int nk, int d, int ks, int vec) {
  if (vec) {
    constexpr int ev = 16 / sizeof(T);
    const int per_row = d / ev;
    for (int c = threadIdx.x; c < kBlockK * per_row; c += blockDim.x) {
      const int j = c / per_row;
      const int col = (c - j * per_row) * ev;
      float kx[ev], vx[ev];
      if (j < nk) {
        const size_t g = (size_t)(k0 + j) * d + col;
        unpack16(*reinterpret_cast<const uint4*>(kb + g), kx, kb);
        unpack16(*reinterpret_cast<const uint4*>(vb + g), vx, vb);
      } else {
#pragma unroll
        for (int e = 0; e < ev; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < ev; ++e) k_s[j * ks + col + e] = kx[e];
#pragma unroll
      for (int e = 0; e < ev; e += 4)
        *reinterpret_cast<float4*>(v_s + j * d + col + e) =
            make_float4(vx[e], vx[e + 1], vx[e + 2], vx[e + 3]);
    }
    return;
  }
  for (int i = threadIdx.x; i < kBlockK * d; i += blockDim.x) {
    const int j = i / d;
    const int c = i - j * d;
    float kx = 0.f, vx = 0.f;
    if (j < nk) {
      const size_t g = (size_t)(k0 + j) * d + c;
      kx = to_float(kb[g]);
      vx = to_float(vb[g]);
    }
    k_s[j * ks + c] = kx;
    v_s[j * d + c] = vx;
  }
}

// DC = ceil(D / 32): output columns per lane. R: query rows a warp owns
// (4 from Tq = 16 on, 1 below: decode). A warp owns rows warp,
// warp + nwarps, ...; past its last row it repeats that row (computed,
// never written), so the inner loops carry no branch.
template <typename T, int DC, int R>
__global__ void flash_fwd_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const uint8_t* __restrict__ mask,
                                 T* __restrict__ o, float* __restrict__ lse,
                                 int h, int tq, int tk, int d, float scale,
                                 int causal, int block_q, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int ks = d | 1;                 // odd stride: conflict-free row reads
  float* q_s = smem;                    // [block_q][d], scaled
  float* k_s = q_s + block_q * d;       // [kBlockK][ks]
  float* v_s = k_s + kBlockK * ks;      // [kBlockK][d]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * block_q;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rows = min(block_q, tq - q0);
  const int nrows = rows > warp ? (rows - warp + nwarps - 1) / nwarps : 0;
  int row[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    row[r] = warp + min(r, max(nrows - 1, 0)) * nwarps;

  const T* qb = q + ((size_t)bh * tq + q0) * d;
  const T* kb = k + (size_t)bh * tk * d;
  const T* vb = v + (size_t)bh * tk * d;
  const uint8_t* mb = mask ? mask + (size_t)(bh / h) * tk : nullptr;

  for (int i = threadIdx.x; i < rows * d; i += blockDim.x)
    q_s[i] = to_float(qb[i]) * scale;

  float acc[R][DC];
  float m_i[R];
  float l_i[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_i[r] = kMaskValue;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < tk; k0 += kBlockK) {
    const int nk = min(kBlockK, tk - k0);
    __syncthreads();  // the previous tile is consumed; q_s is written
    load_kv_tile(kb, vb, k_s, v_s, k0, nk, d, ks, vec);
    __syncthreads();
    if (nrows == 0) continue;           // the warp only helped to load

    const int key = k0 + lane;
    const bool in_range = lane < nk;
    const bool kv_ok = in_range && (mb == nullptr || mb[key] != 0);
    const float* kr = k_s + lane * ks;
    // each K element read serves all of the warp's rows
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float kc = kr[c];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = fmaf(q_s[row[r] * d + c], kc, s[r]);
    }
    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float sr = s[r];
      if (!kv_ok || (causal && key > q0 + row[r])) sr = kMaskValue;
      if (!in_range) sr = -INFINITY;     // past the end: no weight at all
      const float m_new = fmaxf(m_i[r], warp_max(sr));
      const float corr = expf(m_i[r] - m_new);
      p[r] = in_range ? expf(sr - m_new) : 0.f;
      l_i[r] = l_i[r] * corr + warp_sum(p[r]);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= corr;
      m_i[r] = m_new;
    }
    // ... and each V element read
    for (int j = 0; j < nk; ++j) {
      float vj[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = c * 32 + lane;
        vj[c] = col < d ? v_s[j * d + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nrows) {
      const float l_safe = fmaxf(l_i[r], 1e-30f);
      T* orow = o + ((size_t)bh * tq + q0 + row[r]) * d;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = c * 32 + lane;
        if (col < d) orow[col] = from_float<T>(acc[r][c] / l_safe);
      }
      if (lane == 0)
        lse[(size_t)bh * tq + q0 + row[r]] = m_i[r] + logf(l_safe);
    }
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const void* mask,
            void* o, void* lse, int bh, int h, int tq, int tk, int d,
            float scale, int causal, cudaStream_t stream) {
  // four rows a warp from Tq = 16 on; one row a warp below (decode), where
  // the loads, not the arithmetic, take the time: the four warps share
  // the tile loads even where only one owns a row
  const bool wide = tq >= kWarps * kRowsPerWarp;
  const int block_q = wide ? kWarps * kRowsPerWarp : (tq < kWarps ? tq
                                                                   : kWarps);
  const dim3 grid(bh, (tq + block_q - 1) / block_q);
  const dim3 block(kWarps * 32);
  // v_s starts 16-byte aligned when block_q * d + kBlockK * (d | 1) is a
  // multiple of 4 floats; the vector path needs that and 16-byte rows
  const size_t v_off = (size_t)block_q * d + kBlockK * (d | 1);
  const int vec = (d * (int)sizeof(T)) % 16 == 0 && v_off % 4 == 0 &&
                  ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const size_t smem = (v_off + (size_t)kBlockK * d) * sizeof(float);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const uint8_t* mt = static_cast<const uint8_t*>(mask);
  T* ot = static_cast<T*>(o);
  float* lt = static_cast<float*>(lse);
  const int dc = (d + 31) / 32;
#define FLASH_FWD_CASE(DC)                                                  \
  case DC:                                                                  \
    if (wide)                                                               \
      flash_fwd_kernel<T, DC, kRowsPerWarp><<<grid, block, smem, stream>>>( \
          qt, kt, vt, mt, ot, lt, h, tq, tk, d, scale, causal, block_q,     \
          vec);                                                             \
    else                                                                    \
      flash_fwd_kernel<T, DC, 1><<<grid, block, smem, stream>>>(            \
          qt, kt, vt, mt, ot, lt, h, tq, tk, d, scale, causal, block_q,     \
          vec);                                                             \
    break;
  switch (dc) {
    FLASH_FWD_CASE(1)
    FLASH_FWD_CASE(2)
    FLASH_FWD_CASE(3)
    FLASH_FWD_CASE(4)
  }
#undef FLASH_FWD_CASE
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). dtype: 0 = float32,
// 1 = bfloat16. mask may be null. Launches on `stream`, allocates nothing
// and does not synchronize.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* mask, void* o, void* lse, int bh, int h,
                         int tq, int tk, int d, float scale, int causal,
                         int dtype, void* stream) {
  if (bh < 1 || h < 1 || tq < 1 || tk < 1 || d < 1 || d > 128 ||
      bh % h != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(q, k, v, mask, o, lse, bh, h, tq, tk, d, scale, causal, s);
  else
    launch<__nv_bfloat16>(q, k, v, mask, o, lse, bh, h, tq, tk, d, scale,
                          causal, s);
  return (int)cudaGetLastError();
}
