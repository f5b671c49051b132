// One-pass fused optimizer update for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by paddle_tpu_torch/kernels/fused_update.py.
//
// Replaces: the Pallas kernel _update_kernel, launched by _run_bucket under
// fused_update_step in paddle_tpu/kernels/fused_update.py. One launch per
// dtype bucket reads (p, g, accumulators) once and writes (p, accumulators)
// once, in place:
//   g  = g * clip_factor                          (with a global-norm clip)
//   sgd:       p -= lr * g
//   momentum:  v = mu * v + g;  p -= lr * v   (nesterov: lr * (g + mu * v))
//   adam:      m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g * g
//              p -= lr * (m / c1) / (sqrt(v / c2) + eps)
//   adamw:     adam, then p -= (lr * wd) * p_old
// where scal = [lr, clip_factor, c1 = 1 - b1^t, c2 = 1 - b2^t] lives on the
// device (computed once per step by the wrapper, never read by the host).
//
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn), so nvcc contracts nothing into FMAs
// and the result is bit-identical to the same expression evaluated one
// PyTorch operation at a time (the plain version and the unfused sweep).
//
// Layout: a device table of chunks, one row of five int64 per chunk:
// (p, g, acc0, acc1, n) with the pointers already offset to the chunk's
// first element (acc0/acc1 unused by sgd; acc1 unused by momentum). Each
// block updates one chunk: a multi-tensor apply over every parameter of the
// bucket in one launch, instead of the TPU kernel's flat (rows, 128)
// packing, which was a layout need of the TPU and costs a copy in and out.
// Parameters, gradients and accumulators are float32.
//
// What bounds it on the H100: 28 bytes per element for Adam (4 reads, 3
// writes of float32) against ~10 flops: memory bandwidth. Each thread
// touches consecutive elements 256 apart, so a warp's loads coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { kSgd = 0, kMomentum = 1, kAdam = 2, kAdamW = 3 };

struct Hyper {
  int kind, nesterov, has_clip;
  float mu, b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

__global__ void fused_update_kernel(const long long* __restrict__ table,
                                    const float* __restrict__ scal,
                                    Hyper hp) {
  const long long* row = table + (size_t)blockIdx.x * 5;
  float* p = reinterpret_cast<float*>(row[0]);
  const float* g = reinterpret_cast<const float*>(row[1]);
  float* a0 = reinterpret_cast<float*>(row[2]);
  float* a1 = reinterpret_cast<float*>(row[3]);
  const long long n = row[4];
  const float lr = scal[0], factor = scal[1], c1 = scal[2], c2 = scal[3];
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    float gi = g[i];
    if (hp.has_clip) gi = __fmul_rn(gi, factor);
    const float pi = p[i];
    float pn;
    if (hp.kind == kSgd) {
      pn = __fsub_rn(pi, __fmul_rn(lr, gi));
    } else if (hp.kind == kMomentum) {
      const float vn = __fadd_rn(__fmul_rn(hp.mu, a0[i]), gi);
      a0[i] = vn;
      pn = hp.nesterov ? __fsub_rn(pi, __fmul_rn(lr, __fadd_rn(
                             gi, __fmul_rn(hp.mu, vn))))
                       : __fsub_rn(pi, __fmul_rn(lr, vn));
    } else {
      const float m = __fadd_rn(__fmul_rn(hp.b1, a0[i]),
                                __fmul_rn(hp.one_minus_b1, gi));
      const float v = __fadd_rn(__fmul_rn(hp.b2, a1[i]),
                                __fmul_rn(hp.one_minus_b2, __fmul_rn(gi, gi)));
      a0[i] = m;
      a1[i] = v;
      const float mhat = __fdiv_rn(m, c1);
      const float vhat = __fdiv_rn(v, c2);
      const float delta = __fdiv_rn(__fmul_rn(lr, mhat),
                                    __fadd_rn(__fsqrt_rn(vhat), hp.eps));
      pn = __fsub_rn(pi, delta);
      if (hp.kind == kAdamW)
        pn = __fsub_rn(pn, __fmul_rn(__fmul_rn(lr, hp.wd), pi));
    }
    p[i] = pn;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). `table` is a
// device int64 [n_chunks, 5] table as above, `scal` a device float32 [4].
// Launches on `stream`, allocates nothing and does not synchronize.
extern "C" int fused_update(const void* table, int n_chunks, const void* scal,
                            int kind, int nesterov, int has_clip, float mu,
                            float b1, float one_minus_b1, float b2,
                            float one_minus_b2, float eps, float wd,
                            void* stream) {
  if (n_chunks < 1 || kind < kSgd || kind > kAdamW)
    return (int)cudaErrorInvalidValue;
  const Hyper hp{kind, nesterov, has_clip, mu, b1, one_minus_b1,
                 b2, one_minus_b2, eps, wd};
  fused_update_kernel<<<n_chunks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), static_cast<const float*>(scal),
      hp);
  return (int)cudaGetLastError();
}
