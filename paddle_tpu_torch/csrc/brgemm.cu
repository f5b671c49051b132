// Blocked GEMM with an input fold and a fused epilogue, for Hopper (sm_90a),
// with a plain C interface loaded through ctypes by
// paddle_tpu_torch/kernels/tiles.py.
//
// Replaces: the Pallas kernel built by tiles.brgemm (paddle_tpu/kernels/
// tiles.py, pallas_call at :359), which runs the 1x1 convs of
// paddle_tpu/kernels/conv_fused.py: the forward (_conv1x1, mode "nn"), dx
// (_conv1x1_dx, "nn", fold on a) and dw (_conv1x1_dw, "tn", fold on b).
//
//   mode "nn": out[M, N] = fold(a)[M, K] . b[K, N]
//   mode "tn": out[M, N] = a[K, M]^T . fold(b)[K, N]
//   out = relu(acc * scale[n] + bias[n] + residual[m, n]), each optional,
//   cast to the output type; acc is a float32 sum.
//   fold (on a or b): relu mask from the saved forward output (same layout
//   as the operand), then a per-channel scale over the operand's last dim,
//   then a rounding to the operand's type.
//
// The TPU kernel only ever saw block sizes that divide M, N and K; here
// every edge is masked in the loaders (ResNet-50 has K = N = 64, and M =
// N*OH*OW that is a multiple of no tile). The TPU autotuner's memo is not
// carried over: the tile is fixed (igemm.cuh), and a weight gradient with
// few output tiles splits K over blocks instead (the caller picks the split
// and allocates the workspace).
//
// What bounds it on the H100: at ResNet-50's shapes (K, N >= 64) the work
// is float32 FMAs on the SIMT units; see igemm.cuh.

#include "igemm.cuh"

namespace {

template <typename T>
int run(const void* a, const void* b, const igemm::Fold& fold, int fold_on_b,
        const igemm::Epilogue& ep, int M, int N, int K, int tn, int splits,
        int k_per_split, float* ws, cudaStream_t s) {
  const igemm::Fold none{nullptr, nullptr, 0};
  igemm::DenseB<T> lb{static_cast<const T*>(b), fold_on_b ? fold : none, N};
  const igemm::Fold fa = fold_on_b ? none : fold;
  if (tn) {
    igemm::DenseA<T, false> la{static_cast<const T*>(a), fa, M, K};
    return igemm::launch(la, lb, ep, M, N, K, splits, k_per_split, ws, s);
  }
  igemm::DenseA<T, true> la{static_cast<const T*>(a), fa, M, K};
  return igemm::launch(la, lb, ep, M, N, K, splits, k_per_split, ws, s);
}

}  // namespace

extern "C" int brgemm(const void* a, const void* b, void* out,
                      float* workspace, const void* fold_mask,
                      const float* fold_scale, int fold_mask_dt,
                      int fold_on_b, const float* scale, const float* bias,
                      const void* residual, int res_dt, int relu, int M,
                      int N, int K, int tn, int in_dt, int out_dt, int splits,
                      int k_per_split, void* stream) {
  const igemm::Fold fold{fold_mask, fold_scale, fold_mask_dt};
  const igemm::Epilogue ep{scale, bias, residual, out, res_dt, out_dt, relu,
                           N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dt == igemm::BF16)
    return run<__nv_bfloat16>(a, b, fold, fold_on_b, ep, M, N, K, tn, splits,
                              k_per_split, workspace, s);
  return run<float>(a, b, fold, fold_on_b, ep, M, N, K, tn, splits,
                    k_per_split, workspace, s);
}
