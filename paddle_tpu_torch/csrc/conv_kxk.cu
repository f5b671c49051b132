// KxK convolution as an implicit GEMM, forward, dx and dw, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes by
// paddle_tpu_torch/kernels/conv_fused.py.
//
// Replaces the Pallas kernels of paddle_tpu/kernels/conv_fused.py:
//   conv_kxk_fwd  <- _convkxk    (pallas_call at :241)
//   conv_kxk_dx   <- _convkxk_dx (pallas_call at :425)
//   conv_kxk_dw   <- _convkxk_dw (pallas_call at :506)
//
// x is NHWC [N, H, W, C]; the output (and the cotangent g) is
// [N, OH, OW, O] with OH = (H + ph0 + ph1 - (KH-1)*dh - 1) / sh + 1. The
// caller passes the weight as a [K, N_gemm] matrix: [KH, KW, C, O] for the
// forward, [KH, KW, O, C] for dx. Sums are float32.
//
//   fwd: out[n,oh,ow,o] = epilogue(sum_{kh,kw,c} x[n, oh*sh-ph0+kh*dh,
//        ow*sw-pw0+kw*dw, c] * w[kh,kw,c,o]); M = N*OH*OW, K = KH*KW*C.
//   dx:  dx[n,h,w,c] = sum_{kh,kw,o} dy[n,oh,ow,o] * w[kh,kw,o,c] over the
//        (oh, ow) with oh*sh - ph0 + kh*dh = h (same for w); M = N*H*W,
//        K = KH*KW*O. dy = fold(g): relu mask from the saved output, then
//        the per-channel scale, rounded to g's type.
//   dw:  dw[kh,kw,c,o] = sum_{n,oh,ow} x[n, oh*sh-ph0+kh*dh, ...] *
//        dy[n,oh,ow,o]; M = KH*KW*C, K = N*OH*OW (split over blocks), in the
//        output type the caller gives (the weight's).
//
// The TPU kernels pad x (and dilate and pad g for dx) in HBM and walk one
// padded row per grid step. Here the loaders index the unpadded tensors:
// a tap that falls in the padding, or (dx) between two strided outputs,
// reads 0. The dx of a stride-2 conv asks (h + ph0 - kh*dh) to be a
// multiple of the stride; nothing is flipped, since the tap index is used
// as it is. The numbers are those of the padded formulation.
//
// What bounds it on the H100: float32 FMAs on the SIMT units (igemm.cuh).

#include "igemm.cuh"

namespace {

struct Geo {
  int n, h, w, c, o, kh, kw, oh, ow, sh, sw, ph, pw, dh, dw;
};

// Forward A: row m = (n, oh, ow) of the implicit im2col matrix, column
// k = (kh, kw, c); contiguous along c.
template <typename T>
struct XRows {
  static constexpr bool K_CONTIG = true;
  const T* x;
  Geo g;
  int M;
  struct Fixed { long long base; int ih0, iw0; };
  struct Var { int offh, offw, c; };
  __device__ __forceinline__ Fixed fixed(int m) const {
    if (m >= M) return {0, igemm::FAR, igemm::FAR};
    const int hw = g.oh * g.ow;
    const int n = m / hw, r = m - n * hw, y = r / g.ow, xx = r - y * g.ow;
    return {static_cast<long long>(n) * g.h * g.w * g.c, y * g.sh - g.ph,
            xx * g.sw - g.pw};
  }
  __device__ __forceinline__ Var var(int k, int ke) const {
    if (k >= ke) return {0, 0, -1};
    const int tap = k / g.c, c = k - tap * g.c, ky = tap / g.kw;
    return {ky * g.dh, (tap - ky * g.kw) * g.dw, c};
  }
  __device__ __forceinline__ float load(const Fixed& f, const Var& v) const {
    const int ih = f.ih0 + v.offh, iw = f.iw0 + v.offw;
    if (v.c < 0 || ih < 0 || ih >= g.h || iw < 0 || iw >= g.w) return 0.f;
    return igemm::to_f(
        x[f.base + (static_cast<long long>(ih) * g.w + iw) * g.c + v.c]);
  }
};

// dx A: row m = (n, h, w) of dx, column k = (kh, kw, o); the folded
// cotangent at the output position that tap (kh, kw) of (h, w) came from.
template <typename T>
struct DyRows {
  static constexpr bool K_CONTIG = true;
  const T* gr;
  igemm::Fold fold;
  Geo g;
  int M;
  struct Fixed { long long base; int h, w; };
  struct Var { int offh, offw, o; };
  __device__ __forceinline__ Fixed fixed(int m) const {
    if (m >= M) return {0, igemm::FAR, igemm::FAR};
    const int hw = g.h * g.w;
    const int n = m / hw, r = m - n * hw, y = r / g.w;
    return {static_cast<long long>(n) * g.oh * g.ow, y, r - y * g.w};
  }
  __device__ __forceinline__ Var var(int k, int ke) const {
    if (k >= ke) return {0, 0, -1};
    const int tap = k / g.o, o = k - tap * g.o, ky = tap / g.kw;
    return {g.ph - ky * g.dh, g.pw - (tap - ky * g.kw) * g.dw, o};
  }
  __device__ __forceinline__ float load(const Fixed& f, const Var& v) const {
    const int th = f.h + v.offh, tw = f.w + v.offw;
    if (v.o < 0 || th < 0 || tw < 0) return 0.f;
    const int oy = th / g.sh, ox = tw / g.sw;
    if (oy * g.sh != th || ox * g.sw != tw || oy >= g.oh || ox >= g.ow)
      return 0.f;
    const long long i =
        (f.base + static_cast<long long>(oy) * g.ow + ox) * g.o + v.o;
    const float x = igemm::to_f(gr[i]);
    return fold.active() ? fold.apply<T>(x, i, v.o) : x;
  }
};

// dw A (stored transposed): row m = (kh, kw, c), column k = (n, oh, ow);
// contiguous along c, so neighbouring threads take neighbouring rows.
template <typename T>
struct XCols {
  static constexpr bool K_CONTIG = false;
  const T* x;
  Geo g;
  int M;
  struct Fixed { int offh, offw, c; };
  struct Var { long long base; int ih0, iw0; };
  __device__ __forceinline__ Fixed fixed(int m) const {
    if (m >= M) return {0, 0, -1};
    const int tap = m / g.c, c = m - tap * g.c, ky = tap / g.kw;
    return {ky * g.dh, (tap - ky * g.kw) * g.dw, c};
  }
  __device__ __forceinline__ Var var(int k, int ke) const {
    if (k >= ke) return {0, igemm::FAR, igemm::FAR};
    const int hw = g.oh * g.ow;
    const int n = k / hw, r = k - n * hw, y = r / g.ow, xx = r - y * g.ow;
    return {static_cast<long long>(n) * g.h * g.w * g.c, y * g.sh - g.ph,
            xx * g.sw - g.pw};
  }
  __device__ __forceinline__ float load(const Fixed& f, const Var& v) const {
    const int ih = v.ih0 + f.offh, iw = v.iw0 + f.offw;
    if (f.c < 0 || ih < 0 || ih >= g.h || iw < 0 || iw >= g.w) return 0.f;
    return igemm::to_f(
        x[v.base + (static_cast<long long>(ih) * g.w + iw) * g.c + f.c]);
  }
};

Geo geo_from(const int* v) {
  return {v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7],
          v[8], v[9], v[10], v[11], v[12], v[13], v[14]};
}

igemm::Epilogue plain_out(void* out, int out_dt, int ldo) {
  return {nullptr, nullptr, nullptr, out, 0, out_dt, 0, ldo};
}

template <typename T>
int fwd(const void* x, const void* w, const igemm::Epilogue& ep, const Geo& g,
        cudaStream_t s) {
  const int M = g.n * g.oh * g.ow, K = g.kh * g.kw * g.c;
  XRows<T> la{static_cast<const T*>(x), g, M};
  igemm::DenseB<T> lb{static_cast<const T*>(w), {nullptr, nullptr, 0}, g.o};
  return igemm::launch(la, lb, ep, M, g.o, K, 1, K, nullptr, s);
}

template <typename T>
int dx(const void* gr, const igemm::Fold& fold, const void* w, void* out,
       int out_dt, const Geo& g, cudaStream_t s) {
  const int M = g.n * g.h * g.w, K = g.kh * g.kw * g.o;
  DyRows<T> la{static_cast<const T*>(gr), fold, g, M};
  igemm::DenseB<T> lb{static_cast<const T*>(w), {nullptr, nullptr, 0}, g.c};
  return igemm::launch(la, lb, plain_out(out, out_dt, g.c), M, g.c, K, 1, K,
                       nullptr, s);
}

template <typename T>
int dw(const void* x, const void* gr, const igemm::Fold& fold, void* out,
       int out_dt, const Geo& g, int splits, int k_per_split, float* ws,
       cudaStream_t s) {
  const int M = g.kh * g.kw * g.c, K = g.n * g.oh * g.ow;
  XCols<T> la{static_cast<const T*>(x), g, M};
  igemm::DenseB<T> lb{static_cast<const T*>(gr), fold, g.o};
  return igemm::launch(la, lb, plain_out(out, out_dt, g.o), M, g.o, K, splits,
                       k_per_split, ws, s);
}

}  // namespace

// geo: 15 ints (n, h, w, c, o, kh, kw, oh, ow, sh, sw, ph0, pw0, dh, dw).
extern "C" int conv_kxk_fwd(const void* x, const void* w, void* out,
                            const float* scale, const float* bias,
                            const void* residual, int res_dt, int relu,
                            const int* geo, int in_dt, int out_dt,
                            void* stream) {
  const Geo g = geo_from(geo);
  const igemm::Epilogue ep{scale, bias, residual, out, res_dt, out_dt, relu,
                           g.o};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dt == igemm::BF16) return fwd<__nv_bfloat16>(x, w, ep, g, s);
  return fwd<float>(x, w, ep, g, s);
}

extern "C" int conv_kxk_dx(const void* gr, const void* mask,
                           const float* scale, int mask_dt, const void* w,
                           void* out, const int* geo, int in_dt, int out_dt,
                           void* stream) {
  const Geo g = geo_from(geo);
  const igemm::Fold fold{mask, scale, mask_dt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dt == igemm::BF16)
    return dx<__nv_bfloat16>(gr, fold, w, out, out_dt, g, s);
  return dx<float>(gr, fold, w, out, out_dt, g, s);
}

extern "C" int conv_kxk_dw(const void* x, const void* gr, const void* mask,
                           const float* scale, int mask_dt, void* out,
                           float* workspace, const int* geo, int in_dt,
                           int out_dt, int splits, int k_per_split,
                           void* stream) {
  const Geo g = geo_from(geo);
  const igemm::Fold fold{mask, scale, mask_dt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dt == igemm::BF16)
    return dw<__nv_bfloat16>(x, gr, fold, out, out_dt, g, splits, k_per_split,
                             workspace, s);
  return dw<float>(x, gr, fold, out, out_dt, g, splits, k_per_split,
                   workspace, s);
}
