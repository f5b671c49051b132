"""The blocked GEMM of the 1x1 convs (counterpart of ``brgemm`` in
``paddle_tpu/kernels/tiles.py:242``).

``brgemm(a, b, mode=...)`` computes ``out[M, N] = a[M, K] @ b[K, N]``
(mode ``"nn"``) or ``a[K, M]^T @ b[K, N]`` (``"tn"``, the weight-gradient
shape) with a float32 sum, an optional cotangent fold on one operand
(``fold_on``: the relu mask from the saved forward output ``fold_mask``,
laid out as that operand, then ``fold_scale`` over its last dim, rounded to
the other operand's dtype) and the epilogue ``relu(acc * scale + bias +
residual)``, cast to ``out_dtype`` (a's dtype by default). It is what
``_conv1x1``, ``_conv1x1_dx`` and ``_conv1x1_dw`` of ``conv_fused`` call.

On CUDA tensors it launches ``csrc/brgemm.cu`` (it replaces the Pallas
kernel at ``tiles.py:359``) and counts one launch in ``brgemm.launches``;
a failed build or launch raises, nothing falls back. On CPU tensors the
plain version ``brgemm_reference`` runs. The JAX function's autotuner memo
(``tiles.autotune``) is not ported: the CUDA kernel has one tile shape and
``split_k`` spreads a long K over blocks when the output has few tiles
(``split_k_tc`` does the same for the tensor-core weight gradient of the
3x3 convs, ``csrc/conv_kxk_dw_tc.cu``).
The other tile helpers of the JAX module (``row_map``, ``flat_pack``,
``dma_pipeline``) belong to kernels not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels import epilogues as ep

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE_M, TILE_K = 128, 16        # csrc/igemm.cuh's BM and BK


def tile_n(n):
    return 64 if n <= 64 else 128


def split_k(m, n, k, device):
    """(splits, k per split) for an [m, n] output summed over k: enough
    blocks for two waves of the card's SMs, each split at least 1024 deep
    and a multiple of the kernel's K step."""
    tiles = -(-m // TILE_M) * -(-n // tile_n(n))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(-(-2 * sms // tiles), k // 1024, 256))
    per = -(-k // splits)
    per = -(-per // TILE_K) * TILE_K
    return -(-k // per), per


# csrc/conv_kxk_dw_tc.cu's M tile and K step, and the least depth of a
# split of its K
TC_TILE_M, TC_TILE_K, TC_MIN_SPLIT = 128, 64, 2048


def tc_tile_n(n):
    return 128 if n % 128 == 0 else 64


def split_k_tc(m, n, k, sms):
    """(splits, k per split) of the tensor-core weight gradient's K on a
    card with ``sms`` SMs: at least enough blocks for two waves, each split
    a multiple of the K step and at least ``TC_MIN_SPLIT`` deep (one split
    when K is shorter). From that least count up to twice it, the count
    whose blocks fill their last wave best: the fewest waves times steps a
    block, ties to fewer splits (a smaller workspace to reduce). Rounding a
    split down to the step only adds splits, so the waves hold."""
    tiles = -(-m // TC_TILE_M) * -(-n // tc_tile_n(n))
    lo = max(1, min(-(-2 * sms // tiles), k // TC_MIN_SPLIT))
    best = None
    for s in range(lo, max(lo, min(2 * lo, k // TC_MIN_SPLIT)) + 1):
        if s == 1:
            per = -(-k // TC_TILE_K) * TC_TILE_K
        else:
            per = k // s // TC_TILE_K * TC_TILE_K
        splits = -(-k // per)
        cost = -(-tiles * splits // sms) * (per // TC_TILE_K)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


def brgemm_reference(a, b, mode="nn", out_dtype=None, scale=None, bias=None,
                     residual=None, relu=False, fold_on="a", fold_mask=None,
                     fold_scale=None):
    """Plain version of the kernel: the fold, a float32 matmul, the
    epilogue, one cast."""
    if fold_mask is not None or fold_scale is not None:
        if fold_on == "a":
            a = ep.fold_cotangent(a, fold_mask, fold_scale, b.dtype)
        else:
            b = ep.fold_cotangent(b, fold_mask, fold_scale, a.dtype)
    at = a if mode == "nn" else a.t()
    acc = torch.matmul(at.float(), b.float())
    return ep.apply(acc, scale, bias, residual, relu,
                    a.dtype if out_dtype is None else out_dtype)


def _lib():
    from paddle_tpu_torch.core import native_build
    lib = native_build.load("brgemm")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.brgemm.argtypes = [p, p, p, p, p, p, i, i, p, p, p, i, i, i, i,
                               i, i, i, i, i, i, p]
        lib.brgemm.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def check_operand(name, t, shape, dtypes, device):
    """Raise unless ``t`` is a contiguous tensor of ``shape`` with a dtype
    in ``dtypes`` on the CUDA device ``device``."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor on {device}, not "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} is {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} is {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t):
    return None if t is None else t.data_ptr()


def brgemm_cuda(a, b, mode="nn", out_dtype=None, scale=None, bias=None,
                residual=None, relu=False, fold_on="a", fold_mask=None,
                fold_scale=None):
    """Launch ``csrc/brgemm.cu``; arguments as ``brgemm_reference``. a and
    b: contiguous CUDA tensors of one dtype (float32 or bfloat16);
    scale/bias/fold_scale float32 vectors; residual [M, N] and fold_mask
    (the folded operand's shape) float32 or bfloat16. Raises on what the
    kernel does not take and on a launch error."""
    if mode == "nn":
        (m, k), (k2, n) = a.shape, b.shape
    elif mode == "tn":
        (k, m), (k2, n) = a.shape, b.shape
    else:
        raise ValueError(f"mode must be 'nn' or 'tn', not {mode!r}")
    if k != k2:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not "
                         f"contract in mode {mode!r}")
    dev = a.device
    kinds = tuple(DTYPE_CODES)
    check_operand("a", a, a.shape, kinds, dev)
    check_operand("b", b, b.shape, (a.dtype,), dev)
    out_dtype = a.dtype if out_dtype is None else out_dtype
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype} is not float32/bfloat16")
    folded = a if fold_on == "a" else b
    if fold_on not in ("a", "b"):
        raise ValueError(f"fold_on must be 'a' or 'b', not {fold_on!r}")
    for name, t, shape, dts in (
            ("scale", scale, (n,), (torch.float32,)),
            ("bias", bias, (n,), (torch.float32,)),
            ("residual", residual, (m, n), kinds),
            ("fold_mask", fold_mask, folded.shape, kinds),
            ("fold_scale", fold_scale, folded.shape[-1:], (torch.float32,))):
        if t is not None:
            check_operand(name, t, shape, dts, dev)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    splits, per = split_k(m, n, k, dev) if mode == "tn" else (1, k)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    lib = _lib()
    code = DTYPE_CODES
    with torch.cuda.device(dev):
        err = lib.brgemm(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), ptr(ws),
            ptr(fold_mask), ptr(fold_scale),
            code[fold_mask.dtype] if fold_mask is not None else 0,
            int(fold_on == "b"), ptr(scale), ptr(bias), ptr(residual),
            code[residual.dtype] if residual is not None else 0, int(relu),
            m, n, k, int(mode == "tn"), code[a.dtype], code[out_dtype],
            splits, per, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"brgemm launch failed: cudaError_t {err}")
    brgemm.launches += 1
    return out


def brgemm(a, b, *, mode="nn", out_dtype=None, scale=None, bias=None,
           residual=None, relu=False, fold_on="a", fold_mask=None,
           fold_scale=None):
    """The kernel on CUDA tensors, its plain version on CPU tensors (see
    the module docstring)."""
    if a.device.type == "cuda":
        return brgemm_cuda(a, b, mode, out_dtype, scale, bias, residual,
                           relu, fold_on, fold_mask, fold_scale)
    return brgemm_reference(a, b, mode, out_dtype, scale, bias, residual,
                            relu, fold_on, fold_mask, fold_scale)


brgemm.launches = 0
