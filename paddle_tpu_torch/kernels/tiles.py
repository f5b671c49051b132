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

On CUDA tensors it launches one of three kernels (each replaces the Pallas
kernel at ``tiles.py:359``), chosen by the pure rule ``gemm_route``:
- ``"tc_fwd"``: ``csrc/conv_kxk_fwd_tc.cu`` (wgmma), the tensor-core 3x3
  forward, at the geometry of a 1x1, stride-1, unpadded conv
  (``gemm_geometry``), for mode "nn" without a fold: its epilogue is this
  function's chain;
- ``"tc_dw"``: ``csrc/conv_kxk_dw_tc.cu`` (wgmma, K split by
  ``split_k_tc``), the tensor-core 3x3 weight gradient at a 1x1 geometry,
  for mode "tn" without an epilogue, with no fold or the fold on b (that
  kernel's fold of g);
- ``"simt"``: ``csrc/brgemm.cu`` (float32 FMAs; in mode "tn" ``split_k``
  spreads a long K over blocks) for the rest.
``brgemm_launch`` launches the one it is named, or raises: no route gives
way to another. ``brgemm_cuda`` counts each launch in ``brgemm.launches``
and in ``brgemm_cuda.tc_fwd_launches``, ``.tc_dw_launches`` or
``.simt_launches``. On CPU tensors the plain version ``brgemm_reference``
runs. The JAX function's autotuner memo (``tiles.autotune``) is not
ported.

The ctypes loaders of the two tensor-core conv kernels and the rule the
three tensor-core routes share (``tc_fits``) live here; ``conv_fused``,
which imports this module, uses them for its 3x3 routes too.
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


# -- the loaders -----------------------------------------------------------------

# the C entries of the conv kernels (csrc/conv_kxk.cu's SIMT forward and
# weight gradient take the same arguments as their tensor-core twins)
FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + \
    [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
DW_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] + \
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# the tensor-core forward's second entry, a dx by phases
DX_PHASE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + \
    [ctypes.c_void_p]


def _load(name, argtypes, **more):
    """``csrc/<name>.cu``'s library, its entry ``name`` declared (and
    each entry of ``more``: {entry: argtypes})."""
    from paddle_tpu_torch.core import native_build
    lib = native_build.load(name)
    if not getattr(lib, "_argtypes_set", False):
        for entry, types in ((name, argtypes), *more.items()):
            fn = getattr(lib, entry)
            fn.argtypes = types
            fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _load("brgemm", [p, p, p, p, p, p, i, i, p, p, p, i, i, i, i, i,
                            i, i, i, i, i, p])


def fwd_tc_lib():
    """``csrc/conv_kxk_fwd_tc.cu`` (the tensor-core conv forward, and the
    strided dx by phases on it)."""
    return _load("conv_kxk_fwd_tc", FWD_ARGTYPES,
                 conv_kxk_dx_phase_tc=DX_PHASE_ARGTYPES)


def dw_tc_lib():
    """``csrc/conv_kxk_dw_tc.cu`` (the tensor-core conv weight gradient)."""
    return _load("conv_kxk_dw_tc", DW_ARGTYPES)


def geo_arg(geo):
    """The 15 ints of a conv kernel's Geo as a C array."""
    return (ctypes.c_int * 15)(*geo)


def raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


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


# -- the routes ------------------------------------------------------------------


def tc_fits(dtype, m, n, aligned):
    """The rule of every tensor-core conv route (``gemm_route`` here,
    ``conv_fused.kxk_fwd_route``, ``dw_route`` and ``dx_route``): bfloat16
    operands (``dtype``: theirs, None when they differ), both widths
    multiples of 64, 16-byte aligned bases (``aligned``). Float32 never
    fits: no tensor-core input type meets its gates (1e-5 forward, 1e-4
    backward)."""
    return dtype == torch.bfloat16 and m % 64 == 0 and n % 64 == 0 and \
        bool(aligned)


def gemm_route(mode, fold, epilogue, dtype, m_or_k, n, aligned):
    """The kernel a CUDA ``brgemm`` call takes, by a fixed rule:
    ``"tc_fwd"`` for mode "nn" with no fold where ``tc_fits`` takes (K,
    N); ``"tc_dw"`` for mode "tn" with no epilogue and no fold or the fold
    on b where ``tc_fits`` takes (M, N); ``"simt"`` for everything else.
    ``fold``: the operand an active fold is on ("a" or "b"; None when
    neither a mask nor a scale is given); ``epilogue``: whether a scale, a
    bias, a residual or the relu is given; ``dtype``: that of a, b and the
    fold's mask, None when they differ; ``m_or_k``: K in mode "nn", M in
    mode "tn"; ``aligned``: a, b and the mask at 16-byte aligned bases."""
    if mode == "nn" and fold is None and tc_fits(dtype, m_or_k, n, aligned):
        return "tc_fwd"
    if mode == "tn" and fold in (None, "b") and not epilogue and \
            tc_fits(dtype, m_or_k, n, aligned):
        return "tc_dw"
    return "simt"


def gemm_geometry(mode, m, n, k):
    """The Geo (15 ints: n, h, w, c, o, kh, kw, oh, ow, sh, sw, ph0, pw0,
    dh, dw) of the 1x1, stride-1, unpadded conv that is this GEMM. Mode
    "nn": the forward of x [M, 1, 1, K] (a) with the weight [1, 1, K, N]
    (b) laid out [KH, KW, C, O]. Mode "tn": the weight gradient of x [K,
    1, 1, M] (a) against the cotangent [K, 1, 1, N] (b), whose [1, 1, M,
    N] output is the GEMM's."""
    if mode == "nn":
        return (m, 1, 1, k, n, 1, 1, 1, 1, 1, 1, 0, 0, 1, 1)
    if mode == "tn":
        return (k, 1, 1, m, n, 1, 1, 1, 1, 1, 1, 0, 0, 1, 1)
    raise ValueError(f"mode must be 'nn' or 'tn', not {mode!r}")


def _facts(a, b, fold_on, fold_mask, fold_scale, scale, bias, residual,
           relu):
    """What ``gemm_route`` reads of a call beside its mode and widths:
    (the operand an active fold is on or None, whether a scale, a bias, a
    residual or the relu is given, the dtype of a, b and the fold's mask or
    None when they differ, whether those are at 16-byte aligned bases)."""
    fold = fold_on if fold_mask is not None or fold_scale is not None \
        else None
    epilogue = scale is not None or bias is not None or \
        residual is not None or bool(relu)
    operands = (a, b) if fold_mask is None else (a, b, fold_mask)
    dtype = a.dtype if all(t.dtype == a.dtype for t in operands) else None
    return fold, epilogue, dtype, all(t.data_ptr() % 16 == 0
                                      for t in operands)


def _dims(a, b, mode):
    if mode == "nn":
        (m, k), (k2, n) = a.shape, b.shape
    elif mode == "tn":
        (k, m), (k2, n) = a.shape, b.shape
    else:
        raise ValueError(f"mode must be 'nn' or 'tn', not {mode!r}")
    if k != k2:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not "
                         f"contract in mode {mode!r}")
    return m, n, k


def brgemm_launch(route, a, b, mode="nn", out_dtype=None, scale=None,
                  bias=None, residual=None, relu=False, fold_on="a",
                  fold_mask=None, fold_scale=None, facts=None):
    """Launch the kernel of ``route`` (``"tc_fwd"``, ``"tc_dw"`` or
    ``"simt"``) on the inputs ``brgemm_cuda`` takes; count nothing. Raises
    on what the kernel does not take and on a launch error: a tensor-core
    route refuses another mode, a fold or an epilogue it does not compute
    and other types in Python, and its C entry (which then computes
    nothing) widths that are not multiples of 64 and misaligned bases.
    ``facts``: this call's ``_facts``, where the caller has them."""
    m, n, k = _dims(a, b, mode)
    dev = a.device
    kinds = tuple(DTYPE_CODES)
    check_operand("a", a, a.shape, kinds, dev)
    check_operand("b", b, b.shape, (a.dtype,), dev)
    out_dtype = a.dtype if out_dtype is None else out_dtype
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype} is not float32/bfloat16")
    if fold_on not in ("a", "b"):
        raise ValueError(f"fold_on must be 'a' or 'b', not {fold_on!r}")
    folded = a if fold_on == "a" else b
    for name, t, shape, dts in (
            ("scale", scale, (n,), (torch.float32,)),
            ("bias", bias, (n,), (torch.float32,)),
            ("residual", residual, (m, n), kinds),
            ("fold_mask", fold_mask, folded.shape, kinds),
            ("fold_scale", fold_scale, folded.shape[-1:], (torch.float32,))):
        if t is not None:
            check_operand(name, t, shape, dts, dev)
    fold, epilogue, dtype, _ = facts or _facts(
        a, b, fold_on, fold_mask, fold_scale, scale, bias, residual, relu)
    code = DTYPE_CODES
    mask_code = code[fold_mask.dtype] if fold_mask is not None else 0
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "tc_fwd" and (mode, fold) != ("nn", None):
        raise ValueError(f"brgemm route 'tc_fwd' computes mode 'nn' without "
                         f"a fold, not mode {mode!r} with fold {fold!r}")
    if route == "tc_dw" and (mode != "tn" or fold == "a" or epilogue):
        raise ValueError(f"brgemm route 'tc_dw' computes mode 'tn' with no "
                         f"fold on a and no epilogue, not mode {mode!r} with "
                         f"fold {fold!r} and epilogue {epilogue}")
    if route in ("tc_fwd", "tc_dw") and dtype != torch.bfloat16:
        raise TypeError(f"brgemm route {route!r} takes bfloat16, not "
                        f"{a.dtype}" + ("" if fold_mask is None else
                                        f" with a {fold_mask.dtype} mask"))
    geo = geo_arg(gemm_geometry(mode, m, n, k))
    with torch.cuda.device(dev):
        if route == "tc_fwd":
            name = "conv_kxk_fwd_tc"
            err = fwd_tc_lib().conv_kxk_fwd_tc(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), ptr(scale),
                ptr(bias), ptr(residual),
                code[residual.dtype] if residual is not None else 0,
                int(relu), geo, code[a.dtype], code[out_dtype], stream)
        elif route == "tc_dw":
            name = "conv_kxk_dw_tc"
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            splits, per = split_k_tc(m, n, k, sms)
            ws = (torch.empty((splits, m, n), dtype=torch.float32,
                              device=dev) if splits > 1 else None)
            err = dw_tc_lib().conv_kxk_dw_tc(
                a.data_ptr(), b.data_ptr(), ptr(fold_mask), ptr(fold_scale),
                mask_code, out.data_ptr(), ptr(ws), geo, code[a.dtype],
                code[out_dtype], splits, per, stream)
        elif route == "simt":
            name = "brgemm"
            splits, per = split_k(m, n, k, dev) if mode == "tn" else (1, k)
            ws = (torch.empty((splits, m, n), dtype=torch.float32,
                              device=dev) if splits > 1 else None)
            err = _lib().brgemm(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), ptr(ws),
                ptr(fold_mask), ptr(fold_scale), mask_code,
                int(fold_on == "b"), ptr(scale), ptr(bias), ptr(residual),
                code[residual.dtype] if residual is not None else 0,
                int(relu), m, n, k, int(mode == "tn"), code[a.dtype],
                code[out_dtype], splits, per, stream)
        else:
            raise ValueError(f"no brgemm route {route!r}")
    raise_on(err, name)
    return out


def brgemm_cuda(a, b, mode="nn", out_dtype=None, scale=None, bias=None,
                residual=None, relu=False, fold_on="a", fold_mask=None,
                fold_scale=None):
    """Launch the kernel that ``gemm_route`` picks; arguments as
    ``brgemm_reference``. a and b: contiguous CUDA tensors of one dtype
    (float32 or bfloat16); scale/bias/fold_scale float32 vectors; residual
    [M, N] and fold_mask (the folded operand's shape) float32 or bfloat16.
    Counts the launch in ``brgemm.launches`` and in
    ``brgemm_cuda.<route>_launches``. Raises on what the kernel does not
    take and on a launch error."""
    facts = _facts(a, b, fold_on, fold_mask, fold_scale, scale, bias,
                   residual, relu)
    fold, epilogue, dtype, aligned = facts
    # a's last dim is K in mode "nn", M in mode "tn"
    route = gemm_route(mode, fold, epilogue, dtype, a.shape[-1], b.shape[-1],
                       aligned)
    out = brgemm_launch(route, a, b, mode, out_dtype, scale, bias, residual,
                        relu, fold_on, fold_mask, fold_scale,
                        facts=facts)
    brgemm.launches += 1
    setattr(brgemm_cuda, f"{route}_launches",
            getattr(brgemm_cuda, f"{route}_launches") + 1)
    return out


brgemm_cuda.tc_fwd_launches = 0
brgemm_cuda.tc_dw_launches = 0
brgemm_cuda.simt_launches = 0


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
