"""Fused NHWC max pool with an argmax-routed backward (counterpart of
``paddle_tpu/kernels/pool_fused.py``).

``max_pool2d_fused(x, pool_size, pool_stride, pool_padding)`` is an
``autograd.Function``: the forward returns the window max and saves only
its int32 argmax (not x, as ``_pool_core_fwd`` keeps only the index and a
zero-size carrier); the backward sends each cotangent to the position its
saved index names. The semantics are the JAX kernel's, not
``F.max_pool2d``'s:

- padding is ``finfo(dtype).min``; the running max is float32, starts at
  ``finfo.min`` with the index at -1, and a value replaces it only if it
  is strictly greater, in (kh, kw) scan order: the first maximum wins a
  tie, and NaN, -inf and ``finfo.min`` itself are never chosen (a window
  of nothing else gives ``finfo.min`` and index -1);
- ``idx = h * W + w`` is the flat position in the unpadded H x W plane of
  each channel;
- the backward sums float32 contributions with the input-row revisits
  ``ki`` outside and the taps ``kj`` inside, and rounds once to x's dtype.

On CUDA tensors ``pool_fwd`` and ``pool_bwd`` launch ``csrc/pool_fused.cu``
(they replace the Pallas ``_pool_fwd_impl`` and ``_pool_bwd_impl``) and
count their launches in ``pool_fwd.launches`` and ``pool_bwd.launches``; a
failed build or launch raises. The backward has two kernels, chosen by the
pure rule ``bwd_route``: ``"tile"`` (``pool_bwd_tile_kernel``: bands of dx
rows whose g and idx rows are staged once in shared memory by bulk
asynchronous copies, as ``band_rows`` and ``tile_plan`` lay them out) and
``"gather"`` (``pool_bwd_kernel``, any C and alignment), counted apart in
``pool_bwd.tile_launches`` and ``pool_bwd.gather_launches``. On CPU
tensors they take the plain versions ``pool_fwd_reference`` and
``pool_bwd_reference``: explicit PyTorch code with the same semantics
(pad, the windows stacked in scan order, the first ``argmax``, the
cotangent added back tap by tap in the kernel's order).
``max_pool2d_fused_reference`` is the same autograd function on the plain
versions, on any device.

Routing: ``ops.nn_ops.pool2d(use_pallas=None)`` takes this function for
NHWC float max pools without ``ceil_mode`` whose padding is smaller than
the window, when ``POOL_FUSED`` is on (``set_pool_fused``; the ResNet
bench sets it from ``PADDLE_TPU_POOL_FUSED``). The JAX module's
``pool_fused_scope`` has no caller in the port and is not ported.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from paddle_tpu_torch.kernels.tiles import DTYPE_CODES, check_operand

# Fused max-pool routing default, read by nn_ops.pool2d calls whose
# use_pallas is None.
POOL_FUSED = False


def set_pool_fused(on):
    """Set the process-wide default of the fused max-pool routing."""
    global POOL_FUSED
    POOL_FUSED = bool(on)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def geometry(x_shape, pool_size, pool_stride, pool_padding):
    """The 12 ints of ``csrc/pool_fused.cu``'s Geo: (n, h, w, c, oh, ow, kh,
    kw, sh, sw, ph, pw)."""
    n, h, w, c = x_shape
    kh, kw = _pair(pool_size)
    sh, sw = _pair(pool_stride if pool_stride is not None else pool_size)
    ph, pw = _pair(pool_padding)
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    return tuple(int(v) for v in (n, h, w, c, oh, ow, kh, kw, sh, sw, ph,
                                  pw))


# -- plain versions ------------------------------------------------------------


def pool_fwd_reference(x, geo):
    """Plain version of ``pool_fwd``: (out in x's dtype, int32 idx)."""
    n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw = geo
    neg = torch.finfo(x.dtype).min
    xf = x.float()
    # what the strict compare never chooses (NaN, -inf, finfo.min) is the
    # padding value here, so argmax picks a real element or finds only neg
    xf = torch.where(xf > neg, xf, torch.full((), neg, device=x.device))
    xp = F.pad(xf, (0, 0, pw, pw, ph, ph), value=neg)
    taps = torch.stack([xp[:, ki:ki + (oh - 1) * sh + 1:sh,
                           kj:kj + (ow - 1) * sw + 1:sw, :]
                        for ki in range(kh) for kj in range(kw)], dim=-1)
    arg = taps.argmax(dim=-1)                    # the first maximum
    best = taps.gather(-1, arg[..., None])[..., 0]
    oi = torch.arange(oh, device=x.device)[:, None, None]
    oj = torch.arange(ow, device=x.device)[:, None]
    pos = (oi * sh + arg // kw - ph) * w + (oj * sw + arg % kw - pw)
    idx = torch.where(best > neg, pos, -1).to(torch.int32)
    return best.to(x.dtype), idx


def pool_bwd_reference(g, idx, geo, x_dtype):
    """Plain version of ``pool_bwd``: dx [N, H, W, C] in ``x_dtype``."""
    n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw = geo
    hp, wp = h + 2 * ph, w + 2 * pw
    acc = torch.zeros(n, hp, wp, c, dtype=torch.float32, device=g.device)
    gf = g.float()
    oi = torch.arange(oh, device=g.device)[:, None, None]
    oj = torch.arange(ow, device=g.device)[:, None]
    zero = torch.zeros((), device=g.device)
    for ki in range(kh):
        for kj in range(kw):
            # a tap in the padding may alias a real position's index; its
            # sum lands in the padding, which is cut away below
            target = (oi * sh + ki - ph) * w + (oj * sw + kj - pw)
            acc[:, ki:ki + (oh - 1) * sh + 1:sh,
                kj:kj + (ow - 1) * sw + 1:sw, :] += torch.where(
                    idx == target, gf, zero)
    return acc[:, ph:ph + h, pw:pw + w, :].to(x_dtype)


# -- the kernels -----------------------------------------------------------------


def _lib():
    from paddle_tpu_torch.core import native_build
    lib = native_build.load("pool_fused")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pool_fwd.argtypes = [p, p, p, p, i, i, ctypes.c_float, p]
        lib.pool_bwd.argtypes = [p, p, p, p, i, i, p]
        lib.pool_bwd_tile.argtypes = [p, p, p, p, p, i, i, i, i, p]
        for fn in (lib.pool_fwd, lib.pool_bwd, lib.pool_bwd_tile):
            fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _vec(c, dtype, *tensors):
    """Channels a thread loads at once: 16 bytes' worth where C and every
    pointer allow it, else 1."""
    vec = 128 // torch.finfo(dtype).bits
    ok = c % vec == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    return vec if ok else 1


def pool_fwd_cuda(x, geo):
    """Launch ``pool_fwd`` on a contiguous NHWC float32/bfloat16 CUDA
    tensor; returns (out, int32 idx), both [N, OH, OW, C]."""
    n, h, w, c, oh, ow = geo[:6]
    dev = x.device
    check_operand("x", x, (n, h, w, c), tuple(DTYPE_CODES), dev)
    out = torch.empty((n, oh, ow, c), dtype=x.dtype, device=dev)
    idx = torch.empty((n, oh, ow, c), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().pool_fwd(
            x.data_ptr(), out.data_ptr(), idx.data_ptr(),
            (ctypes.c_int * 12)(*geo), DTYPE_CODES[x.dtype],
            _vec(c, x.dtype, x, out, idx), torch.finfo(x.dtype).min,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pool_fwd launch failed: cudaError_t {err}")
    pool_fwd.launches += 1
    return out, idx


# -- the backward's routes -----------------------------------------------------

# the tile kernel's dynamic shared memory: a ring of two stages of staged
# g and idx rows, sized here and only checked by the C entry, within the
# 227 KB (232448 bytes) a block can opt into on the H100 less the kernel's
# two 8-byte mbarriers in static shared memory (one block of 1024 threads
# an SM)
TILE_SMEM_BYTES = 232448 - 16
TILE_STAGES = 2
# a band grows to 6 dx rows while two stages fit: at the stem (bf16, batch
# 256; an H100 80GB HBM3 at 700 W) bands of 4, 6 and 8 rows ran 0.281,
# 0.277 and 0.282 ms a call; a taller band only trims the halo rows that
# the L2 serves, and leaves fewer bands to spread over the SMs
TILE_MAX_BAND = 6


def band_rows(x0, bx, k, s, p, out):
    """The windows along one axis (size ``k``, stride ``s``, low padding
    ``p``, ``out`` of them) that cover positions ``x0 .. x0 + bx - 1``: o
    from ceil((x0 + p - k + 1) / s) to floor((x0 + bx - 1 + p) / s),
    clamped to [0, out), as a half-open (lo, end) with end >= lo. Window o
    covers x when 0 <= x + p - o * s < k. The tile kernel stages a band's
    g and idx rows by it, and sums a dx row's and a dx column's windows by
    it (``bx`` = 1)."""
    lo = max(-(-(x0 + p - k + 1) // s), 0)
    end = min((x0 + bx - 1 + p) // s + 1, out)
    return lo, max(end, lo)


@functools.lru_cache(maxsize=256)
def tile_plan(geo, esize):
    """(bh, stage_rows, stage_bytes) of the tile kernel at ``geo`` for
    elements of ``esize`` bytes: the band height in dx rows, the most
    output rows a band stages (``band_rows``) and the bytes of a stage
    (those rows of g, then of idx), or None where one dx row's band does
    not fit a stage of the shared memory."""
    n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw = geo
    row_bytes = ow * c * (esize + 4)            # one row of g and of idx
    most = TILE_SMEM_BYTES // TILE_STAGES
    plan = None
    for bh in range(1, min(h, TILE_MAX_BAND) + 1):
        rows = max(1, max(e - lo for lo, e in (
            band_rows(h0, min(bh, h - h0), kh, sh, ph, oh)
            for h0 in range(0, h, bh))))
        if rows * row_bytes > most:
            break
        plan = (bh, rows, rows * row_bytes)
    return plan


def bwd_route(dtype, geo, aligned):
    """The backward kernel a CUDA call takes, by a fixed rule: ``"tile"``
    (``pool_bwd_tile_kernel``) for float32 or bfloat16 (``dtype``: g's and
    dx's) with C a multiple of the 16-byte vector, g, idx and dx at
    16-byte aligned bases (``aligned``) and a ``tile_plan`` at ``geo`` (a
    band's staged rows fit the shared memory); ``"gather"``
    (``pool_bwd_kernel``) for everything else."""
    if dtype not in DTYPE_CODES or not aligned:
        return "gather"
    esize = torch.finfo(dtype).bits // 8
    if geo[3] % (16 // esize) or tile_plan(tuple(geo), esize) is None:
        return "gather"
    return "tile"


@functools.lru_cache(maxsize=64)
def tile_table(geo, bh, device):
    """The tile kernel's int32 table [H / bh bands + H + W, 2] on
    ``device``: (lo, end) of ``band_rows`` for each band of an image, each
    dx row and each dx column; made once per geometry and device, and only
    read after."""
    n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw = geo
    rows = [band_rows(h0, min(bh, h - h0), kh, sh, ph, oh)
            for h0 in range(0, h, bh)]
    rows += [band_rows(r, 1, kh, sh, ph, oh) for r in range(h)]
    rows += [band_rows(q, 1, kw, sw, pw, ow) for q in range(w)]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def pool_bwd_launch(route, g, idx, geo, x_dtype):
    """Launch the backward kernel of ``route`` (``"tile"`` or ``"gather"``)
    on what ``pool_bwd_cuda`` takes; count nothing. Returns dx [N, H, W,
    C]. Raises on what the kernel does not take and on a launch error: the
    tile route refuses a geometry without a ``tile_plan``, and its C entry
    C that is not a multiple of the 16-byte vector and a misaligned base,
    before any launch."""
    n, h, w, c, oh, ow = geo[:6]
    dev = g.device
    check_operand("g", g, (n, oh, ow, c), (x_dtype,), dev)
    check_operand("idx", idx, (n, oh, ow, c), (torch.int32,), dev)
    if x_dtype not in DTYPE_CODES:
        raise TypeError(f"pool_bwd takes float32 or bfloat16, not {x_dtype}")
    if route not in ("tile", "gather"):
        raise ValueError(f"no pool backward route {route!r}")
    if route == "tile":
        plan = tile_plan(tuple(geo), g.element_size())
        if plan is None:
            raise ValueError("pool_bwd_tile: one dx row's band of g and idx "
                             "rows does not fit the shared memory")
    dx = torch.empty((n, h, w, c), dtype=x_dtype, device=dev)
    geo_arg = (ctypes.c_int * 12)(*geo)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "tile":
            bh, rows, stage_bytes = plan
            table = tile_table(tuple(geo), bh, dev)
            err = _lib().pool_bwd_tile(
                g.data_ptr(), idx.data_ptr(), dx.data_ptr(), geo_arg,
                table.data_ptr(), bh, rows, stage_bytes,
                DTYPE_CODES[x_dtype], stream)
        else:
            err = _lib().pool_bwd(
                g.data_ptr(), idx.data_ptr(), dx.data_ptr(), geo_arg,
                DTYPE_CODES[x_dtype], _vec(c, x_dtype, g, idx, dx), stream)
    if err != 0:
        name = "pool_bwd_tile" if route == "tile" else "pool_bwd"
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    return dx


def pool_bwd_cuda(g, idx, geo, x_dtype):
    """Launch the backward kernel ``bwd_route`` picks: g [N, OH, OW, C] in
    ``x_dtype`` and the saved int32 idx, contiguous CUDA tensors; returns
    dx [N, H, W, C]. Counts the launch in ``pool_bwd.launches`` and in
    ``pool_bwd.tile_launches`` or ``.gather_launches``."""
    # dx is allocated here, at an aligned base like every fresh tensor
    aligned = all(t.data_ptr() % 16 == 0 for t in (g, idx))
    route = bwd_route(x_dtype if g.dtype == x_dtype else None, geo, aligned)
    dx = pool_bwd_launch(route, g, idx, geo, x_dtype)
    pool_bwd.launches += 1
    if route == "tile":
        pool_bwd.tile_launches += 1
    else:
        pool_bwd.gather_launches += 1
    return dx


def pool_fwd(x, geo):
    """The forward kernel on CUDA tensors, its plain version on CPU ones."""
    fn = pool_fwd_cuda if x.device.type == "cuda" else pool_fwd_reference
    return fn(x, geo)


def pool_bwd(g, idx, geo, x_dtype):
    fn = pool_bwd_cuda if g.device.type == "cuda" else pool_bwd_reference
    return fn(g, idx, geo, x_dtype)


pool_fwd.launches = 0
pool_bwd.launches = 0
pool_bwd.tile_launches = 0
pool_bwd.gather_launches = 0


class _MaxPool2dFused(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, geo, plain):
        out, idx = (pool_fwd_reference if plain else pool_fwd)(x, geo)
        ctx.save_for_backward(idx)
        ctx.cfg = (geo, x.dtype, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        geo, dtype, plain = ctx.cfg
        dx = (pool_bwd_reference if plain else pool_bwd)(
            g.to(dtype).contiguous(), idx, geo, dtype)
        return dx, None, None


def _apply(x, pool_size, pool_stride, pool_padding, plain):
    if x.dim() != 4 or not x.is_floating_point():
        raise ValueError(f"max_pool2d_fused takes a float NHWC tensor, not "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    geo = geometry(x.shape, pool_size, pool_stride, pool_padding)
    kh, kw, ph, pw = geo[6], geo[7], geo[10], geo[11]
    if not (ph < kh and pw < kw):
        raise ValueError("padding must be smaller than the window")
    return _MaxPool2dFused.apply(x.contiguous(), geo, plain)


def max_pool2d_fused(x, pool_size=2, pool_stride=None, pool_padding=0):
    """NHWC max pool through the fused forward and backward: the kernels on
    CUDA tensors, their plain versions on CPU tensors. Symmetric padding,
    smaller than the window; no ceil_mode."""
    return _apply(x, pool_size, pool_stride, pool_padding, plain=False)


def max_pool2d_fused_reference(x, pool_size=2, pool_stride=None,
                               pool_padding=0):
    """``max_pool2d_fused`` through the plain versions on any device."""
    return _apply(x, pool_size, pool_stride, pool_padding, plain=True)
