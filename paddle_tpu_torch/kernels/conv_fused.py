"""Implicit-GEMM convolution with a fused epilogue, forward and backward
(counterpart of ``paddle_tpu/kernels/conv_fused.py``).

``conv2d_bn_act(x, w, scale, bias, residual, act, stride, padding,
dilation)`` computes ``act(conv(x, w) * scale + bias [+ residual])`` with a
float32 sum and one cast to x's dtype. x is NHWC, w OIHW (groups = 1),
scale/bias per output channel, act None or "relu". It is an
``autograd.Function``; its backward computes dx and dw in kernels too,
with the cotangent fold ``dy = g * (out > 0) * scale`` applied inside them
(the saved output is kept only when act is "relu"), and the epilogue's
cotangents (dscale, dbias, dresidual) as one PyTorch reduction over g.

Routing, as in the JAX module (``_dispatch``, ``_pallas_bwd``):
- 1x1 convs without padding are ``tiles.brgemm`` calls over the flattened
  ``[N*OH*OW, C]`` activation (a strided 1x1 slices x first; its dx is
  scattered back into zeros): ``_conv1x1``, ``_conv1x1_dx``,
  ``_conv1x1_dw``. ``tiles.gemm_route`` runs the bf16 ones on the
  tensor-core 3x3 kernels below at a 1x1 geometry (mode "nn" without a
  fold on the forward's, mode "tn" on the weight gradient's) and the rest
  on ``csrc/brgemm.cu``.
- Every other conv runs ``csrc/conv_kxk.cu``: ``convkxk``, ``convkxk_dx``
  and ``convkxk_dw`` replace the Pallas ``_convkxk``, ``_convkxk_dx`` and
  ``_convkxk_dw``. Each wrapper launches its kernel on CUDA tensors (and
  counts it in its ``launches``), runs its plain version on CPU tensors,
  and raises on anything the kernel does not take.
- The forward has two kernels, chosen by the pure rule
  ``kxk_fwd_route``: ``csrc/conv_kxk_fwd_tc.cu`` (wgmma on the tensor
  cores, the epilogue from the accumulators) for bf16 x and w with C and
  O multiples of 64 at a 16-byte aligned x, and ``conv_kxk_fwd`` of
  ``csrc/conv_kxk.cu`` (float32 FMAs) for the rest, float32 among it.
  ``convkxk_launch`` launches the one it is named, or raises.
- The weight gradient has two kernels, chosen by the pure rule
  ``dw_route``: ``csrc/conv_kxk_dw_tc.cu`` (wgmma on the tensor cores)
  for bf16 with C and O multiples of 64 at 16-byte aligned bases, and
  ``conv_kxk_dw`` of ``csrc/conv_kxk.cu`` (float32 FMAs) for the rest.
  Neither gives way to the other: ``convkxk_dw_launch`` launches the one
  it is named, or raises.
- The input gradient has three routes, chosen by the pure rule
  ``dx_route``. A dx that folds nothing, for bf16 with C and O multiples
  of 64 at a 16-byte aligned g, runs on the tensor-core forward
  ``csrc/conv_kxk_fwd_tc.cu``: at stride 1 (``"tc"``) as the forward conv
  of g with the taps flipped and C and O swapped (``dx_geometry``); at a
  larger stride (``"tc_phase"``) as one such conv a phase of dx
  (``dx_phases``: dx's rows ``a + sh*i`` and columns ``b + sw*j`` from
  the taps that reach them), each writing its rows and columns of dx
  straight from its epilogue, with no zero between g's rows read. The
  rest (a fold, float32) runs ``conv_kxk_dx`` of ``csrc/conv_kxk.cu``
  (float32 FMAs). ``convkxk_dx_launch`` launches the one it is named, or
  raises.

The plain versions are the same functions in PyTorch: a float32
``F.conv2d`` (and its gradients through autograd) on the padded input, the
fold and the epilogue of ``kernels/epilogues.py``.

The JAX module's ``CONV_BWD_FUSED`` knob is not ported: the backward
always runs the kernels, and ``conv_epilogue_reference`` differentiated by
autograd is the plain version they are tested against.
``conv2d_dequant_bn_act`` and its dequant prologue are not ported.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from paddle_tpu_torch.kernels import epilogues as ep
from paddle_tpu_torch.kernels import tiles
from paddle_tpu_torch.kernels.tiles import (DTYPE_CODES, check_operand,
                                            geo_arg, ptr, raise_on)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _pad_pairs(padding):
    """int | (ph, pw) | ((ph0, ph1), (pw0, pw1)) -> the latter."""
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    p = tuple(padding)
    if len(p) == 2 and all(isinstance(q, int) for q in p):
        return ((p[0], p[0]), (p[1], p[1]))
    return (tuple(p[0]), tuple(p[1]))


def out_size(size, k, stride, pad, dilation):
    return (size + pad[0] + pad[1] - (k - 1) * dilation - 1) // stride + 1


def geometry(x_shape, w_shape, stride, padding, dilation):
    """The 15 ints of ``csrc/conv_kxk.cu``'s Geo: (n, h, w, c, o, kh, kw,
    oh, ow, sh, sw, ph0, pw0, dh, dw)."""
    n, h, wd, c = x_shape
    o, _, kh, kw = w_shape
    (sh, sw), (dh, dw) = stride, dilation
    ph, pw = padding
    return (n, h, wd, c, o, kh, kw, out_size(h, kh, sh, ph, dh),
            out_size(wd, kw, sw, pw, dw), sh, sw, ph[0], pw[0], dh, dw)


# -- plain versions ------------------------------------------------------------


def _conv_f32(x, w, stride, padding, dilation):
    """float32 conv of NHWC x with OIHW w: explicit (possibly uneven)
    padding, then ``F.conv2d``; NHWC float32 out."""
    (ph0, ph1), (pw0, pw1) = padding
    xn = F.pad(x.float().permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
    out = F.conv2d(xn, w.float(), stride=stride, dilation=dilation)
    return out.permute(0, 2, 3, 1)


def convkxk_reference(x, w, scale=None, bias=None, residual=None,
                      relu=False, stride=(1, 1), padding=((0, 0), (0, 0)),
                      dilation=(1, 1), out_dtype=None):
    """Plain version of ``conv_kxk_fwd``."""
    acc = _conv_f32(x, w, stride, padding, dilation)
    return ep.apply(acc, scale, bias, residual, relu,
                    x.dtype if out_dtype is None else out_dtype)


def convkxk_dx_reference(g, mask, scale, w, x_shape, x_dtype, stride,
                         padding, dilation):
    """Plain version of ``conv_kxk_dx``: the gradient of the float32 conv
    with respect to x for the folded cotangent, cast to ``x_dtype``."""
    dy = ep.fold_cotangent(g, mask, scale, w.dtype).float()
    with torch.enable_grad():
        xz = torch.zeros(x_shape, dtype=torch.float32, device=g.device,
                         requires_grad=True)
        out = _conv_f32(xz, w.detach(), stride, padding, dilation)
        (dx,) = torch.autograd.grad(out, xz, dy)
    return dx.to(x_dtype)


def convkxk_dw_reference(g, mask, scale, x, w_shape, w_dtype, stride,
                         padding, dilation):
    """Plain version of ``conv_kxk_dw``: the gradient of the float32 conv
    with respect to w (OIHW) for the folded cotangent, cast to
    ``w_dtype``."""
    dy = ep.fold_cotangent(g, mask, scale, x.dtype).float()
    with torch.enable_grad():
        wz = torch.zeros(w_shape, dtype=torch.float32, device=g.device,
                         requires_grad=True)
        out = _conv_f32(x.detach(), wz, stride, padding, dilation)
        (dw,) = torch.autograd.grad(out, wz, dy)
    return dw.to(w_dtype)


# -- the KxK kernels -----------------------------------------------------------


def _lib():
    from paddle_tpu_torch.core import native_build
    lib = native_build.load("conv_kxk")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv_kxk_fwd.argtypes = tiles.FWD_ARGTYPES
        lib.conv_kxk_dx.argtypes = [p, p, p, i, p, p, p, i, i, p]
        lib.conv_kxk_dw.argtypes = tiles.DW_ARGTYPES
        for fn in (lib.conv_kxk_fwd, lib.conv_kxk_dx, lib.conv_kxk_dw):
            fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


_KINDS = tuple(DTYPE_CODES)


def kxk_fwd_route(dtype, c, o, aligned):
    """The forward kernel a CUDA call takes, by a fixed rule: ``"tc"``
    (``csrc/conv_kxk_fwd_tc.cu``, wgmma) for bfloat16 x and w (``dtype``:
    theirs, None when they differ) with C and O multiples of 64 and x at a
    16-byte aligned base (``aligned``); ``"simt"`` (``conv_kxk_fwd`` of
    ``csrc/conv_kxk.cu``) for everything else: float32, whose 1e-5 gate
    no tensor-core input type meets, and other channel counts (the rule
    is ``tiles.tc_fits``)."""
    return "tc" if tiles.tc_fits(dtype, c, o, aligned) else "simt"


def convkxk_launch(route, x, w, scale=None, bias=None, residual=None,
                   relu=False, stride=(1, 1), padding=((0, 0), (0, 0)),
                   dilation=(1, 1), out_dtype=None):
    """Launch the forward kernel of ``route`` (``"tc"`` or ``"simt"``) on
    the inputs ``convkxk_cuda`` takes; count nothing. Returns NHWC out in
    ``out_dtype`` (x's). Raises on what the kernel does not take and on a
    launch error: the tensor-core kernel's C entry refuses (and computes
    nothing for) channels that are not multiples of 64 and misaligned
    bases."""
    dev = x.device
    geo = geometry(x.shape, w.shape, stride, padding, dilation)
    n, _, _, c, o, kh, kw, oh, ow = geo[:9]
    check_operand("x", x, x.shape, _KINDS, dev)
    check_operand("w", w, (o, c, kh, kw), (x.dtype,), dev)
    for name, t, shape, dts in (("scale", scale, (o,), (torch.float32,)),
                                ("bias", bias, (o,), (torch.float32,)),
                                ("residual", residual, (n, oh, ow, o),
                                 _KINDS)):
        if t is not None:
            check_operand(name, t, shape, dts, dev)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if route == "tc":
        if x.dtype != torch.bfloat16:
            raise TypeError(f"conv_kxk_fwd_tc takes bfloat16, not {x.dtype}")
        name, fn = "conv_kxk_fwd_tc", tiles.fwd_tc_lib().conv_kxk_fwd_tc
    elif route == "simt":
        name, fn = "conv_kxk_fwd", _lib().conv_kxk_fwd
    else:
        raise ValueError(f"no forward route {route!r}")
    wk = w.permute(2, 3, 1, 0).contiguous()          # [KH, KW, C, O]
    out = torch.empty((n, oh, ow, o), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), wk.data_ptr(), out.data_ptr(), ptr(scale),
                 ptr(bias), ptr(residual),
                 DTYPE_CODES[residual.dtype] if residual is not None else 0,
                 int(relu), geo_arg(geo), DTYPE_CODES[x.dtype],
                 DTYPE_CODES[out_dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, name)
    return out


def convkxk_cuda(x, w, scale=None, bias=None, residual=None, relu=False,
                 stride=(1, 1), padding=((0, 0), (0, 0)), dilation=(1, 1),
                 out_dtype=None):
    """Launch the forward kernel that ``kxk_fwd_route`` picks: x NHWC and
    w OIHW, contiguous CUDA tensors of one dtype (float32 or bfloat16);
    scale/bias float32 [O]; residual the output's shape. Returns NHWC out
    in ``out_dtype`` (x's). Counts the launch in ``convkxk.launches`` and
    in ``convkxk_cuda.tc_launches`` or ``.simt_launches``. Raises on what
    the kernel does not take and on a launch error."""
    dtype = x.dtype if w.dtype == x.dtype else None
    route = kxk_fwd_route(dtype, x.shape[-1], w.shape[0],
                          x.data_ptr() % 16 == 0)
    out = convkxk_launch(route, x, w, scale, bias, residual, relu, stride,
                         padding, dilation, out_dtype)
    convkxk.launches += 1
    if route == "tc":
        convkxk_cuda.tc_launches += 1
    else:
        convkxk_cuda.simt_launches += 1
    return out


convkxk_cuda.tc_launches = 0
convkxk_cuda.simt_launches = 0


def _fold_checks(g, mask, scale, dev, o):
    check_operand("g", g, g.shape, _KINDS, dev)
    if mask is not None:
        check_operand("mask", mask, g.shape, _KINDS, dev)
    if scale is not None:
        check_operand("scale", scale, (o,), (torch.float32,), dev)


def dx_route(dtype, c, o, aligned, stride, folded):
    """The input-gradient kernel a CUDA call takes, by a fixed rule. For
    a dx that folds nothing (``folded``: a relu mask or a scale is given)
    with bfloat16 g and w (``dtype``: theirs, None when they differ or when
    dx is to be neither float32 nor bfloat16), C and O multiples of 64 and
    g at a 16-byte aligned base (``aligned``), the tensor-core forward
    (``csrc/conv_kxk_fwd_tc.cu``, wgmma): ``"tc"`` at ``stride`` (1, 1),
    one conv at ``dx_geometry``; ``"tc_phase"`` at any larger stride, one
    conv a phase of ``dx_phases``. The forward conv a dx becomes has O
    input and C output channels, so the rule is ``tiles.tc_fits(dtype, o,
    c, aligned)``. ``"simt"`` (``conv_kxk_dx`` of ``csrc/conv_kxk.cu``)
    for everything else: a fold, which the forward kernel does not apply
    to its input; float32, whose 1e-4 backward gate no tensor-core input
    type meets; and other channel counts."""
    if folded or not tiles.tc_fits(dtype, o, c, aligned):
        return "simt"
    return "tc" if tuple(stride) == (1, 1) else "tc_phase"


def dx_geometry(x_shape, w_shape, stride, padding, dilation):
    """The Geo (15 ints, as ``geometry``) of the stride-1 forward conv
    that a dx is: g [N, OH, OW, O] with ``stride - 1`` zeros between its
    rows and its columns, as the reference pads it inside (``lax.pad``'s
    interior padding), of shape [N, (OH - 1) * sh + 1, (OW - 1) * sw + 1,
    O], as x, the weight's taps flipped with C and O swapped as w, output
    [N, H, W, C]; the low padding ``(k - 1) * d - p0`` as the reference
    pads g (a tap past either edge of g reads 0, so the high padding
    follows from the output size). The ``"tc"`` route runs it at stride
    (1, 1), where g is itself. Raises on a stride below 1."""
    if min(stride) < 1:
        raise ValueError(f"a dx takes strides of 1 or more, not "
                         f"{tuple(stride)}")
    n, h, wd, c, o, kh, kw, oh, ow, sh, sw, ph0, pw0, dh, dw = geometry(
        x_shape, w_shape, stride, padding, dilation)
    return (n, (oh - 1) * sh + 1, (ow - 1) * sw + 1, o, c, kh, kw, h, wd, 1,
            1, (kh - 1) * dh - ph0, (kw - 1) * dw - pw0, dh, dw)


class DxPhase(NamedTuple):
    """One phase of a dx (``dx_phases``): dx's rows ``a + sh * i`` and
    columns ``b + sw * j``, the taps of the conv's kernel whose products
    reach them (``taps_h``, ``taps_w``, each from the largest down: the
    order of the phase conv's taps) and the Geo (15 ints, as
    ``geometry``) of the stride-1 forward conv of g that computes them
    (``conv_kxk_dx_phase_tc``'s ``phase_geo`` derives the same)."""
    a: int
    b: int
    taps_h: Tuple[int, ...]
    taps_w: Tuple[int, ...]
    geo: Tuple[int, ...]

    @property
    def runs(self):
        """Whether the phase launches a kernel: it has taps, and dx has
        positions in it."""
        n, _, _, _, _, kh, kw, oh, ow = self.geo[:9]
        return n * kh * kw * oh * ow > 0


def _phase_axis(a, k, s, p0, d):
    """One axis of phase ``a`` of a conv of ``k`` taps at stride ``s``,
    low padding ``p0`` and dilation ``d``: (the taps t whose products reach
    dx's positions a + s * i, those with (a + p0 - t * d) divisible by s,
    from the largest down; the phase conv's low padding; its dilation).
    Tap t reads g at i + (a + p0 - t * d) / s: the offsets rise by
    d / gcd(s, d) from the largest tap down, the least is the low padding
    negated."""
    taps = tuple(t for t in range(k - 1, -1, -1) if (a + p0 - t * d) % s == 0)
    if not taps:
        return taps, 0, 1
    return taps, -((a + p0 - taps[0] * d) // s), d // math.gcd(s, d)


def dx_phases(x_shape, w_shape, stride, padding, dilation):
    """The phases of the dx of a conv (``DxPhase``, one for each (a, b)
    in [0, sh) x [0, sw), in that order): phase (a, b) is the stride-1
    forward conv of g [N, OH, OW, O] with its taps ``taps_h`` x
    ``taps_w`` of the weight, C and O swapped, at the dilation and low
    padding ``_phase_axis`` gives (a tap past either edge of g reads 0),
    output [N, ceil((H - a) / sh), ceil((W - b) / sw), C]: dx's rows a +
    sh * i and columns b + sw * j. Together they cover every position of
    dx once and every product of the dx once, and skip the products with
    the zeros the reference puts between g's rows. A phase without taps
    (3x3 at dilation 2 and stride 2 has such) computes nothing: its
    positions of dx are 0. At stride (1, 1) the one phase is
    ``dx_geometry``'s conv. Raises on a stride below 1."""
    if min(stride) < 1:
        raise ValueError(f"a dx takes strides of 1 or more, not "
                         f"{tuple(stride)}")
    n, h, wd, c, o, kh, kw, oh, ow, sh, sw, ph0, pw0, dh, dw = geometry(
        x_shape, w_shape, stride, padding, dilation)
    phases = []
    for a in range(sh):
        taps_h, pad_h, dil_h = _phase_axis(a, kh, sh, ph0, dh)
        for b in range(sw):
            taps_w, pad_w, dil_w = _phase_axis(b, kw, sw, pw0, dw)
            phases.append(DxPhase(a, b, taps_h, taps_w, (
                n, oh, ow, o, c, len(taps_h), len(taps_w), -(-(h - a) // sh),
                -(-(wd - b) // sw), 1, 1, pad_h, pad_w, dil_h, dil_w)))
    return tuple(phases)


@functools.lru_cache(maxsize=64)
def _tap_index(taps, device):
    """(rows, columns): index tensors on ``device`` of the (kh, kw) pairs
    ``taps``, made once a device and set of taps (a copy from the host to
    a card waits for the work queued on the card)."""
    return tuple(torch.tensor([t[i] for t in taps], dtype=torch.long,
                              device=device) for i in (0, 1))


def phase_weights(w, plan):
    """The weights of ``plan``'s phase convs (``DxPhase``s) from w
    (OIHW): each phase's taps ``taps_h`` x ``taps_w`` laid out [T_h, T_w,
    O, C] (the forward kernel's [KH, KW, C, O] for a conv of O input and C
    output channels), one after the other in one contiguous tensor, as
    ``conv_kxk_dx_phase_tc`` reads them."""
    rows, cols = _tap_index(tuple((th, tw) for p in plan for th in p.taps_h
                                  for tw in p.taps_w), w.device)
    return w.permute(2, 3, 0, 1)[rows, cols]


def _dx_facts(g, mask, scale, w, x_dtype):
    """What ``dx_route`` reads of a call beside its widths and stride:
    (whether a mask or a scale is folded, the dtype of g and w or None
    when they differ or when dx is to be neither float32 nor bfloat16,
    whether g is at a 16-byte aligned base)."""
    dtype = g.dtype if w.dtype == g.dtype and x_dtype in DTYPE_CODES \
        else None
    return mask is not None or scale is not None, dtype, \
        g.data_ptr() % 16 == 0


def convkxk_dx_launch(route, g, mask, scale, w, x_shape, x_dtype, stride,
                      padding, dilation, facts=None):
    """Launch the input-gradient kernel of ``route`` (``"tc"``,
    ``"tc_phase"`` or ``"simt"``) on the inputs ``convkxk_dx_cuda`` takes;
    count nothing. Returns dx [N, H, W, C] in ``x_dtype``. Raises on what
    the kernel does not take and on a launch error: the tensor-core routes
    refuse a fold and operands other than bfloat16 before any launch, at
    every stride, and their C entries (which then compute nothing)
    channels that are not multiples of 64 and a misaligned g. ``"tc"``
    takes stride (1, 1) alone; ``"tc_phase"`` runs the phases of
    ``dx_phases`` that have taps, in one call of its C entry, and
    zero-fills dx first where a phase has none. ``facts``: this call's
    ``_dx_facts``, where the caller has them."""
    if route not in ("tc", "tc_phase", "simt"):
        raise ValueError(f"no input-gradient route {route!r}")
    if route == "tc" and tuple(stride) != (1, 1):
        raise ValueError(f"the tc dx takes stride (1, 1), not "
                         f"{tuple(stride)}: a larger stride runs by phases "
                         f"(tc_phase)")
    dev = g.device
    geo = geometry(x_shape, w.shape, stride, padding, dilation)
    n, h, wd, c, o, kh, kw, oh, ow = geo[:9]
    if tuple(g.shape) != (n, oh, ow, o):
        raise ValueError(f"g is {tuple(g.shape)}, expected "
                         f"{(n, oh, ow, o)}")
    _fold_checks(g, mask, scale, dev, o)
    check_operand("w", w, w.shape, (g.dtype,), dev)
    if x_dtype not in DTYPE_CODES:
        raise TypeError(f"x_dtype {x_dtype} is not float32/bfloat16")
    folded, dtype, _ = facts or _dx_facts(g, mask, scale, w, x_dtype)
    if route != "simt":
        if folded:
            raise ValueError("conv_kxk_fwd_tc computes a dx that folds "
                             "nothing, not one with a mask or a scale")
        if dtype != torch.bfloat16:
            raise TypeError(f"conv_kxk_fwd_tc takes bfloat16, not {g.dtype}")
    zeroed = False
    if route == "tc":
        geo = dx_geometry(x_shape, w.shape, stride, padding, dilation)
        # [KH, KW, O, C] with the taps flipped: the forward's [KH, KW, C, O]
        # for a conv of O input and C output channels
        wk = w.flip(2, 3).permute(2, 3, 0, 1).contiguous()
    elif route == "tc_phase":
        phases = dx_phases(x_shape, w.shape, stride, padding, dilation)
        plan = [p for p in phases if p.runs]
        wk = phase_weights(w, plan)
        zeroed = any(p.geo[7] * p.geo[8] and not p.runs for p in phases)
    else:
        wk = w.permute(2, 3, 0, 1).contiguous()      # [KH, KW, O, C]
    dx = (torch.zeros if zeroed else torch.empty)(x_shape, dtype=x_dtype,
                                                  device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if route == "tc_phase":
            name = "conv_kxk_dx_phase_tc"
            err = tiles.fwd_tc_lib().conv_kxk_dx_phase_tc(
                g.data_ptr(), wk.data_ptr(), dx.data_ptr(), geo_arg(geo),
                DTYPE_CODES[g.dtype], DTYPE_CODES[x_dtype], stream)
        elif route == "tc":
            name = "conv_kxk_fwd_tc"
            err = tiles.fwd_tc_lib().conv_kxk_fwd_tc(
                g.data_ptr(), wk.data_ptr(), dx.data_ptr(), None, None, None,
                0, 0, geo_arg(geo), DTYPE_CODES[g.dtype],
                DTYPE_CODES[x_dtype], stream)
        else:
            name = "conv_kxk_dx"
            err = _lib().conv_kxk_dx(
                g.data_ptr(), ptr(mask), ptr(scale),
                DTYPE_CODES[mask.dtype] if mask is not None else 0,
                wk.data_ptr(), dx.data_ptr(), geo_arg(geo),
                DTYPE_CODES[g.dtype], DTYPE_CODES[x_dtype], stream)
    raise_on(err, name)
    return dx


def convkxk_dx_cuda(g, mask, scale, w, x_shape, x_dtype, stride, padding,
                    dilation):
    """Launch the input-gradient kernel that ``dx_route`` picks: g (and
    the saved output ``mask``) NHWC [N, OH, OW, O] in w's dtype, scale
    float32 [O] or None. Returns dx [N, H, W, C] in ``x_dtype``. Counts
    the call in ``convkxk_dx.launches`` and in
    ``convkxk_dx_cuda.<route>_launches`` (``tc_launches``,
    ``tc_phase_launches`` or ``simt_launches``; one a call, whatever
    number of phases the phase route runs). Raises on what the kernel does
    not take and on a launch error."""
    facts = _dx_facts(g, mask, scale, w, x_dtype)
    folded, dtype, aligned = facts
    route = dx_route(dtype, w.shape[1], w.shape[0], aligned, stride, folded)
    dx = convkxk_dx_launch(route, g, mask, scale, w, x_shape, x_dtype,
                           stride, padding, dilation, facts=facts)
    convkxk_dx.launches += 1
    setattr(convkxk_dx_cuda, f"{route}_launches",
            getattr(convkxk_dx_cuda, f"{route}_launches") + 1)
    return dx


convkxk_dx_cuda.tc_launches = 0
convkxk_dx_cuda.tc_phase_launches = 0
convkxk_dx_cuda.simt_launches = 0


def dw_route(dtype, c, o, aligned):
    """The weight-gradient kernel a CUDA call takes, by a fixed rule:
    ``"tc"`` (``csrc/conv_kxk_dw_tc.cu``, wgmma) for bfloat16 operands
    (``dtype``: that of x, g and the saved output, None when they differ)
    with C and O multiples of 64 and x, g and the saved output at 16-byte
    aligned bases (``aligned``); ``"simt"`` (``conv_kxk_dw`` of
    ``csrc/conv_kxk.cu``) for everything else: float32, whose 1e-4 gate
    no tensor-core input type meets, and other channel counts (the rule
    is ``tiles.tc_fits``)."""
    return "tc" if tiles.tc_fits(dtype, c, o, aligned) else "simt"


def _cover_k(k, splits, step):
    """(splits, k per split) for ``splits`` asked-for splits of k in
    multiples of ``step``."""
    per = -(-k // splits)
    per = -(-per // step) * step
    return -(-k // per), per


def convkxk_dw_launch(route, g, mask, scale, x, w_shape, w_dtype, stride,
                      padding, dilation, splits=None):
    """Launch the weight-gradient kernel of ``route`` (``"tc"`` or
    ``"simt"``) on the inputs ``convkxk_dw_cuda`` takes; count nothing.
    ``splits`` forces the number of K splits (default: the route's rule,
    ``tiles.split_k_tc`` or ``tiles.split_k``). Returns dw OIHW in
    ``w_dtype``. Raises on what the kernel does not take and on a launch
    error: the tensor-core kernel's C entry refuses (and computes nothing
    for) channels that are not multiples of 64 and misaligned bases."""
    dev = x.device
    geo = geometry(x.shape, w_shape, stride, padding, dilation)
    n, h, wd, c, o, kh, kw, oh, ow = geo[:9]
    check_operand("x", x, x.shape, _KINDS, dev)
    if tuple(g.shape) != (n, oh, ow, o) or g.dtype != x.dtype:
        raise ValueError(f"g is {tuple(g.shape)} {g.dtype}, expected "
                         f"{(n, oh, ow, o)} {x.dtype}")
    _fold_checks(g, mask, scale, dev, o)
    m, k = kh * kw * c, n * oh * ow
    if route == "tc":
        if x.dtype != torch.bfloat16 or (mask is not None and
                                         mask.dtype != torch.bfloat16):
            raise TypeError(f"conv_kxk_dw_tc takes bfloat16, not {x.dtype}"
                            + ("" if mask is None else
                               f" with a {mask.dtype} mask"))
        name, fn = "conv_kxk_dw_tc", tiles.dw_tc_lib().conv_kxk_dw_tc
        if splits is None:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            splits, per = tiles.split_k_tc(m, o, k, sms)
        else:
            splits, per = _cover_k(k, splits, tiles.TC_TILE_K)
    elif route == "simt":
        name, fn = "conv_kxk_dw", _lib().conv_kxk_dw
        if splits is None:
            splits, per = tiles.split_k(m, o, k, dev)
        else:
            splits, per = _cover_k(k, splits, tiles.TILE_K)
    else:
        raise ValueError(f"no weight-gradient route {route!r}")
    ws = (torch.empty((splits, m, o), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    out = torch.empty((kh, kw, c, o), dtype=w_dtype, device=dev)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), g.data_ptr(), ptr(mask), ptr(scale),
                 DTYPE_CODES[mask.dtype] if mask is not None else 0,
                 out.data_ptr(), ptr(ws), geo_arg(geo), DTYPE_CODES[x.dtype],
                 DTYPE_CODES[w_dtype], splits, per,
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, name)
    return out.permute(3, 2, 0, 1)                   # OIHW


def convkxk_dw_cuda(g, mask, scale, x, w_shape, w_dtype, stride, padding,
                    dilation):
    """Launch the weight-gradient kernel that ``dw_route`` picks: x NHWC,
    g (and the saved output ``mask``) [N, OH, OW, O] in x's dtype, scale
    float32 [O] or None. Returns dw OIHW in ``w_dtype``; a long N*OH*OW is
    split over blocks (float32 workspace, reduced in order). Counts the
    launch in ``convkxk_dw.launches`` and in ``convkxk_dw_cuda.tc_launches``
    or ``.simt_launches``. Raises on what the kernel does not take and on
    a launch error."""
    operands = (x, g) if mask is None else (x, g, mask)
    aligned = all(t.data_ptr() % 16 == 0 for t in operands)
    dtype = x.dtype if all(t.dtype == x.dtype for t in operands) else None
    route = dw_route(dtype, x.shape[-1], w_shape[0], aligned)
    out = convkxk_dw_launch(route, g, mask, scale, x, w_shape, w_dtype,
                            stride, padding, dilation)
    convkxk_dw.launches += 1
    if route == "tc":
        convkxk_dw_cuda.tc_launches += 1
    else:
        convkxk_dw_cuda.simt_launches += 1
    return out


convkxk_dw_cuda.tc_launches = 0
convkxk_dw_cuda.simt_launches = 0


def convkxk(x, w, scale=None, bias=None, residual=None, relu=False,
            stride=(1, 1), padding=((0, 0), (0, 0)), dilation=(1, 1),
            out_dtype=None):
    """KxK forward: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    fn = convkxk_cuda if x.device.type == "cuda" else convkxk_reference
    return fn(x, w, scale, bias, residual, relu, stride, padding, dilation,
              out_dtype)


def convkxk_dx(g, mask, scale, w, x_shape, x_dtype, stride, padding,
               dilation):
    fn = convkxk_dx_cuda if g.device.type == "cuda" else convkxk_dx_reference
    return fn(g, mask, scale, w, x_shape, x_dtype, stride, padding, dilation)


def convkxk_dw(g, mask, scale, x, w_shape, w_dtype, stride, padding,
               dilation):
    fn = convkxk_dw_cuda if g.device.type == "cuda" else convkxk_dw_reference
    return fn(g, mask, scale, x, w_shape, w_dtype, stride, padding, dilation)


convkxk.launches = 0
convkxk_dx.launches = 0
convkxk_dw.launches = 0


# -- forward dispatch ------------------------------------------------------------


def _is_1x1(w, padding):
    return w.shape[2] == w.shape[3] == 1 and padding == ((0, 0), (0, 0))


def _conv1x1(x, w, scale, bias, residual, relu, stride, out_dtype=None):
    """1x1 conv as the BRGEMM: x NHWC (sliced for stride), w [O, C, 1, 1]."""
    sh, sw = stride
    if sh > 1 or sw > 1:
        x = x[:, ::sh, ::sw, :]
    n, oh, ow, c = x.shape
    o = w.shape[0]
    m = n * oh * ow
    out = tiles.brgemm(
        x.reshape(m, c).contiguous(), w.reshape(o, c).t().contiguous(),
        mode="nn", out_dtype=out_dtype or x.dtype, scale=scale, bias=bias,
        residual=None if residual is None else
        residual.reshape(m, o).contiguous(), relu=relu)
    return out.reshape(n, oh, ow, o)


def _dispatch(x, w, scale, bias, residual, act, stride, padding, dilation):
    relu = act == "relu"
    if _is_1x1(w, padding):
        return _conv1x1(x, w, scale, bias, residual, relu, stride)
    return convkxk(x.contiguous(), w.contiguous(), scale, bias,
                   None if residual is None else residual.contiguous(), relu,
                   stride, padding, dilation)


# -- backward dispatch -----------------------------------------------------------


def _conv1x1_dx(g, mask, scale, w, x_shape, x_dtype, stride):
    """1x1 dgrad: dy[m, o] @ w[o, c] with the fold in the kernel; a strided
    forward scatters the dense result back to the sliced positions."""
    n, _, _, c = x_shape
    sh, sw = stride
    _, oh, ow, o = g.shape
    m = n * oh * ow
    dx2 = tiles.brgemm(
        g.reshape(m, o), w.reshape(o, c).contiguous(), mode="nn",
        out_dtype=x_dtype, fold_on="a",
        fold_mask=None if mask is None else mask.reshape(m, o),
        fold_scale=scale)
    dx2 = dx2.reshape(n, oh, ow, c)
    if sh > 1 or sw > 1:
        dx = torch.zeros(x_shape, dtype=x_dtype, device=g.device)
        dx[:, ::sh, ::sw, :] = dx2
        return dx
    return dx2


def _conv1x1_dw(g, mask, scale, x, w_shape, w_dtype, stride):
    """1x1 wgrad: x2[m, c]^T @ dy[m, o] (mode "tn"), fold on b."""
    sh, sw = stride
    if sh > 1 or sw > 1:
        x = x[:, ::sh, ::sw, :]
    n, oh, ow, c = x.shape
    o = w_shape[0]
    m = n * oh * ow
    dw2 = tiles.brgemm(
        x.reshape(m, c).contiguous(), g.reshape(m, o), mode="tn",
        out_dtype=w_dtype, fold_on="b",
        fold_mask=None if mask is None else mask.reshape(m, o),
        fold_scale=scale)                                   # [C, O]
    return dw2.t().reshape(w_shape)


def _pallas_bwd(x, w, scale, bias, has_res, res_dtype, out, g, act, stride,
                padding, dilation):
    """The full VJP from the dx/dw kernels plus the epilogue's cotangents
    (the counterpart of the JAX ``_pallas_bwd``): dscale recomputes the
    raw conv output through the forward kernel (identity epilogue)."""
    mask = out if act == "relu" else None
    g = g.contiguous()
    if _is_1x1(w, padding):
        dx = _conv1x1_dx(g, mask, scale, w, x.shape, x.dtype, stride)
        dw = _conv1x1_dw(g, mask, scale, x, w.shape, w.dtype, stride)
    else:
        dx = convkxk_dx(g, mask, scale, w.contiguous(), x.shape, x.dtype,
                        stride, padding, dilation)
        dw = convkxk_dw(g, mask, scale, x.contiguous(), w.shape, w.dtype,
                        stride, padding, dilation)
    dscale = dbias = dres = None
    if scale is not None or bias is not None or has_res:
        gm = g.float()
        if mask is not None:
            gm = torch.where(mask > 0, gm, torch.zeros((), device=g.device))
        if scale is not None:
            z = _dispatch(x, w, None, None, None, None, stride, padding,
                          dilation)
            dscale = torch.sum(gm * z.float(), dim=(0, 1, 2))
        if bias is not None:
            dbias = torch.sum(gm, dim=(0, 1, 2))
        if has_res:
            dres = gm.to(res_dtype)
    return dx, dw, dscale, dbias, dres


# -- reference + autograd --------------------------------------------------------


def conv_epilogue_reference(x, w, scale=None, bias=None, residual=None,
                            act=None, stride=1, padding=0, dilation=1):
    """The XLA formulation of the same math: the conv in x's dtype, then
    the epilogue in float32, cast to x's dtype. x NHWC, w OIHW."""
    (ph0, ph1), (pw0, pw1) = _pad_pairs(padding)
    xn = F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1))
    out = F.conv2d(xn, w.to(x.dtype), stride=_pair(stride),
                   dilation=_pair(dilation)).permute(0, 2, 3, 1)
    return ep.apply(out.float(), scale, bias, residual, act == "relu",
                    x.dtype)


class _ConvFusedCore(torch.autograd.Function):
    """Counterpart of ``_conv_fused_core`` and its custom VJP."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, residual, act, stride, padding,
                dilation):
        out = _dispatch(x, w, scale, bias, residual, act, stride, padding,
                        dilation)
        # the backward derives the relu mask from the saved output; without
        # an activation nothing extra is saved
        ctx.save_for_backward(x, w, scale, bias,
                              out if act == "relu" else None)
        ctx.cfg = (act, stride, padding, dilation)
        ctx.has_res = residual is not None
        ctx.res_dtype = None if residual is None else residual.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, scale, bias, out = ctx.saved_tensors
        grads = _pallas_bwd(x, w, scale, bias, ctx.has_res, ctx.res_dtype,
                            out, g, *ctx.cfg)
        return (*grads, None, None, None, None)


def conv2d_bn_act(x, w, scale=None, bias=None, residual=None, act=None,
                  stride=1, padding=0, dilation=1):
    """``act(conv(x, w) * scale + bias [+ residual])`` (see the module
    docstring). x: [N, H, W, C]; w: OIHW [O, C, KH, KW]; scale/bias:
    optional per-channel [O] (cast to float32); residual: optional, the
    output's shape; act: None | "relu"."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("conv2d_bn_act expects NHWC x and OIHW w")
    if w.shape[1] != x.shape[-1]:
        raise ValueError(f"grouped conv unsupported: w in_ch {w.shape[1]} "
                         f"!= C {x.shape[-1]}")
    if act not in (None, "relu"):
        raise ValueError(f"fused epilogue supports relu, got {act!r}")
    scale = None if scale is None else scale.float()
    bias = None if bias is None else bias.float()
    return _ConvFusedCore.apply(x, w, scale, bias, residual, act,
                                _pair(stride), _pad_pairs(padding),
                                _pair(dilation))
