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
  ``_conv1x1_dw``.
- Every other conv runs ``csrc/conv_kxk.cu``: ``convkxk``, ``convkxk_dx``
  and ``convkxk_dw`` replace the Pallas ``_convkxk``, ``_convkxk_dx`` and
  ``_convkxk_dw``. Each wrapper launches its kernel on CUDA tensors (and
  counts it in its ``launches``), runs its plain version on CPU tensors,
  and raises on anything the kernel does not take.

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

import torch
import torch.nn.functional as F

from paddle_tpu_torch.kernels import epilogues as ep
from paddle_tpu_torch.kernels import tiles
from paddle_tpu_torch.kernels.tiles import DTYPE_CODES, check_operand, ptr


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
        lib.conv_kxk_fwd.argtypes = [p, p, p, p, p, p, i, i, p, i, i, p]
        lib.conv_kxk_dx.argtypes = [p, p, p, i, p, p, p, i, i, p]
        lib.conv_kxk_dw.argtypes = [p, p, p, p, i, p, p, p, i, i, i, i, p]
        for fn in (lib.conv_kxk_fwd, lib.conv_kxk_dx, lib.conv_kxk_dw):
            fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _geo_arg(geo):
    return (ctypes.c_int * 15)(*geo)


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


_KINDS = tuple(DTYPE_CODES)


def convkxk_cuda(x, w, scale=None, bias=None, residual=None, relu=False,
                 stride=(1, 1), padding=((0, 0), (0, 0)), dilation=(1, 1),
                 out_dtype=None):
    """Launch ``conv_kxk_fwd``: x NHWC and w OIHW, contiguous CUDA tensors
    of one dtype (float32 or bfloat16); scale/bias float32 [O]; residual
    the output's shape. Returns NHWC out in ``out_dtype`` (x's)."""
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
    wk = w.permute(2, 3, 1, 0).contiguous()          # [KH, KW, C, O]
    out = torch.empty((n, oh, ow, o), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        err = _lib().conv_kxk_fwd(
            x.data_ptr(), wk.data_ptr(), out.data_ptr(), ptr(scale),
            ptr(bias), ptr(residual),
            DTYPE_CODES[residual.dtype] if residual is not None else 0,
            int(relu), _geo_arg(geo), DTYPE_CODES[x.dtype],
            DTYPE_CODES[out_dtype], torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "conv_kxk_fwd")
    convkxk.launches += 1
    return out


def _fold_checks(g, mask, scale, dev, o):
    check_operand("g", g, g.shape, _KINDS, dev)
    if mask is not None:
        check_operand("mask", mask, g.shape, _KINDS, dev)
    if scale is not None:
        check_operand("scale", scale, (o,), (torch.float32,), dev)


def convkxk_dx_cuda(g, mask, scale, w, x_shape, x_dtype, stride, padding,
                    dilation):
    """Launch ``conv_kxk_dx``: g (and the saved output ``mask``) NHWC
    [N, OH, OW, O] in w's dtype, scale float32 [O] or None. Returns dx
    [N, H, W, C] in ``x_dtype``."""
    dev = g.device
    geo = geometry(x_shape, w.shape, stride, padding, dilation)
    n, h, wd, c, o, kh, kw, oh, ow = geo[:9]
    if tuple(g.shape) != (n, oh, ow, o):
        raise ValueError(f"g is {tuple(g.shape)}, expected "
                         f"{(n, oh, ow, o)}")
    _fold_checks(g, mask, scale, dev, o)
    check_operand("w", w, w.shape, (g.dtype,), dev)
    wk = w.permute(2, 3, 0, 1).contiguous()          # [KH, KW, O, C]
    dx = torch.empty(x_shape, dtype=x_dtype, device=dev)
    with torch.cuda.device(dev):
        err = _lib().conv_kxk_dx(
            g.data_ptr(), ptr(mask), ptr(scale),
            DTYPE_CODES[mask.dtype] if mask is not None else 0,
            wk.data_ptr(), dx.data_ptr(), _geo_arg(geo), DTYPE_CODES[g.dtype],
            DTYPE_CODES[x_dtype], torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "conv_kxk_dx")
    convkxk_dx.launches += 1
    return dx


def convkxk_dw_cuda(g, mask, scale, x, w_shape, w_dtype, stride, padding,
                    dilation):
    """Launch ``conv_kxk_dw``: x NHWC, g (and ``mask``) [N, OH, OW, O] in
    x's dtype. Returns dw OIHW in ``w_dtype``; a long N*OH*OW is split over
    blocks (float32 workspace, reduced in order)."""
    dev = x.device
    geo = geometry(x.shape, w_shape, stride, padding, dilation)
    n, h, wd, c, o, kh, kw, oh, ow = geo[:9]
    check_operand("x", x, x.shape, _KINDS, dev)
    if tuple(g.shape) != (n, oh, ow, o) or g.dtype != x.dtype:
        raise ValueError(f"g is {tuple(g.shape)} {g.dtype}, expected "
                         f"{(n, oh, ow, o)} {x.dtype}")
    _fold_checks(g, mask, scale, dev, o)
    m, k = kh * kw * c, n * oh * ow
    splits, per = tiles.split_k(m, o, k, dev)
    ws = (torch.empty((splits, m, o), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    out = torch.empty((kh, kw, c, o), dtype=w_dtype, device=dev)
    with torch.cuda.device(dev):
        err = _lib().conv_kxk_dw(
            x.data_ptr(), g.data_ptr(), ptr(mask), ptr(scale),
            DTYPE_CODES[mask.dtype] if mask is not None else 0,
            out.data_ptr(), ptr(ws), _geo_arg(geo), DTYPE_CODES[x.dtype],
            DTYPE_CODES[w_dtype], splits, per,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "conv_kxk_dw")
    convkxk_dw.launches += 1
    return out.permute(3, 2, 0, 1)                   # OIHW


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
