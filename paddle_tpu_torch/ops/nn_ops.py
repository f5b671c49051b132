"""NN ops of the serving and training paths (counterpart of
``paddle_tpu/ops/nn_ops.py``): ``layer_norm`` (differentiated by plain
autograd), ``embedding`` and ``dropout``; for ResNet, ``conv2d`` with its
fused-kernel routing knob (``CONV_FUSED``), ``conv2d_stem_s2d``,
``pool2d`` and ``batch_norm`` (with an fp8-residual mode that a
``BatchNorm`` module pins; the JAX module's process-wide
``BN_LOWP_RESIDUAL`` default is not ported).

The routing knob keeps the JAX module's contract: a process-wide default
(``set_conv_fused``) and a scope that outranks it (``conv_fused``). JAX
reads it when a function is traced; the port reads it when the op runs.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.activation import get_activation


def layer_norm(x, scale=None, bias=None, begin_norm_axis=1, epsilon=1e-5):
    """layer_norm_op parity (``paddle_tpu/ops/nn_ops.py:794``): normalize
    over dims ``[begin_norm_axis:]`` in float32 and cast back to x's
    dtype."""
    dims = tuple(range(begin_norm_axis, x.dim()))
    xf = x.float()
    m = xf.mean(dim=dims, keepdim=True)
    v = (xf - m).square().mean(dim=dims, keepdim=True)
    out = (xf - m) * torch.rsqrt(v + epsilon)
    lead = (1,) * begin_norm_axis
    if scale is not None:
        out = out * scale.reshape(lead + tuple(scale.shape))
    if bias is not None:
        out = out + bias.reshape(lead + tuple(bias.shape))
    return out.to(x.dtype)


def dropout(x, dropout_prob=0.5, is_test=False, generator=None):
    """dropout_op parity (``paddle_tpu/ops/nn_ops.py:868-883``) in its
    default ``upscale_in_train`` convention: the identity at inference;
    in training, x / keep where a uniform draw from ``generator`` (a
    ``torch.Generator`` on x's device, or the default one) falls below
    keep = 1 - p, else 0. The streams differ from the reference's, so
    parity with the reference holds only at ``dropout_prob == 0``."""
    if is_test or dropout_prob == 0.0:
        return x
    keep = 1.0 - dropout_prob
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def embedding(ids, weight, padding_idx=None):
    """lookup_table_op forward (``paddle_tpu/ops/nn_ops.py:888``),
    including the squeeze of a trailing size-1 id dim."""
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    out = weight[ids.long()]
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device), out)
    return out


# -- convolution ---------------------------------------------------------------


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _explicit_pads(x_hw, w_hw, stride, padding, dilation):
    """Fluid padding (int, [ph, pw], [ph0, ph1, pw0, pw1], "SAME",
    "VALID") -> ((ph0, ph1), (pw0, pw1)) for spatial sizes ``x_hw`` and
    kernel sizes ``w_hw``."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return ((0, 0), (0, 0))
        if padding.upper() != "SAME":
            raise ValueError(f"bad padding {padding!r}")
        pads = []
        for size, k, s, d in zip(x_hw, w_hw, _pair(stride), _pair(dilation)):
            eff = (k - 1) * d + 1
            total = max((-(-size // s) - 1) * s + eff - size, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    p = list(padding)
    if len(p) == 2:
        return ((p[0], p[0]), (p[1], p[1]))
    if len(p) == 4:
        return ((p[0], p[1]), (p[2], p[3]))
    raise ValueError(f"bad padding {padding}")


def _conv_nchw(x, weight, stride, pads, dilation, groups):
    """``F.conv2d`` on NCHW x with explicit (possibly uneven) pads."""
    (ph0, ph1), (pw0, pw1) = pads
    if ph0 == ph1 and pw0 == pw1:
        return F.conv2d(x, weight, None, stride, (ph0, pw0), dilation, groups)
    return F.conv2d(F.pad(x, (pw0, pw1, ph0, ph1)), weight, None, stride, 0,
                    dilation, groups)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", act=None, use_pallas=None):
    """conv2d (``paddle_tpu/ops/nn_ops.py:85``); weight OIHW.

    ``use_pallas`` routes an NHWC, groups=1 conv through the fused kernels
    (``kernels/conv_fused.conv2d_bn_act``) with bias and relu in the
    epilogue: True/False per call, None follows ``CONV_FUSED``. Other
    configs, and the knob off, take ``F.conv2d`` in x's dtype. The int8
    compute route of the JAX function is not ported."""
    use_p = CONV_FUSED if use_pallas is None else bool(use_pallas)
    sp = (1, 2) if data_format == "NHWC" else (2, 3)
    pads = _explicit_pads([x.shape[a] for a in sp], weight.shape[2:],
                          stride, padding, dilation)
    if use_p and data_format == "NHWC" and groups == 1 and x.dim() == 4:
        from paddle_tpu_torch.kernels.conv_fused import conv2d_bn_act
        k_act = act if act in (None, "relu") else None
        out = conv2d_bn_act(x, weight.to(x.dtype), bias=bias, act=k_act,
                            stride=_pair(stride), padding=pads,
                            dilation=_pair(dilation))
        return out if k_act == act else get_activation(act)(out)
    xn = x.permute(0, 3, 1, 2) if data_format == "NHWC" else x
    out = _conv_nchw(xn, weight, _pair(stride), pads, _pair(dilation),
                     groups)
    if data_format == "NHWC":
        out = out.permute(0, 2, 3, 1)
    if bias is not None:
        out = out + (bias if data_format == "NHWC" else
                     bias.reshape(-1, 1, 1))
    return get_activation(act)(out)


def conv2d_stem_s2d(x, weight):
    """The 7x7/stride-2/pad-3 stem conv through space-to-depth
    (``paddle_tpu/ops/nn_ops.py:170``): x NHWC is cut into 2x2 blocks
    ([N, H, W, C] -> [N, ceil(H/2), ceil(W/2), 4C], an odd H or W padded by
    one more zero row/column) and the weight into the equivalent stride-1
    4x4 kernel over 4C channels. The same function as the strided conv;
    the conv itself is ``F.conv2d`` in x's dtype."""
    n, h, w, c = x.shape
    o = weight.shape[0]
    if tuple(weight.shape[2:]) != (7, 7):
        raise ValueError(f"stem weight must be 7x7, got "
                         f"{tuple(weight.shape)}")
    xp = F.pad(x, (0, 0, 3, 3 + w % 2, 3, 3 + h % 2))
    hp, wp = h + 6 + h % 2, w + 6 + w % 2
    xs = xp.reshape(n, hp // 2, 2, wp // 2, 2, c)
    xs = xs.permute(0, 1, 3, 2, 4, 5).reshape(n, hp // 2, wp // 2, 4 * c)
    w8 = F.pad(weight, (0, 1, 0, 1))
    w2 = w8.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    w2 = w2.reshape(o, 4 * c, 4, 4).to(xs.dtype)
    out = F.conv2d(xs.permute(0, 3, 1, 2), w2)
    return out.permute(0, 2, 3, 1)


# -- pooling -----------------------------------------------------------------------


def pool2d(x, pool_size=2, pool_type="max", pool_stride=None, pool_padding=0,
           global_pooling=False, ceil_mode=False, exclusive=True,
           data_format="NCHW"):
    """pool_op parity (``paddle_tpu/ops/nn_ops.py:256``), the XLA route:
    max pools pad with -inf, avg pools sum in float32 and divide by the
    window (or, exclusive with padding, by the count of real elements);
    ``ceil_mode`` pads the high end by stride - 1 as the JAX op does. The
    fused max-pool kernel (``POOL_FUSED``) is not ported yet."""
    nchw = x if data_format == "NCHW" else x.permute(0, 3, 1, 2)
    if global_pooling:
        red = (2, 3)
        out = (nchw.amax(red, keepdim=True) if pool_type == "max" else
               nchw.float().mean(red, keepdim=True).to(x.dtype))
    else:
        ks = _pair(pool_size)
        st = _pair(pool_stride if pool_stride is not None else pool_size)
        pd = _pair(pool_padding)
        extra = [s - 1 if ceil_mode else 0 for s in st]
        pads = (pd[1], pd[1] + extra[1], pd[0], pd[0] + extra[0])
        if pool_type == "max":
            if not ceil_mode and pd[0] <= ks[0] // 2 and pd[1] <= ks[1] // 2:
                out = F.max_pool2d(nchw, ks, st, pd)
            else:
                out = F.max_pool2d(F.pad(nchw, pads, value=float("-inf")),
                                   ks, st)
        else:
            xf = F.pad(nchw.float(), pads)
            ssum = F.avg_pool2d(xf, ks, st, divisor_override=1)
            if exclusive and (pd[0] or pd[1] or ceil_mode):
                ones = F.pad(torch.ones_like(nchw[:1, :1], dtype=torch.float32),
                             pads)
                cnt = F.avg_pool2d(ones, ks, st, divisor_override=1)
                out = (ssum / torch.clamp_min(cnt, 1.0)).to(x.dtype)
            else:
                out = (ssum / (ks[0] * ks[1])).to(x.dtype)
    return out if data_format == "NCHW" else out.permute(0, 2, 3, 1)


# -- fused-conv routing knob ---------------------------------------------------

# Fused-conv routing default (kernels/conv_fused.py), consulted by conv2d /
# ConvBNLayer calls whose use_pallas is None.
CONV_FUSED = False
_CONV_FUSED_SCOPE_DEPTH = 0


def set_conv_fused(on):
    """Set the process-wide DEFAULT of the fused-conv routing (a no-op
    inside an active ``conv_fused`` scope)."""
    global CONV_FUSED
    if _CONV_FUSED_SCOPE_DEPTH == 0:
        CONV_FUSED = bool(on)


@contextlib.contextmanager
def conv_fused(on=True):
    """Scope the fused-conv routing to a block (exception-safe)."""
    global CONV_FUSED, _CONV_FUSED_SCOPE_DEPTH
    prev = CONV_FUSED
    CONV_FUSED = bool(on)
    _CONV_FUSED_SCOPE_DEPTH += 1
    try:
        yield
    finally:
        _CONV_FUSED_SCOPE_DEPTH -= 1
        CONV_FUSED = prev


# -- batch norm ---------------------------------------------------------------------

# fp8 BN residuals (``lowp_residual``): the backward's saved x is stored
# e4m3 (clipped at e4m3's 448 first, so nothing overflows to NaN) and the
# relu mask as an exact bool.
def _bn_res_store(x):
    return torch.clamp(x, -448.0, 448.0).to(torch.float8_e4m3fn)


def _chan(v, x, ch_axis):
    shape = [1] * x.dim()
    shape[ch_axis] = x.shape[ch_axis]
    return v.reshape(shape)


def _moments(xf, ch_axis):
    """One-pass moments, as the JAX op: m = s1/n, v = max(s2/n - m^2, 0)."""
    red = tuple(i for i in range(xf.dim()) if i != ch_axis)
    n = xf.numel() // xf.shape[ch_axis]
    m = torch.sum(xf, dim=red) / n
    v = torch.clamp_min(torch.sum(xf * xf, dim=red) / n - m * m, 0.0)
    return m, v


def _bn_bwd(x, g_out, scale, m, rstd, keep, ch_axis):
    """(dx, dscale, dbias, g) of the normalisation for the (masked)
    cotangent, the expressions of ``_bn_train_act_bwd``."""
    if x.dtype == torch.float8_e4m3fn:
        x = x.to(g_out.dtype)
    red = tuple(i for i in range(x.dim()) if i != ch_axis)
    n = x.numel() // x.shape[ch_axis]
    xhat = (x.float() - _chan(m, x, ch_axis)) * _chan(rstd, x, ch_axis)
    g = g_out.float()
    if keep is not None:
        g = torch.where(keep, g, torch.zeros((), device=g.device))
    dbias = torch.sum(g, dim=red)
    dscale = torch.sum(g * xhat, dim=red)
    dx = _chan(rstd * scale, x, ch_axis) * (
        g - _chan(dbias / n, x, ch_axis) - xhat * _chan(dscale / n, x,
                                                        ch_axis))
    return dx.to(x.dtype), dscale, dbias, g


class _BnTrainAct(torch.autograd.Function):
    """(out, batch_mean, batch_var) of training BN with an optional fused
    relu (``_bn_train_act``); mean and var are not differentiable."""

    @staticmethod
    def forward(ctx, x, scale, bias, epsilon, ch_axis, relu, lowp):
        xf = x.float()
        m, v = _moments(xf, ch_axis)
        rstd = torch.rsqrt(v + epsilon)
        pre = (xf - _chan(m, x, ch_axis)) * _chan(rstd, x, ch_axis) \
            * _chan(scale, x, ch_axis) + _chan(bias, x, ch_axis)
        out = (torch.clamp_min(pre, 0.0) if relu else pre).to(x.dtype)
        mask = None
        if lowp:
            # exact bool mask: the sign of e4m3 x could flip near 0
            mask = out > 0 if relu else None
            x = _bn_res_store(x)
        ctx.save_for_backward(x, scale, bias, m, rstd, mask)
        ctx.cfg = (ch_axis, relu)
        ctx.mark_non_differentiable(m, v)
        return out, m, v

    @staticmethod
    def backward(ctx, g_out, _dm, _dv):
        x, scale, bias, m, rstd, mask = ctx.saved_tensors
        ch_axis, relu = ctx.cfg
        keep = None
        if relu:
            if mask is not None:
                keep = mask
            else:
                # the pre-activation's sign, recomputed from x
                xhat = (x.float() - _chan(m, x, ch_axis)) * _chan(
                    rstd, x, ch_axis)
                pre = xhat * _chan(scale, x, ch_axis) + _chan(bias, x,
                                                              ch_axis)
                keep = pre > 0
        dx, dscale, dbias, _ = _bn_bwd(x, g_out, scale, m, rstd, keep,
                                       ch_axis)
        return dx, dscale, dbias, None, None, None, None


class _BnTrainActRes(torch.autograd.Function):
    """``_bn_train_act`` with a fused skip-add: out = act(bn(x) +
    residual) (``_bn_train_act_res``)."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, epsilon, ch_axis, relu, lowp):
        xf = x.float()
        m, v = _moments(xf, ch_axis)
        rstd = torch.rsqrt(v + epsilon)
        pre = (xf - _chan(m, x, ch_axis)) * _chan(rstd, x, ch_axis) \
            * _chan(scale, x, ch_axis) + _chan(bias, x, ch_axis) \
            + residual.float()
        out = (torch.clamp_min(pre, 0.0) if relu else pre).to(x.dtype)
        mask = None
        if relu:
            mask = out > 0 if lowp else out
        ctx.save_for_backward(_bn_res_store(x) if lowp else x, scale, bias,
                              m, rstd, mask)
        ctx.cfg = (ch_axis, relu)
        ctx.mark_non_differentiable(m, v)
        return out, m, v

    @staticmethod
    def backward(ctx, g_out, _dm, _dv):
        x, scale, bias, m, rstd, out = ctx.saved_tensors
        ch_axis, relu = ctx.cfg
        keep = None
        if relu:
            keep = out if out.dtype == torch.bool else out > 0
        dx, dscale, dbias, g = _bn_bwd(x, g_out, scale, m, rstd, keep,
                                       ch_axis)
        # the skip path's cotangent is the masked upstream gradient
        dres = g.to(dx.dtype)
        return dx, dscale, dbias, dres, None, None, None, None


def batch_norm(x, scale, bias, mean, variance, epsilon=1e-5, momentum=0.9,
               is_test=False, data_format="NCHW", act=None, residual=None,
               lowp_residual=False):
    """batch_norm_op parity (``paddle_tpu/ops/nn_ops.py:456``). Returns
    (out, new_mean, new_var) in training, out alone in inference.

    Training takes the JAX op's one-pass moments (the biased batch
    variance, ``s2/n - m^2`` clamped at 0) and its backward as
    ``autograd.Function``s that save (x, mean, rstd) and, with
    ``lowp_residual``, x as e4m3 and an
    exact bool relu mask. ``residual`` folds a skip add before the
    activation. Running stats: ``momentum * old + (1 - momentum) *
    batch``, with the biased variance."""
    ch_axis = 1 if data_format in ("NCHW", "NCDHW") else x.dim() - 1
    if is_test:
        out = (x - _chan(mean, x, ch_axis)) * torch.rsqrt(
            _chan(variance, x, ch_axis) + epsilon)
        out = out * _chan(scale, x, ch_axis) + _chan(bias, x, ch_axis)
        if residual is not None:
            out = out + residual
        return get_activation(act)(out)
    if act not in (None, "relu"):
        raise NotImplementedError(f"batch_norm act {act!r} is not ported")
    lowp = bool(lowp_residual)
    if residual is not None:
        out, m, v = _BnTrainActRes.apply(x, scale, bias, residual,
                                         float(epsilon), ch_axis,
                                         act == "relu", lowp)
    else:
        out, m, v = _BnTrainAct.apply(x, scale, bias, float(epsilon),
                                      ch_axis, act == "relu", lowp)
    with torch.no_grad():
        new_mean = momentum * mean + (1 - momentum) * m
        new_var = momentum * variance + (1 - momentum) * v
    return out, new_mean, new_var
