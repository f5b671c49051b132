"""ResNet family (counterpart of ``paddle_tpu/models/resnet.py``): NHWC
activations, OIHW float32 conv weights cast to the activations' dtype per
call, float32 BatchNorm parameters with running stats in buffers.

Module names follow the JAX tree: ``stem``, ``stage0``..``stage3`` (lists
of blocks: ``stage0.1.conv0.conv.weight`` is the JAX
``stage0_1/conv0/conv/weight``), ``head``. Random weights come from
``torch.Generator().manual_seed(seed)`` with the JAX initializers'
distributions (the streams differ); ``convert.from_jax_variables`` loads
the JAX package's parameters and BN state.

``lowp`` takes the JAX model's tokens: "grad", "out", "in", "blk", "stem"
and "bnres" mark fp8 storage edges (``paddle_tpu_torch/amp``) and the fp8
BN residual; the int8 tokens "i8"/"i8f" are not ported and raise. With
``nn_ops.CONV_FUSED`` on (or ``use_pallas=True``) every conv outside the
stem runs the fused kernels; in eval mode ``ConvBNLayer`` fuses the
BatchNorm's folded affine, the relu and a residual into the conv's
epilogue. The DeepLab options of the JAX ResNet (``output_stride``,
``features_only``) and SE-ResNeXt are not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch import amp
from paddle_tpu_torch import initializer as I
from paddle_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from paddle_tpu_torch.nn.layers import BatchNorm, Conv2D, Linear, Pool2D
from paddle_tpu_torch.ops import nn_ops


def _tokens(lowp):
    flags = set(lowp.split("+")) if lowp else set()
    if flags & {"i8", "i8f"}:
        raise NotImplementedError("int8 conv compute (lowp i8/i8f) is not "
                                  "ported")
    return flags


class StemConv(Conv2D):
    """The 7x7/s2 stem conv through space-to-depth whenever the exact
    7x7/s2/pad-3 bias-free config holds (``nn_ops.conv2d_stem_s2d``)."""

    def forward(self, x):
        if (self.data_format == "NHWC"
                and self.w_shape[2:] == (7, 7)
                and self.stride == 2 and self.padding == 3
                and self.bias is None and self.act is None
                and self.dilation == 1 and self.groups == 1):
            return nn_ops.conv2d_stem_s2d(x, self.weight.to(x.dtype))
        return super().forward(x)


class ConvBNLayer(nn.Module):
    """conv + bn (+act), with the JAX layer's lowp tokens: "in" (fp8 the
    conv's input edge), "grad" (fp8 the conv's output cotangent, unless
    "out" is set), "out" (fp8 the conv->BN edge), "bnres" (fp8 BN
    residual)."""

    def __init__(self, in_ch, out_ch, filter_size, stride=1, groups=1,
                 act=None, data_format="NHWC", dilation=1, stem=False,
                 lowp="", use_pallas=None, generator=None):
        super().__init__()
        pad = ((filter_size - 1) // 2) * dilation
        flags = _tokens(lowp)
        conv_cls = StemConv if stem else Conv2D
        self.conv = conv_cls(in_ch, out_ch, filter_size, stride=stride,
                             padding=pad, dilation=dilation, groups=groups,
                             act=None, bias=False, data_format=data_format,
                             weight_init=I.MSRANormal(),
                             input_cast="e4m3" if "in" in flags else None,
                             grad_cast="e5m2" if "grad" in flags
                             and "out" not in flags else None,
                             use_pallas=use_pallas, generator=generator)
        self.lowp_out = "out" in flags
        self.use_pallas = use_pallas
        self.bn = BatchNorm(out_ch, act=act, data_format=data_format,
                            lowp_residual="bnres" in flags)

    def _fused_eval_ok(self):
        """The conv+BN(+act+skip) epilogue fusion: inference mode only
        (training BN needs the batch moments of the conv output), NHWC,
        groups 1, no fp8 "out" edge, not the stem, act None or relu."""
        up = nn_ops.CONV_FUSED if self.use_pallas is None else self.use_pallas
        return (up and not self.training
                and self.conv.data_format == "NHWC"
                and self.conv.groups == 1
                and not self.lowp_out
                and type(self.conv) is Conv2D
                and self.bn.act in (None, "relu"))

    def forward(self, x, residual=None):
        if self._fused_eval_ok():
            from paddle_tpu_torch.kernels.conv_fused import conv2d_bn_act
            if self.conv.input_cast is not None:
                x = amp.float8_store(x)
            w = self.conv.fetch_weight()
            s, b = self.bn.folded_scale_bias()
            return conv2d_bn_act(
                x, w.to(x.dtype), s, b, residual=residual, act=self.bn.act,
                stride=self.conv.stride, padding=self.conv.padding,
                dilation=self.conv.dilation)
        h = self.conv(x)
        if self.lowp_out:
            h = amp.float8_store(h)
        return self.bn(h, residual=residual)


def _block_relu(y):
    # jnp.maximum(y, 0): its gradient at an exact 0 is 0.5, as
    # torch.maximum's (torch.relu's is 0)
    return torch.maximum(y, torch.zeros((), dtype=y.dtype, device=y.device))


class BasicBlock(nn.Module):
    """2-conv residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_ch, ch, stride=1, data_format="NHWC", dilation=1,
                 lowp="", use_pallas=None, generator=None):
        super().__init__()
        sub = _tokens(lowp)
        self.lowp_blk = "blk" in sub
        g = "+".join(sorted(sub & {"grad", "out", "bnres"}))
        kw = dict(data_format=data_format, use_pallas=use_pallas,
                  generator=generator)
        self.conv0 = ConvBNLayer(in_ch, ch, 3, stride=stride, act="relu",
                                 dilation=dilation, lowp=g, **kw)
        self.conv1 = ConvBNLayer(ch, ch, 3, act=None, dilation=dilation,
                                 lowp=lowp, **kw)
        self.short = None
        if stride != 1 or in_ch != ch:
            self.short = ConvBNLayer(in_ch, ch, 1, stride=stride, act=None,
                                     lowp=g, **kw)

    def forward(self, x):
        s = self.short(x) if self.short is not None else x
        out = _block_relu(self.conv1(self.conv0(x)) + s)
        return amp.float8_store(out) if self.lowp_blk else out


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck."""

    expansion = 4

    def __init__(self, in_ch, ch, stride=1, data_format="NHWC", dilation=1,
                 lowp="", use_pallas=None, generator=None):
        super().__init__()
        sub = _tokens(lowp)
        self.lowp_blk = "blk" in sub
        g = "+".join(sorted(sub & {"grad", "out", "bnres"}))
        kw = dict(data_format=data_format, use_pallas=use_pallas,
                  generator=generator)
        self.conv0 = ConvBNLayer(in_ch, ch, 1, act="relu", lowp=g, **kw)
        self.conv1 = ConvBNLayer(ch, ch, 3, stride=stride, act="relu",
                                 dilation=dilation, lowp=lowp, **kw)
        self.conv2 = ConvBNLayer(ch, ch * 4, 1, act=None, lowp=lowp, **kw)
        self.short = None
        if stride != 1 or in_ch != ch * 4:
            self.short = ConvBNLayer(in_ch, ch * 4, 1, stride=stride,
                                     act=None, lowp=g, **kw)

    def forward(self, x):
        s = self.short(x) if self.short is not None else x
        out = _block_relu(self.conv2(self.conv1(self.conv0(x))) + s)
        return amp.float8_store(out) if self.lowp_blk else out


_DEPTH_CFG = {
    18: (BasicBlock, [2, 2, 2, 2]),
    34: (BasicBlock, [3, 4, 6, 3]),
    50: (BottleneckBlock, [3, 4, 6, 3]),
    101: (BottleneckBlock, [3, 4, 23, 3]),
    152: (BottleneckBlock, [3, 8, 36, 3]),
}


class ResNet(nn.Module):
    """ImageNet-style ResNet over NHWC input; returns float logits in the
    input's dtype. Built in training mode (``.eval()`` for inference), on
    ``device`` (default ``"cuda"``, which raises without a card)."""

    def __init__(self, depth=50, num_classes=1000, lowp="", use_pallas=None,
                 device=DEFAULT_DEVICE, seed=0):
        super().__init__()
        data_format = "NHWC"
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        block, counts = _DEPTH_CFG[depth]
        flags = _tokens(lowp)
        self.lowp = lowp
        self.lowp_stem = "stem" in flags
        self.stem = ConvBNLayer(3, 64, 7, stride=2, act="relu",
                                data_format=data_format, stem=True,
                                lowp="bnres" if "bnres" in flags else "",
                                generator=gen)
        self.maxpool = Pool2D(3, "max", 2, 1, data_format=data_format)
        in_ch = 64
        for i, (n, ch) in enumerate(zip(counts, [64, 128, 256, 512])):
            stage = []
            for j in range(n):
                stage.append(block(in_ch, ch,
                                   stride=(1 if i == 0 else 2) if j == 0
                                   else 1,
                                   data_format=data_format, lowp=lowp,
                                   use_pallas=use_pallas, generator=gen))
                in_ch = ch * block.expansion
            setattr(self, f"stage{i}", nn.ModuleList(stage))
        stdv = 1.0 / (in_ch ** 0.5)
        self.head = Linear(in_ch, num_classes, generator=gen,
                           weight_init=I.Uniform(-stdv, stdv))
        self.to(dev)

    def forward(self, x):
        x = self.maxpool(self.stem(x))
        if self.lowp_stem:
            x = amp.float8_store(x)
        for stage in (self.stage0, self.stage1, self.stage2, self.stage3):
            for blk in stage:
                x = blk(x)
        # jnp.mean over bf16: a float32 sum, one rounding
        x = x.float().mean(dim=(1, 2)).to(x.dtype)
        return self.head(x)


def resnet18(**kw):
    return ResNet(18, **kw)


def resnet34(**kw):
    return ResNet(34, **kw)


def resnet50(**kw):
    return ResNet(50, **kw)


def resnet101(**kw):
    return ResNet(101, **kw)


def resnet152(**kw):
    return ResNet(152, **kw)
