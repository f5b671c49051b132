"""Layers of the serving and training paths as ``nn.Module``s (counterpart
of ``paddle_tpu/nn/layers.py``): ``Linear``, ``LayerNorm``, ``Embedding``,
``Dropout``, and for ResNet ``Conv2D``, ``BatchNorm`` and ``Pool2D``.
Parameters are trainable; the serving entry points run them under
``torch.no_grad``.

Parameter names and layouts follow the JAX package so that weights carry
over by path (``paddle_tpu_torch/convert.py``): ``Linear.weight`` is stored
``[in, out]`` (``paddle_tpu/nn/layers.py:43``) and applied as ``x @ w``;
``LayerNorm`` holds float32 ``scale`` and ``bias``. Initial values are
drawn from an explicit ``torch.Generator`` on the CPU; the caller moves
the finished model to its device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from paddle_tpu_torch import amp
from paddle_tpu_torch import initializer as I
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops.activation import get_activation
from paddle_tpu_torch.ops.math import matmul


def xavier_uniform(shape, generator):
    fan_in, fan_out = shape[0], shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


class Linear(nn.Module):
    """fc: ``act(x @ w + b)``, w ``[in, out]`` cast to x's dtype per call
    as ``paddle_tpu/nn/layers.py:46`` does. ``weight_init`` is an
    initializer of ``paddle_tpu_torch/initializer.py`` (Xavier uniform by
    default)."""

    def __init__(self, in_features, out_features, act=None, bias=True,
                 generator=None, weight_init=None):
        super().__init__()
        self.act = act
        shape = (in_features, out_features)
        self.weight = nn.Parameter(
            xavier_uniform(shape, generator) if weight_init is None
            else weight_init(shape, generator))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if bias
                     else None)

    def forward(self, x):
        out = matmul(x, self.weight.to(x.dtype))
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return get_activation(self.act)(out)


class LayerNorm(nn.Module):
    """layer_norm over the trailing ``normalized_shape`` dims
    (``paddle_tpu/nn/layers.py:239-256``): float32 ``scale`` (ones) and
    ``bias`` (zeros) parameters, each absent when its flag is off.
    ``use_pallas`` routes a 2-D input normalized over its last dim to the
    forward-only kernel (``nn_ops.layer_norm``)."""

    def __init__(self, normalized_shape, epsilon=1e-5, scale=True,
                 shift=True, use_pallas=False):
        super().__init__()
        self.shape = ((normalized_shape,) if isinstance(normalized_shape, int)
                      else tuple(normalized_shape))
        self.epsilon, self.use_pallas = epsilon, use_pallas
        self.scale = nn.Parameter(torch.ones(self.shape)) if scale else None
        self.bias = nn.Parameter(torch.zeros(self.shape)) if shift else None

    def forward(self, x):
        begin = x.dim() - len(self.shape)
        return nn_ops.layer_norm(x, self.scale, self.bias,
                                 begin_norm_axis=begin, epsilon=self.epsilon,
                                 use_pallas=self.use_pallas)


class Embedding(nn.Module):
    """lookup_table (``paddle_tpu/nn/layers.py:273-288``). ``weight_init``
    is an initializer of ``paddle_tpu_torch/initializer.py``, XavierNormal
    by default as in the JAX layer."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 weight_init=None, generator=None):
        super().__init__()
        self.padding_idx = padding_idx
        weight_init = weight_init or I.XavierNormal()
        self.weight = nn.Parameter(
            weight_init((num_embeddings, embedding_dim), generator))

    def forward(self, ids):
        return nn_ops.embedding(ids, self.weight, self.padding_idx)


class Dropout(nn.Module):
    """dropout in ``upscale_in_train`` mode while ``self.training``, the
    identity otherwise. The keep mask comes from ``generator`` (a
    ``torch.Generator`` on the activations' device), or from PyTorch's
    default generator when it is None. Under remat keep the default: the
    checkpoint restores only the default generators' state for the
    recompute, so an explicit generator would draw another mask there."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return nn_ops.dropout(x, self.p, is_test=not self.training,
                              generator=self.generator)


class Conv2D(nn.Module):
    """conv2d (``paddle_tpu/nn/layers.py:56``): weight OIHW, cast to x's
    dtype per call (``:123``), so in bf16 the conv's weight gradient is
    bf16, rounded once from its float32 sum, and autograd casts it back.

    ``input_cast="e4m3"`` stores the input edge through
    ``amp.float8_store``; ``grad_cast="e5m2"`` puts
    ``amp.float8_grad_barrier`` between the conv and its activation;
    ``use_pallas`` routes through the fused kernels (None follows
    ``nn_ops.CONV_FUSED``). The int8 ``compute`` modes are not ported."""

    def __init__(self, in_channels, out_channels, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, act=None, bias=True,
                 data_format="NCHW", weight_init=None, bias_init=None,
                 input_cast=None, grad_cast=None, use_pallas=None,
                 generator=None):
        super().__init__()
        ks = (filter_size, filter_size) if isinstance(filter_size, int) \
            else tuple(filter_size)
        self.w_shape = (out_channels, in_channels // groups, *ks)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.act = groups, act
        self.data_format = data_format
        self.input_cast, self.grad_cast = input_cast, grad_cast
        self.use_pallas = use_pallas
        weight_init = weight_init or I.MSRANormal()
        self.weight = nn.Parameter(weight_init(self.w_shape, generator))
        self.bias = (nn.Parameter((bias_init or I.Constant(0.0))(
            (out_channels,), generator)) if bias else None)

    def fetch_weight(self):
        """The weight, for a parent that fuses this conv into a larger
        kernel (``ConvBNLayer``'s eval route)."""
        return self.weight

    def forward(self, x):
        if self.input_cast is not None:
            x = amp.float8_store(x)
        b = None if self.bias is None else self.bias.to(x.dtype)
        out = nn_ops.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                            self.padding, self.dilation, self.groups,
                            self.data_format,
                            None if self.grad_cast else self.act,
                            use_pallas=self.use_pallas)
        if self.grad_cast:
            # the barrier sits between conv and act, so the conv's own
            # cotangent is the fp8-stored edge
            out = get_activation(self.act)(amp.float8_grad_barrier(out))
        return out


class BatchNorm(nn.Module):
    """batch_norm (``paddle_tpu/nn/layers.py:165``): float32 ``scale`` and
    ``bias`` parameters, running ``mean`` / ``variance`` buffers, updated
    in place in training mode. ``lowp_residual`` turns on the fp8-residual
    mode for this module."""

    def __init__(self, num_channels, momentum=0.9, epsilon=1e-5, act=None,
                 data_format="NCHW", lowp_residual=False):
        super().__init__()
        self.c = num_channels
        self.momentum, self.epsilon = momentum, epsilon
        self.act, self.data_format = act, data_format
        self.lowp_residual = lowp_residual
        self.scale = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.register_buffer("mean", torch.zeros(num_channels))
        self.register_buffer("variance", torch.ones(num_channels))

    def folded_scale_bias(self):
        """The running stats folded into a per-channel affine:
        ``bn(x) == x * s + b`` in inference mode."""
        s = self.scale * torch.rsqrt(self.variance + self.epsilon)
        return s, self.bias - self.mean * s

    def forward(self, x, residual=None):
        if self.training:
            out, new_mean, new_var = nn_ops.batch_norm(
                x, self.scale, self.bias, self.mean, self.variance,
                self.epsilon, self.momentum, is_test=False,
                data_format=self.data_format, act=self.act,
                residual=residual, lowp_residual=self.lowp_residual)
            with torch.no_grad():
                self.mean.copy_(new_mean)
                self.variance.copy_(new_var)
            return out
        return nn_ops.batch_norm(x, self.scale, self.bias, self.mean,
                                 self.variance, self.epsilon, self.momentum,
                                 is_test=True, data_format=self.data_format,
                                 act=self.act, residual=residual)


class Pool2D(nn.Module):
    """pool2d (``paddle_tpu/nn/layers.py:305``)."""

    def __init__(self, pool_size=2, pool_type="max", pool_stride=None,
                 pool_padding=0, global_pooling=False, ceil_mode=False,
                 data_format="NCHW"):
        super().__init__()
        self.cfg = dict(pool_size=pool_size, pool_type=pool_type,
                        pool_stride=pool_stride, pool_padding=pool_padding,
                        global_pooling=global_pooling, ceil_mode=ceil_mode,
                        data_format=data_format)

    def forward(self, x):
        return nn_ops.pool2d(x, **self.cfg)
