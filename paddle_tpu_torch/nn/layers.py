"""Layers of the serving path as ``nn.Module``s (counterpart of
``paddle_tpu/nn/layers.py``).

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

from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops.activation import get_activation
from paddle_tpu_torch.ops.math import matmul


def xavier_uniform(shape, generator):
    fan_in, fan_out = shape[0], shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


def normal(shape, std, generator):
    return torch.randn(shape, generator=generator) * std


class Linear(nn.Module):
    """fc: ``act(x @ w + b)``, w ``[in, out]`` cast to x's dtype per call
    as ``paddle_tpu/nn/layers.py:46`` does."""

    def __init__(self, in_features, out_features, act=None, bias=True,
                 generator=None):
        super().__init__()
        self.act = act
        self.weight = nn.Parameter(
            xavier_uniform((in_features, out_features), generator),
            requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(out_features),
                                  requires_grad=False) if bias else None)

    def forward(self, x):
        out = matmul(x, self.weight.to(x.dtype))
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return get_activation(self.act)(out)


class LayerNorm(nn.Module):
    """Layer norm over the trailing dims, epsilon 1e-5."""

    def __init__(self, normalized_shape):
        super().__init__()
        shape = ((normalized_shape,) if isinstance(normalized_shape, int)
                 else tuple(normalized_shape))
        self.scale = nn.Parameter(torch.ones(shape), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(shape), requires_grad=False)

    def forward(self, x):
        begin = x.dim() - self.scale.dim()
        return nn_ops.layer_norm(x, self.scale, self.bias,
                                 begin_norm_axis=begin)


class Embedding(nn.Module):
    """lookup_table; ``std`` is the normal init's scale."""

    def __init__(self, num_embeddings, embedding_dim, std=None,
                 generator=None):
        super().__init__()
        if std is None:   # XavierNormal, the JAX layer's default
            std = math.sqrt(2.0 / (num_embeddings + embedding_dim))
        self.weight = nn.Parameter(
            normal((num_embeddings, embedding_dim), std, generator),
            requires_grad=False)

    def forward(self, ids):
        return nn_ops.embedding(ids, self.weight)


class Dropout(nn.Module):
    """Eval-mode dropout: the port serves and does not train yet."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return nn_ops.dropout(x, self.p, is_test=True)
