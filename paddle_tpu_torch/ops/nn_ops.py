"""NN ops of the serving and training paths (counterpart of
``paddle_tpu/ops/nn_ops.py``): ``layer_norm`` (differentiated by plain
autograd), ``embedding`` and ``dropout``."""

from __future__ import annotations

import torch


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
