"""NN ops of the serving path (counterpart of ``paddle_tpu/ops/nn_ops.py``):
``layer_norm``, ``embedding`` and eval-mode ``dropout``."""

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


def dropout(x, dropout_prob=0.5, is_test=False):
    """dropout_op at inference with the default ``upscale_in_train``
    convention (``paddle_tpu/ops/nn_ops.py:868-875``): the identity.
    Training-mode dropout comes with the training slice."""
    if not (is_test or dropout_prob == 0.0):
        raise NotImplementedError("training-mode dropout is not ported yet")
    return x


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
