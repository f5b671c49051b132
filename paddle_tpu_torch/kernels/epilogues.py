"""The conv kernels' epilogue and cotangent fold (counterpart of
``paddle_tpu/kernels/epilogues.py``).

The JAX module builds an ``Epilogue`` chain of combinators; its conv
kernels only ever build the chain ``scale -> bias -> residual -> relu``
(each optional, in that order) and its reverse, the cotangent fold
``relu mask -> scale``. The port's CUDA kernels take that chain as flags
and operands (a null pointer for an absent link), so here the chain is a
pair of plain functions: the reference of what the kernels compute, for
the CPU and for the checks on the card.

``apply`` is ``Epilogue.apply`` (``paddle_tpu/kernels/epilogues.py:128``)
on a float32 accumulator: every operand is read as float32, each link is
one rounded float32 operation, the result is cast once to ``out_dtype``.
``fold_cotangent`` is ``Epilogue.fold_cotangent`` (``:150``): the incoming
cotangent in float32, zeroed where the saved forward output is not > 0,
times the per-channel scale of the last dim, cast to the dtype of the GEMM
operand it meets. The ``quantize`` and ``dequant`` combinators have no
caller on the port's path and are not ported.
"""

from __future__ import annotations

import torch


def apply(acc, scale=None, bias=None, residual=None, relu=False,
          out_dtype=torch.float32):
    """``relu(acc * scale + bias + residual)``, each link optional, on the
    float32 accumulator ``acc``; scale and bias broadcast over the last
    dim, residual has acc's shape."""
    acc = acc.float()
    if scale is not None:
        acc = acc * scale.float()
    if bias is not None:
        acc = acc + bias.float()
    if residual is not None:
        acc = acc + residual.float()
    if relu:   # jnp.maximum's gradient: 0.5 at an exact 0
        acc = torch.maximum(acc, torch.zeros((), device=acc.device))
    return acc.to(out_dtype)


def fold_cotangent(g, mask=None, scale=None, dot_dtype=None):
    """The accumulator's cotangent from the output's: ``g`` where the
    saved output ``mask`` is > 0 (0 elsewhere), times ``scale`` over the
    last dim, cast to ``dot_dtype`` (g's dtype when None)."""
    dy = g.float()
    if mask is not None:
        dy = torch.where(mask > 0, dy, torch.zeros((), device=dy.device))
    if scale is not None:
        dy = dy * scale.float()
    return dy.to(g.dtype if dot_dtype is None else dot_dtype)
