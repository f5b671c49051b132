"""Math ops of the serving path (counterpart of ``paddle_tpu/ops/math.py``)."""

from __future__ import annotations

import torch


def matmul(x, y):
    """Batched matmul (``paddle_tpu/ops/math.py:216``; the Fluid
    transpose/alpha options have no caller in the port yet). Operands stay
    in their dtype: a bf16 x bf16 product accumulates in float32 (cuBLAS
    and the CPU kernels both use a float32 accumulator) and returns bf16."""
    return torch.matmul(x, y)


def stable_argmax(scores, dim=-1):
    """Greedy-decode argmax with a deterministic tie-break
    (``paddle_tpu/ops/math.py:259``): scores collapse to bf16 and the
    LOWEST index among the maxima wins. ``torch.argmax`` promises no
    order among ties, so the tie-break is written out. A NaN score makes
    every comparison False; the sentinel ``n`` is clamped to ``n - 1`` so
    a diverged model still emits an in-range id."""
    s = scores.to(torch.bfloat16)
    m = s.amax(dim=dim, keepdim=True)   # propagates NaN, as jnp.max does
    n = s.shape[dim]
    shape = [1] * s.dim()
    shape[dim] = n
    idx = torch.arange(n, dtype=torch.int32, device=s.device).reshape(shape)
    sentinel = torch.full_like(idx, n)
    out = torch.where(s == m, idx, sentinel).amin(dim=dim)
    return out.clamp(max=n - 1).to(torch.int32)
