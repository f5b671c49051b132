"""float8 storage markers (counterpart of ``float8_store`` and
``float8_grad_barrier`` in ``paddle_tpu/amp/__init__.py``; the rest of the
JAX ``amp`` package is not ported).

``float8_store(x)`` rounds x through e4m3 (and back to x's dtype), so the
edge it marks holds only values an fp8 copy can hold; its backward rounds
the cotangent through e5m2 at a fixed scale of 256 with the clip at e5m2's
largest value. ``float8_grad_barrier(y)`` is the identity whose backward
does the same to the cotangent. Both are ``autograd.Function``s.

The port keeps JAX's conversion exactly: round to nearest even, and a
value beyond e4m3's range (|x| > 464, the midpoint above the largest
finite 448) becomes NaN, as ml_dtypes' cast gives; PyTorch's own cast
saturates to 448 there, so ``to_e4m3_round_trip`` writes the NaN out.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
#: above this magnitude e4m3's round-to-nearest-even overflows
E4M3_OVERFLOW = 464.0
GRAD_SCALE = 256.0


def to_e4m3_round_trip(x):
    """x through float8_e4m3fn and back, NaN beyond e4m3's range."""
    y = x.to(torch.float8_e4m3fn).to(x.dtype)
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    return torch.where(x.abs() > E4M3_OVERFLOW, torch.copysign(nan, x), y)


def e5m2_grad_store(g, scale=GRAD_SCALE):
    """clip(g * s) -> e5m2 -> / s, in g's dtype (the scale is a power of
    two, so the multiply and divide are exact)."""
    s = torch.tensor(scale, dtype=g.dtype, device=g.device)
    scaled = torch.clamp(g * s, -E5M2_MAX, E5M2_MAX)
    return scaled.to(torch.float8_e5m2).to(g.dtype) / s


class _Float8Store(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return to_e4m3_round_trip(x)

    @staticmethod
    def backward(ctx, g):
        return e5m2_grad_store(g)


class _Float8GradBarrier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale):
        ctx.scale = scale
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return e5m2_grad_store(g, ctx.scale), None


def float8_store(x):
    """Round-trip ``x`` through e4m3 (see the module docstring)."""
    return _Float8Store.apply(x)


def float8_grad_barrier(y, scale=GRAD_SCALE):
    """Identity forward; the cotangent is stored through e5m2 at the fixed
    ``scale``. The JAX function's dynamic-scale mode (``scale=None``) has
    no caller on the port's path and is not ported."""
    if scale is None:
        raise NotImplementedError("the dynamic-scale barrier is not ported")
    return _Float8GradBarrier.apply(y, float(scale))


__all__ = ["float8_store", "float8_grad_barrier", "to_e4m3_round_trip"]
