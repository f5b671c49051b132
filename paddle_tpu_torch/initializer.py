"""Initializers of the ResNet path (counterpart of
``paddle_tpu/initializer.py``): ``Constant``, ``Uniform`` and
``MSRANormal``. Each is called as ``init(shape, generator)`` with an
explicit ``torch.Generator`` and returns a float32 CPU tensor; the caller
moves the finished model to its device. The streams differ from the
reference's: parity tests carry its weights across
(``paddle_tpu_torch/convert.py``) instead of matching draws.
"""

from __future__ import annotations

import math

import torch


def _fans(shape):
    """(fan_in, fan_out) as the JAX ``_fans``: conv weights OIHW."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Constant:
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, generator=None, dtype=torch.float32):
        return torch.full(tuple(shape), self.value, dtype=dtype)


class Uniform:
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, generator=None, dtype=torch.float32):
        u = torch.rand(tuple(shape), generator=generator, dtype=dtype)
        return u * (self.high - self.low) + self.low


class MSRANormal:
    """He normal: std sqrt(2 / fan_in)."""

    def __call__(self, shape, generator=None, dtype=torch.float32):
        fan_in, _ = _fans(shape)
        std = math.sqrt(2.0 / fan_in)
        return std * torch.randn(tuple(shape), generator=generator,
                                 dtype=dtype)


MSRA = KaimingNormal = MSRANormal
