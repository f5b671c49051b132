"""Dtype names <-> ``torch.dtype`` (counterpart of
``paddle_tpu/core/dtypes.py``).

bfloat16 is first-class: it is the compute dtype of the serving config.
The two float8 formats hold the fp8 storage edges of the ResNet path
(``paddle_tpu_torch/amp``).
"""

from __future__ import annotations

import torch

_DTYPES = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}

_NAMES = {v: k for k, v in _DTYPES.items()}


def convert_dtype(dtype) -> torch.dtype:
    """Normalize a name or ``torch.dtype`` to a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype in _DTYPES:
        return _DTYPES[dtype]
    raise ValueError(f"unknown dtype {dtype!r}")


def dtype_name(dtype) -> str:
    return _NAMES[convert_dtype(dtype)]
