"""Activations the ported paths name (counterpart of
``paddle_tpu/ops/activation.py``): identity and relu (the Transformer's
``fc1``), gelu (BERT's ``fc1`` and MLM transform) and tanh (BERT's
pooler). The rest of the table comes with the slices that use it."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


def gelu(x):
    """GELU in its tanh approximation, the JAX table's ``"gelu"``
    (``paddle_tpu/ops/activation.py:75``, ``approximate=True``)."""
    return F.gelu(x, approximate="tanh")


def _identity(x):
    return x


_ACTIVATIONS = {
    None: _identity,
    "relu": relu,
    "tanh": tanh,
    "gelu": gelu,
}


def get_activation(name):
    """Resolve an activation by name (LayerHelper.append_activation analog)."""
    if callable(name):
        return name
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}")
    return _ACTIVATIONS[name]
