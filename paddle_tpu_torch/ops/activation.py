"""Activations the serving path names (counterpart of
``paddle_tpu/ops/activation.py``): identity and relu, the FFN's ``fc1``
activation. The rest of the table comes with the slices that use it."""

from __future__ import annotations

import torch


def relu(x):
    return torch.relu(x)


def _identity(x):
    return x


_ACTIVATIONS = {
    None: _identity,
    "relu": relu,
}


def get_activation(name):
    """Resolve an activation by name (LayerHelper.append_activation analog)."""
    if callable(name):
        return name
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}")
    return _ACTIVATIONS[name]
