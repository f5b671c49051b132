"""Load the JAX package's Transformer parameters into the port's model.

The JAX tree is a nested dict of arrays (numpy, or anything
``np.asarray`` takes), either the whole variables dict or its ``"params"``
subtree. Paths map one to one onto the port's parameter names:
``enc_layers_3/attn/q_proj/weight`` -> ``enc_layers.3.attn.q_proj.weight``.

Layouts: the port keeps the JAX layouts, so nothing is transposed here.
``Linear`` weights stay ``[in, out]`` and are applied as ``x @ w``.

Tied embedding: with ``share_embedding=True`` the JAX tree holds the table
only under ``trg_emb`` (its ``trg_emb = src_emb`` retags the shared module).
The port shares one ``Embedding`` under both names and loads it from
``trg_emb``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LAYER = re.compile(r"^(enc_layers|dec_layers)_(\d+)$")


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _port_name(path) -> str:
    parts = []
    for p in path:
        m = _LAYER.match(p)
        parts.extend([m.group(1), m.group(2)] if m else [p])
    return ".".join(parts)


@torch.no_grad()
def from_jax_variables(params, model):
    """Copy every leaf of the JAX tree into ``model``'s parameter of the
    same path, on the parameter's device and in its dtype. Raises if a
    leaf has no counterpart, a shape differs, or a port parameter is left
    without a value."""
    if "params" in params:
        params = params["params"]
    assigned = set()
    for path, value in _flatten(params):
        name = _port_name(path)
        try:
            p = model.get_parameter(name)
        except AttributeError as e:
            raise KeyError(f"JAX param {'/'.join(path)} has no counterpart "
                           f"{name!r} in the port's model") from e
        arr = np.asarray(value)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: JAX shape {arr.shape} vs "
                             f"port {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
        assigned.add(id(p))
    missing = [n for n, p in model.named_parameters() if id(p) not in assigned]
    if missing:
        raise KeyError(f"port parameters without a JAX value: {missing}")
    return model
