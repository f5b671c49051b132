"""Carry the JAX package's Transformer parameters and optimizer state into
the port, and name the port's parameters by their JAX paths.

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

``param_tree(model)`` is the dict the port's optimizers take: every
trainable parameter under its JAX path (``enc_layers_3/attn/q_proj/weight``)
in the JAX tree's leaf order (paths sorted), the tied table under
``trg_emb/weight``. ``from_jax_opt_state`` turns a JAX optimizer state
(``{"m": tree, "v": tree, "step": int}``) into the port's state for that
dict.
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


def _jax_path(name: str):
    parts = name.split(".")
    out = []
    for p in parts:
        if p.isdigit() and out and out[-1] in ("enc_layers", "dec_layers"):
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    return tuple(out)


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


def param_tree(model):
    """{JAX path: parameter} over ``model``'s parameters, in the JAX tree's
    leaf order. A parameter registered under two names (the tied
    embedding) takes the last one, as the JAX module's retagging does."""
    names = {}
    for name, p in model.named_parameters(remove_duplicate=False):
        names[id(p)] = (_jax_path(name), p)
    return {"/".join(path): p for path, p in sorted(names.values(),
                                                    key=lambda t: t[0])}


@torch.no_grad()
def from_jax_opt_state(opt_state, params):
    """The port's optimizer state for ``params`` (``param_tree``'s dict)
    from a JAX optimizer state: each accumulator tree becomes
    ``{path: float32 tensor}`` on its parameter's device, ``step`` an int.
    Raises if a path is missing on either side."""
    state = {"step": int(np.asarray(opt_state["step"]))}
    for name, tree in opt_state.items():
        if name == "step":
            continue
        flat = {"/".join(path): v for path, v in _flatten(tree)}
        if set(flat) != set(params):
            raise KeyError(f"accumulator {name!r}: paths differ from the "
                           f"parameters' ({sorted(set(flat) ^ set(params))})")
        state[name] = {k: torch.from_numpy(np.array(flat[k], np.float32))
                       .to(p.device) for k, p in params.items()}
    return state
