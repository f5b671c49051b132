"""Carry the JAX package's parameters (and BatchNorm state) and optimizer
state into the port, and name the port's parameters by their JAX paths.

The JAX tree is a nested dict of arrays (numpy, or anything
``np.asarray`` takes), either the whole variables dict (``{"params": ...,
"state": ...}``) or its ``"params"`` subtree. Paths map one to one onto the
port's parameter and buffer names: ``enc_layers_3/attn/q_proj/weight`` ->
``enc_layers.3.attn.q_proj.weight``, ``stage0_1/conv0/bn/mean`` ->
``stage0.1.conv0.bn.mean`` (a ResNet's running stats, from ``"state"``).

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

_LAYER = re.compile(r"^(enc_layers|dec_layers|stage\d+)_(\d+)$")
_LISTS = re.compile(r"^(enc_layers|dec_layers|stage\d+)$")


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
        if p.isdigit() and out and _LISTS.match(out[-1]):
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


def _copy_tree(tree, get, what):
    """Copy every leaf of ``tree`` into ``get(port name)``; returns the ids
    of the tensors assigned."""
    assigned = set()
    for path, value in _flatten(tree):
        name = _port_name(path)
        try:
            t = get(name)
        except AttributeError as e:
            raise KeyError(f"JAX {what} {'/'.join(path)} has no counterpart "
                           f"{name!r} in the port's model") from e
        arr = np.asarray(value)
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{'/'.join(path)}: JAX shape {arr.shape} vs "
                             f"port {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
        assigned.add(id(t))
    return assigned


@torch.no_grad()
def from_jax_variables(variables, model):
    """Copy every leaf of the JAX tree into ``model``'s parameter (and,
    from ``"state"``, buffer) of the same path, on its device and in its
    dtype. Raises if a leaf has no counterpart, a shape differs, or a port
    parameter (or, when a state is given, a persistent buffer) is left
    without a value."""
    params = variables["params"] if "params" in variables else variables
    assigned = _copy_tree(params, model.get_parameter, "param")
    missing = [n for n, p in model.named_parameters() if id(p) not in assigned]
    if "state" in variables:
        done = _copy_tree(variables["state"], model.get_buffer, "state")
        missing += [n for n, b in model.named_buffers()
                    if id(b) not in done and _persistent(model, n)]
    if missing:
        raise KeyError(f"port tensors without a JAX value: {missing}")
    return model


def _persistent(model, name):
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    return leaf not in mod._non_persistent_buffers_set


@torch.no_grad()
def state_tree(model):
    """{JAX path: buffer} over ``model``'s persistent buffers (a ResNet's
    BN running stats: the JAX ``"state"`` collection), paths sorted."""
    out = {}
    for name, b in model.named_buffers():
        if _persistent(model, name):
            out["/".join(_jax_path(name))] = b
    return dict(sorted(out.items()))


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
