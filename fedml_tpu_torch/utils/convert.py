"""Parameters of the JAX package <-> parameters of the port.

The JAX package holds a model's parameters as a nested flax tree
``{"params": {module: {submodule: {leaf: array}}}}``. The port holds them as
a flat dict of tensors keyed like a ``state_dict``
(``"module.submodule.weight"``) in PyTorch's layout. The leaves map by
kind:

  - Dense/Conv ``kernel`` <-> ``weight``: conv kernels HWIO <-> OIHW, dense
    kernels [in, out] <-> [out, in];
  - ``bias`` <-> ``bias``, as is;
  - LayerNorm ``scale`` <-> ``weight``, as is;
  - Embed ``embedding`` <-> ``weight``, as is ([num, features] on both
    sides).

Both functions accept leading batch axes (a client-stacked tree converts
leaf by leaf). The port's ``CNN_DropOut`` flattens its pooled activations
channels-last, as flax does, so the rows of ``linear_1`` keep their order.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def flax_to_torch(tree, device="cpu", dtype=torch.float32) -> dict:
    """flax params tree (numpy or jax arrays) -> {"module.weight": tensor}."""
    out = {}

    def walk(node, prefix):
        for name, value in node.items():
            if hasattr(value, "items"):  # a module's subtree (dict or FrozenDict)
                walk(value, f"{prefix}{name}.")
                continue
            a = np.asarray(value)
            if name == "kernel":
                n = a.ndim
                if n >= 4:  # [..., H, W, I, O] -> [..., O, I, H, W]
                    lead = tuple(range(n - 4))
                    a = a.transpose(lead + (n - 1, n - 2, n - 4, n - 3))
                else:  # [..., in, out] -> [..., out, in]
                    a = np.swapaxes(a, -1, -2)
            key = "bias" if name == "bias" else "weight"
            out[f"{prefix}{key}"] = torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                                 device=device)

    walk(tree.get("params", tree), "")
    return out


def leaf_kinds(module: nn.Module) -> dict:
    """{"module.weight": flax leaf name} for the weights that are not a
    Dense/Conv ``kernel``: LayerNorm ``scale`` and Embed ``embedding``."""
    kinds = {}
    for name, mod in module.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(mod, nn.LayerNorm):
            kinds[f"{prefix}weight"] = "scale"
        elif isinstance(mod, nn.Embedding):
            kinds[f"{prefix}weight"] = "embedding"
    return kinds


def torch_to_flax(state: dict, module: nn.Module | None = None) -> dict:
    """{"module.weight": tensor} -> {"params": nested tree} of numpy arrays
    (the inverse of ``flax_to_torch``). A weight is a ``kernel`` unless
    ``module`` makes it a LayerNorm ``scale`` or an Embed ``embedding``."""
    kinds = leaf_kinds(module) if module is not None else {}
    params: dict = {}
    for key, value in state.items():
        path, kind = key.rsplit(".", 1)
        a = value.detach().float().cpu().numpy()
        leaf = kinds.get(key, "kernel") if kind == "weight" else "bias"
        if leaf == "kernel":
            n = a.ndim
            if n >= 4:  # [..., O, I, H, W] -> [..., H, W, I, O]
                lead = tuple(range(n - 4))
                a = a.transpose(lead + (n - 2, n - 1, n - 3, n - 4))
            else:
                a = np.swapaxes(a, -1, -2)
        node = params
        for part in path.split("."):
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a)
    return {"params": params}


#: optax state fields that hold a tree of moments beside the params
_MOMENT_FIELDS = ("mu", "nu", "nu_max", "trace")


def optax_state_to_torch(state, device="cpu") -> dict:
    """An optax optimizer state (numpy or jax leaves) -> the port's flat
    state dict (``algorithms/engine.py::Optimizer``).

    Walks the chain's tuple of states: ``count`` becomes an int32 scalar
    tensor, the moment trees (``mu``, ``nu``, ``nu_max``, ``trace``) convert
    as parameter trees, and a bare parameter tree (``torch_adagrad``'s
    accumulator) becomes ``sum``. Empty states add nothing."""
    out: dict = {}

    def walk(node):
        if hasattr(node, "_fields"):  # an optax NamedTuple state
            for name in node._fields:
                value = getattr(node, name)
                if name == "count":
                    out["count"] = torch.tensor(np.asarray(value), dtype=torch.int32,
                                                device=device)
                elif name in _MOMENT_FIELDS:
                    out[name] = flax_to_torch(value, device=device)
                else:
                    walk(value)
        elif hasattr(node, "items"):
            out["sum"] = flax_to_torch(node, device=device)
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(state)
    return out
