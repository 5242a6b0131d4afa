"""Variables of the JAX package <-> variables of the port.

The JAX package holds a model's variables as a nested flax tree
``{"params": {module: {submodule: {leaf: array}}}, "batch_stats": {...}}``.
The port holds them as a flat dict of tensors keyed like a ``state_dict``
(``"module.submodule.weight"``) in PyTorch's layout. The leaves map by
kind:

  - Dense/Conv ``kernel`` <-> ``weight``: 2-D conv kernels HWIO <-> OIHW,
    1-D conv kernels WIO <-> OIW, dense kernels [in, out] <-> [out, in]; a
    depthwise kernel (flax ``feature_group_count=C``, [kh, kw, 1, C]) is
    the same transpose, to a ``groups=C`` conv's [C, 1, kh, kw] and back
    (the I axis holds the input channels of one group); a flax
    ``ConvTranspose`` kernel [kh, kw, in, out] takes the conv rule too, to
    ``models/segmentation.py::ConvTranspose``'s [out, in, kh, kw] (the
    kernel it correlates with the zero-inserted input, unflipped);
  - ``bias`` <-> ``bias``, as is;
  - LayerNorm, GroupNorm and BatchNorm ``scale`` <-> ``weight``, as is;
  - Embed ``embedding`` <-> ``weight``, as is ([num, features] on both
    sides);
  - ``batch_stats``' ``mean`` and ``var`` <-> the state buffers ``mean``
    and ``var`` under the same path (``utils/pytree.py::STATE_LEAVES``);
  - an ``OptimizedLSTMCell``'s eight gate kernels (input ``ii, if, ig, io``
    [in, H], no bias; hidden ``hi, hf, hg, ho`` [H, H] with bias) <->
    ``weight_ih`` [4H, in], ``weight_hh`` [4H, H] and ``bias`` [4H], each
    the gates' transposed kernels or biases stacked in the order i, f, g, o.

LoRA (``models/lora.py``): the ``lora_base`` collection, a frozen params
tree, converts as one and lands under the ``lora_base/`` prefix; an
adapter node ``{"lora_A": [d_in, r], "lora_B": [r, d_out]}`` where a
``kernel`` was is copied as is (the port keeps flax's adapter layout) to
``<layer>.weight.lora_A`` and ``.lora_B``; an LSTM cell's gate adapters
(``cell/ii/kernel``, ...) land under ``cell.ii.weight.lora_A`` and back
(``models/lora.py::gate_key``).

Both functions accept leading batch axes (a client-stacked tree converts
leaf by leaf). Without ``module`` a kernel of 4 or more axes is a 2-D conv
kernel and any other a dense one; with it, each kernel's own rank comes from
the module's parameter, which 1-D convs and stacked trees need. The port's
CNNs flatten their pooled activations channels-last, as flax does, so
dense rows keep their order.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from fedml_tpu_torch.utils.pytree import STATE_LEAVES

_GATES = ("i", "f", "g", "o")


def _kernel_to_torch(a: np.ndarray, rank: int) -> np.ndarray:
    """flax kernel [..., *spatial, I, O] -> [..., O, I, *spatial] (rank 3
    or 4), or [..., in, out] -> [..., out, in]."""
    n = a.ndim
    lead = tuple(range(n - rank))
    if rank >= 3:
        spatial = tuple(range(n - rank, n - 2))
        return a.transpose(lead + (n - 1, n - 2) + spatial)
    return np.swapaxes(a, -1, -2)


def _kernel_to_flax(a: np.ndarray, rank: int) -> np.ndarray:
    """The inverse of ``_kernel_to_torch``."""
    n = a.ndim
    lead = tuple(range(n - rank))
    if rank >= 3:
        spatial = tuple(range(n - rank + 2, n))
        return a.transpose(lead + spatial + (n - rank + 1, n - rank))
    return np.swapaxes(a, -1, -2)


def _param_ranks(module: nn.Module | None) -> dict:
    if module is None:
        return {}
    named = dict(module.named_parameters())
    named.update(module.named_buffers())
    return {k: v.dim() for k, v in named.items()}


def flax_to_torch(tree, device="cpu", dtype=torch.float32, module=None) -> dict:
    """flax variables tree (numpy or jax arrays; ``params`` and
    ``batch_stats``) -> {"module.weight": tensor}."""
    ranks = _param_ranks(module)
    out = {}

    def put(key, a):
        out[key] = torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    def walk(node, prefix):
        if (set(node) == {f"{d}{g}" for d in "ih" for g in _GATES}
                and not hasattr(node["ii"]["kernel"], "items")):  # an LSTM cell
            put(f"{prefix}weight_ih", np.concatenate(
                [np.swapaxes(np.asarray(node[f"i{g}"]["kernel"]), -1, -2) for g in _GATES], -2))
            put(f"{prefix}weight_hh", np.concatenate(
                [np.swapaxes(np.asarray(node[f"h{g}"]["kernel"]), -1, -2) for g in _GATES], -2))
            put(f"{prefix}bias", np.concatenate(
                [np.asarray(node[f"h{g}"]["bias"]) for g in _GATES], -1))
            return
        for name, value in node.items():
            if name == "kernel" and hasattr(value, "items"):  # a LoRA adapter
                for leaf in ("lora_A", "lora_B"):
                    put(f"{prefix}weight.{leaf}", np.asarray(value[leaf]))
                continue
            if hasattr(value, "items"):  # a module's subtree (dict or FrozenDict)
                walk(value, f"{prefix}{name}.")
                continue
            a = np.asarray(value)
            key = name if name in ("bias",) + tuple(STATE_LEAVES) else "weight"
            if name == "kernel":
                rank = ranks.get(f"{prefix}weight", 4 if a.ndim >= 4 else 2)
                a = _kernel_to_torch(a, rank)
            put(f"{prefix}{key}", a)

    if "params" in tree or "batch_stats" in tree:
        walk(tree.get("params", {}), "")
        walk(tree.get("batch_stats", {}), "")
    else:
        walk(tree, "")
    if "lora_base" in tree:
        base = flax_to_torch(tree["lora_base"], device, dtype, module)
        out.update({f"lora_base/{k}": v for k, v in base.items()})
    return out


def leaf_kinds(module: nn.Module) -> dict:
    """{"module.weight": flax leaf name} for the weights that are not a
    Dense/Conv ``kernel``: a norm's ``scale`` and Embed's ``embedding``."""
    kinds = {}
    for name, mod in module.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(mod, nn.LayerNorm) or getattr(mod, "flax_leaf", None) == "scale":
            kinds[f"{prefix}weight"] = "scale"
        elif isinstance(mod, nn.Embedding):
            kinds[f"{prefix}weight"] = "embedding"
    return kinds


def torch_to_flax(state: dict, module: nn.Module | None = None) -> dict:
    """{"module.weight": tensor} -> {"params": nested tree[, "batch_stats":
    nested tree]} of numpy arrays (the inverse of ``flax_to_torch``). A
    weight is a ``kernel`` unless ``module`` makes it a norm's ``scale`` or
    an Embed ``embedding``."""
    kinds = leaf_kinds(module) if module is not None else {}
    ranks = _param_ranks(module)
    trees: dict = {"params": {}}

    def node_at(collection, path):
        node = trees.setdefault(collection, {})
        for part in path.split("."):
            node = node.setdefault(part, {})
        return node

    base = {k[len("lora_base/"):]: v for k, v in state.items()
            if k.startswith("lora_base/")}
    if base:
        trees["lora_base"] = torch_to_flax(base, module)["params"]
    for key, value in state.items():
        if key.startswith("lora_base/"):
            continue
        path, kind = key.rsplit(".", 1)
        a = value.detach().float().cpu().numpy()
        if kind in ("lora_A", "lora_B"):  # an adapter, in flax's layout already
            node_at("params", path.rpartition(".")[0]).setdefault(
                "kernel", {})[kind] = np.ascontiguousarray(a)
            continue
        if kind in STATE_LEAVES:
            node_at("batch_stats", path)[kind] = np.ascontiguousarray(a)
            continue
        node = node_at("params", path)
        if kind in ("weight_ih", "weight_hh", "bias") and f"{path}.weight_hh" in state:
            side = {"weight_ih": "i", "weight_hh": "h", "bias": "h"}[kind]
            leaf = "bias" if kind == "bias" else "kernel"
            for g, part in zip(_GATES, np.split(a, 4, axis=-1 if kind == "bias" else -2)):
                if leaf == "kernel":
                    part = np.swapaxes(part, -1, -2)
                node.setdefault(f"{side}{g}", {})[leaf] = np.ascontiguousarray(part)
            continue
        leaf = kinds.get(key, "kernel") if kind == "weight" else "bias"
        if leaf == "kernel":
            a = _kernel_to_flax(a, ranks.get(key, 4 if a.ndim >= 4 else 2))
        node[leaf] = np.ascontiguousarray(a)
    return trees


#: optax state fields that hold a tree of moments beside the params
_MOMENT_FIELDS = ("mu", "nu", "nu_max", "trace")


def optax_state_to_torch(state, device="cpu", names=None) -> dict:
    """An optax optimizer state (numpy or jax leaves) -> the port's flat
    state dict (``algorithms/engine.py::Optimizer``).

    Walks the chain's tuple of states: ``count`` becomes an int32 scalar
    tensor, the moment trees (``mu``, ``nu``, ``nu_max``, ``trace``) convert
    as parameter trees, and a bare parameter tree (``torch_adagrad``'s
    accumulator) becomes ``sum``. Empty states add nothing. A moment that
    is a tuple of arrays (FedNAS's alphas, ``(normal, reduce)``) becomes a
    dict under ``names``, one key an array, each array as it is."""
    out: dict = {}

    def moment(value):
        if isinstance(value, (tuple, list)):
            if names is None or len(names) != len(value):
                raise ValueError(f"a moment of {len(value)} arrays needs as many names, "
                                 f"not {names!r}")
            return {k: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
                    for k, a in zip(names, value)}
        return flax_to_torch(value, device=device)

    def walk(node):
        if hasattr(node, "_fields"):  # an optax NamedTuple state
            for name in node._fields:
                value = getattr(node, name)
                if name == "count":
                    out["count"] = torch.tensor(np.asarray(value), dtype=torch.int32,
                                                device=device)
                elif name in _MOMENT_FIELDS:
                    out[name] = moment(value)
                else:
                    walk(value)
        elif hasattr(node, "items"):
            out["sum"] = flax_to_torch(node, device=device)
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(state)
    return out
