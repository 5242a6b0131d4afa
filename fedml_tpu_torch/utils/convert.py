"""Parameters of the JAX package <-> parameters of the port.

The JAX package holds a model's parameters as a flax tree
``{"params": {layer: {"kernel": ..., "bias": ...}}}`` with conv kernels in
HWIO and dense kernels as [in, out]. The port holds them as a flat dict of
tensors keyed like a ``state_dict`` (``"layer.weight"``, ``"layer.bias"``)
in PyTorch's layout: conv weights OIHW, linear weights [out, in].

Both functions accept leading batch axes (a client-stacked tree converts
leaf by leaf). Dense kernels are transposed and nothing else: the port's
``CNN_DropOut`` flattens its pooled activations channels-last, as flax does,
so the rows of ``linear_1`` keep their order.
"""

from __future__ import annotations

import numpy as np
import torch


def flax_to_torch(tree, device="cpu", dtype=torch.float32) -> dict:
    """flax params tree (numpy or jax arrays) -> {"layer.weight": tensor}."""
    params = tree.get("params", tree)
    out = {}
    for layer, leaves in params.items():
        kernel = np.asarray(leaves["kernel"])
        n = kernel.ndim
        if n >= 4:  # [..., H, W, I, O] -> [..., O, I, H, W]
            lead = tuple(range(n - 4))
            kernel = kernel.transpose(lead + (n - 1, n - 2, n - 4, n - 3))
        else:  # [..., in, out] -> [..., out, in]
            kernel = np.swapaxes(kernel, -1, -2)
        out[f"{layer}.weight"] = torch.tensor(np.ascontiguousarray(kernel),
                                              dtype=dtype, device=device)
        out[f"{layer}.bias"] = torch.tensor(np.asarray(leaves["bias"]),
                                            dtype=dtype, device=device)
    return out


def torch_to_flax(state: dict) -> dict:
    """{"layer.weight": tensor} -> {"params": {layer: {"kernel", "bias"}}}
    of numpy arrays (the inverse of ``flax_to_torch``)."""
    params: dict = {}
    for key, value in state.items():
        layer, kind = key.rsplit(".", 1)
        a = value.detach().float().cpu().numpy()
        n = a.ndim
        if kind == "weight":
            if n >= 4:  # [..., O, I, H, W] -> [..., H, W, I, O]
                lead = tuple(range(n - 4))
                a = a.transpose(lead + (n - 2, n - 1, n - 3, n - 4))
            else:
                a = np.swapaxes(a, -1, -2)
            params.setdefault(layer, {})["kernel"] = np.ascontiguousarray(a)
        else:
            params.setdefault(layer, {})["bias"] = a
    return {"params": params}
