"""Mmap-backed spill store for evicted tenant snapshots (PyTorch form of
``fedml_tpu/serving/evict_store.py``).

``Job.evict()`` moves a tenant's whole checkpoint surface to the host: the
globals (adapters only under LoRA), the aggregator (and codec residual)
state, the buffered runner's K-row buffer, birth tags and pending arrivals,
the guard's loss window. Holding many evicted tenants' snapshots as live
host tensors in the scheduler's process is the RSS failure the packed store
avoids, so the store spills every array leaf of a snapshot into ONE packed
binary per tenant (``<name>.bin``, the format of ``utils/packed_leaves.py``)
with a JSON manifest of (offset, dtype, shape) entries, and ``load()``
hands the leaves back as ``np.memmap`` views, which the OS pages in when
``Job.resume()`` copies them to the device. A resumed tenant's bytes equal
an in-memory round trip's.

Tensors leave as numpy arrays of their own dtype (bfloat16 as its int16
bits) and come back as CPU tensors of that dtype. Only array leaves go out
of line; the snapshot's small host structure (arrival schedules, counters,
the nesting itself) stays in memory: it is O(cohort), not O(model). The
store frees the DEVICE (the tenant's slot on the card), not the scheduler's
address space.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from fedml_tpu_torch.utils.packed_leaves import load_leaves, spill_leaves


def _flatten(node, leaves: list):
    """(skeleton, with ``leaves`` appended): tensors and arrays become
    numbered leaves; dicts, lists and tuples keep their nesting; anything
    else stays inline in the skeleton."""
    if isinstance(node, torch.Tensor):
        t = node.detach().cpu()
        dtype = str(t.dtype)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        leaves.append(t.numpy())
        return ("tensor", len(leaves) - 1, dtype)
    if isinstance(node, np.ndarray):
        leaves.append(node)
        return ("array", len(leaves) - 1)
    if isinstance(node, dict):
        return ("dict", [(k, _flatten(v, leaves)) for k, v in node.items()])
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, [_flatten(v, leaves) for v in node])
    return ("value", node)


def _unflatten(skeleton, leaves: list):
    kind = skeleton[0]
    if kind == "tensor":
        dtype = getattr(torch, skeleton[2].replace("torch.", ""))
        t = torch.from_numpy(np.array(leaves[skeleton[1]]))
        return t.view(dtype) if dtype == torch.bfloat16 else t
    if kind == "array":
        return leaves[skeleton[1]]
    if kind == "dict":
        return {k: _unflatten(v, leaves) for k, v in skeleton[1]}
    if kind in ("list", "tuple"):
        items = [_unflatten(v, leaves) for v in skeleton[1]]
        return items if kind == "list" else tuple(items)
    return skeleton[1]


class EvictionStore:
    """One spill directory; tenants addressed by job name (evicting a name
    again overwrites its previous spill). The bytes are the packed-leaf
    format the adapter bank also writes."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        # name -> (skeleton, inline leaves with None placeholders, manifest)
        self._index: Dict[str, Tuple[Any, list, dict]] = {}

    def save(self, name: str, snapshot: Any) -> dict:
        """Spill ``snapshot``'s array leaves to ``<name>.bin``; returns the
        manifest (also written as ``<name>.json`` for inspection)."""
        leaves: list = []
        skeleton = _flatten(snapshot, leaves)
        bin_path = os.path.join(self.root, f"{name}.bin")
        entries, inline, offset = spill_leaves(bin_path, leaves)
        manifest = {"bin": bin_path, "bytes": offset, "arrays": entries}
        with open(os.path.join(self.root, f"{name}.json"), "w") as f:
            json.dump(manifest, f)
        self._index[name] = (skeleton, inline, manifest)
        return manifest

    def load(self, name: str) -> Any:
        """Rehydrate ``name``'s snapshot: tensors come back as CPU tensors
        read from the packed binary's pages, arrays as read-only
        ``np.memmap`` views."""
        skeleton, inline, manifest = self._index.pop(name)
        leaves = load_leaves(manifest["bin"], manifest["arrays"], inline)
        return _unflatten(skeleton, leaves)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __len__(self) -> int:
        return len(self._index)
