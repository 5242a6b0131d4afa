"""Checkpoint and resume of a run's state (the port's own format, beside
``fedml_tpu/utils/checkpoint.py``'s orbax and npz ones).

A step is a directory ``ckpt_<step>/`` holding ``tree.pt``, the state's
tree of CPU tensors (dtypes kept, bf16 and integers included) written by
``torch.save`` and read back by ``torch.load(weights_only=True)``, and a
``meta_<step>.json`` beside it written last, through ``os.replace``. Only
steps whose meta file exists are seen, so a crash mid-save leaves the
previous step as the latest. The newest ``keep`` steps are kept.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any

import torch

from fedml_tpu_torch import telemetry
from fedml_tpu_torch.utils.pytree import tree_leaves, tree_map

BACKEND = "torch"


def save_checkpoint(ckpt_dir: str, step: int, state: dict[str, Any],
                    keep: int = 3) -> str:
    """Save ``state["tree"]`` (a tree of tensors) and ``state["meta"]`` (JSON)
    as step ``step``; returns the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step}")
    os.makedirs(path, exist_ok=True)
    tree = tree_map(lambda t: t.detach().cpu(), state["tree"])
    torch.save(tree, os.path.join(path, "tree.pt"))
    meta_path = os.path.join(ckpt_dir, f"meta_{step}.json")
    tmp_path = meta_path + ".tmp"
    with open(tmp_path, "w") as f:
        json.dump({"step": step, "backend": BACKEND,
                   "meta": state.get("meta", {})}, f, default=float)
    os.replace(tmp_path, meta_path)
    for s in all_checkpoint_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"ckpt_{s}"), ignore_errors=True)
        try:
            os.remove(os.path.join(ckpt_dir, f"meta_{s}.json"))
        except FileNotFoundError:
            pass
    telemetry.emit("checkpoint_save", step=step, backend=BACKEND)
    return path


def all_checkpoint_steps(ckpt_dir: str) -> list[int]:
    """The complete steps in ``ckpt_dir`` (those with a meta file), sorted."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(name[5:-5]) for name in os.listdir(ckpt_dir)
                  if name.startswith("meta_") and name.endswith(".json"))


def restore_checkpoint(ckpt_dir: str, example_tree, step: int | None = None):
    """(tree, step, meta) of the latest step (or ``step``), or None when
    ``ckpt_dir`` holds none. ``example_tree`` gives the structure, dtypes
    and devices: the restored tree must have its leaves, and each tensor
    comes back on its example's device."""
    steps = all_checkpoint_steps(ckpt_dir)
    if not steps:
        return None
    step = steps[-1] if step is None else step
    with open(os.path.join(ckpt_dir, f"meta_{step}.json")) as f:
        meta = json.load(f)
    if meta.get("backend") != BACKEND:
        raise ValueError(
            f"checkpoint step {step} in {ckpt_dir} was written by the "
            f"{meta.get('backend')!r} backend (the JAX package's); "
            f"fedml_tpu_torch reads its own {BACKEND!r} format only")
    tree = torch.load(os.path.join(ckpt_dir, f"ckpt_{step}", "tree.pt"),
                      map_location="cpu", weights_only=True)
    got, want = tree_leaves(tree), tree_leaves(example_tree)
    if [p for p, _ in got] != [p for p, _ in want]:
        raise ValueError(
            f"checkpoint step {step} in {ckpt_dir} holds leaves "
            f"{[p for p, _ in got]}, this run's state {[p for p, _ in want]}")
    for (p, a), (_, b) in zip(got, want):
        if isinstance(b, torch.Tensor) and (a.dtype != b.dtype or a.shape != b.shape):
            raise ValueError(f"checkpoint leaf {p}: {a.dtype} {tuple(a.shape)}, "
                             f"this run's {b.dtype} {tuple(b.shape)}")
    devices = iter([b.device for _, b in want if isinstance(b, torch.Tensor)])
    tree = tree_map(lambda t: t.to(next(devices)), tree)
    return tree, step, meta.get("meta", {})


class Checkpointable:
    """Save and restore for algorithm APIs, which provide
      _ckpt_tree()           -> tree of tensors of the run state
      _ckpt_meta()           -> JSON-serialisable metadata
      _ckpt_load(tree, meta) -> installs a restored state."""

    def save_checkpoint(self, ckpt_dir: str, step: int):
        save_checkpoint(ckpt_dir, step,
                        {"tree": self._ckpt_tree(), "meta": self._ckpt_meta()})

    def maybe_restore(self, ckpt_dir: str) -> int:
        """Restore the latest checkpoint if there is one; returns the next
        round."""
        out = restore_checkpoint(ckpt_dir, self._ckpt_tree())
        if out is None:
            return 0
        tree, step, meta = out
        self._ckpt_load(tree, meta)
        logging.getLogger(__name__).info(
            "restored %s checkpoint at round %d from %s",
            type(self).__name__, step, ckpt_dir)
        return step
