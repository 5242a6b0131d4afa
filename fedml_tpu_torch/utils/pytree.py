"""Arithmetic over dicts of tensors, the port's parameter trees."""

from __future__ import annotations

import torch


def tree_weighted_mean(stacked: dict, weights: torch.Tensor) -> dict:
    """Weighted mean over the leading (client) axis of every leaf.

    ``weights`` is [C] and unnormalized (per-client sample counts). An
    all-zero weight vector yields a zero mean instead of NaN."""
    w = weights / torch.clamp(weights.sum(), min=1e-12)

    def avg(leaf):
        wb = w.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)
        return (leaf * wb).sum(0)

    return {k: avg(v) for k, v in stacked.items()}


def tree_where(pred: torch.Tensor, a: dict, b: dict) -> dict:
    """Select dict ``a`` where scalar bool ``pred`` else ``b``."""
    return {k: torch.where(pred, a[k], b[k]) for k in a}


#: The leaf names of model state (flax's ``batch_stats`` collection: a
#: BatchNorm's running ``mean`` and ``var``). Every other key of a variables
#: dict is a parameter. The engine, the aggregators and the converter all
#: split a variables dict by this rule, and the models name their state
#: buffers by it.
STATE_LEAVES = frozenset({"mean", "var"})


def is_param(key: str) -> bool:
    """True for a parameter's key, False for model state."""
    return key.rpartition(".")[2] not in STATE_LEAVES


def split_variables(variables: dict) -> tuple[dict, dict]:
    """(params, state): a variables dict split by ``is_param``."""
    params = {k: v for k, v in variables.items() if is_param(k)}
    return params, {k: v for k, v in variables.items() if not is_param(k)}


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a tree of dicts, lists and tuples
    (an aggregator state, a checkpoint); other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_stack(trees: list):
    """Equal trees of dicts of tensors -> one tree, each leaf the trees'
    leaves stacked on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def tree_leaves(tree, path: str = "") -> list:
    """[(path, leaf)] of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in tree_leaves(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in tree_leaves(v, f"{path}/{i}")]
    return [(path, tree)]
