"""Server aggregation (PyTorch form of the FedAvg part of
``fedml_tpu/algorithms/aggregators.py``).

An aggregator is a callable
    (global_variables, LocalResult, weights, rng, state) -> (new_global, state)
where ``LocalResult.variables`` is a dict of client-stacked tensors [C, ...].
Only FedAvg is ported; FedOpt, robust and FedNova are in ROADMAP.md Queue 1.
"""

from __future__ import annotations

from typing import Any

import torch

from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.utils.pytree import tree_weighted_mean


def client_finite_mask(stacked: dict) -> torch.Tensor:
    """[C] bool: every floating leaf of client c's stacked update is finite."""
    leaves = [v for v in stacked.values() if v.is_floating_point()]
    first = next(iter(stacked.values()))
    if not leaves:
        return torch.ones(first.shape[0], dtype=torch.bool, device=first.device)
    per_leaf = [torch.isfinite(v.reshape(v.shape[0], -1)).all(1) for v in leaves]
    return torch.stack(per_leaf).all(0)


def quarantine_stage(result, weights, participation):
    """Compose the participation mask with per-client finiteness and zero
    the dead rows before aggregation.

    Returns (safe_result, masked_weights, alive, quarantined). Dead rows are
    zeroed with ``torch.where``, never by a zero weight: NaN * 0 is NaN, so
    one poisoned client would contaminate every weighted sum."""
    participation = participation.to(torch.bool)
    alive = participation & client_finite_mask(result.variables)
    quarantined = participation & ~alive

    def zero_dead(leaf):
        keep = alive.reshape((-1,) + (1,) * (leaf.dim() - 1))
        return torch.where(keep, leaf, torch.zeros((), dtype=leaf.dtype,
                                                   device=leaf.device))

    safe = result._replace(
        variables={k: zero_dead(v) for k, v in result.variables.items()},
        metrics={k: zero_dead(v) for k, v in result.metrics.items()})
    masked = torch.where(alive, weights, torch.zeros((), dtype=weights.dtype,
                                                     device=weights.device))
    return safe, masked, alive, quarantined


class FedAvgAggregator:
    """Sample-weighted mean over every variable (reference
    FedAVGAggregator.py:58-87)."""

    def __init__(self, cfg: FedConfig):
        self.cfg = cfg

    def init_state(self, global_variables) -> Any:
        return ()

    def __call__(self, global_variables, result, weights, rng, state):
        return tree_weighted_mean(result.variables, weights), state


AGGREGATORS = {"fedavg": FedAvgAggregator}


def make_aggregator(name: str, cfg: FedConfig):
    if name not in AGGREGATORS:
        raise NotImplementedError(
            f"aggregator {name!r} is not ported to fedml_tpu_torch yet "
            f"(ported: {sorted(AGGREGATORS)})")
    return AGGREGATORS[name](cfg)
