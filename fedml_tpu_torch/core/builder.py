"""The synchronous-round body and the codec seam (PyTorch form of
``fedml_tpu/core/builder.py``'s ``build_round_core``, without LoRA, and
``wrap_codec``)."""

from __future__ import annotations

from typing import Callable

import torch

from fedml_tpu_torch.utils.pytree import tree_where


def wrap_codec(aggregator, codec, slots: int):
    """The one ``CodecAggregator`` seam: ``aggregator`` wrapped with the
    compressed update transport at ``slots`` residual rows. A no-op when
    ``codec`` is None (a round without a codec keeps its aggregator and
    state) or when the aggregator is wrapped already (``FedAvgAPI`` wraps
    before ``init_state`` and passes ``codec=None`` down)."""
    if codec is None:
        return aggregator
    from fedml_tpu_torch.codecs.transport import CodecAggregator

    if isinstance(aggregator, CodecAggregator):
        return aggregator
    return CodecAggregator(codec, aggregator, slots=slots)


def build_round_core(batched_update, aggregator) -> Callable:
    """core(gv, agg_state, x, y, counts, rng, participation, seeds, perms,
    host_counts) -> (new_gv, new_state, metrics).

    ``participation=None`` aggregates every client; a [C] mask arms the
    quarantine stage: dropped clients and clients whose update is not finite
    get weight 0 through where-zeroed rows, the metrics gain
    ``participated_count`` / ``quarantined_count``, and a round in which no
    client survives leaves globals and aggregator state unchanged."""
    from fedml_tpu_torch.algorithms.aggregators import quarantine_stage

    def core(global_variables, agg_state, x, y, counts, rng, participation,
             seeds=None, perms=None, host_counts=None):
        result = batched_update(global_variables, x, y, counts, rng, seeds,
                                perms, host_counts)
        weights = counts.float()
        if participation is None:
            new_global, new_state = aggregator(global_variables, result,
                                               weights, rng, agg_state)
            metrics = {k: v.sum() for k, v in result.metrics.items()}
            return new_global, new_state, metrics
        result, weights, alive, quarantined = quarantine_stage(
            result, weights, participation)
        new_global, new_state = aggregator(global_variables, result, weights,
                                           rng, agg_state)
        any_alive = alive.any()
        new_global = tree_where(any_alive, new_global, global_variables)
        new_state = _select_state(any_alive, new_state, agg_state)
        metrics = {k: v.sum() for k, v in result.metrics.items()}
        metrics["participated_count"] = alive.sum().float()
        metrics["quarantined_count"] = quarantined.sum().float()
        return new_global, new_state, metrics

    return core


def _select_state(pred: torch.Tensor, new_state, old_state):
    """The aggregator state ``new_state`` where the device bool ``pred``
    holds, else ``old_state``: a select on the device, so the round does
    not wait to read ``pred`` on the host. A state is a tree of dicts,
    lists and tuples of tensors (``()`` for FedAvg, FedOpt's moments)."""
    if isinstance(new_state, dict):
        return {k: _select_state(pred, v, old_state[k]) for k, v in new_state.items()}
    if isinstance(new_state, (list, tuple)):
        return type(new_state)(_select_state(pred, a, b)
                               for a, b in zip(new_state, old_state))
    return torch.where(pred, new_state, old_state)
