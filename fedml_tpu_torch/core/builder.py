"""The synchronous-round bodies and the codec seam (PyTorch form of
``fedml_tpu/core/builder.py``'s ``build_round_core``,
``build_personal_round_core`` and ``wrap_codec``)."""

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


def build_round_core(batched_update, aggregator, collect_stats: bool = False) -> Callable:
    """core(gv, agg_state, x, y, counts, rng, participation, seeds, perms,
    host_counts, stats=collect_stats) -> (new_gv, new_state, metrics, stats
    or None).

    ``participation=None`` aggregates every client; a [C] mask arms the
    quarantine stage: dropped clients and clients whose update is not finite
    get weight 0 through where-zeroed rows, the metrics gain
    ``participated_count`` / ``quarantined_count``, and a round in which no
    client survives leaves globals and aggregator state unchanged.

    ``stats`` (by default ``collect_stats``) computes the client ledger's
    per-client rows (``engine.cohort_stats``) from the raw results before
    the quarantine, so a poisoned update stays visible in the ledger. They
    only read the results: the other outputs are the same bits either way. Under LoRA
    the aggregator sees the stripped globals and the adapters-only results,
    and the server's frozen base re-attaches to its output."""
    from fedml_tpu_torch.algorithms.engine import cohort_stats
    from fedml_tpu_torch.models.lora import attach_lora_base, strip_lora_base

    def core(global_variables, agg_state, x, y, counts, rng, participation,
             seeds=None, perms=None, host_counts=None, stats=collect_stats):
        result = batched_update(global_variables, x, y, counts, rng, seeds,
                                perms, host_counts)
        new_global, new_state, metrics, _ = _aggregate(
            aggregator, global_variables, agg_state, result, counts, rng, participation)
        rows = cohort_stats(strip_lora_base(global_variables), result) if stats else None
        return attach_lora_base(new_global, global_variables), new_state, metrics, rows

    return core


def build_personal_round_core(batched_update, aggregator,
                              collect_stats: bool = False) -> Callable:
    """The personalized round's body: ``build_round_core``'s plus a trailing
    [C, ...]-stacked ``personal`` adapter tree in and the updated rows out,
    UNAGGREGATED. The personal rows never reach the aggregator; they ride
    the outputs as the ledger's stats do and scatter back into the mmap bank
    on the host. ``batched_update(gv, x, y, counts, rng, seeds, perms,
    host_counts, personal) -> (LocalResult, new_personal)``
    (``engine._batched_update(..., personal=True)``).

    Returns core(gv, agg_state, x, y, counts, rng, participation, personal,
    seeds, perms, host_counts, stats=collect_stats) -> (new_gv, new_state,
    metrics, stats or None, new_personal). Under the chaos mask a dropped
    or quarantined client's personal row passes through UNCHANGED: its bank
    row must not absorb a poisoned or never-run update."""
    from fedml_tpu_torch.algorithms.engine import cohort_stats
    from fedml_tpu_torch.models.lora import attach_lora_base, strip_lora_base

    def core(global_variables, agg_state, x, y, counts, rng, participation, personal,
             seeds=None, perms=None, host_counts=None, stats=collect_stats):
        result, new_personal = batched_update(global_variables, x, y, counts, rng, seeds,
                                              perms, host_counts, personal)
        new_global, new_state, metrics, alive = _aggregate(
            aggregator, global_variables, agg_state, result, counts, rng, participation)
        rows = cohort_stats(strip_lora_base(global_variables), result) if stats else None
        if alive is not None:
            new_personal = {
                k: torch.where(alive.reshape((-1,) + (1,) * (n.dim() - 1)), n, personal[k])
                for k, n in new_personal.items()}
        return (attach_lora_base(new_global, global_variables), new_state, metrics, rows,
                new_personal)

    return core


def _aggregate(aggregator, global_variables, agg_state, result, counts, rng,
               participation):
    """The round's aggregation stage over a stacked result: (new_global
    without the LoRA base, new_state, metrics, the [C] alive mask or None
    without a participation mask)."""
    from fedml_tpu_torch.algorithms.aggregators import quarantine_stage
    from fedml_tpu_torch.models.lora import strip_lora_base

    trained = strip_lora_base(global_variables)
    weights = counts.float()
    if participation is None:
        new_global, new_state = aggregator(trained, result, weights, rng, agg_state)
        metrics = {k: v.sum() for k, v in result.metrics.items()}
        return new_global, new_state, metrics, None
    result, weights, alive, quarantined = quarantine_stage(
        result, weights, participation)
    new_global, new_state = aggregator(trained, result, weights, rng, agg_state)
    any_alive = alive.any()
    new_global = tree_where(any_alive, new_global, trained)
    new_state = _select_state(any_alive, new_state, agg_state)
    metrics = {k: v.sum() for k, v in result.metrics.items()}
    metrics["participated_count"] = alive.sum().float()
    metrics["quarantined_count"] = quarantined.sum().float()
    return new_global, new_state, metrics, alive


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
