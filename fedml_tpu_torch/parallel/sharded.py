"""The clients-sharded federated round over a ``torch.distributed`` process
group (PyTorch form of ``fedml_tpu/parallel/sharded.py``).

The JAX package runs one ``shard_map`` program: each device trains its
shard of the round's clients and the aggregator's ``sharded`` rule reduces
locally weighted partial sums with ``psum``. The port runs one process a
rank: each rank stages only its block of the cohort
(``parallel/multihost.py::sample_sharded_cohort`` and
``stage_local_cohort``), trains it with the engine's client step, and the
aggregator's ``sharded`` rule all-reduces the partial sums over the group
(``parallel/mesh.py::all_reduce_tree``). Every rank then holds the same
globals.

Equivalence: every rank draws the real cohort's permutations and dropout
seeds from the round generator, as the single-device round does, and takes
its block of them (``core/builder.py::shard_key_slice``), so each client's
local training is the single-device round's bit for bit; the aggregation
reassociates the weighted sum across ranks, equal to the single-device
round up to float summation order (the JAX bound, <= 1e-6,
``tests/test_torch_parallel.py``).

Verified on the CPU over gloo and on one H100 with two gloo ranks on the
card and a one-rank nccl group; a run over several GPUs with one nccl rank
each is not verified (the card's machine has one GPU).
"""

from __future__ import annotations

from typing import Callable

import torch

from fedml_tpu_torch.algorithms.aggregators import quarantine_stage
from fedml_tpu_torch.algorithms.engine import LocalResult, _batched_update, cohort_stats
from fedml_tpu_torch.core.builder import masked_psum_tail, shard_key_slice
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.models.lora import attach_lora_base, strip_lora_base
from fedml_tpu_torch.parallel.mesh import Mesh, all_reduce_tree


def build_sharded_round_fn(trainer, cfg: FedConfig, aggregator, mesh: Mesh,
                           collect_stats: bool = False) -> Callable:
    """The sharded round, with ``engine.build_round_fn``'s signature:

        round_fn(gv, agg_state, x, y, counts, rng, participation=None,
                 seeds=None, perms=None, host_counts=None, stats=collect_stats)
            -> (new_global, agg_state, metrics[, stats])

    ``x``/``y``/``counts`` (and ``participation``) are THIS rank's block of
    the padded cohort, rows ``[rank * block, (rank + 1) * block)``; pad rows
    have zero counts and are weight-0 no-ops in every aggregator.
    ``host_counts`` is the REAL cohort's host counts, the same on every rank
    (the draws are the whole cohort's); injected ``seeds``/``perms`` are the
    real cohort's too. The metrics are summed over the group; the stats
    rows (``collect_stats``) are this rank's block.

    ``participation`` arms the quarantine stage as in the single-device
    round, and ``core/builder.py::masked_psum_tail`` then all-reduces the
    alive and quarantined counts and passes the globals and the state
    through when the whole cohort is dead. A codec-wrapped aggregator's
    residual rows are this rank's block (``codecs/transport.py``)."""
    if cfg.fused_kernel:
        raise ValueError(
            "--fused_kernel drives the single-chip vmap engine — the kernel owns the "
            "whole client step and has no shard_map lowering; drop one of "
            "fused_kernel / backend='shard_map'")
    batched = _batched_update(trainer, cfg)
    device = mesh.device

    def round_fn(global_variables, agg_state, x, y, counts, rng, participation=None,
                 seeds=None, perms=None, host_counts=None, stats=collect_stats):
        if host_counts is None:
            raise ValueError("the sharded round needs the real cohort's host counts "
                             "(host_counts): every rank draws the whole cohort's randomness")
        x, y, counts = x.to(device), y.to(device), counts.to(device)
        block = x.shape[0]
        local_seeds, local_perms, local_counts = shard_key_slice(
            rng, host_counts, x.shape[1], cfg.epochs, cfg.shuffle, mesh.rank, block,
            seeds, perms)
        # the draws above are the round's; the client step's own draw goes
        # to a throwaway generator, so the round generator is left where
        # the single-device round leaves it
        result = batched(global_variables, x, y, counts, torch.Generator(), local_seeds,
                         local_perms, local_counts)
        trained = strip_lora_base(global_variables)
        rows = cohort_stats(trained, result) if stats else None
        weights = counts.float()
        if participation is not None:
            result, weights, alive, quarantined = quarantine_stage(
                result, weights, participation.to(device))
        new_global, new_state = aggregator.sharded(trained, result, weights, rng,
                                                   agg_state, mesh.group)
        metrics = all_reduce_tree({k: v.sum() for k, v in result.metrics.items()},
                                  group=mesh.group)
        if participation is not None:
            new_global, new_state, metrics = masked_psum_tail(
                new_global, new_state, metrics, alive, quarantined, trained, agg_state,
                mesh.group)
        out = (attach_lora_base(new_global, global_variables), new_state, metrics)
        return out + (rows,) if collect_stats else out

    return round_fn


def build_sharded_buffer_fns(aggregator, discount_fn, mesh: Mesh, codec=None) -> tuple:
    """The buffered aggregation's admit and commit with the K-row update
    buffer and the stacked client-step result split over the ranks: the
    sharded twins of ``aggregators.build_buffer_admit`` and
    ``build_buffer_commit`` (JAX ``parallel/sharded.py::
    build_sharded_buffer_fns``). Rank r holds buffer rows ``[r * k_local,
    (r + 1) * k_local)`` and stacked rows ``[r * c_local, (r + 1) *
    c_local)``.

    ``admit(buf, stacked_vars, stacked_steps, stacked_metrics, counts, src,
    fill)`` moves the client at global index ``src`` into global buffer row
    ``fill`` (host ints): the owner of ``src`` contributes the row to one
    masked all-reduce (every other rank adds zeros, so the row arrives
    exact), and the owner of ``fill`` writes it. In place, as the
    single-device admit.

    ``commit(gv, agg_state, buf, fill, births, commit_round, rng)`` mirrors
    the single-device commit (``births`` the host list of the first
    ``fill`` global rows' birth rounds): staleness discount and quarantine
    on the local rows, the aggregator's ``sharded`` rule, then
    ``masked_psum_tail``; ``staleness_sum`` is all-reduced and
    ``staleness_max`` all-reduced by max. Equal to the single-device commit
    up to float summation order.

    The compressed admit transport (``codec``) belongs to the tensor-sharded
    slice (ROADMAP.md Queue 1 item 2.6) and raises."""
    if codec is not None:
        raise NotImplementedError(
            "the sharded buffer's compressed admit transport (masked_row_transport) is "
            "not ported to fedml_tpu_torch yet (ROADMAP.md Queue 1 item 2.6)")
    group = mesh.group

    @torch.no_grad()
    def admit(buf, stacked_vars, stacked_steps, stacked_metrics, counts, src, fill):
        c_local = stacked_steps.shape[0]
        k_local = buf["weights"].shape[0]
        owns_src = src // c_local == mesh.rank
        s = src - mesh.rank * c_local if owns_src else 0

        def take(v):
            return v[s] if owns_src else torch.zeros_like(v[0])

        row = {f"vars/{n}": take(v) for n, v in stacked_vars.items()}
        row.update({f"metrics/{n}": take(v) for n, v in stacked_metrics.items()})
        row["steps"] = take(stacked_steps)
        row["weights"] = take(counts).to(torch.float32)
        row = all_reduce_tree(row, group=group)
        if fill // k_local == mesh.rank:
            f = fill - mesh.rank * k_local
            for n in stacked_vars:
                buf["vars"][n][f].copy_(row[f"vars/{n}"])
            for n in stacked_metrics:
                buf["metrics"][n][f].copy_(row[f"metrics/{n}"])
            buf["steps"][f].copy_(row["steps"])
            buf["weights"][f].copy_(row["weights"])
        return buf

    @torch.no_grad()
    def commit(global_variables, agg_state, buf, fill, births, commit_round, rng):
        k_local = buf["weights"].shape[0]
        device = buf["weights"].device
        lo = mesh.rank * k_local
        ages = [commit_round - b for b in births] + [0] * (k_local * mesh.world_size
                                                          - len(births))
        staleness = torch.tensor(ages[lo:lo + k_local], dtype=torch.int32).to(
            device).to(torch.float32)
        weights = buf["weights"] * discount_fn(staleness)
        participation = torch.arange(lo, lo + k_local, device=device) < fill
        result = LocalResult(buf["vars"], buf["steps"], buf["metrics"])
        result, weights, alive, quarantined = quarantine_stage(result, weights, participation)
        trained = strip_lora_base(global_variables)
        new_global, new_state = aggregator.sharded(trained, result, weights, rng,
                                                   agg_state, group)
        local = {n: v.sum() for n, v in result.metrics.items()}
        local["staleness_sum"] = (staleness * alive.float()).sum()
        metrics = all_reduce_tree(local, group=group)
        metrics["staleness_max"] = all_reduce_tree(
            {"m": torch.where(alive, staleness, torch.zeros((), device=device)).max()},
            op="max", group=group)["m"]
        new_global, new_state, metrics = masked_psum_tail(
            new_global, new_state, metrics, alive, quarantined, trained, agg_state, group)
        return attach_lora_base(new_global, global_variables), new_state, metrics

    return admit, commit
