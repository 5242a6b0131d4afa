"""The federated round engine — local SGD + aggregation, PyTorch form of
``fedml_tpu/algorithms/engine.py``.

A round is a function

    round_fn(global_variables, agg_state, x, y, counts, rng,
             participation=None, seeds=None, perms=None)
        -> (new_global, agg_state, train_metrics)

``rng`` is a CPU ``torch.Generator`` for the round. Each client's dropout
stream is a seed and each client's shuffle a permutation, both drawn from
``rng`` by ``draw_client_randomness`` unless the caller injects them, so a
test can feed the same numbers to two implementations.

The client axis is a loop: each client's local update runs eagerly on the
device, and the results are stacked along a leading client axis for the
aggregator. With ``cfg.fused_kernel`` the whole local epoch instead goes
through the fused CUDA kernel (ops/fused_sgd.py).

Epoch semantics follow the JAX engine (torch DataLoader(shuffle=True,
drop_last=False)): a shuffle permutes the valid prefix of a client's rows
and leaves the padding after it, batches are full except the last, which is
masked, and a batch holding only padding is no step at all.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.utils.device import resolve_device


class LocalResult(NamedTuple):
    variables: dict  # per-client trained variables, stacked [C, ...]
    num_steps: torch.Tensor  # optimizer steps taken per client
    metrics: dict  # summed train metrics of the final epoch, [C] each


def draw_client_randomness(rng: torch.Generator, counts, n_max: int,
                           epochs: int, shuffle: bool):
    """(perms, seeds) for one round's clients from the round generator.

    perms: [C, epochs, n_max] int64 — per epoch a uniform permutation of the
    client's first ``counts[c]`` rows followed by its padding rows in order
    — or None without shuffle. seeds: [C] int64 in [0, 2**31 - 1), the
    clients' dropout streams. Both live on the CPU."""
    perms = None
    if shuffle:
        rows = []
        for count in counts:
            tail = torch.arange(int(count), n_max)
            rows.append(torch.stack([
                torch.cat([torch.randperm(int(count), generator=rng), tail])
                for _ in range(epochs)]))
        perms = torch.stack(rows)
    seeds = torch.randint(0, 2 ** 31 - 1, (len(counts),), generator=rng)
    return perms, seeds


def make_local_optimizer(cfg: FedConfig) -> Callable:
    """Client optimizer (reference my_model_trainer_classification.py:25-46):
    optax's ``clip_by_global_norm`` then plain SGD, as
    ``update(params, grads) -> new params``. Momentum, weight decay and Adam
    are not ported yet."""
    if cfg.client_optimizer != "sgd" or cfg.momentum or cfg.wd:
        raise NotImplementedError(
            "only plain SGD (momentum 0, wd 0) is ported to fedml_tpu_torch")
    clip, lr = cfg.grad_clip, cfg.lr

    @torch.no_grad()
    def update(params: dict, grads: dict) -> dict:
        if clip is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            # unchanged below the bound, else g / ||g|| * clip
            grads = {k: torch.where(norm < clip, g, g / norm * clip)
                     for k, g in grads.items()}
        return {k: p + (-lr) * grads[k] for k, p in params.items()}

    return update


def _build_epoch_fn(trainer, cfg: FedConfig, opt) -> Callable:
    """epoch_fn(params, x, y, count, generator, perm) -> (params, steps,
    metric sums) — one local epoch of minibatch SGD over one client."""
    full = cfg.assume_full_clients

    def epoch_fn(params, x, y, count, generator, perm):
        n_max = x.shape[0]
        b = n_max if cfg.batch_size <= 0 else min(cfg.batch_size, n_max)
        nb = math.ceil(n_max / b)
        n_pad = nb * b
        if full and n_pad != n_max:
            raise ValueError(
                f"assume_full_clients requires n_max ({n_max}) % batch_size "
                f"({b}) == 0 — padded batches would be trained unmasked")
        if perm is None:
            perm = torch.arange(n_max)
        if n_pad > n_max:
            perm = torch.cat([perm, torch.zeros(n_pad - n_max, dtype=perm.dtype)])
        perm = perm.to(x.device)
        xe = x[perm].reshape((nb, b) + tuple(x.shape[1:]))
        ye = y[perm].reshape((nb, b) + tuple(y.shape[1:]))
        n_valid = n_max if full else count
        valid = (torch.arange(n_pad) < n_valid).reshape(nb, b)
        steps = 0
        sums = None
        keys = list(params)
        for i in range(nb):
            if not valid[i].any():
                continue  # an all-padding batch is no step
            batch = {"x": xe[i], "y": ye[i],
                     "mask": valid[i].to(x.device, torch.float32)}
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss, aux = trainer.loss_fn(leaves, batch, generator, True)
            grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
            params = opt(params, dict(zip(keys, grads)))
            steps += 1
            sums = aux if sums is None else {k: sums[k] + aux[k] for k in aux}
        if sums is None:
            zero = torch.zeros((), device=x.device)
            sums = {"loss_sum": zero, "correct": zero, "total": zero}
        return params, steps, sums

    return epoch_fn


def build_local_update(trainer, cfg: FedConfig) -> Callable:
    """local_update(global_variables, x, y, count, generator, perms) ->
    LocalResult for one client. x: [n_max, ...]; count: valid rows (int);
    perms: [epochs, n_max] or None (stored order). Runs cfg.epochs epochs;
    the metrics are those of the last one."""
    if cfg.epochs < 1:
        raise ValueError(f"cfg.epochs must be >= 1, got {cfg.epochs}")
    epoch_fn = _build_epoch_fn(trainer, cfg, make_local_optimizer(cfg))

    def local_update(global_variables, x, y, count, generator, perms=None):
        params = dict(global_variables)
        steps = 0
        for e in range(cfg.epochs):
            perm = perms[e] if perms is not None else None
            params, n, metrics = epoch_fn(params, x, y, count, generator, perm)
            steps += n
        return LocalResult(params, steps, metrics)

    return local_update


def _batched_update(trainer, cfg: FedConfig) -> Callable:
    """batched(gv, x[C, ...], y, counts, rng, seeds, perms) -> LocalResult
    stacked over clients: the client axis as a loop over local_update."""
    local_update = build_local_update(trainer, cfg)

    def batched(global_variables, x, y, counts, rng, seeds=None, perms=None):
        cl, n_max = x.shape[0], x.shape[1]
        counts_host = [int(c) for c in counts.cpu()]
        drawn_perms, drawn_seeds = draw_client_randomness(
            rng, counts_host, n_max, cfg.epochs, cfg.shuffle)
        if seeds is None:
            seeds = drawn_seeds
        if cfg.shuffle and perms is None:
            perms = drawn_perms
        results = []
        for c in range(cl):
            gen = torch.Generator(device=x.device).manual_seed(int(seeds[c]))
            results.append(local_update(
                global_variables, x[c], y[c], counts_host[c], gen,
                perms[c] if perms is not None else None))
        variables = {k: torch.stack([r.variables[k] for r in results])
                     for k in results[0].variables}
        metrics = {k: torch.stack([r.metrics[k] for r in results])
                   for k in results[0].metrics}
        steps = torch.tensor([r.num_steps for r in results], dtype=torch.int32,
                             device=x.device)
        return LocalResult(variables, steps, metrics)

    return batched


def cohort_stats(global_variables: dict, result: LocalResult) -> dict:
    """Per-client health rows for a client ledger: update L2 norm,
    finiteness, loss_sum and total, each [C], computed from the raw
    (pre-quarantine) results."""
    from fedml_tpu_torch.algorithms.aggregators import client_finite_mask

    total_sq = None
    for k, p in result.variables.items():
        if not p.is_floating_point():
            continue
        d = (p - global_variables[k][None]).float()
        sq = (d * d).reshape(d.shape[0], -1).sum(1)
        total_sq = sq if total_sq is None else total_sq + sq
    norm = torch.sqrt(total_sq)
    zeros = torch.zeros_like(norm)
    return {
        "update_norm": norm,
        "finite": client_finite_mask(result.variables),
        "loss_sum": result.metrics.get("loss_sum", zeros).float(),
        "total": result.metrics.get("total", zeros).float(),
    }


def build_round_fn(trainer, cfg: FedConfig, aggregator, codec=None,
                   param_sharding=None, device="cuda") -> Callable:
    """Synchronous round: every sampled client's local update, then the
    aggregator. Runs on ``device`` (``cuda`` unless the caller asks for the
    CPU); x, y and counts are moved there.

    ``cfg.fused_kernel`` routes the local epoch through the fused CUDA
    kernel (ops/fused_sgd.py) with the JAX engine's guards: CNN_DropOut
    only, no participation mask, no codec, no tensor sharding.
    """
    device = resolve_device(device)
    cfg.validate()
    if cfg.fused_kernel:
        if param_sharding is not None:
            raise ValueError(
                "--fused_kernel is mutually exclusive with --tensor_shards "
                "(the kernel owns the whole client step)")
        if codec is not None:
            raise ValueError(
                "--fused_kernel is mutually exclusive with --update_codec")
        if type(trainer.module).__name__ != "CNN_DropOut":
            raise ValueError(
                "--fused_kernel supports the femnist CNN_DropOut model only")
        from fedml_tpu_torch.ops.fused_sgd import (FusedEpochSpec,
                                                   build_fused_round_fn)

        module = trainer.module
        specialized: dict = {}

        def fused_round(gv, agg_state, x, y, counts, rng, participation=None,
                        seeds=None, perms=None):
            # the per-client sample count is data geometry: one spec per
            # cohort shape
            key = tuple(x.shape)
            if key not in specialized:
                spec = FusedEpochSpec(
                    height=int(x.shape[2]), width=int(x.shape[3]),
                    n_classes=int(module.output_dim), samples=int(x.shape[1]),
                    batch=cfg.batch_size, lr=cfg.lr, grad_clip=cfg.grad_clip,
                    compute_dtype=module.dtype,
                    drop1=float(module.drop1), drop2=float(module.drop2))
                specialized[key] = build_fused_round_fn(
                    spec, aggregator, shuffle=cfg.shuffle)
            return specialized[key](gv, agg_state, x.to(device), y.to(device),
                                    counts.to(device), rng, participation,
                                    seeds, perms)

        return fused_round
    if codec is not None or param_sharding is not None:
        raise NotImplementedError(
            "update codecs and tensor sharding are not ported to "
            "fedml_tpu_torch yet")
    from fedml_tpu_torch.core.builder import build_round_core

    core = build_round_core(_batched_update(trainer, cfg), aggregator)

    def round_fn(gv, agg_state, x, y, counts, rng, participation=None,
                 seeds=None, perms=None):
        if participation is not None:
            participation = participation.to(device)
        return core(gv, agg_state, x.to(device), y.to(device),
                    counts.to(device), rng, participation, seeds, perms)

    return round_fn


def build_eval_fn(trainer) -> Callable:
    """eval(variables, bx[nb, b, ...], by, bmask, clients=1) -> summed
    metrics, one batch at a time; each batch's rows are ``clients`` equal
    consecutive blocks, one per client."""

    @torch.no_grad()
    def eval_fn(variables, bx, by, bmask, clients=1):
        sums = None
        for i in range(bx.shape[0]):
            m = trainer.eval_fn(variables, {"x": bx[i], "y": by[i],
                                            "mask": bmask[i], "clients": clients})
            sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        return sums

    return eval_fn
