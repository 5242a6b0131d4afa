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

Model state (a BatchNorm's running statistics) is carried through the local
steps beside the parameters: each step's train-mode forward returns the new
state, which replaces the old one; the optimizer, the clip, weight decay
and FedProx see the parameters only (``utils/pytree.py::split_variables``).
An all-padding batch updates neither. The state returns in
``LocalResult.variables`` with the parameters.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.utils.device import resolve_device
from fedml_tpu_torch.utils.pytree import split_variables


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


class Optimizer(NamedTuple):
    """optax's ``GradientTransformation`` over the port's dicts of tensors:
    ``init(params) -> state`` and ``update(updates, state, params) ->
    (updates, state)``. A state is a flat dict named as optax's fields
    (``count``, ``mu``, ``nu``, ``nu_max``, ``trace``; ``sum`` for
    Adagrad's accumulator), each moment a dict of tensors beside the params
    (``utils/convert.py::optax_state_to_torch`` reads optax's)."""

    init: Callable
    update: Callable


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: p + updates[k] for k, p in params.items()}


def zeros_like(params: dict) -> dict:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def scaled(transform: Optimizer, step: float) -> Optimizer:
    """``optax.chain(transform, optax.scale(step))``."""

    def update(updates, state, params=None):
        updates, state = transform.update(updates, state, params)
        return {k: step * u for k, u in updates.items()}, state

    return Optimizer(transform.init, update)


def bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """1 - decay**count, the power taken in float32 as JAX takes it (a
    float64 power drifts from it in the 7th digit)."""
    return 1 - torch.tensor(decay, dtype=torch.float32,
                            device=count.device) ** count.float()


def trace(decay: float) -> Optimizer:
    """optax.trace: t = g + decay * t from t = 0 (momentum)."""

    def update(updates, state, params=None):
        t = {k: g + decay * state["trace"][k] for k, g in updates.items()}
        return t, {"trace": t}

    return Optimizer(lambda params: {"trace": zeros_like(params)}, update)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """optax.sgd(lr, momentum=momentum or None)."""
    if momentum:
        return scaled(trace(momentum), -lr)
    return Optimizer(lambda params: {}, lambda updates, state, params=None: (
        {k: -lr * g for k, g in updates.items()}, state))


def scale_by_torch_amsgrad(b1: float = 0.9, b2: float = 0.999,
                           eps: float = 1e-8) -> Optimizer:
    """torch.optim.Adam(amsgrad=True) numerics, exactly (JAX
    ``engine.py::scale_by_torch_amsgrad``): the max is over the *raw*
    second moment and the current step's bias correction applies after it,
    where optax.amsgrad maxes bias-corrected moments."""

    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=next(iter(params.values())).device),
                "mu": zeros_like(params), "nu": zeros_like(params),
                "nu_max": zeros_like(params)}

    def update(updates, state, params=None):
        t = state["count"] + 1
        mu = {k: b1 * state["mu"][k] + (1 - b1) * g for k, g in updates.items()}
        nu = {k: b2 * state["nu"][k] + (1 - b2) * g * g for k, g in updates.items()}
        nu_max = {k: torch.maximum(state["nu_max"][k], v) for k, v in nu.items()}
        bc1, bc2 = bias_correction(b1, t), bias_correction(b2, t)
        out = {k: (mu[k] / bc1) / (torch.sqrt(nu_max[k] / bc2) + eps) for k in mu}
        return out, {"count": t, "mu": mu, "nu": nu, "nu_max": nu_max}

    return Optimizer(init, update)


def torch_amsgrad(lr: float, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Optimizer:
    return scaled(scale_by_torch_amsgrad(b1, b2, eps), -lr)


def torch_adagrad(lr: float, eps: float = 1e-10) -> Optimizer:
    """torch.optim.Adagrad numerics, exactly: the accumulator starts at 0
    and eps sits outside the sqrt (p -= lr * g / (sqrt(sum) + eps))."""

    def update(updates, state, params=None):
        acc = {k: state["sum"][k] + g * g for k, g in updates.items()}
        out = {k: -lr * g / (torch.sqrt(acc[k]) + eps) for k, g in updates.items()}
        return out, {"sum": acc}

    return Optimizer(lambda params: {"sum": zeros_like(params)}, update)


def make_local_optimizer(cfg: FedConfig) -> Optimizer:
    """Client optimizer (reference my_model_trainer_classification.py:25-46:
    SGD(lr, momentum) or Adam(lr, wd, amsgrad=True)) as the JAX package's
    optax chain: ``clip_by_global_norm``, then ``add_decayed_weights(wd)``,
    then SGD with momentum or ``torch_amsgrad``. Weight decay joins after
    the clip, so its term is never clipped (torch's L2, added before the
    adaptive scaling: not AdamW's decoupled decay)."""
    if cfg.client_optimizer == "sgd":
        inner = sgd(cfg.lr, cfg.momentum)
    elif cfg.client_optimizer == "adam":
        inner = torch_amsgrad(cfg.lr)
    else:
        raise ValueError(f"unknown client_optimizer {cfg.client_optimizer!r}")
    clip, wd = cfg.grad_clip, cfg.wd

    @torch.no_grad()
    def update(grads, state, params):
        if clip is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            # unchanged below the bound, else g / ||g|| * clip
            grads = {k: torch.where(norm < clip, g, g / norm * clip)
                     for k, g in grads.items()}
        if wd:
            grads = {k: g + wd * params[k] for k, g in grads.items()}
        return inner.update(grads, state, params)

    return Optimizer(inner.init, update)


def _build_epoch_fn(trainer, cfg: FedConfig, opt: Optimizer) -> Callable:
    """epoch_fn(params, state, opt_state, global_params, x, y, count,
    generator, perm) -> (params, state, opt_state, steps, metric sums): one
    local epoch of minibatch steps over one client. With ``cfg.fedprox_mu``
    the loss gains FedProx's 0.5 * mu * sum ||p - g||^2 against the round's
    global parameters."""
    full = cfg.assume_full_clients
    mu = cfg.fedprox_mu

    def epoch_fn(params, state, opt_state, global_params, x, y, count, generator, perm):
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
                continue  # an all-padding batch is no step: params and state stay
            batch = {"x": xe[i], "y": ye[i],
                     "mask": valid[i].to(x.device, torch.float32)}
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss, (new_state, aux) = trainer.loss_fn({**leaves, **state}, batch, generator,
                                                     True)
            if mu > 0.0:
                sq = sum(((leaves[k] - global_params[k]) ** 2).sum() for k in keys)
                loss = loss + 0.5 * mu * sq
            grads = dict(zip(keys, torch.autograd.grad(loss, [leaves[k] for k in keys])))
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
            state = {**state, **new_state}
            steps += 1
            sums = aux if sums is None else {k: sums[k] + aux[k] for k in aux}
        if sums is None:
            zero = torch.zeros((), device=x.device)
            sums = {"loss_sum": zero, "correct": zero, "total": zero}
        return params, state, opt_state, steps, sums

    return epoch_fn


def build_local_update(trainer, cfg: FedConfig) -> Callable:
    """local_update(global_variables, x, y, count, generator, perms) ->
    LocalResult for one client. x: [n_max, ...]; count: valid rows (int);
    perms: [epochs, n_max] or None (stored order). Runs cfg.epochs epochs
    with one optimizer state over the parameters, made here and carried
    across batches and epochs; the metrics are those of the last epoch."""
    if cfg.epochs < 1:
        raise ValueError(f"cfg.epochs must be >= 1, got {cfg.epochs}")
    opt = make_local_optimizer(cfg)
    epoch_fn = _build_epoch_fn(trainer, cfg, opt)

    def local_update(global_variables, x, y, count, generator, perms=None):
        params, state = split_variables(global_variables)
        global_params = params
        opt_state = opt.init(params)
        steps = 0
        for e in range(cfg.epochs):
            perm = perms[e] if perms is not None else None
            params, state, opt_state, n, metrics = epoch_fn(
                params, state, opt_state, global_params, x, y, count, generator, perm)
            steps += n
        variables = {k: params[k] if k in params else state[k] for k in global_variables}
        return LocalResult(variables, steps, metrics)

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
    """Per-client health rows for a client ledger: update L2 norm (over
    the parameters), finiteness, loss_sum and total, each [C], computed
    from the raw (pre-quarantine) results."""
    from fedml_tpu_torch.algorithms.aggregators import client_finite_mask

    total_sq = None
    for k, p in split_variables(result.variables)[0].items():
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


def stage_to_device(x, y, counts, participation, device, stream=None) -> tuple:
    """The stage seam's copy to the device, shared by the eager and the
    pipelined drive (``FedAvgAPI._stage_cohort``): every cohort reaches the
    device through this one call, so the two drives feed the round the
    same bytes.

    On the CPU: ``torch.from_numpy`` of each array. On the card: each array
    is copied into a pinned host buffer, then to the card with a
    ``non_blocking`` copy on ``stream`` (a side stream, so the copies of
    round t+1 overlap round t), and an event is recorded on that stream
    after them. The caller must have the reading stream wait for the event
    and keep the pinned buffers until it has passed
    (``data/prefetch.py::StagedCohort``). A pinning or copy failure raises:
    there is no synchronous fallback.

    Returns (tensors, ready, pinned): the four tensors (participation None
    when not given), the event (None on the CPU) and the pinned sources
    (None on the CPU)."""
    device = torch.device(device)
    arrays = [np.ascontiguousarray(a) for a in (x, y, counts)]
    if participation is not None:
        arrays.append(np.ascontiguousarray(participation))
    if device.type == "cpu":
        out = [torch.from_numpy(a) for a in arrays]
        ready = pinned = None
    else:
        if stream is None:
            raise ValueError("stage_to_device on the card needs its side stream")
        pinned = tuple(torch.from_numpy(a).pin_memory() for a in arrays)
        with torch.cuda.device(device), torch.cuda.stream(stream):
            out = [p.to(device, non_blocking=True) for p in pinned]
            ready = torch.cuda.Event()
            ready.record(stream)
    if participation is None:
        out.append(None)
    return tuple(out), ready, pinned


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
