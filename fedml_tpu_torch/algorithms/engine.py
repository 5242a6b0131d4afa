"""The federated round engine — local SGD + aggregation, PyTorch form of
``fedml_tpu/algorithms/engine.py``.

A round is a function

    round_fn(global_variables, agg_state, x, y, counts, rng,
             participation=None, seeds=None, perms=None, host_counts=None)
        -> (new_global, agg_state, train_metrics)

``rng`` is a CPU ``torch.Generator`` for the round. Each client's dropout
stream is a seed and each client's shuffle a permutation, both drawn from
``rng`` by ``draw_client_randomness`` unless the caller injects them, so a
test can feed the same numbers to two implementations. ``host_counts``,
a host copy of ``counts`` (the drive passes the staged cohort's), spares
the round a read of the counts from the device: a round queues its work
without waiting for the device (``tests/test_torch_packed_store.py`` and
``chip_smoke.py``'s sync check hold it).

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
from fedml_tpu_torch.models.lora import lora_base, strip_lora_base
from fedml_tpu_torch.utils.device import resolve_device, to_device
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


def valid_first_permutation(count: int, n_max: int, n_pad: int,
                            generator: torch.Generator) -> torch.Tensor:
    """[n_pad] int64 on the CPU: the first ``count`` rows in the order of a
    uniform draw from ``generator``, the rest in order, then row 0 up to
    ``n_pad`` (the JAX package's argsort of uniforms with the invalid rows
    at infinity, fedgkt.py and splitnn.py's epoch shuffles)."""
    u = torch.rand(n_max, generator=generator)
    key = torch.where(torch.arange(n_max) < count, u, torch.inf)
    perm = torch.argsort(key, stable=True)
    return torch.cat([perm, perm.new_zeros(n_pad - n_max)])


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
    return 1 - torch.full((), decay, dtype=torch.float32,
                          device=count.device) ** count.float()


def trace(decay: float, nesterov: bool = False) -> Optimizer:
    """optax.trace: t = g + decay * t from t = 0 (momentum); the update is
    t, or with ``nesterov`` g + decay * t of the new t."""

    def update(updates, state, params=None):
        t = {k: g + decay * state["trace"][k] for k, g in updates.items()}
        if nesterov:
            return {k: g + decay * t[k] for k, g in updates.items()}, {"trace": t}
        return t, {"trace": t}

    return Optimizer(lambda params: {"trace": zeros_like(params)}, update)


def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    """optax.sgd(lr, momentum=momentum or None, nesterov=nesterov)."""
    if momentum:
        return scaled(trace(momentum, nesterov), -lr)
    return Optimizer(lambda params: {}, lambda updates, state, params=None: (
        {k: -lr * g for k, g in updates.items()}, state))


def add_decayed_weights(wd: float) -> Optimizer:
    """optax.add_decayed_weights: g + wd * p (stateless)."""
    return Optimizer(lambda params: {}, lambda updates, state, params=None: (
        {k: g + wd * params[k] for k, g in updates.items()}, state))


def clip_by_global_norm(max_norm: float) -> Optimizer:
    """optax.clip_by_global_norm (stateless): unchanged below ``max_norm``,
    else g / ||g|| * max_norm, ||g|| over every leaf."""

    def update(updates, state, params=None):
        norm = torch.sqrt(sum((g * g).sum() for g in updates.values()))
        return {k: torch.where(norm < max_norm, g, g / norm * max_norm)
                for k, g in updates.items()}, state

    return Optimizer(lambda params: {}, update)


def chain(*transforms: Optimizer) -> Optimizer:
    """optax.chain over the port's flat states: the transforms' state
    fields side by side in one dict (their names differ, as optax's do in
    the chains the port builds). Each transform reads its own fields of
    the dict and returns them updated; a stateless one returns the dict it
    was given."""

    def init(params):
        return {k: v for t in transforms for k, v in t.init(params).items()}

    def update(updates, state, params=None):
        state = dict(state)
        for t in transforms:
            updates, part = t.update(updates, state, params)
            state.update(part)
        return updates, state

    return Optimizer(init, update)


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
    clip = None if cfg.grad_clip is None else clip_by_global_norm(cfg.grad_clip)
    wd = cfg.wd

    @torch.no_grad()
    def update(grads, state, params):
        if clip is not None:
            grads = clip.update(grads, {})[0]
        if wd:
            grads = {k: g + wd * params[k] for k, g in grads.items()}
        return inner.update(grads, state, params)

    return Optimizer(inner.init, update)


def _build_epoch_fn(trainer, cfg: FedConfig, opt: Optimizer) -> Callable:
    """epoch_fn(params, state, opt_state, global_params, x, y, count,
    generator, perm, frozen) -> (params, state, opt_state, steps, metric
    sums): one local epoch of minibatch steps over one client. With
    ``cfg.fedprox_mu`` the loss gains FedProx's 0.5 * mu * sum ||p - g||^2
    against the round's global parameters. ``frozen`` (LoRA's base, keys
    under ``lora_base/``) joins the variables the loss reads, and nothing
    differentiates or updates it."""
    full = cfg.assume_full_clients
    mu = cfg.fedprox_mu
    aux_keys = getattr(trainer, "aux_keys", ("loss_sum", "correct", "total"))

    def epoch_fn(params, state, opt_state, global_params, x, y, count, generator, perm,
                 frozen):
        n_max = x.shape[0]
        b = n_max if cfg.batch_size <= 0 else min(cfg.batch_size, n_max)
        nb = math.ceil(n_max / b)
        n_pad = nb * b
        if full and n_pad != n_max:
            raise ValueError(
                f"assume_full_clients requires n_max ({n_max}) % batch_size "
                f"({b}) == 0 — padded batches would be trained unmasked")
        perm = (torch.arange(n_max, device=x.device) if perm is None
                else perm.to(x.device))
        if n_pad > n_max:
            perm = torch.cat([perm, perm.new_zeros(n_pad - n_max)])
        xe = x[perm].reshape((nb, b) + tuple(x.shape[1:]))
        ye = y[perm].reshape((nb, b) + tuple(y.shape[1:]))
        n_valid = n_max if full else count
        # the host copy decides which batches are steps; the device copy is
        # the loss mask, built there so no step copies it from the host
        valid = (torch.arange(n_pad) < n_valid).reshape(nb, b)
        mask = (torch.arange(n_pad, device=x.device) < n_valid).reshape(
            nb, b).to(torch.float32)
        steps = 0
        sums = None
        keys = list(params)
        for i in range(nb):
            if not valid[i].any():
                continue  # an all-padding batch is no step: params and state stay
            batch = {"x": xe[i], "y": ye[i], "mask": mask[i]}
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss, (new_state, aux) = trainer.loss_fn({**leaves, **state, **frozen}, batch,
                                                     generator, True)
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
            # the trainer's own keys, as the JAX scan's masked sums carry them
            zero = torch.zeros((), device=x.device)
            sums = {k: zero for k in aux_keys}
        return params, state, opt_state, steps, sums

    return epoch_fn


def build_local_update(trainer, cfg: FedConfig) -> Callable:
    """local_update(global_variables, x, y, count, generator, perms) ->
    LocalResult for one client. x: [n_max, ...]; count: valid rows (int);
    perms: [epochs, n_max] or None (stored order). Runs cfg.epochs epochs
    with one optimizer state over the parameters, made here and carried
    across batches and epochs; the metrics are those of the last epoch.

    Federated LoRA (``models/lora.py``): the frozen base leaves the client's
    result here, so the cohort-stacked tree never holds C copies of it;
    aggregation, codecs, the buffer and the wire see adapters only, and the
    round re-attaches the server's base."""
    if cfg.epochs < 1:
        raise ValueError(f"cfg.epochs must be >= 1, got {cfg.epochs}")
    opt = make_local_optimizer(cfg)
    epoch_fn = _build_epoch_fn(trainer, cfg, opt)

    def local_update(global_variables, x, y, count, generator, perms=None):
        frozen = lora_base(global_variables)
        trained = strip_lora_base(global_variables)
        params, state = split_variables(trained)
        global_params = params
        opt_state = opt.init(params)
        steps = 0
        for e in range(cfg.epochs):
            perm = perms[e] if perms is not None else None
            params, state, opt_state, n, metrics = epoch_fn(
                params, state, opt_state, global_params, x, y, count, generator, perm,
                frozen)
            steps += n
        variables = {k: params[k] if k in params else state[k] for k in trained}
        return LocalResult(variables, steps, metrics)

    return local_update


def build_personal_local_update(trainer, cfg: FedConfig) -> Callable:
    """personal_update(gv, x, y, count, generator, perms, personal) ->
    (LocalResult, new_personal): the personalized client step.

    The client trains the EFFECTIVE adapters ``gv``'s parameters plus its
    personal row (the zero row, a client the bank never wrote, is the
    identity, so that client's step is the shared round's bit for bit)
    through the shared round's ``local_update``. The trained adapters go to
    the aggregator as in the shared round; the client's new personal row
    is the residual ``trained - global`` and returns beside the result,
    never entering aggregation or the wire."""
    local_update = build_local_update(trainer, cfg)

    def personal_update(global_variables, x, y, count, generator, perms, personal):
        effective = {**global_variables,
                     **{k: global_variables[k] + p for k, p in personal.items()}}
        result = local_update(effective, x, y, count, generator, perms)
        new_personal = {k: result.variables[k] - global_variables[k] for k in personal}
        return result, new_personal

    return personal_update


def _batched_update(trainer, cfg: FedConfig, personal: bool = False) -> Callable:
    """batched(gv, x[C, ...], y, counts, rng, seeds, perms, host_counts)
    -> LocalResult stacked over clients: the client axis as a loop over
    local_update. With ``personal`` the call takes one more argument, the
    cohort's stacked personal rows [C, ...], and returns (LocalResult, new
    personal rows stacked [C, ...]) (``build_personal_local_update``).

    ``host_counts`` is a host copy of ``counts`` (the staged cohort's
    pinned source): the loop reads the counts there and not from the
    device, which would wait for the work queued before the round. The
    permutations reach the device in one pinned copy a round."""
    update = (build_personal_local_update if personal else build_local_update)(trainer, cfg)

    def batched(global_variables, x, y, counts, rng, seeds=None, perms=None,
                host_counts=None, personal_rows=None):
        cl, n_max = x.shape[0], x.shape[1]
        counts_host = [int(c) for c in (counts.cpu() if host_counts is None
                                        else host_counts)]
        drawn_perms, drawn_seeds = draw_client_randomness(
            rng, counts_host, n_max, cfg.epochs, cfg.shuffle)
        if seeds is None:
            seeds = drawn_seeds
        if cfg.shuffle and perms is None:
            perms = drawn_perms
        if perms is not None:
            perms = to_device(perms, x.device)
        results, rows = [], []
        for c in range(cl):
            gen = torch.Generator(device=x.device).manual_seed(int(seeds[c]))
            args = (global_variables, x[c], y[c], counts_host[c], gen,
                    perms[c] if perms is not None else None)
            if personal:
                out, row = update(*args, {k: v[c] for k, v in personal_rows.items()})
                rows.append(row)
            else:
                out = update(*args)
            results.append(out)
        variables = {k: torch.stack([r.variables[k] for r in results])
                     for k in results[0].variables}
        metrics = {k: torch.stack([r.metrics[k] for r in results])
                   for k in results[0].metrics}
        steps = to_device(torch.tensor([r.num_steps for r in results],
                                       dtype=torch.int32), x.device)
        result = LocalResult(variables, steps, metrics)
        if personal:
            return result, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        return result

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
                   param_sharding=None, device="cuda",
                   collect_stats: bool = False) -> Callable:
    """Synchronous round: every sampled client's local update, then the
    aggregator. Runs on ``device`` (``cuda`` unless the caller asks for the
    CPU); x, y and counts are moved there.

    ``cfg.fused_kernel`` routes the local epoch through the fused CUDA
    kernel (ops/fused_sgd.py) with the JAX engine's guards: CNN_DropOut
    only, no participation mask, no codec, no tensor sharding.

    ``codec`` (``codecs.make_codec``) wraps the aggregator with the
    compressed update transport (``core.builder.wrap_codec``, one residual
    row a cohort slot); its state is then ``{"agg": ..., "codec": ...}``.
    ``codec=None`` builds the round without a codec.

    ``collect_stats=True`` makes the round return a fourth output, the
    client ledger's per-client rows (``cohort_stats``), from the same
    round: (new_global, agg_state, metrics, stats). A call's ``stats=False``
    skips computing them (the fourth output is then None): ``FedAvgAPI``
    asks for them only while a ledger is attached. They only read the
    round's results, so the other outputs are the same bits either way.
    """
    device = resolve_device(device)
    cfg.validate(device=device)
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
                        seeds=None, perms=None, host_counts=None, stats=collect_stats):
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
                    spec, aggregator, shuffle=cfg.shuffle, collect_stats=collect_stats)
            return specialized[key](gv, agg_state, x.to(device), y.to(device),
                                    counts.to(device), rng, participation,
                                    seeds, perms, stats=stats)

        return fused_round
    if param_sharding is not None:
        raise NotImplementedError(
            "tensor sharding is not ported to fedml_tpu_torch yet (ROADMAP.md Queue 1 "
            "item 2.6, tensor parallelism)")
    from fedml_tpu_torch.core.builder import build_round_core, wrap_codec

    # a codec wraps the aggregator here unless the caller wrapped it
    # already (FedAvgAPI does, before init_state, so that its state holds
    # the residuals)
    aggregator = wrap_codec(aggregator, codec, slots=cfg.client_num_per_round)
    core = build_round_core(_batched_update(trainer, cfg), aggregator, collect_stats)

    def round_fn(gv, agg_state, x, y, counts, rng, participation=None,
                 seeds=None, perms=None, host_counts=None, stats=collect_stats):
        if participation is not None:
            participation = participation.to(device)
        out = core(gv, agg_state, x.to(device), y.to(device),
                   counts.to(device), rng, participation, seeds, perms,
                   host_counts, stats)
        return out if collect_stats else out[:3]

    return round_fn


def build_personal_round_fn(trainer, cfg: FedConfig, aggregator, device="cuda",
                            collect_stats: bool = False) -> Callable:
    """The personalized round: the personal client step over the cohort,
    then the shared round's aggregation, returning the cohort's updated
    personal adapter rows UNAGGREGATED:

        round_fn(gv, agg_state, x, y, counts, rng, personal,
                 participation=None, seeds=None, perms=None, host_counts=None,
                 stats=collect_stats)
            -> (new_global, agg_state, metrics[, stats], new_personal)

    ``personal`` is the [C, ...] stacked adapter rows of the cohort
    (``models/adapter_bank.py``'s gather, on the device); the drive
    scatters ``new_personal`` back through the record log's deferred fetch.
    The aggregator sees the TRAINED effective adapters; the personal rows
    never reach it. There is no codec argument by design: codec x
    personalization is excluded (``core/config.py``). Requires a LoRA
    trainer (``lora_rank`` > 0). Dropped and quarantined clients keep their
    OLD rows bit for bit (``core.builder.build_personal_round_core``)."""
    device = resolve_device(device)
    cfg.validate(device=device)
    from fedml_tpu_torch.core.builder import build_personal_round_core

    core = build_personal_round_core(_batched_update(trainer, cfg, personal=True),
                                     aggregator, collect_stats)

    def round_fn(gv, agg_state, x, y, counts, rng, personal, participation=None,
                 seeds=None, perms=None, host_counts=None, stats=collect_stats):
        if participation is not None:
            participation = participation.to(device)
        out = core(gv, agg_state, x.to(device), y.to(device), counts.to(device), rng,
                   participation, personal, seeds, perms, host_counts, stats)
        return out if collect_stats else out[:3] + out[4:]

    return round_fn


def build_superstep_fn(trainer, cfg: FedConfig, aggregator, num_rounds: int, *,
                       client_num_in_total: int, chaos_armed: bool = False,
                       collect_stats: bool = False) -> Callable:
    """K federated rounds in one dispatch, each the synchronous round's core
    (``core.builder.build_round_core``) on the round's generator
    ``fedavg.round_generator(seed, round_idx)``: bit for bit K eager rounds
    (tests/test_torch_superstep.py). The caller passes the aggregator its
    eager round uses (codec-wrapped and all), so the states line up.

    superstep(gv, agg_state, data_x, data_y, data_counts, per_round,
              stats=collect_stats)
        -> (gv, agg_state, metrics with a leading [K] axis[, stats [K, C]])

    (the stats with ``collect_stats``, None for a call's ``stats=False``, as
    ``build_round_fn``).

    ``data_*`` is the whole train store on the device
    (``data.packed_store.resident_train_arrays``); each round gathers its
    cohort from it there. ``per_round`` holds, for the K rounds:

    - ``round_idx``: K host ints;
    - ``host_counts``: [K, C] host counts of the cohorts (the client loop
      decides its steps from them, so that no round reads the device);
    - ``idx``: [K, C] int64 cohort ids on the device, drawn on the host
      (which needs them for ``host_counts`` anyway);
    - with ``chaos_armed``: ``nan``, ``corrupt`` and ``participation``,
      [K, C] bool on the device. The faults are applied after the gather
      as ``chaos.apply_faults`` applies them on the host: x * 1e3 + 7.0
      as two operations (each rounded, as numpy's float32 ops), then NaN.
      Faults on integer inputs are data-dependent on the host: the drive
      runs those rounds eagerly.

    On the card the K rounds are a loop on the host that queues each
    round's work without waiting for the device: nothing in a dispatch
    reads a tensor of the card (``chip_smoke.py`` phase 10 checks it under
    ``torch.cuda.set_sync_debug_mode("error")``). The metrics stay on the
    device, stacked, so the K records flush with one transfer."""
    if num_rounds < 1:
        raise ValueError(f"num_rounds must be >= 1, got {num_rounds}")
    from fedml_tpu_torch.algorithms.fedavg import round_generator
    from fedml_tpu_torch.core.builder import build_round_core

    core = build_round_core(_batched_update(trainer, cfg), aggregator, collect_stats)
    cohort = min(cfg.client_num_per_round, int(client_num_in_total))

    def superstep(global_variables, agg_state, data_x, data_y, data_counts,
                  per_round, stats=collect_stats):
        gv, st = global_variables, agg_state
        rounds = list(per_round["round_idx"])
        if len(rounds) != num_rounds:
            raise ValueError(f"a {num_rounds}-round superstep was handed "
                             f"{len(rounds)} rounds")
        out, rows = [], []
        for j, round_idx in enumerate(rounds):
            idx = per_round["idx"][j]
            xs = data_x.index_select(0, idx)
            ys = data_y.index_select(0, idx)
            cs = data_counts.index_select(0, idx)
            participation = None
            if chaos_armed:
                mshape = (cohort,) + (1,) * (xs.dim() - 1)
                corrupt = per_round["corrupt"][j].reshape(mshape)
                xs = torch.where(corrupt, xs * 1e3 + 7.0, xs)
                xs = torch.where(per_round["nan"][j].reshape(mshape),
                                 torch.full((), float("nan"), dtype=xs.dtype,
                                            device=xs.device), xs)
                participation = per_round["participation"][j]
            rng = round_generator(cfg.seed, int(round_idx))
            gv, st, metrics, round_rows = core(gv, st, xs, ys, cs, rng, participation,
                                               None, None, per_round["host_counts"][j],
                                               stats)
            out.append(metrics)
            rows.append(round_rows)
        metrics = {k: torch.stack([m[k] for m in out]) for k in out[0]}
        if not collect_stats:
            return gv, st, metrics
        return gv, st, metrics, ({k: torch.stack([r[k] for r in rows]) for k in rows[0]}
                                 if stats else None)

    return superstep


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
    """eval(variables, bx[nb, b, ...], by, bmask) -> summed metrics, one
    batch at a time."""

    @torch.no_grad()
    def eval_fn(variables, bx, by, bmask):
        sums = None
        for i in range(bx.shape[0]):
            m = trainer.eval_fn(variables, {"x": bx[i], "y": by[i], "mask": bmask[i]})
            sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        return sums

    return eval_fn


def build_federation_eval_fn(trainer) -> Callable:
    """The resident federation eval (JAX ``engine.py::
    build_federation_eval_fn``): eval(variables, xs, ys, counts) -> summed
    metric scalars on the device, from a split staged on the device once
    (``FedAvgAPI._resident_eval_data``), or from one chunk staged from the
    host (the chunked path, ``FedAvgAPI._client_chunks``). xs and ys are
    [nc, k * n_max, ...]: nc chunks of k whole clients each, in the port's
    chunk geometry (``fedavg.py``'s ``_EVAL_ROWS`` and ``_EVAL_LOGITS``),
    the last chunk padded with empty clients; counts is [nc, k]. Each chunk
    is one forward pass with every client's rows past its count masked (the
    trainer's per-client quantities see ``clients`` = k), and the sums stay
    on the device."""

    @torch.no_grad()
    def eval_fn(variables, xs, ys, counts):
        k = counts.shape[1]
        n_max = xs.shape[1] // k
        rows = torch.arange(n_max, device=xs.device)
        sums = None
        for i in range(xs.shape[0]):
            mask = (rows[None] < counts[i][:, None]).to(torch.float32).reshape(k * n_max)
            m = trainer.eval_fn(variables, {"x": xs[i], "y": ys[i], "mask": mask,
                                            "clients": k})
            sums = m if sums is None else {key: sums[key] + m[key] for key in m}
        return sums

    return eval_fn


def pack_test_batches(test_global, batch_size: int, device) -> tuple:
    """The global test split as (bx, by, bmask) on ``device``, in batches of
    max(batch_size, 64) (256 at full batch), as every drive evaluates."""
    from fedml_tpu_torch.data.packing import pack_eval_batches

    bs = batch_size if batch_size > 0 else 256
    return tuple(torch.from_numpy(a).to(device)
                 for a in pack_eval_batches(*test_global, max(bs, 64)))


def test_metrics(eval_fn, variables, batches) -> dict[str, float]:
    """Test/Acc and Test/Loss of ``variables`` on ``pack_test_batches``'
    batches, in one host transfer."""
    from fedml_tpu_torch.telemetry.records import fetch_scalars

    m = eval_fn(variables, *batches)
    m = dict(zip(m, fetch_scalars(list(m.values()))))
    total = max(m.get("test_total", 1.0), 1.0)
    return {"Test/Acc": m.get("test_correct", 0.0) / total,
            "Test/Loss": m.get("test_loss", 0.0) / total}


def build_client_eval_fn(trainer) -> Callable:
    """eval(variables, x[C, n_max, ...], y, counts) -> per-client metric
    sums, each [C]: every client's rows masked to its count, one forward
    pass per client (the JAX package's vmap over clients)."""

    @torch.no_grad()
    def eval_fn(variables, x, y, counts):
        rows = _per_client_eval(trainer, [variables] * x.shape[0], x, y, counts)
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return eval_fn


def build_personal_client_eval_fn(trainer) -> Callable:
    """eval(variables, personal[C, ...], x[C, n_max, ...], y, counts) ->
    per-client metric sums, each [C], client c under its EFFECTIVE
    adapters: ``variables``' plus its personal row (the personalization
    lift's probe). The same masked eval as ``build_client_eval_fn``."""

    @torch.no_grad()
    def eval_fn(variables, personal, x, y, counts):
        per_client = [{**variables, **{k: variables[k] + p[c] for k, p in personal.items()}}
                      for c in range(x.shape[0])]
        rows = _per_client_eval(trainer, per_client, x, y, counts)
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return eval_fn


def _per_client_eval(trainer, variables_list, x, y, counts) -> list:
    """Client c's eval sums under ``variables_list[c]``, its rows past its
    count masked."""
    mask = (torch.arange(x.shape[1], device=x.device)[None]
            < counts.to(x.device)[:, None]).to(torch.float32)
    return [trainer.eval_fn(v, {"x": x[c], "y": y[c], "mask": mask[c]})
            for c, v in enumerate(variables_list)]
