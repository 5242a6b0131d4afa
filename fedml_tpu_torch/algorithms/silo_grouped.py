"""Silo-grouped federated rounds, PyTorch form of
``fedml_tpu/algorithms/silo_grouped.py``.

The engine (``algorithms/engine.py``) trains a round's clients one after
another, each step a forward and backward of its own. For the cross-silo
CIFAR ResNets that is S narrow convolutions where one grouped convolution
would do (``ops/silo_conv.py``). This module trains the round's S silos
together: every step is ONE forward of the silo-stacked model over the S
silos' batches (``models/resnet.py``'s packed layout), the sum of the
per-silo losses differentiated once (silos share no parameters, so
d(sum)/d(w_s) is d(loss_s)/d(w_s)), and the client optimizer applied per
silo through ``torch.func.vmap`` (the clip's global norm, momentum and
AMSGrad's step count are each silo's own, as the JAX package's
``jax.vmap(opt.update)``).

The round's randomness is the engine's: ``engine.draw_client_randomness``
gives the same permutations and dropout seeds from the round generator,
and each silo's generator is seeded from its seed, so a silo's trajectory
is its engine client's (``tests/test_torch_silo_grouped.py`` holds the
two). A silo whose batch at a step holds only padding keeps its
variables, optimizer state and step count, as the engine skips that batch.
The round is the engine's scaffold (``core/builder.py::build_round_core``),
so participation masks, quarantine and every aggregator work unchanged.

Scope: the ``ResNetCifar`` family with ``ClassificationTrainer``, one
device. The silo round has no client-ledger stats rows (its results are
one stacked forward's, as in the JAX package). The K-round twin of the
JAX package (``build_silo_multi_round_fn``) is not ported here.
"""

from __future__ import annotations

import copy
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch.func import vmap

from fedml_tpu_torch.algorithms.engine import (LocalResult, apply_updates,
                                               draw_client_randomness, make_local_optimizer)
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import ClassificationTrainer, ModelTrainer
from fedml_tpu_torch.utils.device import resolve_device, to_device
from fedml_tpu_torch.utils.pytree import split_variables


def silo_trainer(trainer, threshold: int):
    """A shallow copy of ``trainer`` whose module has the silo-grouped
    convolutions (``ResNetCifar.clone(silo_threshold=threshold)``). Train
    with it through the builders below and keep the original for the eval
    paths: both read the same variables."""
    if not hasattr(trainer.module, "silo_threshold"):
        raise ValueError(
            f"silo_threshold is only supported for models with a "
            f"silo_threshold attr (ResNetCifar family), got "
            f"{type(trainer.module).__name__}")
    t = copy.copy(trainer)
    ModelTrainer.__init__(t, trainer.module.clone(silo_threshold=threshold))
    return t


def _silo_where(cond: torch.Tensor, new, old):
    """Per-silo select over stacked [S, ...] trees of dicts (variables, an
    optimizer state); ``cond`` is [S] bool."""
    if isinstance(new, dict):
        return {k: _silo_where(cond, n, old[k]) for k, n in new.items()}
    return torch.where(cond.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _silo_loss(trainer, variables, x, y, mask, generators, has_data):
    """(sum of the silos' losses, (new model state, aux sums [S] each)):
    ``ClassificationTrainer.loss_fn`` a silo, the silos in one forward. A
    silo with data at this step augments its batch from its own generator,
    as the engine's step does."""
    if trainer.augment_fn is not None:
        x = torch.stack([trainer.augment_fn(g, xs) if on else xs
                         for xs, g, on in zip(x, generators, has_data)])
    logits, state = trainer.apply(variables, x, None, True)
    s, b = logits.shape[:2]
    per = F.cross_entropy(logits.reshape(s * b, -1), y.reshape(-1).long(),
                          reduction="none").reshape(s, b)
    m = mask.to(per.dtype)
    losses = (per * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    with torch.no_grad():
        mask32 = mask.float()
        correct = ((logits.argmax(-1) == y).float() * mask32).sum(1)
        aux = {"loss_sum": (per.detach().float() * mask32).sum(1), "correct": correct,
               "total": mask32.sum(1)}
    return losses.sum(), (state, aux)


def build_silo_local_update(trainer, cfg: FedConfig) -> Callable:
    """silo_update(global_variables, x, y, counts, rng, seeds=None,
    perms=None, host_counts=None) -> LocalResult stacked over the silos:
    ``engine._batched_update``'s contract, the silos trained together.
    x: [S, n_max, ...]; ``rng`` the round's CPU generator; ``seeds`` and
    ``perms`` injected or drawn from it as the engine draws them."""
    if cfg.epochs < 1:
        raise ValueError(f"cfg.epochs must be >= 1, got {cfg.epochs}")
    if not isinstance(trainer, ClassificationTrainer):
        raise ValueError("the silo-grouped round trains ClassificationTrainer models, got "
                         f"{type(trainer).__name__}")
    opt = make_local_optimizer(cfg)
    opt_init, opt_update = vmap(opt.init), vmap(opt.update)
    mu = cfg.fedprox_mu
    full = cfg.assume_full_clients
    # as the JAX module: a stateless optimizer maps an all-padding silo's
    # zero gradient to an unchanged parameter, so only the model state
    # needs the per-silo select; FedProx's term is not zero there
    stateless_opt = (cfg.client_optimizer == "sgd" and not cfg.momentum
                     and not cfg.wd and mu == 0.0)

    def silo_update(global_variables, x, y, counts, rng, seeds=None, perms=None,
                    host_counts=None) -> LocalResult:
        s, n_max = x.shape[0], x.shape[1]
        device = x.device
        b = n_max if cfg.batch_size <= 0 else min(cfg.batch_size, n_max)
        nb = math.ceil(n_max / b)
        n_pad = nb * b
        if full and n_pad != n_max:
            raise ValueError(
                f"assume_full_clients requires n_max ({n_max}) % batch_size "
                f"({b}) == 0 — padded batches would be trained unmasked")
        counts_host = [int(c) for c in (counts.cpu() if host_counts is None
                                        else host_counts)]
        drawn_perms, drawn_seeds = draw_client_randomness(
            rng, counts_host, n_max, cfg.epochs, cfg.shuffle)
        if seeds is None:
            seeds = drawn_seeds
        if cfg.shuffle and perms is None:
            perms = drawn_perms
        if perms is not None:
            perms = to_device(perms, device)
        generators = [torch.Generator(device=device).manual_seed(int(seed))
                      for seed in seeds[:s]]

        n_valid = [n_max if full else c for c in counts_host]
        # which silos hold data in each batch: decided on the host, one copy
        has_data = [[i * b < n for n in n_valid] for i in range(nb)]
        has_data_dev = to_device(torch.tensor(has_data), device)
        mask = (torch.arange(n_pad, device=device)[None]
                < to_device(torch.tensor(n_valid), device)[:, None])
        mask = mask.reshape(s, nb, b).float()
        rows = torch.arange(s, device=device)[:, None]

        params, state = split_variables(global_variables)
        global_params = params
        params = {k: v.expand((s,) + tuple(v.shape)).clone() for k, v in params.items()}
        state = {k: v.expand((s,) + tuple(v.shape)).clone() for k, v in state.items()}
        opt_state = opt_init(params)
        keys = list(params)
        steps = [0] * s
        for e in range(cfg.epochs):
            perm = (torch.arange(n_max, device=device).expand(s, n_max) if perms is None
                    else perms[:, e])
            if n_pad > n_max:
                perm = torch.cat([perm, perm.new_zeros(s, n_pad - n_max)], 1)
            xe = x[rows, perm].reshape((s, nb, b) + tuple(x.shape[2:]))
            ye = y[rows, perm].reshape((s, nb, b) + tuple(y.shape[2:]))
            sums = None
            for i in range(nb):
                on = has_data[i]
                if not any(on):
                    continue  # no silo steps: every silo keeps its state
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                loss, (new_state, aux) = _silo_loss(
                    trainer, {**leaves, **state}, xe[:, i], ye[:, i], mask[:, i],
                    generators, on)
                if mu > 0.0:
                    sq = sum(((leaves[k] - global_params[k]) ** 2).sum() for k in keys)
                    loss = loss + 0.5 * mu * sq
                grads = dict(zip(keys, torch.autograd.grad(loss, [leaves[k] for k in keys])))
                updates, new_opt_state = opt_update(grads, opt_state, params)
                new_params = apply_updates(params, updates)
                new_state = {**state, **new_state}
                if all(on):
                    params, state, opt_state = new_params, new_state, new_opt_state
                else:
                    cond = has_data_dev[i]
                    state = _silo_where(cond, new_state, state)
                    if stateless_opt:
                        params, opt_state = new_params, new_opt_state
                    else:
                        params = _silo_where(cond, new_params, params)
                        opt_state = _silo_where(cond, new_opt_state, opt_state)
                steps = [n + int(o) for n, o in zip(steps, on)]
                sums = aux if sums is None else {k: sums[k] + aux[k] for k in aux}
        if sums is None:
            zero = torch.zeros(s, device=device)
            sums = {k: zero for k in ("loss_sum", "correct", "total")}
        variables = {k: params[k] if k in params else state[k] for k in global_variables}
        return LocalResult(variables, to_device(torch.tensor(steps, dtype=torch.int32),
                                                device), sums)

    return silo_update


def build_silo_round_fn(trainer, cfg: FedConfig, aggregator, device="cuda",
                        collect_stats: bool = False) -> Callable:
    """The synchronous round on the silo-grouped path, the drop-in
    counterpart of ``engine.build_round_fn`` (the same scaffold, so the
    randomness and the metrics contract cannot drift):

        round_fn(gv, agg_state, x, y, counts, rng, participation=None,
                 seeds=None, perms=None, host_counts=None, stats=...)
            -> (new_global, agg_state, metrics[, None])

    ``collect_stats=True`` gives ``build_round_fn``'s four outputs, the
    fourth always None: the silo round has no client-ledger rows."""
    device = resolve_device(device)
    cfg.validate(device=device)
    from fedml_tpu_torch.core.builder import build_round_core

    core = build_round_core(build_silo_local_update(trainer, cfg), aggregator)

    def round_fn(gv, agg_state, x, y, counts, rng, participation=None, seeds=None,
                 perms=None, host_counts=None, stats=False):
        if participation is not None:
            participation = participation.to(device)
        out = core(gv, agg_state, x.to(device), y.to(device), counts.to(device), rng,
                   participation, seeds, perms, host_counts, False)
        return out if collect_stats else out[:3]

    return round_fn
