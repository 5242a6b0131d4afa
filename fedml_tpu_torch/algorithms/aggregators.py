"""Server aggregation rules (PyTorch form of
``fedml_tpu/algorithms/aggregators.py``).

An aggregator is a callable
    (global_variables, LocalResult, weights, rng, state) -> (new_global, state)
where ``LocalResult.variables`` is a dict of client-stacked tensors [C, ...].

  FedAvgAggregator   <- reference FedAVGAggregator.py:58-87 (weighted mean)
  FedOptAggregator   <- reference FedOptAggregator.py:94-123 (a server
                        optimizer on the pseudo-gradient w_global - w_avg)
  RobustAggregator   <- reference robust_aggregation.py:32-55 (per-client
                        delta norm clipping + weak-DP gaussian noise)
  FedNovaAggregator  <- reference fednova.py:79-155 (normalized averaging)

FedAvg averages every variable. The other rules act on the parameters
only and plain-average the model state (a BatchNorm's running statistics),
as the JAX rules act on the ``params`` collection and the reference's
robust rule skips what ``is_weight_param`` rejects: FedOpt's pseudo-gradient
and server optimizer state, the robust rule's clip and noise and FedNova's
tau normalisation see parameters only (``utils/pytree.py::split_variables``).
``rng`` is the round's CPU generator; an aggregator state is a dict of
tensors on the device.

Each aggregator also has ``sharded(gv, result, weights, rng, state)``: the
same rule in the clients-sharded round (``parallel/sharded.py``), where
``result`` and ``weights`` hold this rank's block of the cohort and
``group`` is the process group (None: the default one). Every
cross-client reduction becomes a locally weighted partial sum and an
``all_reduce(SUM)`` over the process group (``tree_weighted_sum_psum``);
per-client work (clipping, tau normalisation) stays local, so the sharded
rule equals ``__call__`` up to float summation order.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from fedml_tpu_torch.algorithms.engine import (Optimizer, apply_updates,
                                               bias_correction, scaled, sgd,
                                               torch_adagrad)
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.utils.pytree import split_variables, tree_weighted_mean


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


def tree_weighted_sum_psum(stacked: dict, weights: torch.Tensor, group=None) -> dict:
    """The cross-rank weighted SUM: this rank's clients weight-summed, then
    the leaf-sized partials all-reduced over the process group in one
    buffer (``parallel/mesh.py::all_reduce_tree``). Callers own the weight
    normalisation."""
    from fedml_tpu_torch.parallel.mesh import all_reduce_tree

    def wsum(leaf):
        wb = weights.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)
        return (leaf * wb).sum(0)

    return all_reduce_tree({k: wsum(v) for k, v in stacked.items()}, group=group)


def total_weight_psum(weights: torch.Tensor, group=None) -> torch.Tensor:
    """The cohort's total weight over every rank."""
    from fedml_tpu_torch.parallel.mesh import all_reduce_tree

    return all_reduce_tree({"w": weights.sum()}, group=group)["w"]


def tree_weighted_mean_psum(stacked: dict, weights: torch.Tensor, group=None) -> dict:
    """``tree_weighted_mean`` with the client axis split over the ranks:
    normalised by the all-reduced total weight, then the weighted-sum
    all-reduce."""
    w = weights / torch.clamp(total_weight_psum(weights, group), min=1e-12)
    return tree_weighted_sum_psum(stacked, w, group)


class FedAvgAggregator:
    """Sample-weighted mean over every variable (reference
    FedAVGAggregator.py:58-87)."""

    def __init__(self, cfg: FedConfig):
        self.cfg = cfg

    def init_state(self, global_variables) -> Any:
        return ()

    def __call__(self, global_variables, result, weights, rng, state):
        return tree_weighted_mean(result.variables, weights), state

    def sharded(self, global_variables, result, weights, rng, state, group=None):
        if self.cfg.extra.get("flat_agg", False):
            raise ValueError(
                "flat_agg is a single-chip latency probe (and a measured "
                "negative, docs/PERF.md) — it has no sharded rule; drop "
                "extra['flat_agg'] for shard_map runs")
        return tree_weighted_mean_psum(result.variables, weights, group), state


def _scale_by_moments(b1: float, b2: float, eps: float, initial: float,
                      second) -> Optimizer:
    """optax's ``ScaleByAdamState`` family (eps_root 0): moments start at
    ``initial``, the first is an EMA of g, the second ``second(g, nu)``;
    the update is the bias-corrected mu / (sqrt(nu) + eps)."""

    def init(params):
        device = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": {k: torch.full_like(p, initial) for k, p in params.items()},
                "nu": {k: torch.full_like(p, initial) for k, p in params.items()}}

    def update(updates, state, params=None):
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in updates.items()}
        nu = {k: second(g, state["nu"][k]) for k, g in updates.items()}
        t = state["count"] + 1
        bc1, bc2 = bias_correction(b1, t), bias_correction(b2, t)
        out = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps) for k in mu}
        return out, {"count": t, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """optax.scale_by_adam."""
    return _scale_by_moments(b1, b2, eps, 0.0,
                             lambda g, v: (1 - b2) * (g * g) + b2 * v)


def scale_by_yogi(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3,
                  initial: float = 1e-6) -> Optimizer:
    """optax.scale_by_yogi: the second moment moves by
    (1 - b2) * sign(v - g^2) * g^2, with sign(0) = 0."""
    return _scale_by_moments(
        b1, b2, eps, initial,
        lambda g, v: v - (1 - b2) * torch.sign(v - g * g) * (g * g))


def make_server_optimizer(cfg: FedConfig) -> Optimizer:
    """The JAX package's server optimizers (reference OptRepo,
    fedopt/optrepo.py:7-64), each with optax's numerics: ``sgd`` (with
    ``server_momentum``), ``adam`` (torch.optim.Adam's defaults), ``yogi``
    (Reddi et al.'s FedYogi, optax.yogi) and torch-exact ``adagrad``."""
    name = cfg.server_optimizer.lower()
    if name == "sgd":
        return sgd(cfg.server_lr, cfg.server_momentum)
    if name == "adam":
        return scaled(scale_by_adam(), -cfg.server_lr)
    if name == "yogi":
        return scaled(scale_by_yogi(), -cfg.server_lr)
    if name == "adagrad":
        return torch_adagrad(cfg.server_lr)
    raise ValueError(f"unknown server_optimizer {cfg.server_optimizer!r}")


class FedOptAggregator:
    """FedOpt family: the pseudo-gradient w_global - w_avg drives a server
    optimizer (FedAdam, FedYogi, FedAdagrad, server SGD with momentum =
    FedAvgM). With server SGD at lr 1.0 it reduces to FedAvg (reference
    set_model_global_grads, FedOptAggregator.py:109)."""

    def __init__(self, cfg: FedConfig):
        self.cfg = cfg
        self.opt = make_server_optimizer(cfg)

    def init_state(self, global_variables) -> dict:
        return self.opt.init(split_variables(global_variables)[0])

    def __call__(self, global_variables, result, weights, rng, state):
        avg = tree_weighted_mean(result.variables, weights)
        return self.server_step(global_variables, avg, state)

    def sharded(self, global_variables, result, weights, rng, state, group=None):
        # the server step runs on every rank over the all-reduced mean:
        # elementwise work, the same bits everywhere
        avg = tree_weighted_mean_psum(result.variables, weights, group)
        return self.server_step(global_variables, avg, state)

    def server_step(self, global_variables, avg, state):
        """(new_global, state) from the round's weighted mean ``avg``: the
        server optimizer steps the parameters; the model state is the
        mean's."""
        params = split_variables(global_variables)[0]
        pseudo_grad = {k: g - avg[k] for k, g in params.items()}
        updates, state = self.opt.update(pseudo_grad, state, params)
        return {**avg, **apply_updates(params, updates)}, state


class RobustAggregator:
    """Clip each client's parameter delta to ``norm_bound``, take the
    weighted mean, then add N(0, stddev^2) weak-DP noise to the parameters
    (reference robust_aggregation.py:37-55); the model state is averaged,
    never clipped or noised.

    JAX's threefry noise cannot be reproduced, so the noise is drawn on the
    device from a generator seeded by the round generator ``rng`` (after the
    clients' draws): a pure function of (seed, round)."""

    def __init__(self, cfg: FedConfig):
        self.cfg = cfg

    def init_state(self, global_variables):
        return ()

    def __call__(self, global_variables, result, weights, rng, state):
        avg = tree_weighted_mean(self._clipped(global_variables, result), weights)
        return self._add_noise(avg, rng), state

    def sharded(self, global_variables, result, weights, rng, state, group=None):
        # the clip is per client (local); only the mean crosses ranks. Every
        # rank's round generator is in the same state here (each drew the
        # whole cohort's randomness, parallel/sharded.py), so the noise is
        # drawn on each rank's device from the same seed: the same bits
        avg = tree_weighted_mean_psum(self._clipped(global_variables, result), weights,
                                      group)
        return self._add_noise(avg, rng), state

    def _clipped(self, global_variables, result):
        params = split_variables(result.variables)[0]
        deltas = {k: v - global_variables[k][None] for k, v in params.items()}
        sq = sum((d * d).reshape(d.shape[0], -1).sum(1) for d in deltas.values())
        nrm = torch.sqrt(sq + 1e-12)
        scale = torch.clamp(self.cfg.norm_bound / nrm, max=1.0)
        clipped = {k: global_variables[k][None]
                   + d * scale.reshape((-1,) + (1,) * (d.dim() - 1))
                   for k, d in deltas.items()}
        return {k: clipped.get(k, v) for k, v in result.variables.items()}

    def _add_noise(self, avg, rng):
        params = split_variables(avg)[0]
        device = next(iter(avg.values())).device
        seed = int(torch.randint(0, 2 ** 63 - 1, (), generator=rng))
        gen = torch.Generator(device=device).manual_seed(seed)
        noisy = {k: v + self.cfg.stddev * torch.randn(v.shape, generator=gen,
                                                      device=device, dtype=v.dtype)
                 for k, v in params.items()}
        return {**avg, **noisy}


class FedNovaAggregator:
    """FedNova normalized averaging (Wang et al. 2020; reference
    fednova.py:79-155): each client's delta is divided by its local step
    count tau_i, and the weighted mean is rescaled by
    tau_eff = sum_i w_i tau_i:

        w_new = w_global - tau_eff * sum_i w_i (w_global - w_i) / tau_i

    over the parameters; the model state is plainly averaged.
    """

    def __init__(self, cfg: FedConfig):
        self.cfg = cfg

    def init_state(self, global_variables):
        return ()

    def __call__(self, global_variables, result, weights, rng, state):
        w = weights / weights.sum()
        tau = torch.clamp(result.num_steps.float(), min=1.0)
        tau_eff = (w * tau).sum()

        def combine(stack, g):
            shape = (-1,) + (1,) * (stack.dim() - 1)
            d = (g[None] - stack) / tau.reshape(shape)
            return g - tau_eff * (d * w.reshape(shape).to(d.dtype)).sum(0)

        params, rest = split_variables(result.variables)
        mean = tree_weighted_mean(rest, weights)
        return {k: combine(v, global_variables[k]) if k in params else mean[k]
                for k, v in result.variables.items()}, state

    def sharded(self, global_variables, result, weights, rng, state, group=None):
        # tau normalisation is per client (local); tau_eff, the normalised
        # deltas' weighted sum and the state's weighted mean are partial
        # sums, all-reduced together in one buffer after the total weight
        from fedml_tpu_torch.parallel.mesh import all_reduce_tree

        wtotal = total_weight_psum(weights, group)
        w = weights / wtotal
        tau = torch.clamp(result.num_steps.float(), min=1.0)
        params, rest = split_variables(result.variables)
        partial = {"tau_eff": (w * tau).sum()}
        for k, stack in params.items():
            shape = (-1,) + (1,) * (stack.dim() - 1)
            d = (global_variables[k][None] - stack) / tau.reshape(shape)
            partial[k] = (d * w.reshape(shape).to(d.dtype)).sum(0)
        w_rest = weights / torch.clamp(wtotal, min=1e-12)
        for k, stack in rest.items():
            wb = w_rest.reshape((-1,) + (1,) * (stack.dim() - 1)).to(stack.dtype)
            partial[k] = (stack * wb).sum(0)
        total = all_reduce_tree(partial, group=group)
        tau_eff = total["tau_eff"]
        return {k: global_variables[k] - tau_eff * total[k] if k in params else total[k]
                for k in result.variables}, state


# --------------------------------------------------------------- buffered
# Staleness-aware buffered aggregation (FedBuff): the admit and commit
# steps. ``algorithms/buffered.py`` owns the drive loop and the host-side
# arrival schedule; the rules live here beside the synchronous aggregators
# they stay bit-compatible with (the degenerate buffer is the synchronous
# round, tests/test_torch_buffered.py).


def make_staleness_discount(alpha: float):
    """The default staleness discount: an update born at round b and
    committed at round t gets the multiplier (1 + (t - b)) ** -alpha, the
    power taken in float32. With alpha 0 (or staleness 0) it is exactly 1.0
    (pow(x, -0.0) == 1 and pow(1, y) == 1), so the degenerate buffer
    multiplies its weights by the identity."""
    exponent = float(np.float32(-float(alpha)))

    def discount(staleness: torch.Tensor) -> torch.Tensor:
        return torch.pow(1.0 + staleness,
                         torch.tensor(exponent, dtype=torch.float32,
                                      device=staleness.device))

    return discount


def init_buffer(result, k: int) -> dict:
    """An all-zero K-row update buffer shaped after one stacked LocalResult:
    ``vars``, ``steps``, ``weights`` and ``metrics`` rows. Its fill and the
    rows' birth rounds live on the host (``buffered._HostState``)."""
    def row(leaf):
        return torch.zeros((k,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                           device=leaf.device)

    return {"vars": {n: row(v) for n, v in result.variables.items()},
            "steps": row(result.num_steps),
            "weights": torch.zeros(k, dtype=torch.float32,
                                   device=result.num_steps.device),
            "metrics": {n: row(v) for n, v in result.metrics.items()}}


def build_buffer_admit(codec=None):
    """admit(buf, stacked_vars, stacked_steps, stacked_metrics, counts, src,
    fill, global_variables=None) -> buf: row ``src`` of a stacked
    LocalResult written into buffer row ``fill`` (host ints), in place. A
    caller that must keep the old buffer (the guard's snapshot) clones it.

    ``codec`` arms the compressed admit: the row's delta against
    ``global_variables`` (the current globals, the reference the commit
    applies it to) crosses into the buffer encoded and decoded, with no
    residual (an admitted row is a one-off sender), so the buffer holds
    what the wire delivered and the commit is unchanged."""
    from fedml_tpu_torch.codecs.int8 import _inexact

    @torch.no_grad()
    def admit(buf, stacked_vars, stacked_steps, stacked_metrics, counts, src,
              fill, global_variables=None):
        row_vars = {n: v[src:src + 1] for n, v in stacked_vars.items()}
        if codec is not None:
            delta = {n: r - global_variables[n][None] if _inexact(r) else r
                     for n, r in row_vars.items()}
            payload, _ = codec.encode(delta, codec.init_state(delta))
            dec = codec.decode(payload, delta)
            row_vars = {n: (global_variables[n][None] + dec[n]).to(r.dtype)
                        if _inexact(r) else dec[n]
                        for n, r in row_vars.items()}
        for n, r in row_vars.items():
            buf["vars"][n][fill].copy_(r[0])
        buf["steps"][fill].copy_(stacked_steps[src])
        buf["weights"][fill].copy_(counts[src].to(torch.float32))
        for n, v in stacked_metrics.items():
            buf["metrics"][n][fill].copy_(v[src])
        return buf

    return admit


def build_buffer_commit(aggregator, discount_fn):
    """commit(global_variables, agg_state, buf, fill, births, commit_round,
    rng) -> (new_global, new_state, metrics): the buffer's first ``fill``
    rows (born at the host ints ``births``) staleness-discounted, then the
    quarantine stage and the aggregator over them.

    Rows at index >= ``fill`` (a partial final flush, stale rows of an
    earlier commit) are masked out through the synchronous round's
    participation-mask path, so a full buffer with zero staleness feeds the
    aggregator the synchronous round's inputs. When every row quarantines,
    globals and aggregator state pass through unchanged. The buffer is only
    read; the metrics are 0-d tensors on the device. Under LoRA the rows
    are adapters only: the aggregator sees the stripped globals, and the
    server's frozen base re-attaches to its output."""
    from fedml_tpu_torch.algorithms.engine import LocalResult
    from fedml_tpu_torch.core.builder import _select_state
    from fedml_tpu_torch.models.lora import attach_lora_base, strip_lora_base
    from fedml_tpu_torch.utils.device import to_device
    from fedml_tpu_torch.utils.pytree import tree_where

    @torch.no_grad()
    def commit(global_variables, agg_state, buf, fill, births, commit_round, rng):
        k = buf["weights"].shape[0]
        device = buf["weights"].device
        ages = [commit_round - b for b in births] + [0] * (k - len(births))
        staleness = to_device(torch.tensor(ages, dtype=torch.int32),
                              device).to(torch.float32)
        weights = buf["weights"] * discount_fn(staleness)
        participation = torch.arange(k, device=device) < fill
        result = LocalResult(buf["vars"], buf["steps"], buf["metrics"])
        result, weights, alive, quarantined = quarantine_stage(
            result, weights, participation)
        trained = strip_lora_base(global_variables)
        new_global, new_state = aggregator(trained, result, weights, rng, agg_state)
        any_alive = alive.any()
        new_global = tree_where(any_alive, new_global, trained)
        new_global = attach_lora_base(new_global, global_variables)
        new_state = _select_state(any_alive, new_state, agg_state)
        metrics = {n: v.sum() for n, v in result.metrics.items()}
        metrics["participated_count"] = alive.sum().float()
        metrics["quarantined_count"] = quarantined.sum().float()
        alive_f = alive.float()
        metrics["staleness_sum"] = (staleness * alive_f).sum()
        metrics["staleness_max"] = torch.where(
            alive, staleness, torch.zeros((), device=device)).max()
        return new_global, new_state, metrics

    return commit


AGGREGATORS = {
    "fedavg": FedAvgAggregator,
    "fedopt": FedOptAggregator,
    "robust": RobustAggregator,
    "fednova": FedNovaAggregator,
}


def make_aggregator(name: str, cfg: FedConfig):
    if name not in AGGREGATORS:
        raise NotImplementedError(
            f"aggregator {name!r} is not ported to fedml_tpu_torch yet "
            f"(ported: {sorted(AGGREGATORS)})")
    return AGGREGATORS[name](cfg)
