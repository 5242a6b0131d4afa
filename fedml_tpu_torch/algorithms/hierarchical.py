"""Hierarchical (two-level cloud -> group -> client) FedAvg, PyTorch form of
``fedml_tpu/algorithms/hierarchical.py``.

Reference fedml_api/standalone/hierarchical_fl/ (group.py:24-46
``Group.train``: group_comm_round inner FedAvg rounds; trainer.py:43-71
``Trainer.train``: the cloud averages the group models). Held against the CI
oracle: hierarchical == flat FedAvg == centralized when the total local work
is fixed (reference CI-script-fedavg.sh:52-62).

The groups and their clients are loops over the engine's client step
(``engine._batched_update``), as the port's FedAvg round loops its cohort.
``backend="shard_map"`` on one device is this round (the JAX package's
two-level mesh over one device). In a process group of more than one rank
the API raises: the two-level sharded round is ROADMAP.md Queue 1 item 2.3,
and running this one-device round on every rank would repeat it silently.
``cfg.fused_kernel`` has
no effect here, as in the JAX package: only ``engine.build_round_fn``
routes a round through the fused kernel.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from fedml_tpu_torch.algorithms.engine import (_batched_update, build_eval_fn,
                                               pack_test_batches, test_metrics)
from fedml_tpu_torch.algorithms.fedavg import round_generator
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.registry import FederatedDataset
from fedml_tpu_torch.telemetry.records import fetch_scalars
from fedml_tpu_torch.utils.device import resolve_device
from fedml_tpu_torch.utils.pytree import tree_weighted_mean


def default_group_assignment(client_num: int, group_num: int, seed: int) -> list:
    """The JAX package's default split, bit for bit: a ``RandomState(seed)``
    permutation of the clients cut by ``np.array_split``, each group
    sorted."""
    idx = np.random.RandomState(seed).permutation(client_num)
    return [np.sort(a) for a in np.array_split(idx, group_num)]


def build_hierarchical_round_fn(trainer, cfg: FedConfig, group_comm_round: int) -> Callable:
    """hier_round(global_variables, x, y, counts, rng, host_counts) ->
    (new_global, metrics): every group runs ``group_comm_round`` inner
    FedAvg rounds from the cloud model over all its clients, each inner
    round's model their sample-weighted mean; then the cloud averages the
    group models weighted by each group's total count. The metrics are the
    last inner round's, summed over clients and groups (0-d tensors on the
    device).

    Inputs are group-major: x [G, C, n_max, ...] and counts [G, C] on the
    device, ``host_counts`` their [G, C] host copy (the client loop decides
    its steps from it), ``rng`` the round's CPU generator, from which every
    inner round draws its clients' shuffles and dropout seeds in turn
    (group by group). A zero-count client (a ragged group's padding) takes
    no step and weighs 0 at both levels."""
    batched = _batched_update(trainer, cfg)

    def hier_round(global_variables, x, y, counts, rng, host_counts):
        weights = counts.to(torch.float32)
        group_models, metrics = [], None
        for g in range(x.shape[0]):
            gv = global_variables
            for _ in range(group_comm_round):
                result = batched(gv, x[g], y[g], counts[g], rng, host_counts=host_counts[g])
                gv = tree_weighted_mean(result.variables, weights[g])
            last = {k: v.sum() for k, v in result.metrics.items()}
            metrics = last if metrics is None else {k: metrics[k] + last[k] for k in last}
            group_models.append(gv)
        stacked = {k: torch.stack([m[k] for m in group_models]) for k in group_models[0]}
        return tree_weighted_mean(stacked, counts.sum(1).to(torch.float32)), metrics

    return hier_round


class HierarchicalFLAPI:
    """Cloud/group/client simulator (reference hierarchical_fl Trainer) on
    ``device`` (``cuda`` unless the caller asks for the CPU).

    ``group_assignment``: a list of client-index arrays, one per group
    (default ``default_group_assignment``). Ragged groups (the reference
    accepts any split, group.py:24-46) are padded to the largest group with
    zero-count clients. The group-major arrays are stacked and copied to
    the device once, here."""

    def __init__(self, dataset: FederatedDataset, cfg: FedConfig, trainer,
                 group_num: int = 2, group_comm_round: int = 1,
                 group_assignment: list[np.ndarray] | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.cfg = cfg.validate(device=self.device)
        if cfg.mesh_size() > 1:
            raise NotImplementedError(
                f"hierarchical FL over a process group of {cfg.mesh_size()} ranks is not "
                f"ported to fedml_tpu_torch yet (ROADMAP.md Queue 1 item 2.3, "
                f"parallel/hierarchical.py); run it in one process")
        self.trainer = trainer
        self.group_comm_round = group_comm_round
        if group_assignment is None:
            group_assignment = default_group_assignment(dataset.client_num, group_num,
                                                        cfg.seed)
        self.groups = group_assignment
        if any(len(g) == 0 for g in self.groups):
            raise ValueError("every group needs at least one client")
        self.eval_fn = build_eval_fn(trainer)
        c_max = max(len(g) for g in self.groups)
        xs, ys, cs = [], [], []
        for g in self.groups:
            x, y, c = dataset.train.select(g)
            pad = c_max - len(g)
            if pad:
                x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
                y = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
                c = np.concatenate([c, np.zeros(pad, c.dtype)])
            xs.append(x)
            ys.append(y)
            cs.append(c)
        self._host_counts = np.stack(cs)
        self._x = torch.from_numpy(np.stack(xs)).to(self.device)
        self._y = torch.from_numpy(np.stack(ys)).to(self.device)
        self._counts = torch.from_numpy(self._host_counts).to(self.device)
        self.round_fn = build_hierarchical_round_fn(trainer, cfg, group_comm_round)
        self.global_variables = trainer.init(torch.Generator().manual_seed(cfg.seed),
                                             self.device)
        self._test_batches = pack_test_batches(dataset.test_global, cfg.batch_size,
                                               self.device)

    def train_one_round(self, round_idx: int) -> dict[str, Any]:
        self.global_variables, metrics = self.round_fn(
            self.global_variables, self._x, self._y, self._counts,
            round_generator(self.cfg.seed, round_idx), self._host_counts)
        return dict(zip(metrics, fetch_scalars(list(metrics.values()))))

    def train(self):
        history = []
        for r in range(self.cfg.comm_round):
            m = self.train_one_round(r)
            history.append({"round": r, **m, **self.eval_global()})
        return history

    def eval_global(self):
        return test_metrics(self.eval_fn, self.global_variables, self._test_batches)
