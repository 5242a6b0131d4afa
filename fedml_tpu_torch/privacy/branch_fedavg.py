"""Branch-wise FedAvg and the server-side ensembles, PyTorch form of
``fedml_tpu/privacy/branch_fedavg.py`` (reference privacy_fedml/
fedavg_api.py:15-200 and the ensemble APIs predavg_api.py:16-130,
predweight_api.py, blockavg_api.py, heteroensemble_api.py).

``branch_num`` global models ("branches") train side by side. Each round
the sampled clients are assigned a branch round-robin (reference
_set_client_branch, predavg_api.py:35-47) and each branch runs the
engine's round (``algorithms/engine.py::build_round_fn``) with its own
FedAvg aggregator over its own clients. The server serves an ensemble:

  predavg    - the mean of the branches' softmax outputs
  predvote   - a majority vote of the branches' argmaxes
  predweight - convex branch weights fit on a held-out server split
  blockavg   - the mean of the named top-level blocks across branches
               after every round (homogeneous blocks), then predavg
  hetero     - branches of different ArchSpecs, predavg

Argmax ties go to the first index, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import build_round_fn
from fedml_tpu_torch.algorithms.fedavg import client_sampling, round_generator
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.registry import FederatedDataset
from fedml_tpu_torch.utils.device import resolve_device


class BranchFedAvgAPI:
    """``trainers`` is one ModelTrainer per branch (one module for
    homogeneous branches, one per ArchSpec for the hetero ensemble). Runs
    on ``device`` (``cuda`` unless the caller asks for the CPU); the
    branches start from the port's own initialisation, drawn in branch
    order from one generator seeded with ``cfg.seed``, and branch b's
    round draws from ``round_generator(cfg.seed, round, b)``."""

    def __init__(self, dataset: FederatedDataset, cfg: FedConfig,
                 trainers: Sequence, ensemble_method: str = "predavg",
                 shared_blocks: Sequence[str] = (), server_data_ratio: float = 0.1,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.cfg = cfg.validate(device=self.device)
        self.trainers = list(trainers)
        self.branch_num = len(self.trainers)
        self.ensemble_method = ensemble_method
        self.shared_blocks = tuple(shared_blocks)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.branches = [t.init(gen, self.device) for t in self.trainers]
        agg = [make_aggregator("fedavg", cfg) for _ in self.trainers]
        self.round_fns = [build_round_fn(t, cfg, a, device=self.device)
                          for t, a in zip(self.trainers, agg)]
        self.agg_states = [a.init_state(v) for a, v in zip(agg, self.branches)]
        # held-out server split for predweight fitting (reference
        # --server_data_ratio, privacy_fedml/main_fedavg.py:122-134)
        xte, yte = dataset.test_global
        k = max(1, int(len(yte) * server_data_ratio))
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        self._server_data = (to(xte[:k]), to(yte[:k]))
        self._eval_data = (to(xte[k:]), to(yte[k:]))
        self.branch_weights = torch.ones(self.branch_num, device=self.device) / self.branch_num
        self.history: list[dict[str, Any]] = []

    # ------------------------------------------------------------- training
    def assign_branches(self, num_clients: int, round_idx: int) -> np.ndarray:
        """Round-robin slot -> branch map (reference _set_client_branch)."""
        return np.array([(i - round_idx) % self.branch_num for i in range(num_clients)])

    def train_one_round(self, round_idx: int) -> dict[str, Any]:
        cfg = self.cfg
        idx = client_sampling(round_idx, self.dataset.client_num, cfg.client_num_per_round)
        branch_of = self.assign_branches(len(idx), round_idx)
        metrics = {}
        for b in range(self.branch_num):
            mine = idx[branch_of == b]
            if len(mine) == 0:
                continue
            x, y, counts = self.dataset.train.select(mine)
            counts = torch.from_numpy(np.ascontiguousarray(counts))
            self.branches[b], self.agg_states[b], m = self.round_fns[b](
                self.branches[b], self.agg_states[b],
                torch.from_numpy(np.ascontiguousarray(x)),
                torch.from_numpy(np.ascontiguousarray(y)), counts,
                round_generator(cfg.seed, round_idx, b), host_counts=counts)
            metrics[f"branch{b}_loss"] = (float(m.get("loss_sum", 0.0))
                                          / max(float(m.get("total", 1.0)), 1.0))
        if self.shared_blocks:
            self._average_shared_blocks()
        if self.ensemble_method == "predweight":
            self.fit_branch_weights()
        return metrics

    def _average_shared_blocks(self):
        """blockavg: the mean of the named top-level blocks' parameters
        across branches (those blocks must be homogeneous; reference
        blockavg_api.py averages matching state_dict prefixes)."""
        for name in self.shared_blocks:
            keys = [k for k in self.branches[0] if k.split(".")[0] == name]
            mean = {k: torch.stack([b[k] for b in self.branches]).mean(0) for k in keys}
            self.branches = [{**b, **mean} for b in self.branches]

    def train(self):
        for r in range(self.cfg.comm_round):
            m = self.train_one_round(r)
            self.history.append({"round": r, **m, **self.evaluate()})
        return self.history

    # ------------------------------------------------------------- ensembles
    def branch_probs(self, x) -> torch.Tensor:
        """[branch_num, n, classes] softmax predictions of every branch
        (differentiable in ``x``: the adversarial attacks take its
        gradient)."""
        x = torch.as_tensor(x).to(self.device)
        return torch.stack([torch.softmax(t.apply(v, x)[0], -1)
                            for t, v in zip(self.trainers, self.branches)])

    def _combine(self, probs: torch.Tensor) -> torch.Tensor:
        """The ensemble's class per row from the branches' probabilities."""
        if self.ensemble_method == "predvote":
            votes = probs.argmax(-1)  # [B, n]
            onehot = torch.nn.functional.one_hot(votes, probs.shape[-1]).sum(0)
            return onehot.argmax(-1)
        if self.ensemble_method == "predweight":
            w = torch.softmax(self.branch_weights, 0)
            return torch.tensordot(w, probs.to(w.dtype), dims=([0], [0])).argmax(-1)
        # predavg / blockavg / hetero: mean probability
        return probs.mean(0).argmax(-1)

    @torch.no_grad()
    def ensemble_predict(self, x) -> torch.Tensor:
        return self._combine(self.branch_probs(x))

    def fit_branch_weights(self, steps: int = 50, lr: float = 0.5):
        """predweight: fit the convex combination on the server split by
        plain SGD (reference PredWeight trains its weight layer on server
        data)."""
        xs, ys = self._server_data
        with torch.no_grad():
            probs = self.branch_probs(xs)  # [B, n, C]
        rows = torch.arange(ys.shape[0], device=ys.device)
        w = self.branch_weights
        for _ in range(steps):
            w = w.detach().requires_grad_(True)
            p = torch.tensordot(torch.softmax(w, 0), probs.to(w.dtype), dims=([0], [0]))
            loss = -torch.log(p[rows, ys.long()] + 1e-9).mean()
            (g,) = torch.autograd.grad(loss, [w])
            w = w - lr * g
        self.branch_weights = w.detach()

    @torch.no_grad()
    def evaluate(self) -> dict[str, float]:
        x, y = self._eval_data
        probs = self.branch_probs(x)
        out = {"Ensemble/Acc": float((self._combine(probs) == y).float().mean())}
        out.update({f"Branch{b}/Acc": float((p.argmax(-1) == y).float().mean())
                    for b, p in enumerate(probs)})
        return out
