"""The block ensemble, PyTorch form of ``fedml_tpu/privacy/blockensemble.py``
(reference privacy_fedml/blockensemble_api.py:1-318).

The server keeps ``branch_num`` variables dicts ("branches") of one
AdaptiveCNN architecture. Each round (reference prepare_branch_dict,
:119-152):

1. for every block (conv1 / conv2 / linear1 / linear2) draw ``num_paths``
   distinct branches without replacement;
2. assemble ``num_paths`` mixed-path models: path k takes block B's
   parameters from the k-th branch drawn for B;
3. the sampled clients train all paths jointly (``multi_model.py``), one
   client after another on the device, and each path is sample-weighted
   over the clients;
4. each trained block goes back to the branch it came from, averaged over
   the paths that trained that (branch, block) this round (reference
   update_branch_params / average_updated_branch_params:160-185); blocks
   no path trained keep their parameters bit for bit.

Prediction is the branches' mean softmax.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import client_sampling, round_generator
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import flax_default_init
from fedml_tpu_torch.data.registry import FederatedDataset
from fedml_tpu_torch.models.ensemble import AdaptiveCNN, ArchSpec
from fedml_tpu_torch.privacy.multi_model import build_joint_local_update
from fedml_tpu_torch.utils.device import resolve_device
from fedml_tpu_torch.utils.pytree import tree_weighted_mean

BLOCKS = ("conv1", "conv2", "linear1", "linear2")


def block_of(param_name: str) -> str:
    """A parameter's key -> its block (reference block_to_param_name,
    blockensemble_api.py:51, groups state_dict keys by block prefix)."""
    for b in BLOCKS:
        if param_name.startswith(b):
            return b
    raise KeyError(f"param {param_name!r} belongs to no block")


class BlockEnsembleAPI:
    """Runs on ``device`` (``cuda`` unless the caller asks for the CPU).
    The branches start from the port's own initialisation, drawn in branch
    order from one generator seeded with ``cfg.seed``."""

    def __init__(self, dataset: FederatedDataset, cfg: FedConfig,
                 branch_num: int = 4, num_paths: int = 2,
                 feat_lmda: float = 0.0, arch: ArchSpec | None = None,
                 device="cuda"):
        if not 2 <= num_paths <= branch_num:
            raise ValueError("need 2 <= num_paths <= branch_num")
        self.device = resolve_device(device)
        self.dataset = dataset
        self.cfg = cfg.validate(device=self.device)
        self.branch_num = branch_num
        self.num_paths = num_paths
        shape = dataset.train.x.shape[2:]
        self.module = AdaptiveCNN(output_dim=dataset.class_num, arch=arch or ArchSpec(),
                                  dtype=cfg.dtype, input_hw=int(shape[0]),
                                  in_channels=int(shape[-1]))
        gen = torch.Generator().manual_seed(cfg.seed)
        self.branches: list[dict] = [flax_default_init(self.module, gen, self.device)
                                     for _ in range(branch_num)]
        self._local = build_joint_local_update(self.module, cfg, num_paths, feat_lmda)
        self.history: list[dict[str, Any]] = []

    # ------------------------------------------------------------- one round
    def prepare_paths(self, round_idx: int):
        """Per-block branch draw and path assembly (reference
        prepare_branch_dict, blockensemble_api.py:119-152)."""
        rng = np.random.RandomState(self.cfg.seed * 1000003 + round_idx)
        pick = {b: rng.choice(self.branch_num, self.num_paths, replace=False)
                for b in BLOCKS}
        paths = tuple({name: self.branches[pick[block_of(name)][k]][name]
                       for name in self.branches[0]}
                      for k in range(self.num_paths))
        return paths, pick

    def train_one_round(self, round_idx: int, perms=None) -> dict[str, Any]:
        """One round. ``perms`` [C, epochs, n_max], when given, replaces the
        clients' drawn permutations."""
        cfg = self.cfg
        idx = client_sampling(round_idx, self.dataset.client_num, cfg.client_num_per_round)
        x, y, counts = self.dataset.train.select(idx)
        paths, pick = self.prepare_paths(round_idx)
        dx = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        dy = torch.from_numpy(np.ascontiguousarray(y)).to(self.device)
        rng = round_generator(cfg.seed, round_idx)
        trained, metrics = [], []
        for c in range(len(idx)):
            t, m = self._local(paths, dx[c], dy[c], int(counts[c]), rng,
                               None if perms is None else perms[c])
            trained.append(t)
            metrics.append(m)
        w = torch.as_tensor(np.asarray(counts, np.float32), device=self.device)
        means = [tree_weighted_mean({name: torch.stack([t[k][name] for t in trained])
                                     for name in paths[k]}, w)
                 for k in range(self.num_paths)]
        # scatter the trained blocks back, averaged per (branch, block)
        accum = {(b, blk): [] for b in range(self.branch_num) for blk in BLOCKS}
        for k in range(self.num_paths):
            for blk in BLOCKS:
                accum[(int(pick[blk][k]), blk)].append(means[k])
        for (b, blk), contribs in accum.items():
            if not contribs:
                continue  # an untrained block keeps its parameters
            branch = dict(self.branches[b])
            for name in branch:
                if block_of(name) == blk:
                    branch[name] = torch.stack([c[name] for c in contribs]).mean(0)
            self.branches[b] = branch
        sums = {k: float(sum(m[k] for m in metrics)) for k in metrics[0]}
        total = max(sums["total"], 1.0)
        return {"Train/Loss": sums["loss_sum"] / total, "Train/Acc": sums["correct"] / total}

    def train(self, metrics_logger=None):
        for r in range(self.cfg.comm_round):
            rec = {"round": r, **self.train_one_round(r)}
            if r % self.cfg.frequency_of_the_test == 0 or r == self.cfg.comm_round - 1:
                rec.update(self.evaluate())
            self.history.append(rec)
            if metrics_logger is not None:
                metrics_logger.log({k: v for k, v in rec.items() if k != "round"}, step=r)
        return self.history

    # ------------------------------------------------------------------ eval
    def branch_probs(self, x) -> torch.Tensor:
        """[branch_num, n, classes] softmax of every branch (differentiable
        in ``x``: the adversarial attacks take its gradient)."""
        x = torch.as_tensor(x).to(self.device)
        return torch.stack([torch.softmax(torch.func.functional_call(
            self.module, v, (x,), {"train": False}), -1) for v in self.branches])

    @torch.no_grad()
    def evaluate(self) -> dict[str, float]:
        xte, yte = self.dataset.test_global
        y = torch.as_tensor(yte).to(self.device)
        probs = self.branch_probs(xte)
        out = {"Ensemble/Acc": float((probs.mean(0).argmax(-1) == y).float().mean())}
        for b in range(self.branch_num):
            out[f"Branch{b}/Acc"] = float((probs[b].argmax(-1) == y).float().mean())
        return out
