"""SplitNN, split learning over a client/server model split: PyTorch form of
``fedml_tpu/algorithms/splitnn.py`` (reference
fedml_api/distributed/split_nn/: client.py:24-35 the lower half's forward
and backward, server.py:40-61 the upper half and the loss, the managers'
round-robin relay at client_manager.py:35-67).

A batch step runs the lower half, then the upper half and the CE loss, and
one backward pass through the composition: the gradient the server would
send back for the activations is what autograd carries into the lower
half. The halves keep their own parameters and optimizer states. Each
client owns its lower half; one upper half (the trunk) and its optimizer
state pass from client to client in a fixed order, each client running
``cfg.epochs`` epochs against it before handing it on.

Inputs are NHWC, as in the JAX package. The lower half returns its
activations channels-last, so the upper half flattens them in flax's
(h, w, c) order and the converted weights line up.

The shuffles and the initial weights come from the port's own generators
(pure functions of ``cfg.seed``), not JAX's keys: float parity with the
JAX package holds at full batch from converted weights.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from fedml_tpu_torch.algorithms.engine import (Optimizer, add_decayed_weights, apply_updates,
                                               chain, sgd, valid_first_permutation)
from fedml_tpu_torch.algorithms.fedavg import round_generator
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import flax_default_init
from fedml_tpu_torch.data.registry import FederatedDataset
from fedml_tpu_torch.models.cnn import conv2d
from fedml_tpu_torch.telemetry.records import fetch_scalars
from fedml_tpu_torch.utils.device import resolve_device
from fedml_tpu_torch.utils.pytree import tree_map, tree_stack

# salts of round_generator's streams: the clients' lower halves, the trunk,
# a cycle's shuffles
_INIT_CLIENT, _INIT_SERVER, _CYCLE = 1, 2, 3


class SplitLowerCNN(nn.Module):
    """Client-side lower half: 3x3 conv ``width`` -> ReLU -> 2x2 max-pool ->
    3x3 conv ``2 * width`` -> ReLU -> 2x2 max-pool (the reference splits an
    arch's ``nn.Sequential`` at split_layer, split_nn/client.py:10-22)."""

    def __init__(self, width: int = 32, in_channels: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, width, 3, padding=1)
        self.conv2 = nn.Conv2d(width, 2 * width, 3, padding=1)

    def forward(self, x, train: bool = False, generator=None):
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(conv2d(self.conv1, x, torch.float32)), 2)
        x = F.max_pool2d(F.relu(conv2d(self.conv2, x, torch.float32)), 2)
        return x.permute(0, 2, 3, 1)


class SplitUpperCNN(nn.Module):
    """Server-side upper half: the activations flattened channels-last ->
    dense ``hidden`` -> ReLU -> dense ``output_dim``. ``in_features`` is the
    flattened width of the lower half's activations."""

    def __init__(self, in_features: int, output_dim: int = 10, hidden: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, output_dim)

    def forward(self, acts, train: bool = False, generator=None):
        x = acts.reshape(acts.shape[0], -1)
        return self.fc2(F.relu(self.fc1(x)))


def make_splitnn_optimizer(cfg: FedConfig, momentum: float | None = None,
                           wd: float | None = None) -> Optimizer:
    """The reference's SGD(lr, momentum=0.9, weight_decay=5e-4) on both
    halves (client.py:18-19, server.py:19-20): weight decay, then SGD with
    momentum. ``None`` means the reference's value, and an explicit 0.0
    turns it off (``cfg.momentum`` and ``cfg.wd`` are not read: their 0.0
    default could not be told from "unset")."""
    return chain(add_decayed_weights(5e-4 if wd is None else wd),
                 sgd(cfg.lr, momentum=0.9 if momentum is None else momentum))


def build_split_step(client_module, server_module, cfg: FedConfig,
                     momentum: float | None = None, wd: float | None = None) -> Callable:
    """step(client_params, server_params, c_opt, s_opt, batch) ->
    (client_params, server_params, c_opt, s_opt, metrics): the lower half's
    forward, the upper half's forward and the masked CE, one backward pass
    through both, and each half's own optimizer update. ``metrics`` holds
    0-d tensors: the batch's mean loss over its valid rows, the correct
    count and the valid rows."""
    opt = make_splitnn_optimizer(cfg, momentum, wd)

    def step(client_params, server_params, c_opt, s_opt, batch):
        cp = {k: v.detach().requires_grad_(True) for k, v in client_params.items()}
        sp = {k: v.detach().requires_grad_(True) for k, v in server_params.items()}
        acts = functional_call(client_module, cp, (batch["x"],), {"train": True})
        logits = functional_call(server_module, sp, (acts,), {"train": True})
        per = F.cross_entropy(logits, batch["y"].long(), reduction="none")
        mask = batch["mask"].to(per.dtype)
        total = mask.sum()
        loss = (per * mask).sum() / torch.clamp(total, min=1.0)
        keys = list(cp) + list(sp)
        grads = torch.autograd.grad(loss, [cp[k] for k in cp] + [sp[k] for k in sp])
        grads = dict(zip(keys, grads))
        with torch.no_grad():
            cu, c_opt = opt.update({k: grads[k] for k in cp}, c_opt, client_params)
            su, s_opt = opt.update({k: grads[k] for k in sp}, s_opt, server_params)
            correct = ((logits.argmax(-1) == batch["y"]).to(per.dtype) * mask).sum()
        return (apply_updates(client_params, cu), apply_updates(server_params, su),
                c_opt, s_opt, {"loss": loss.detach(), "correct": correct, "total": total})

    return step


class SplitNNAPI:
    """Round-robin split learning over the client pool (reference
    SplitNNAPI.py:15) on ``device`` (``cuda`` unless the caller asks for
    the CPU). ``client_params`` and ``client_opts`` hold every client's
    lower half and its optimizer state stacked on a leading client axis;
    ``server_params`` and ``server_opt`` the one trunk."""

    def __init__(self, dataset: FederatedDataset, cfg: FedConfig, client_module,
                 server_module, momentum: float | None = None, wd: float | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.cfg = cfg
        self.client_module = client_module.to(self.device)
        self.server_module = server_module.to(self.device)
        self.opt = make_splitnn_optimizer(cfg, momentum, wd)
        seed = cfg.seed
        lowers = [flax_default_init(self.client_module, round_generator(seed, c, _INIT_CLIENT),
                                    self.device) for c in range(dataset.client_num)]
        self.client_params = tree_stack(lowers)
        self.client_opts = tree_stack([self.opt.init(p) for p in lowers])
        self.server_params = flax_default_init(self.server_module,
                                               round_generator(seed, 0, _INIT_SERVER),
                                               self.device)
        self.server_opt = self.opt.init(self.server_params)
        self.step = build_split_step(self.client_module, self.server_module, cfg,
                                     momentum, wd)
        self.history: list[dict[str, Any]] = []
        self._staged = None

    def staged(self):
        """(x, y, host counts): every client's rows on the device, staged
        once (the relay visits every client every cycle)."""
        if self._staged is None:
            train = self.dataset.train
            self._staged = (torch.from_numpy(np.asarray(train.x)).to(self.device),
                            torch.from_numpy(np.asarray(train.y)).to(self.device),
                            np.asarray(train.counts))
        return self._staged

    def client_epoch(self, cp, sp, co, so, x, y, count: int, generator: torch.Generator):
        """One local epoch of a client against the trunk. Its valid rows
        come first in a uniform random order, the permutation is padded
        with row 0 to whole batches, and every batch is a step, an
        all-padding one included (its loss is 0, but momentum and weight
        decay still move the weights, as in the JAX scan). Returns the
        updated (cp, sp, co, so) and the epoch's sums: the loss weighted by
        each batch's valid rows, the correct count and the valid rows."""
        n_max = x.shape[0]
        b = n_max if self.cfg.batch_size <= 0 else min(self.cfg.batch_size, n_max)
        nb = -(-n_max // b)
        perm = valid_first_permutation(count, n_max, nb * b, generator)
        bidx = perm.to(self.device).reshape(nb, b)
        bmask = (torch.arange(nb * b, device=self.device) < count).reshape(nb, b).float()
        sums = None
        for i in range(nb):
            batch = {"x": x[bidx[i]], "y": y[bidx[i]], "mask": bmask[i]}
            cp, sp, co, so, m = self.step(cp, sp, co, so, batch)
            # per-sample semantics: the batch's mean loss weighted by its
            # valid rows, so the epoch's sums divide by ``total``
            m = dict(m, loss=m["loss"] * m["total"])
            sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        return cp, sp, co, so, sums

    def relay_cycle(self, cycle: int, x, y, counts) -> dict:
        """One cycle of the relay: the trunk and its optimizer state pass
        through clients 0 ... C-1 in turn, each running ``cfg.epochs``
        epochs. Returns the cycle's metric sums (0-d tensors)."""
        rng = round_generator(self.cfg.seed, cycle, _CYCLE)
        sp, so = self.server_params, self.server_opt
        lowers, opts, sums = [], [], None
        for k in range(x.shape[0]):
            cp = {n: v[k] for n, v in self.client_params.items()}
            co = tree_map(lambda t: t[k], self.client_opts)
            for _ in range(self.cfg.epochs):
                cp, sp, co, so, m = self.client_epoch(cp, sp, co, so, x[k], y[k],
                                                      int(counts[k]), rng)
                sums = m if sums is None else {n: sums[n] + m[n] for n in m}
            lowers.append(cp)
            opts.append(co)
        self.client_params, self.client_opts = tree_stack(lowers), tree_stack(opts)
        self.server_params, self.server_opt = sp, so
        return sums

    def train(self) -> list[dict[str, Any]]:
        """``cfg.comm_round`` relay cycles; a record per cycle."""
        x, y, counts = self.staged()
        for cycle in range(self.cfg.comm_round):
            m = self.relay_cycle(cycle, x, y, counts)
            loss, correct, total = fetch_scalars([m["loss"], m["correct"], m["total"]])
            total = max(total, 1.0)
            self.history.append({"round": cycle, "Train/Acc": correct / total,
                                 "Train/Loss": loss / total})
        return self.history

    @torch.no_grad()
    def evaluate(self) -> dict[str, float]:
        """The global test set through every client's lower half and the
        trunk: the accuracy averaged over the clients."""
        xte, yte = self.dataset.test_global
        x = torch.from_numpy(np.asarray(xte)).to(self.device)
        y = torch.from_numpy(np.asarray(yte)).to(self.device)
        correct = []
        for k in range(self.dataset.client_num):
            cp = {n: v[k] for n, v in self.client_params.items()}
            acts = functional_call(self.client_module, cp, (x,), {"train": False})
            logits = functional_call(self.server_module, self.server_params, (acts,),
                                     {"train": False})
            correct.append((logits.argmax(-1) == y).sum())
        total = sum(fetch_scalars(correct))
        return {"Test/Acc": total / (len(yte) * self.dataset.client_num)}
