"""FedGKT, group knowledge transfer between an edge model and a server
model: PyTorch form of ``fedml_tpu/algorithms/fedgkt.py`` (reference
fedml_api/distributed/fedgkt/).

A round has two phases:

  * client phase: every client trains its own edge model for ``cfg.epochs``
    epochs of minibatch SGD or Adam on CE + alpha * KL(server logits)
    (GKTClientTrainer.py:62-92; no KD term in round 0, when there are no
    server logits yet), then exports its logits and feature maps for all
    its rows in one eval-mode pass (:105-121);
  * server phase: ``server_epochs`` epochs (or the round-indexed schedule
    of ``get_server_epoch_strategy``) of one step per (client, batch)
    feature chunk with the server's own persistent optimizer, loss
    KL(client logits) + alpha * CE, or CE alone with distillation off
    (GKTServerTrainer.py:234-271); then the next round's KD targets from
    one eval-mode sweep over the features (the JAX package's deviation from
    the reference, which reuses the last epoch's train-mode outputs).

The JAX package's layout is kept: features and logits are per-sample
tensors [C, n_max, ...] on the device, and the server logits are indexed by
sample, so a client's shuffle permutes its KD targets with its rows.

Batches follow the JAX package exactly. A client epoch puts its valid rows
first in a uniform random order, pads the permutation with row 0 to a
multiple of the batch, and masks the padding out of the loss only: a
BatchNorm's train-mode statistics are taken over the whole batch. The
server zero-pads each client's features to a multiple of the batch before
chunking them. A step whose batch holds no valid row changes neither the
variables (their BatchNorm statistics included) nor the optimizer state.
Which batches hold data is read from the host's counts, so no step waits
for the device.

The shuffles and the initial weights come from the port's own generators
(``torch.Generator``, pure functions of ``cfg.seed``), not JAX's keys:
float parity with the JAX package holds at full batch from converted
weights. Both optimizers persist across rounds, as the reference's do.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.algorithms.engine import (Optimizer, add_decayed_weights, apply_updates,
                                               chain, sgd, torch_amsgrad,
                                               valid_first_permutation)
from fedml_tpu_torch.algorithms.fedavg import round_generator
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import ModelTrainer
from fedml_tpu_torch.data.registry import FederatedDataset
from fedml_tpu_torch.telemetry.records import fetch_scalars
from fedml_tpu_torch.utils.checkpoint import Checkpointable, restore_checkpoint
from fedml_tpu_torch.utils.device import resolve_device
from fedml_tpu_torch.utils.pytree import split_variables, tree_map, tree_stack

# salts of round_generator's streams: each client's initial weights, the
# server's, a round's client shuffles and dropout seeds, the server's dropout
_INIT_CLIENT, _INIT_SERVER, _CLIENT_ROUND, _SERVER_ROUND = 1, 2, 3, 4


def kd_kl_loss(student_logits, teacher_logits, T: float = 1.0):
    """T^2 * KL(softmax(teacher/T) || log_softmax(student/T)) per sample
    (reference KL_Loss, utils.py:75-94; the +1e-7 regulariser included)."""
    s = F.log_softmax(student_logits / T, dim=-1)
    t = F.softmax(teacher_logits / T, dim=-1) + 1e-7
    return T * T * (t * (torch.log(t) - s)).sum(-1)


def get_server_epoch_strategy(round_idx: int) -> tuple[int, bool]:
    """The round-indexed server epochs and distillation switch
    (GKTServerTrainer.py:166-192, strategy "2")."""
    if round_idx < 20:
        return 20, True
    if round_idx < 30:
        return 15, True
    if round_idx < 40:
        return 10, True
    if round_idx < 50:
        return 8, True
    if round_idx < 100:
        return 5, True
    if round_idx < 150:
        return 3, True
    return 1, False


def _make_gkt_optimizer(cfg: FedConfig) -> Optimizer:
    """SGD (weight decay ``cfg.wd``, Nesterov momentum 0.9) or Adam
    (AMSGrad after a fixed weight decay of 1e-4): the optimizers both GKT
    trainers build (GKTClientTrainer.py:31-37)."""
    if cfg.client_optimizer == "sgd":
        parts = [add_decayed_weights(cfg.wd)] if cfg.wd else []
        return chain(*parts, sgd(cfg.lr, momentum=0.9, nesterov=True))
    return chain(add_decayed_weights(1e-4), torch_amsgrad(cfg.lr))


def _epoch_batches(x, y, extra, count: int, b: int, generator: torch.Generator):
    """One epoch's batches of a client: (x, y, extra) gathered [nb, b, ...]
    and the host's [nb, b] validity. The valid rows come first in the order
    of a uniform draw from ``generator`` (the JAX package's argsort of
    uniforms), the invalid ones after them in order, and the permutation is
    padded with row 0 to ``nb * b``. ``extra`` (the server logits) is
    permuted with the rows."""
    nb = math.ceil(x.shape[0] / b)
    n_pad = nb * b
    perm = valid_first_permutation(count, x.shape[0], n_pad, generator).to(x.device)

    def gather(a):
        return a[perm].reshape((nb, b) + tuple(a.shape[1:]))

    return gather(x), gather(y), gather(extra), (torch.arange(n_pad) < count).reshape(nb, b)


def _index(tree, i: int):
    return tree_map(lambda t: t[i], tree)


class FedGKTAPI(Checkpointable):
    """Alternating edge/server knowledge transfer (reference FedGKTAPI.py:16)
    on ``device`` (``cuda`` unless the caller asks for the CPU).

    ``client_module(x) -> (logits, features)``, ``server_module(features)
    -> logits``. ``client_vars`` and ``client_opt_states`` hold every
    client's variables and optimizer state stacked on a leading client axis,
    as the JAX package's vmapped trees do."""

    def __init__(self, dataset: FederatedDataset, cfg: FedConfig, client_module,
                 server_module, alpha: float = 1.0, temperature: float = 3.0,
                 server_epochs: int = 1, use_epoch_schedule: bool = False,
                 distill_on_server: bool = True, train_on_client: bool = True,
                 pretrained_server_ckpt: str | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.cfg = cfg
        self.alpha = alpha
        self.T = temperature
        self.server_epochs = server_epochs
        self.use_epoch_schedule = use_epoch_schedule
        self.distill_on_server = distill_on_server
        self.train_on_client = train_on_client
        self.client_module = client_module.to(self.device)
        self.server_module = server_module.to(self.device)
        self.client = ModelTrainer(self.client_module)
        self.server = ModelTrainer(self.server_module)
        seed = cfg.seed
        self.client_vars = tree_stack([
            self.client.init(round_generator(seed, c, _INIT_CLIENT), self.device)
            for c in range(dataset.client_num)])
        self.server_vars = self.server.init(round_generator(seed, 0, _INIT_SERVER),
                                            self.device)
        if pretrained_server_ckpt:
            # reference resnet56_pretrained(pretrained=True, path=...): the
            # server warm-starts from a saved checkpoint of its variables
            out = restore_checkpoint(pretrained_server_ckpt, self.server_vars)
            if out is None:
                raise FileNotFoundError(f"no checkpoint under {pretrained_server_ckpt!r} "
                                        f"for the pretrained GKT server")
            self.server_vars = out[0]
        self.c_opt = _make_gkt_optimizer(cfg)
        self.s_opt = _make_gkt_optimizer(cfg)
        self.client_opt_states = tree_stack([
            self.c_opt.init(split_variables(_index(self.client_vars, c))[0])
            for c in range(dataset.client_num)])
        self.server_opt_state = self.s_opt.init(split_variables(self.server_vars)[0])
        self.history: list[dict[str, Any]] = []
        self.server_loss_history: list[float] = []  # one per server epoch
        self.server_logits = None  # [C, n_max, classes] once train() starts
        self._staged = None

    def _batch_size(self, n_max: int) -> int:
        b = self.cfg.batch_size
        return n_max if b <= 0 else min(b, n_max)

    def staged(self):
        """(x, y, counts, mask): the federation's training rows on the
        device, staged once (GKT trains every client every round), the host
        counts, and the [C, n_max] float mask of valid rows."""
        if self._staged is None:
            train = self.dataset.train
            counts = np.asarray(train.counts)
            x = torch.from_numpy(np.asarray(train.x)).to(self.device)
            y = torch.from_numpy(np.asarray(train.y)).to(self.device)
            mask = (torch.arange(train.n_max)[None, :] < torch.from_numpy(counts)[:, None])
            self._staged = (x, y, counts, mask.to(torch.float32).to(self.device))
        return self._staged

    def _step(self, trainer, opt, variables, opt_state, bx, loss_of, generator):
        """One optimizer step on the masked loss ``loss_of(output)``;
        returns (variables, opt_state, loss)."""
        params, state = split_variables(variables)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        out, new_state = trainer.apply({**leaves, **state}, bx, generator, True)
        loss = loss_of(out)
        keys = list(leaves)
        grads = dict(zip(keys, torch.autograd.grad(loss, [leaves[k] for k in keys])))
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return {**params, **state, **new_state}, opt_state, loss.detach()

    def _train_client(self, cvars, copt, x, y, count: int, server_logits, have_server: bool,
                      rng: torch.Generator):
        """``cfg.epochs`` epochs of one client's masked CE (+ alpha * KD)
        minibatch steps."""
        alpha, T = self.alpha, self.T
        b = self._batch_size(x.shape[0])
        gen = torch.Generator(device=self.device).manual_seed(
            int(torch.randint(0, 2 ** 31 - 1, (), generator=rng)))
        for _ in range(self.cfg.epochs):
            xe, ye, se, bvalid = _epoch_batches(x, y, server_logits, count, b, rng)
            mask = bvalid.to(torch.float32).to(self.device)
            for i in range(xe.shape[0]):
                if not bvalid[i].any():
                    continue  # no valid row: variables and optimizer state stay

                def loss_of(out, by=ye[i], bsl=se[i], m=mask[i]):
                    logits = out[0]
                    per = F.cross_entropy(logits, by.long(), reduction="none")
                    if have_server:
                        per = per + alpha * kd_kl_loss(logits, bsl, T)
                    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)

                cvars, copt, _ = self._step(self.client, self.c_opt, cvars, copt, xe[i],
                                            loss_of, gen)
        return cvars, copt

    def client_phase(self, r: int, x, y, counts, server_logits):
        """Every client's local training, then its logits and features for
        all its rows (eval mode): (client_logits [C, n_max, classes],
        features [C, n_max, ...])."""
        rng = round_generator(self.cfg.seed, r, _CLIENT_ROUND)
        variables, states, logits, feats = [], [], [], []
        for c in range(x.shape[0]):
            cvars, copt = _index(self.client_vars, c), _index(self.client_opt_states, c)
            if self.train_on_client:
                cvars, copt = self._train_client(cvars, copt, x[c], y[c], int(counts[c]),
                                                 server_logits[c], r > 0, rng)
            with torch.no_grad():
                (lg, ft), _ = self.client.apply(cvars, x[c], None, False)
            variables.append(cvars)
            states.append(copt)
            logits.append(lg)
            feats.append(ft)
        self.client_vars = tree_stack(variables)
        self.client_opt_states = tree_stack(states)
        return torch.stack(logits), torch.stack(feats)

    def server_phase(self, r: int, feats, y, counts, mask, client_logits, distill: bool,
                     epochs: int):
        """``epochs`` epochs of one server step per (client, batch) chunk of
        the features, then the next round's KD targets from one eval-mode
        sweep. Returns (server_logits [C, n_max, classes], the epochs' mean
        losses over the chunks that hold data, a [epochs] tensor)."""
        alpha, T = self.alpha, self.T
        C, n = feats.shape[:2]
        b = self._batch_size(n)
        nb = math.ceil(n / b)
        n_pad = nb * b

        def chunk(a):
            if n_pad > n:
                a = torch.cat([a, a.new_zeros((C, n_pad - n) + tuple(a.shape[2:]))], 1)
            return a.reshape((C * nb, b) + tuple(a.shape[2:]))

        xb, yb, cb, mb = chunk(feats), chunk(y), chunk(client_logits), chunk(mask)
        # chunk i of client c holds data iff its first row is valid
        has = [i * b < int(counts[c]) for c in range(C) for i in range(nb)]
        gen = torch.Generator(device=self.device).manual_seed(
            int(torch.randint(0, 2 ** 31 - 1, (),
                              generator=round_generator(self.cfg.seed, r, _SERVER_ROUND))))
        svars, sopt = self.server_vars, self.server_opt_state
        epoch_losses = []
        for _ in range(epochs):
            losses = []
            for j in range(C * nb):
                if not has[j]:
                    continue  # an all-padding chunk: no step

                def loss_of(logits, by=yb[j], bcl=cb[j], m=mb[j]):
                    ce = F.cross_entropy(logits, by.long(), reduction="none")
                    per = kd_kl_loss(logits, bcl, T) + alpha * ce if distill else ce
                    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)

                svars, sopt, loss = self._step(self.server, self.s_opt, svars, sopt, xb[j],
                                               loss_of, gen)
                losses.append(loss)
            epoch_losses.append(torch.stack(losses).sum() / max(len(losses), 1)
                                if losses else torch.zeros((), device=self.device))
        self.server_vars, self.server_opt_state = svars, sopt
        with torch.no_grad():
            lb = torch.stack([self.server.apply(svars, xb[j], None, False)[0]
                              for j in range(C * nb)])
        server_logits = lb.reshape(C, n_pad, -1)[:, :n]
        return server_logits, torch.stack(epoch_losses)

    def train_one_round(self, r: int, x, y, counts, mask, server_logits):
        """One round from round ``r - 1``'s server logits; returns round
        ``r``'s."""
        client_logits, feats = self.client_phase(r, x, y, counts, server_logits)
        if self.use_epoch_schedule:
            epochs, distill = get_server_epoch_strategy(r)
        else:
            epochs, distill = self.server_epochs, self.distill_on_server
        server_logits, epoch_losses = self.server_phase(r, feats, y, counts, mask,
                                                        client_logits, distill, epochs)
        self.server_loss_history.extend(epoch_losses.tolist())
        return server_logits

    def train(self, ckpt_dir: str | None = None, ckpt_every: int = 25) -> list[dict[str, Any]]:
        """``cfg.comm_round`` rounds with optional checkpoint and resume. The
        state a round consumes is every client's variables and optimizer
        state, the server's variables and persistent optimizer state, and
        the server logits (round r's KD targets are round r - 1's server
        outputs): a resumed run is the uninterrupted one."""
        x, y, counts, mask = self.staged()
        if self.server_logits is None:
            self.server_logits = self._init_server_logits()
        start = self.maybe_restore(ckpt_dir) if ckpt_dir else 0
        for r in range(start, self.cfg.comm_round):
            self.server_logits = self.train_one_round(r, x, y, counts, mask,
                                                      self.server_logits)
            self.history.append({"round": r, **self.evaluate()})
            if ckpt_dir and (r + 1) % ckpt_every == 0:
                self.save_checkpoint(ckpt_dir, r + 1)
        if ckpt_dir:
            self.save_checkpoint(ckpt_dir, self.cfg.comm_round)
        return self.history

    # -- checkpoint state (utils/checkpoint.py::Checkpointable)
    def _init_server_logits(self):
        ds = self.dataset
        return torch.zeros((ds.client_num, ds.train.n_max, ds.class_num), device=self.device)

    def _ckpt_tree(self):
        if self.server_logits is None:
            # maybe_restore() before train(): the example tree needs the
            # trained tree's structure
            self.server_logits = self._init_server_logits()
        return {"client_vars": self.client_vars,
                "client_opt_states": self.client_opt_states,
                "server_vars": self.server_vars,
                "server_opt_state": self.server_opt_state,
                "server_logits": self.server_logits}

    def _ckpt_meta(self):
        return {"history": self.history, "server_loss_history": self.server_loss_history}

    def _ckpt_load(self, tree, meta):
        for name in ("client_vars", "client_opt_states", "server_vars", "server_opt_state",
                     "server_logits"):
            setattr(self, name, tree[name])
        self.history = list(meta.get("history", []))
        self.server_loss_history = list(meta.get("server_loss_history", []))

    @torch.no_grad()
    def evaluate(self) -> dict[str, float]:
        """Client 0's edge model composed with the server on the global test
        set (reference eval_large_model_on_the_server,
        GKTServerTrainer.py:292)."""
        xte, yte = self.dataset.test_global
        x = torch.from_numpy(np.asarray(xte)).to(self.device)
        y = torch.from_numpy(np.asarray(yte)).to(self.device)
        (_, feats), _ = self.client.apply(_index(self.client_vars, 0), x, None, False)
        logits, _ = self.server.apply(self.server_vars, feats, None, False)
        (acc,) = fetch_scalars([(logits.argmax(-1) == y).float().mean()])
        return {"Test/Acc": acc}
