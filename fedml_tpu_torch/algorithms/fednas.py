"""FedNAS — federated neural architecture search (DARTS), PyTorch form of
``fedml_tpu/algorithms/fednas.py`` (reference fedml_api/distributed/
fednas/: FedNASTrainer.search, architect.py's bi-level architecture
gradient, FedNASAggregator's averaging of weights and alphas and its
genotype log).

Each round every sampled client runs ``cfg.epochs`` sweeps of a local
search over its train half, one step a train batch: an architecture step
on a random batch of its val half, then a weight step on the train batch.
The server averages both the weights and the alphas by the clients'
sample counts and parses the genotype.

A client's batches follow the JAX package exactly. Its first
``max(count // 2, 1)`` rows are the train half, the rest the val half. An
epoch orders the train half's rows uniformly at random ahead of the rest
of the first half of the padded width, pads that order with row 0 to a
multiple of the batch, and masks everything after the train half out of
the loss only: those rows still enter the batch standardization's
statistics. Each step's val batch is drawn with replacement from the val
half alone. A client with no val half takes no architecture step (its
alphas and their Adam state stay), and a batch with no valid row no step
at all. Which steps run is read from the host's counts, so no step waits
for the device. Both optimizers start fresh for every client in every
round; the server's copies never change, but checkpoints carry them.

The weight optimizer is optax's chain of the JAX package: clip the global
norm to 5, add ``wd * w``, momentum trace, negate, times the epoch's
learning rate (a cosine over the local epochs from ``cfg.lr`` to
``lr_min``, fresh each round). The architecture optimizer is
``add_decayed_weights(1e-3)`` then Adam(3e-4, b1 0.5, b2 0.999). The
first-order architecture gradient is the reference's ``step_v2``: the
val loss's gradient plus ``lambda_train`` times the train loss's.
``unrolled=True`` differentiates the val loss exactly through one virtual
weight step w' = w - lr * (momentum * buf + g + wd * w) with the live
momentum buffer (``torch.autograd.grad`` with ``create_graph``), where
the reference approximates it by finite differences. ``gdas=True`` mixes
the ops with hard straight-through gumbel samples, fresh for every cell
and for each of a step's three forwards.

The shuffles, the val indices and the gumbel noise come from the port's
own generators (``torch.Generator``, pure functions of ``cfg.seed`` and
the round), not JAX's keys; the tests inject JAX's to compare the two.
The alphas are a dict ``{"normal": [k, ops], "reduce": [k, ops]}``, the
form the port's optimizer transforms take.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from fedml_tpu_torch.algorithms.aggregators import scale_by_adam
from fedml_tpu_torch.algorithms.engine import (add_decayed_weights, apply_updates, chain,
                                               clip_by_global_norm, scaled, trace,
                                               valid_first_permutation, zeros_like)
from fedml_tpu_torch.algorithms.fedavg import client_sampling, round_generator
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import flax_default_init
from fedml_tpu_torch.data.registry import FederatedDataset
from fedml_tpu_torch.models.darts import (PRIMITIVES, DARTSNetwork, Genotype,
                                          gumbel_softmax_st, init_alphas, parse_genotype)
from fedml_tpu_torch.telemetry.records import fetch_scalars
from fedml_tpu_torch.utils.checkpoint import Checkpointable
from fedml_tpu_torch.utils.device import resolve_device, to_device
from fedml_tpu_torch.utils.pytree import tree_stack, tree_weighted_mean

#: the alphas dict's keys, in the order of DARTSNetwork.forward's arguments
ALPHA_KEYS = ("normal", "reduce")
#: a GDAS step's three forwards, each with its own noise: the architecture
#: step's, the weight step's and the lambda_train term's
GDAS_STREAMS = ("a", "w", "t")


class NASState(NamedTuple):
    params: dict
    alphas: dict  # {"normal": ..., "reduce": ...}
    w_opt: dict
    a_opt: dict


def _momentum_buffer(w_opt_state: dict, params: dict) -> dict:
    """The weight optimizer's momentum buffer, or zeros when it has none
    (the reference's try/except, architect.py:36-40)."""
    return w_opt_state["trace"] if "trace" in w_opt_state else zeros_like(params)


def _leaves(tree: dict, grad: bool) -> dict:
    return {k: v.detach().requires_grad_(grad) for k, v in tree.items()}


def _alpha_grads(loss, alphas: list) -> list:
    """d loss / d alphas; zeros for alphas no cell reads (a network whose
    cells all reduce never reads the normal ones)."""
    return list(torch.autograd.grad(loss, alphas, allow_unused=True, materialize_grads=True))


def draw_gdas_uniforms(generator: torch.Generator, steps: int, layers: int,
                       edges: int) -> torch.Tensor:
    """[steps, 3, 2, layers, edges, |PRIMITIVES|] uniforms in [1e-10, 1) on
    the CPU: for each step and each of its three forwards (GDAS_STREAMS),
    the normal and the reduce cells' samples."""
    shape = (steps, len(GDAS_STREAMS), 2, layers, edges, len(PRIMITIVES))
    return torch.rand(shape, generator=generator) * (1.0 - 1e-10) + 1e-10


def build_search_step(network: DARTSNetwork, cfg: FedConfig, arch_lr: float = 3e-4,
                      arch_wd: float = 1e-3, unrolled: bool = False,
                      w_grad_clip: float = 5.0, gdas: bool = False, tau: float = 5.0,
                      lambda_train: float = 1.0):
    """(step, w_opt, a_opt): one DARTS search step, the architecture step on
    the val batch, then the weight step on the train batch (reference
    FedNASTrainer.local_search:82).

    ``step(state, (tx, ty, tmask), (vx, vy), lr_e, val_ok=True,
    uniforms=None) -> (state, (loss * n, correct, n))``: ``tmask`` is the
    train batch's float validity mask, ``lr_e`` the epoch's learning rate,
    ``val_ok`` False skips the architecture step (a client with no val
    half). Under GDAS ``uniforms`` is one step's [3, 2, layers, k, ops]
    of ``draw_gdas_uniforms``."""
    momentum = cfg.momentum if cfg.momentum else 0.9
    wd = cfg.wd if cfg.wd else 3e-4
    # the reference's own darts/train_search.py:110 clips the weight
    # gradients, as the JAX package does
    w_opt = chain(clip_by_global_norm(w_grad_clip), add_decayed_weights(wd),
                  scaled(trace(momentum), -1.0))  # step() multiplies by lr_e
    a_opt = chain(add_decayed_weights(arch_wd),
                  scaled(scale_by_adam(b1=0.5, b2=0.999), -arch_lr))

    def ce(params, alphas, x, y, mask, uniforms=None):
        an, ar = alphas["normal"], alphas["reduce"]
        mix = {}
        if gdas:
            # one independent sample per cell (the reference draws fresh
            # inside every cell's forward, model_search_gdas.py:125-129)
            mix = {"weights_normal": gumbel_softmax_st(an, tau, network.layers,
                                                       uniform=uniforms[0]),
                   "weights_reduce": gumbel_softmax_st(ar, tau, network.layers,
                                                       uniform=uniforms[1])}
        logits = functional_call(network, params, (x, an, ar), mix)
        per = F.cross_entropy(logits, y.long(), reduction="none")
        loss = (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        correct = ((logits.argmax(-1) == y).float() * mask).sum()
        return loss, correct

    def arch_grads(state: NASState, train_batch, val_batch, lr_e, streams) -> dict:
        tx, ty, tmask = train_batch
        vx, vy = val_batch
        vmask = torch.ones(vy.shape, device=vy.device)
        alphas = _leaves(state.alphas, True)
        targets = [alphas[k] for k in ALPHA_KEYS]
        if unrolled:
            # the reference's virtual weight step (architect.py:31-43) with
            # the live momentum buffer, differentiated exactly
            params = _leaves(state.params, True)
            buf = _momentum_buffer(state.w_opt, state.params)
            inner = ce(params, alphas, tx, ty, tmask, streams["w"])[0]
            g = torch.autograd.grad(inner, list(params.values()), create_graph=True)
            w2 = {k: p - lr_e * (momentum * buf[k] + gk + wd * p)
                  for (k, p), gk in zip(params.items(), g)}
            grads = _alpha_grads(ce(w2, alphas, vx, vy, vmask, streams["a"])[0], targets)
        else:
            params = _leaves(state.params, False)
            grads = _alpha_grads(ce(params, alphas, vx, vy, vmask, streams["a"])[0], targets)
            if lambda_train:
                # step_v2's train-gradient term (architect.py:63-85)
                gt = _alpha_grads(ce(params, alphas, tx, ty, tmask, streams["t"])[0], targets)
                grads = [gv + lambda_train * g for gv, g in zip(grads, gt)]
        return dict(zip(ALPHA_KEYS, grads))

    def step(state: NASState, train_batch, val_batch, lr_e, val_ok=True, uniforms=None):
        if gdas and uniforms is None:
            raise ValueError("gdas=True needs a step's gumbel uniforms")
        streams = dict.fromkeys(GDAS_STREAMS)
        if gdas:
            streams = dict(zip(GDAS_STREAMS, uniforms))
        alphas, a_state = state.alphas, state.a_opt
        if val_ok:
            a_grads = arch_grads(state, train_batch, val_batch, lr_e, streams)
            with torch.no_grad():
                a_upd, a_state = a_opt.update(a_grads, state.a_opt, alphas)
                alphas = apply_updates(alphas, a_upd)
        tx, ty, tmask = train_batch
        params = _leaves(state.params, True)
        loss, correct = ce(params, alphas, tx, ty, tmask, streams["w"])
        w_grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        with torch.no_grad():
            w_upd, w_state = w_opt.update(w_grads, state.w_opt, state.params)
            new_params = {k: p + w_upd[k] * lr_e for k, p in state.params.items()}
            n = tmask.sum()
            metrics = (loss.detach() * n, correct.detach(), n)
        return NASState(new_params, alphas, w_state, a_state), metrics

    return step, w_opt, a_opt


def epoch_lrs(lr: float, lr_min: float, epochs: int) -> list[float]:
    """The cosine epoch schedule the reference builds inside search()
    (FedNASTrainer.py:52-53): epoch e of E at lr_min + (lr - lr_min)(1 +
    cos(pi e / E)) / 2, rounded to float32 as the JAX package holds it."""
    return [float(np.float32(lr_min + 0.5 * (lr - lr_min) * (1.0 + math.cos(math.pi * e / epochs))))
            for e in range(epochs)]


class FedNASAPI(Checkpointable):
    """Federated DARTS search (reference FedNASAPI.py) on one device
    (``cuda`` unless the caller passes ``device="cpu"``): each round the
    sampled clients run their local bi-level search; the server
    sample-weight-averages weights and alphas and records the genotype."""

    def __init__(self, dataset: FederatedDataset, cfg: FedConfig, channels: int = 8,
                 layers: int = 4, arch_lr: float = 3e-4, unrolled: bool = False,
                 lr_min: float = 1e-3, gdas: bool = False, tau: float = 5.0,
                 lambda_train: float = 1.0, steps: int = 4, multiplier: int = 4,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.cfg = cfg
        self.steps, self.multiplier = steps, multiplier
        self.network = DARTSNetwork(output_dim=dataset.class_num, channels=channels,
                                    layers=layers, steps=steps, multiplier=multiplier,
                                    dtype=cfg.dtype,
                                    in_channels=int(dataset.train.x.shape[-1]))
        generator = torch.Generator().manual_seed(cfg.seed)
        params = flax_default_init(self.network, generator, self.device)
        alphas = dict(zip(ALPHA_KEYS, init_alphas(generator, steps, device=self.device)))
        self.search_step, self._w_opt, self._a_opt = build_search_step(
            self.network, cfg, arch_lr=arch_lr, unrolled=unrolled, gdas=gdas, tau=tau,
            lambda_train=lambda_train)
        self.gdas = gdas
        self.global_state = NASState(params, alphas, self._w_opt.init(params),
                                     self._a_opt.init(alphas))
        self.epoch_lrs = epoch_lrs(cfg.lr, lr_min, cfg.epochs)
        self.genotype_history: list = []
        self.history: list[dict[str, Any]] = []

    def client_search(self, params: dict, alphas: dict, x, y, count: int,
                      generator: torch.Generator, perms=None, val_idx=None):
        """``cfg.epochs`` sweeps over one client's train minibatches
        (reference local_search, FedNASTrainer.py:84-128), each step paired
        with a random batch of its val half. ``x``, ``y``: the client's
        padded rows on the device; ``count``: its valid rows (a host int).
        ``perms`` [E, nb * b] and ``val_idx`` [E, nb, b] replace the
        shuffles and the val draws. Returns (params, alphas, loss * n,
        correct, n), the last three summed over the steps."""
        cfg, device = self.cfg, self.device
        state = NASState(params, alphas, self._w_opt.init(params), self._a_opt.init(alphas))
        n_max = x.shape[0]
        n_tr_max = max(n_max // 2, 1)
        b = min(cfg.batch_size if cfg.batch_size > 0 else n_tr_max, n_tr_max)
        nb = -(-n_tr_max // b)
        count_tr = max(count // 2, 1)
        count_val = max(count - count_tr, 1)
        val_ok = count - count_tr >= 1
        edges = self.network.num_edges
        loss_n = correct = torch.zeros((), device=device)
        n = 0
        for e, lr_e in enumerate(self.epoch_lrs):
            perm = (torch.as_tensor(perms[e]) if perms is not None else
                    valid_first_permutation(count_tr, n_tr_max, nb * b, generator))
            vi = (torch.as_tensor(val_idx[e]) if val_idx is not None else
                  count_tr + torch.randint(0, count_val, (nb, b), generator=generator))
            uniforms = (to_device(draw_gdas_uniforms(generator, nb, self.network.layers,
                                                     edges), device)
                        if self.gdas else [None] * nb)
            perm, vi = to_device(perm.long(), device), to_device(vi.long().reshape(-1), device)
            xe = x[perm].reshape((nb, b) + x.shape[1:])
            ye = y[perm].reshape(nb, b)
            xv = x[vi].reshape((nb, b) + x.shape[1:])
            yv = y[vi].reshape(nb, b)
            rows = torch.arange(b, device=device)
            for i in range(nb):
                valid = min(max(count_tr - i * b, 0), b)
                if valid == 0:
                    continue  # the state stays as it was (JAX: tree_where(n > 0))
                mask = (rows < valid).float()
                state, (ln, c, _) = self.search_step(state, (xe[i], ye[i], mask),
                                                     (xv[i], yv[i]), lr_e, val_ok,
                                                     uniforms[i])
                loss_n, correct, n = loss_n + ln, correct + c, n + valid
        return state.params, state.alphas, loss_n, correct, n

    def round_fn(self, gstate: NASState, x, y, counts, rng: torch.Generator,
                 perms=None, val_idx=None):
        """One round over the cohort ``x`` [C, n_max, ...], ``y``, host
        ``counts``: (new global state, metrics). ``perms`` [C, E, n] and
        ``val_idx`` [C, E, nb, b] replace the clients' draws."""
        device = self.device
        x, y = to_device(torch.as_tensor(x), device), to_device(torch.as_tensor(y), device)
        counts = [int(c) for c in counts]
        seeds = torch.randint(0, 2 ** 31 - 1, (len(counts),), generator=rng)
        params, alphas, loss_n, correct, n = [], [], 0.0, 0.0, 0
        for c, count in enumerate(counts):
            out = self.client_search(
                gstate.params, gstate.alphas, x[c], y[c], count,
                torch.Generator().manual_seed(int(seeds[c])),
                None if perms is None else perms[c],
                None if val_idx is None else val_idx[c])
            params.append(out[0])
            alphas.append(out[1])
            loss_n, correct, n = loss_n + out[2], correct + out[3], n + out[4]
        w = torch.tensor(counts, dtype=torch.float32, device=device)
        new_params = tree_weighted_mean(tree_stack(params), w)
        new_alphas = tree_weighted_mean(tree_stack(alphas), w)
        n_tot = max(n, 1)
        # search_samples: the (sample, epoch) visits, every real train-half
        # sample once an epoch
        metrics = {"search_loss": loss_n / n_tot, "search_acc": correct / n_tot,
                   "search_samples": n}
        return NASState(new_params, new_alphas, gstate.w_opt, gstate.a_opt), metrics

    def train_one_round(self, round_idx: int) -> dict[str, Any]:
        idx = client_sampling(round_idx, self.dataset.client_num,
                              self.cfg.client_num_per_round)
        x, y, counts = self.dataset.train.select(idx)
        self.global_state, metrics = self.round_fn(
            self.global_state, x, y, counts, round_generator(self.cfg.seed, round_idx))
        loss, acc = fetch_scalars([metrics["search_loss"], metrics["search_acc"]])
        geno = parse_genotype(self.global_state.alphas["normal"],
                              self.global_state.alphas["reduce"], steps=self.steps,
                              multiplier=self.multiplier)
        self.genotype_history.append(geno)
        return {"search_loss": loss, "search_acc": acc,
                "search_samples": int(metrics["search_samples"]), "genotype": geno}

    def train(self, ckpt_dir: str | None = None, ckpt_every: int = 25):
        """Search loop; ``ckpt_dir`` resumes from its latest checkpoint and
        saves every ``ckpt_every`` rounds and at the end (the reference only
        logs genotypes, FedNASAggregator.py:173, and cannot resume)."""
        start = self.maybe_restore(ckpt_dir) if ckpt_dir else 0
        for r in range(start, self.cfg.comm_round):
            rec = self.train_one_round(r)
            self.history.append({"round": r, "search_loss": rec["search_loss"],
                                 "search_acc": rec["search_acc"]})
            if ckpt_dir and (r + 1) % ckpt_every == 0:
                self.save_checkpoint(ckpt_dir, r + 1)
        if ckpt_dir:
            self.save_checkpoint(ckpt_dir, self.cfg.comm_round)
        return self.history

    # -- checkpoint state: weights, alphas, both optimizer states and the
    # genotype and metric history
    def _ckpt_tree(self):
        return {"state": tuple(self.global_state)}

    def _ckpt_meta(self):
        return {"history": self.history, "genotype_history": self.genotype_history}

    def _ckpt_load(self, tree, meta):
        self.global_state = NASState(*tree["state"])
        self.history = list(meta.get("history", []))
        # JSON keeps a Genotype as nested lists: rebuild the namedtuples
        self.genotype_history = [
            Genotype(normal=[tuple(e) for e in g[0]], normal_concat=list(g[1]),
                     reduce=[tuple(e) for e in g[2]], reduce_concat=list(g[3]))
            for g in meta.get("genotype_history", [])
        ]

    @torch.no_grad()
    def evaluate(self, batch_size: int = 256) -> dict[str, float]:
        """Test/Acc over the whole test set in batches of ``batch_size``
        (reference FedNASAggregator.infer, FedNASAggregator.py:137-171); the
        last batch is padded with zero rows, which enter its batch
        statistics, as in the JAX package."""
        xte, yte = self.dataset.test_global
        n = xte.shape[0]
        b = min(batch_size, n)
        nb = math.ceil(n / b)
        xp = np.zeros((nb * b,) + xte.shape[1:], np.float32)
        yp = np.zeros((nb * b,), np.int64)
        xp[:n], yp[:n] = xte, yte
        xb = to_device(torch.from_numpy(xp), self.device).reshape((nb, b) + xte.shape[1:])
        yb = to_device(torch.from_numpy(yp), self.device).reshape(nb, b)
        mb = (torch.arange(nb * b, device=self.device) < n).float().reshape(nb, b)
        params, alphas = self.global_state.params, self.global_state.alphas
        correct = torch.zeros((), device=self.device)
        for i in range(nb):
            logits = functional_call(self.network, params,
                                     (xb[i], alphas["normal"], alphas["reduce"]))
            correct = correct + ((logits.argmax(-1) == yb[i]).float() * mb[i]).sum()
        return {"Test/Acc": fetch_scalars([correct / n])[0]}
