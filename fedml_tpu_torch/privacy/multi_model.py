"""Multi-model joint client training, PyTorch form of
``fedml_tpu/privacy/multi_model.py`` (reference privacy_fedml
two_model_trainer.py:15-140 / three_model_trainer.py).

A client trains 2-3 branch models together on its local data: one
optimizer over the union of their parameters, and a loss that is the sum
of each model's cross-entropy plus ``feat_lmda`` times the squared
distance between the models' block features. Every model then goes back
to the server for branch-wise aggregation.

The models are variables dicts of one module. Feature matching reads the
pre-ReLU outputs of the fixed-width block layers (``conv1_out``,
``conv2_out``, ``linear1_out``; equal widths across branches by
AdaptiveCNN's design) from a ``features=True`` forward, where the JAX
package captures the same outputs with flax's ``capture_intermediates``.

The optimizer is ``engine.make_local_optimizer`` over one dict holding
every model's parameters (keys ``"{k}/{name}"``), so its global-norm clip
takes the norm over all models together, as optax does over the JAX
package's tuple of trees. Epochs follow the engine's: a fresh permutation
of the valid rows each epoch (the shuffle is always on), batches full but
the last, which is masked, and a batch of padding alone is no step.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch.func import functional_call

from fedml_tpu_torch.algorithms.engine import (apply_updates, draw_client_randomness,
                                               make_local_optimizer)
from fedml_tpu_torch.core.config import FedConfig


def build_joint_local_update(module, cfg: FedConfig, num_models: int,
                             feat_lmda: float = 0.0) -> Callable:
    """Returns local_update(paths, x, y, count, rng, perms=None) ->
    (paths, metrics): ``paths`` is a sequence of ``num_models`` variables
    dicts trained jointly on one client's rows x [n_max, ...] (the first
    ``count`` valid). ``rng`` is a CPU ``torch.Generator``: the client's
    per-epoch permutations and its dropout seed are drawn from it
    (``engine.draw_client_randomness``); ``perms`` [epochs, n_max], when
    given, replaces the drawn permutations. The metrics, summed over every
    step of every epoch, are ``loss_sum`` (the joint loss times the batch's
    valid rows), ``correct`` (summed over models, divided by
    ``num_models``) and ``total``."""
    if cfg.epochs < 1:
        raise ValueError(f"cfg.epochs must be >= 1, got {cfg.epochs}")
    opt = make_local_optimizer(cfg)

    def joint_loss(paths, bx, by, bmask, generator):
        n = torch.clamp(bmask.sum(), min=1.0)
        total = 0.0
        correct = torch.zeros((), device=bx.device)
        feats_all = []
        for v in paths:
            logits, feats = functional_call(
                module, v, (bx,), {"train": True, "generator": generator, "features": True})
            per = F.cross_entropy(logits, by.long(), reduction="none")
            total = total + (per * bmask).sum() / n
            correct = correct + ((logits.argmax(-1) == by).float() * bmask).sum().detach()
            feats_all.append(feats)
        if feat_lmda != 0.0 and num_models > 1:
            reg = 0.0
            for a in range(num_models):
                for b in range(a + 1, num_models):
                    for fa, fb in zip(feats_all[a], feats_all[b]):
                        m = bmask.reshape((-1,) + (1,) * (fa.dim() - 1))
                        reg = reg + ((fa - fb) ** 2 * m).sum() / (n * fa[0].numel())
            total = total + feat_lmda * reg
        return total, correct

    def local_update(paths, x, y, count, rng, perms=None):
        paths = list(paths)
        if len(paths) != num_models:
            raise ValueError(f"expected {num_models} models, got {len(paths)}")
        count = int(count)
        n_max = x.shape[0]
        b = n_max if cfg.batch_size <= 0 else min(cfg.batch_size, n_max)
        nb = math.ceil(n_max / b)
        n_pad = nb * b
        drawn, seeds = draw_client_randomness(rng, [count], n_max, cfg.epochs, True)
        perms = drawn[0] if perms is None else perms
        generator = torch.Generator(device=x.device).manual_seed(int(seeds[0]))
        names = [list(v) for v in paths]
        params = {f"{k}/{name}": t for k, v in enumerate(paths) for name, t in v.items()}
        opt_state = opt.init(params)
        # the host copy decides which batches are steps, the device copy is
        # the loss mask
        valid = (torch.arange(n_pad) < count).reshape(nb, b)
        mask = (torch.arange(n_pad, device=x.device) < count).reshape(nb, b).float()
        zero = torch.zeros((), device=x.device)
        loss_sum, correct_sum, total = zero, zero, zero
        for e in range(cfg.epochs):
            perm = torch.as_tensor(perms[e]).to(x.device)
            if n_pad > n_max:
                perm = torch.cat([perm, perm.new_zeros(n_pad - n_max)])
            xe = x[perm].reshape((nb, b) + tuple(x.shape[1:]))
            ye = y[perm].reshape((nb, b) + tuple(y.shape[1:]))
            for i in range(nb):
                if not valid[i].any():
                    continue  # an all-padding batch: models and optimizer state stay
                leaves = {k: t.detach().requires_grad_(True) for k, t in params.items()}
                views = [{name: leaves[f"{k}/{name}"] for name in names[k]}
                         for k in range(num_models)]
                loss, correct = joint_loss(views, xe[i], ye[i], mask[i], generator)
                grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
                updates, opt_state = opt.update(grads, opt_state, params)
                params = apply_updates(params, updates)
                rows = mask[i].sum()
                loss_sum = loss_sum + loss.detach() * rows
                correct_sum = correct_sum + correct
                total = total + rows
        trained = tuple({name: params[f"{k}/{name}"] for name in names[k]}
                        for k in range(num_models))
        return trained, {"loss_sum": loss_sum, "correct": correct_sum / num_models,
                         "total": total}

    return local_update


class TwoModelTrainer:
    """Reference two_model_trainer.py's surface: two branch models trained
    jointly on one client's data."""

    num_models = 2

    def __init__(self, module, cfg: FedConfig, feat_lmda: float = 0.0):
        self.module = module
        self._update = build_joint_local_update(module, cfg, self.num_models, feat_lmda)

    def train(self, paths: Sequence, x, y, count, rng, perms=None):
        return self._update(paths, x, y, count, rng, perms)


class ThreeModelTrainer(TwoModelTrainer):
    """Reference three_model_trainer.py: the same, three models jointly."""

    num_models = 3
