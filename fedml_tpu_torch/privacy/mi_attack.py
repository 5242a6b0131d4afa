"""Membership-inference attacks against a federated model, PyTorch form of
``fedml_tpu/privacy/mi_attack.py`` (reference privacy_fedml/MI_attack/:
NN_attack.py:20-130, the shadow-NN attack on prediction vectors, the loss,
top-3 and gradient attacks).

The attack data are the target model's outputs on members (training rows)
and non-members (held-out rows); the metric is the attack's accuracy and
its advantage (true-positive rate minus false-positive rate). The attack
classifiers train with SGD at momentum 0.9 over batches drawn by
``np.random.RandomState(seed)`` permutations, the last partial batch
included, as in the JAX package. Their initial weights are the port's own
(flax's initialisers, drawn from a generator seeded with ``seed``); ``fit``
takes other initial variables through ``init_variables``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from fedml_tpu_torch.algorithms.engine import apply_updates, sgd
from fedml_tpu_torch.core.trainer import flax_default_init
from fedml_tpu_torch.models.cnn import _dropout
from fedml_tpu_torch.utils.convert import leaf_kinds
from fedml_tpu_torch.utils.pytree import split_variables


class NNAttackModel(nn.Module):
    """The 4-layer MLP attack classifier (reference NN_attack.py:20-40:
    input -> 512 -> 256 -> 128 -> 2). Layers carry flax's automatic names."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, 512)
        self.Dense_1 = nn.Linear(512, 256)
        self.Dense_2 = nn.Linear(256, 128)
        self.Dense_3 = nn.Linear(128, 2)

    def forward(self, x, train: bool = False, generator=None):
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        x = F.relu(self.Dense_2(x))
        return self.Dense_3(x)


class TwoBranchAttackModel(nn.Module):
    """The two-branch MI classifier (reference Gradient_attack.py:21-54):
    the prediction vector (the first ``pred_dim`` features) and the
    penultimate-activation gradient (the other ``grad_dim``) run through
    separate MLP towers (512 -> 256 -> 128 with dropout 0.2, and 256 ->
    128) before a joint head."""

    def __init__(self, pred_dim: int, grad_dim: int):
        super().__init__()
        self.pred_dim = pred_dim
        self.Dense_0 = nn.Linear(pred_dim, 512)
        self.Dense_1 = nn.Linear(512, 256)
        self.Dense_2 = nn.Linear(256, 128)
        self.Dense_3 = nn.Linear(grad_dim, 256)
        self.Dense_4 = nn.Linear(256, 128)
        self.Dense_5 = nn.Linear(256, 2)

    def forward(self, x, train: bool = False, generator=None):
        p, g = x[:, :self.pred_dim], x[:, self.pred_dim:]
        p = F.relu(self.Dense_0(p))
        if train:
            p = _dropout(p, 0.2, generator)
        p = F.relu(self.Dense_1(p))
        if train:
            p = _dropout(p, 0.2, generator)
        p = F.relu(self.Dense_2(p))
        g = F.relu(self.Dense_3(g))
        g = F.relu(self.Dense_4(g))
        return self.Dense_5(torch.cat([p, g], 1))


def _sorted_probs(logits: torch.Tensor) -> torch.Tensor:
    """The softmax vector sorted in descending order (the reference's
    -np.sort(-pred)), in float32: the attack models' Dense layers take a
    bf16 input in float32, as flax's do with float32 kernels."""
    return torch.sort(torch.softmax(logits, -1), -1, descending=True).values.float()


def _prediction_features(predict_fn: Callable, x, top_k: int | None = None):
    """The MI feature the reference feeds the attack model: the sorted
    softmax vector, its first ``top_k`` entries when given."""
    feats = _sorted_probs(predict_fn(x))
    return feats if top_k is None else feats[:, :top_k]


def _membership_labels(n_members: int, n_nonmembers: int, device) -> torch.Tensor:
    return torch.cat([torch.ones(n_members, dtype=torch.int64, device=device),
                      torch.zeros(n_nonmembers, dtype=torch.int64, device=device)])


@torch.no_grad()
def attack_dataset(predict_fn, member_x, nonmember_x, top_k: int | None = None):
    """(features, labels): members 1, non-members 0."""
    fm = _prediction_features(predict_fn, member_x, top_k)
    fn_ = _prediction_features(predict_fn, nonmember_x, top_k)
    return torch.cat([fm, fn_]), _membership_labels(len(fm), len(fn_), fm.device)


def _fit_classifier(module, variables: dict, x, y, lr: float, epochs: int,
                    batch_size: int, seed: int, generator=None) -> dict:
    """SGD with momentum 0.9 on the mean cross-entropy of ``module`` over
    (x, y), in batches of a ``RandomState(seed)`` permutation per epoch,
    the last partial batch included; train mode (dropout from
    ``generator``) when a generator is given. Returns the trained
    variables."""
    opt = sgd(lr, momentum=0.9)
    params = dict(variables)
    state = opt.init(params)
    n = len(y)
    nprng = np.random.RandomState(seed)
    kwargs = {"train": generator is not None, "generator": generator}
    for _ in range(epochs):
        order = nprng.permutation(n)
        for s in range(0, n, batch_size):
            i = torch.from_numpy(order[s:s + batch_size]).to(x.device)
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            logits = functional_call(module, leaves, (x[i],), kwargs)
            loss = F.cross_entropy(logits, y[i])
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            with torch.no_grad():
                updates, state = opt.update(grads, state, params)
                params = apply_updates(params, updates)
    return params


@torch.no_grad()
def _attack_scores(module, variables: dict, x, y) -> dict[str, float]:
    pred = functional_call(module, variables, (x,), {"train": False}).argmax(-1)
    acc = float((pred == y).float().mean())
    members, nonmembers = y == 1, y == 0
    tpr = float(pred[members].float().mean()) if int(members.sum()) else 0.0
    fpr = float(pred[nonmembers].float().mean()) if int(nonmembers.sum()) else 0.0
    return {"attack_acc": acc, "advantage": tpr - fpr, "tpr": tpr, "fpr": fpr}


class NNAttack:
    """Shadow-model NN attack (reference NNAttack, NN_attack.py:59): the MLP
    trained on member / non-member prediction vectors. ``top_k=3`` is the
    reference's top-3 variant."""

    def __init__(self, top_k: int | None = None, lr: float = 0.1,
                 epochs: int = 40, batch_size: int = 64, seed: int = 0):
        self.top_k = top_k
        self.lr = lr
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.model = None
        self.variables = None

    def fit(self, predict_fn, member_x, nonmember_x, init_variables=None):
        x, y = attack_dataset(predict_fn, member_x, nonmember_x, self.top_k)
        self.model = NNAttackModel(x.shape[1])
        if init_variables is None:
            init_variables = flax_default_init(
                self.model, torch.Generator().manual_seed(self.seed), x.device)
        self.variables = _fit_classifier(self.model, init_variables, x, y, self.lr,
                                         self.epochs, self.batch_size, self.seed)
        return self

    def score(self, predict_fn, member_x, nonmember_x) -> dict[str, float]:
        x, y = attack_dataset(predict_fn, member_x, nonmember_x, self.top_k)
        return _attack_scores(self.model, self.variables, x, y)


def _to_numpy(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _threshold_sweep(member_scores, nonmember_scores) -> dict[str, float]:
    """Predict 'member' when a score is below t, for t at the 5%..95%
    quantiles of all scores; the t of the best advantage."""
    sm, sn = _to_numpy(member_scores), _to_numpy(nonmember_scores)
    ts = np.quantile(np.concatenate([sm, sn]), np.linspace(0.05, 0.95, 19))
    best = {"attack_acc": 0.0, "advantage": -1.0, "threshold": float(ts[0])}
    for t in ts:
        tpr = float((sm < t).mean())
        fpr = float((sn < t).mean())
        acc = 0.5 * (tpr + (1 - fpr))
        if tpr - fpr > best["advantage"]:
            best = {"attack_acc": acc, "advantage": tpr - fpr, "threshold": float(t)}
    return best


def loss_attack(loss_fn: Callable, member, nonmember) -> dict[str, float]:
    """Threshold-on-loss attack (reference MI_attack loss attack): members
    have the lower loss."""
    return _threshold_sweep(loss_fn(*member), loss_fn(*nonmember))


def gradient_norm_attack(grad_norm_fn: Callable, member, nonmember) -> dict[str, float]:
    """Gradient-norm attack (reference mix-gradient attack): members have
    the smaller per-sample gradient norm on a trained model."""
    return _threshold_sweep(grad_norm_fn(*member), grad_norm_fn(*nonmember))


def make_per_sample_loss(trainer, variables):
    """Per-sample cross-entropy through a ModelTrainer in eval mode (the
    loss attack's scores)."""

    @torch.no_grad()
    def f(x, y):
        logits, _ = trainer.apply(variables, x)
        return F.cross_entropy(logits, y.long(), reduction="none")

    return f


def make_per_sample_grad_norm(trainer, variables):
    """Per-sample L2 norms of the parameters' gradient of the eval-mode
    cross-entropy: ``torch.func.vmap(torch.func.grad(...))`` over the rows,
    all at once (512 rows of AdaptiveCNN hold 2.3 GiB of gradients)."""
    params, state = split_variables(variables)

    def loss(p, x, y):
        logits, _ = trainer.apply({**p, **state}, x[None])
        return F.cross_entropy(logits, y[None].long())

    per_sample = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0, 0))

    def f(x, y):
        g = per_sample(params, x, y)
        return torch.sqrt(sum((t.float() ** 2).reshape(t.shape[0], -1).sum(1)
                              for t in g.values()))

    return f


def _head_weight(trainer, variables: dict, n_classes: int, head_path):
    """The classifier head's weight [n_classes, in]: the module at
    ``head_path`` (a tuple of module names, flax's path), else the last
    Dense/Conv kernel of rank 2 with output width ``n_classes`` in flax's
    sorted path order (the converter's names)."""
    if head_path is not None:
        return variables[".".join(head_path) + ".weight"]
    other = leaf_kinds(trainer.module)
    heads = sorted((k.split(".")[:-1], k) for k, v in variables.items()
                   if k.rpartition(".")[2] == "weight" and k not in other
                   and v.dim() == 2 and v.shape[0] == n_classes)
    if not heads:
        raise ValueError("no 2D kernel with output width == n_classes found; pass "
                         "head_path explicitly for this model")
    return variables[heads[-1][1]]


def make_penultimate_grad_fn(trainer, variables, head_path: tuple | None = None):
    """Per-sample gradient of the cross-entropy with respect to the
    classifier head's input (the 'penultimate' activations the reference
    logs via model.penultimate.grad, Gradient_attack.py:70), in closed form:
    (softmax - onehot) @ W_head, with W_head in PyTorch's [out, in]
    layout."""

    @torch.no_grad()
    def f(x, y):
        logits, _ = trainer.apply(variables, x)
        n_classes = logits.shape[-1]
        w = _head_weight(trainer, variables, n_classes, head_path)
        sm = torch.softmax(logits, -1)
        oh = F.one_hot(y.long(), n_classes).to(sm.dtype)
        return (sm - oh) @ w.to(sm.dtype)

    return f


class GradientVectorAttack:
    """Gradient-vector-classifier MI attack (reference Gradient_attack.py:56):
    attack features = the descending-sorted softmax concatenated with the
    penultimate-activation gradient; classifier = TwoBranchAttackModel,
    trained with dropout drawn from a generator seeded with ``seed + 1``."""

    def __init__(self, lr: float = 0.1, epochs: int = 40,
                 batch_size: int = 64, seed: int = 0):
        self.lr, self.epochs, self.batch_size, self.seed = lr, epochs, batch_size, seed
        self.model = None
        self.variables = None

    @torch.no_grad()
    def _features(self, pred_fn, grad_fn, x, y):
        preds = _sorted_probs(pred_fn(x))
        self._pred_dim = preds.shape[1]
        return torch.cat([preds, grad_fn(x, y).float()], 1)

    def _dataset(self, pred_fn, grad_fn, member, nonmember):
        # fit() then score() on the same arrays is the common path: reuse
        # the features instead of re-running the model and the gradient
        # sweeps. The cache holds strong references to the inputs and
        # compares object identity against them, so a recycled id() can
        # never alias different data.
        inputs = (pred_fn, grad_fn, *member, *nonmember)
        cached = getattr(self, "_feat_inputs", None)
        if cached is not None and len(cached) == len(inputs) and all(
                a is b for a, b in zip(cached, inputs)):
            return self._feat_cache
        fm = self._features(pred_fn, grad_fn, *member)
        fn_ = self._features(pred_fn, grad_fn, *nonmember)
        x = torch.cat([fm, fn_])
        y = _membership_labels(len(fm), len(fn_), x.device)
        self._feat_inputs, self._feat_cache = inputs, (x, y)
        return x, y

    def fit(self, pred_fn, grad_fn, member, nonmember, init_variables=None):
        x, y = self._dataset(pred_fn, grad_fn, member, nonmember)
        self.model = TwoBranchAttackModel(self._pred_dim, x.shape[1] - self._pred_dim)
        if init_variables is None:
            init_variables = flax_default_init(
                self.model, torch.Generator().manual_seed(self.seed), x.device)
        dropout = torch.Generator(device=x.device).manual_seed(self.seed + 1)
        self.variables = _fit_classifier(self.model, init_variables, x, y, self.lr,
                                         self.epochs, self.batch_size, self.seed,
                                         generator=dropout)
        return self

    def score(self, pred_fn, grad_fn, member, nonmember) -> dict[str, float]:
        x, y = self._dataset(pred_fn, grad_fn, member, nonmember)
        # scoring ends the fit -> score fast path: drop the pinned inputs so
        # a retained attack object keeps no datasets or model closures alive
        self._feat_inputs = self._feat_cache = None
        return _attack_scores(self.model, self.variables, x, y)


class MixGradientAttack(GradientVectorAttack):
    """Mix-gradient MI attack (reference MixGradient_attack.py:104-114): the
    prediction features come from the TARGET (global / ensemble) model while
    the penultimate gradients come from a LOCAL branch model; fit and score
    take (target_pred_fn, local_grad_fn). The feature mix is the attack;
    the classifier is GradientVectorAttack's."""
