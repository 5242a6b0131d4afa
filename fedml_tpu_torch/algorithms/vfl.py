"""Vertical (feature-split) federated learning: PyTorch form of
``fedml_tpu/algorithms/vfl.py`` (reference
fedml_api/standalone/classical_vertical_fl/: vfl.py:21-56 the fit loop,
party_models.py:12-118 the guest and hosts; the distributed variant's
guest_trainer.py:73-127).

Every party holds a column slice of the same rows. Each computes its logit
component on its slice; the guest (party 0, the label owner) sums them,
takes the BCE-with-logits loss, and the common gradient dL/dU reaches every
party's weights through the sum: one backward pass is the reference's
message exchange. Only the guest has a bias.

The initial weights are drawn from ``np.random.RandomState(seed)`` as the
JAX package draws them, so the two start from the same bits; the
minibatches are ``_minibatch_indices``' (numpy, the same in both). A fit
stages the parties' rows and its batches' indices on the device once and
gathers each batch there; the per-step losses stay on the device until
the fit ends.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.algorithms.engine import add_decayed_weights, apply_updates, chain, sgd
from fedml_tpu_torch.telemetry.records import fetch_scalars
from fedml_tpu_torch.utils.device import resolve_device


def _minibatch_indices(n: int, epochs: int, batch_size: int, seed: int):
    """The epochs' minibatches of both VFL APIs: a seeded permutation per
    epoch, full batches only (the tail under ``batch_size`` is dropped, as
    the reference's range(0, n - bs + 1, bs) loop drops it)."""
    rng = np.random.RandomState(seed)
    for _e in range(epochs):
        order = rng.permutation(n)
        for s in range(0, n - batch_size + 1, batch_size):
            yield order[s:s + batch_size]


def sigmoid_bce(u, y):
    """optax.sigmoid_binary_cross_entropy's log-sigmoid form, per sample."""
    return -(y * F.logsigmoid(u) + (1.0 - y) * F.logsigmoid(-u))


def _grad_step(opt, params_list, opt_states, loss_fn):
    """The loss of ``params_list`` and one update of every party; returns
    (params_list, opt_states, loss)."""
    leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()} for p in params_list]
    loss = loss_fn(leaves)
    flat = [t for p in leaves for t in p.values()]
    grads = iter(torch.autograd.grad(loss, flat))
    new_params, new_states = [], []
    with torch.no_grad():
        for p, leaf, s in zip(params_list, leaves, opt_states):
            g = {k: next(grads) for k in leaf}
            upd, s = opt.update(g, s, p)
            new_params.append(apply_updates(p, upd))
            new_states.append(s)
    return new_params, new_states, loss.detach()


def _linear_logit(params_list, xs, n: int):
    u = torch.zeros(n, dtype=torch.float32, device=xs[0].device)
    for x, p in zip(xs, params_list):
        comp = x @ p["w"][:, 0]
        if "b" in p:
            comp = comp + p["b"][0]
        u = u + comp
    return u


def build_vfl_step(cfg_lr: float) -> Callable:
    """step(params_list, opt_states, xs, y) -> (params_list, opt_states,
    loss): ``params_list[k] = {"w": [d_k, 1]}`` for party k, the guest
    (k = 0) also ``"b": [1]``; plain SGD at ``cfg_lr`` on every party."""
    opt = sgd(cfg_lr)

    def step(params_list, opt_states, xs, y):
        def loss_fn(params):
            return sigmoid_bce(_linear_logit(params, xs, y.shape[0]), y.float()).mean()

        return _grad_step(opt, params_list, opt_states, loss_fn)

    return step


def _batch_indices(n: int, epochs: int, batch_size: int, seed: int, device) -> list:
    """``_minibatch_indices``' batches as rows of one tensor copied to
    ``device`` once, so no step copies (and waits) on its own."""
    batches = list(_minibatch_indices(n, epochs, batch_size, seed))
    if not batches:
        return []
    return list(torch.from_numpy(np.stack(batches)).to(device))


def _stage(arrays, device) -> list:
    """Float arrays as float32 tensors on ``device`` (JAX's default type)."""
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device) for a in arrays]


class VerticalFederatedLearningAPI:
    """Multi-party vertical logistic regression (reference
    VerticalMultiplePartyLogisticRegressionFederatedLearning, vfl.py:1-56)
    on ``device`` (``cuda`` unless the caller asks for the CPU).
    ``feature_splits`` gives each party's columns of the design matrix;
    party 0 is the guest."""

    def __init__(self, feature_splits: list[np.ndarray], lr: float = 0.05, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.splits = feature_splits
        rng = np.random.RandomState(seed)
        self.params = []
        for k, cols in enumerate(feature_splits):
            p = {"w": torch.from_numpy(
                rng.normal(0, 0.01, size=(len(cols), 1)).astype(np.float32)).to(self.device)}
            if k == 0:
                p["b"] = torch.zeros(1, dtype=torch.float32, device=self.device)
            self.params.append(p)
        self.step = build_vfl_step(lr)
        self.opt_states = [sgd(lr).init(p) for p in self.params]
        self.loss_history: list[float] = []

    def fit(self, X: np.ndarray, y: np.ndarray, epochs: int = 10, batch_size: int = 64,
            seed: int = 0):
        parties = _stage([X[:, cols] for cols in self.splits], self.device)
        yd = torch.from_numpy(np.asarray(y)).to(self.device)
        losses = []
        for i in _batch_indices(len(y), epochs, batch_size, seed, self.device):
            self.params, self.opt_states, loss = self.step(
                self.params, self.opt_states, [x[i] for x in parties], yd[i])
            losses.append(loss)
        self.loss_history.extend(fetch_scalars(losses))
        return self

    @torch.no_grad()
    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        xs = _stage([X[:, cols] for cols in self.splits], self.device)
        u = _linear_logit(self.params, xs, len(X)).cpu().numpy()
        return 1.0 / (1.0 + np.exp(-u))

    def score(self, X, y) -> float:
        return float(np.mean((self.predict_proba(X) > 0.5).astype(int) == y))


# --------------------------------------------------------------- neural VFL


def party_logit(p: dict, x):
    """A party's LocalModel (dense + LeakyReLU, slope 0.01) then its
    DenseModel (a scalar logit component; the guest's with its bias)."""
    z = F.leaky_relu(x @ p["local_w"] + p["local_b"], 0.01)
    u = z @ p["dense_w"][:, 0]
    if "dense_b" in p:
        u = u + p["dense_b"][0]
    return u


def build_neural_vfl_step(lr: float = 0.01, momentum: float = 0.9,
                          wd: float = 0.01) -> tuple:
    """(step, party_logit, opt) of the neural party stack (reference
    fedml_api/model/finance/vfl_models_standalone.py:6-75 and
    party_models.py:12-118): every party's LocalModel and DenseModel, the
    guest summing the components into BCE-with-logits; weight decay then
    SGD with momentum on every party (the reference's SGD(momentum=0.9,
    weight_decay=0.01) on each sub-model). ``step(params_list,
    opt_states, xs, y) -> (params_list, opt_states, loss)``."""
    opt = chain(add_decayed_weights(wd), sgd(lr, momentum=momentum))

    def step(params_list, opt_states, xs, y):
        def loss_fn(params):
            u = torch.zeros(y.shape[0], dtype=torch.float32, device=y.device)
            for p, x in zip(params, xs):
                u = u + party_logit(p, x)
            return sigmoid_bce(u, y.float()).mean()

        return _grad_step(opt, params_list, opt_states, loss_fn)

    return step, party_logit, opt


class NeuralVFLAPI:
    """Vertical FL with the reference's neural party models (LocalModel
    feature extractors and DenseModel components, the "VFL finance models")
    on ``device`` (``cuda`` unless the caller asks for the CPU). Party 0 is
    the guest."""

    def __init__(self, party_dims: list[int], hidden_dim: int = 32, lr: float = 0.01,
                 momentum: float = 0.9, wd: float = 0.01, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        rng = np.random.RandomState(seed)
        self.params: list[dict] = []
        for k, d in enumerate(party_dims):
            p = {"local_w": rng.normal(0, np.sqrt(2.0 / d), (d, hidden_dim)).astype(np.float32),
                 "local_b": np.zeros(hidden_dim, np.float32),
                 "dense_w": rng.normal(0, 0.05, (hidden_dim, 1)).astype(np.float32)}
            if k == 0:  # the guest's dense model keeps its bias (party_models.py:21)
                p["dense_b"] = np.zeros(1, np.float32)
            self.params.append({n: torch.from_numpy(a).to(self.device) for n, a in p.items()})
        self.step, self._party_logit, opt = build_neural_vfl_step(lr, momentum, wd)
        self.opt_states = [opt.init(p) for p in self.params]
        self.loss_history: list[float] = []

    def fit(self, party_xs: list[np.ndarray], y: np.ndarray, epochs: int = 10,
            batch_size: int = 64, seed: int = 0):
        parties = _stage(party_xs, self.device)
        yd = torch.from_numpy(np.asarray(y)).to(self.device)
        losses = []
        for i in _batch_indices(len(y), epochs, batch_size, seed, self.device):
            self.params, self.opt_states, loss = self.step(
                self.params, self.opt_states, [x[i] for x in parties], yd[i])
            losses.append(loss)
        self.loss_history.extend(fetch_scalars(losses))
        return self

    @torch.no_grad()
    def predict_proba(self, party_xs: list[np.ndarray]) -> np.ndarray:
        u = torch.zeros(len(party_xs[0]), dtype=torch.float32, device=self.device)
        for p, x in zip(self.params, _stage(party_xs, self.device)):
            u = u + self._party_logit(p, x)
        return torch.sigmoid(u).cpu().numpy()

    def score(self, party_xs, y) -> float:
        return float(np.mean((self.predict_proba(party_xs) > 0.5).astype(int) == y))
