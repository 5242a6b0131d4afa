"""Decentralized (serverless) FL: DSGD and push-sum gossip, PyTorch form of
``fedml_tpu/algorithms/decentralized.py``.

Reference fedml_api/standalone/decentralized/ (client_dsgd.py:6-92,
client_pushsum.py:7-110, decentralized_fl_api.py:20) and the MPI gossip
skeleton fedml_api/distributed/decentralized_framework/. All node
parameters live as one node-stacked dict [N, ...] and a gossip exchange is

    x_{t+1} = W @ x_t        (W = row-stochastic mixing matrix)

one ``torch.einsum`` a leaf. Push-sum (for a directed W) also mixes the
omega mass vector and de-biases with z = x / omega.

The reference task is streaming online learning (one sample a node per
iteration, regret metric); ``DecentralizedFLAPI.run`` reproduces that loop.
``backend="shard_map"`` wants one device per node in the JAX package (a
``ppermute`` exchange); with more nodes than devices it warns and mixes
densely, and so does the port, which runs on one device. In a process
group of more than one rank the API raises: the cross-rank gossip exchange
is ROADMAP.md Queue 1 item 2.4 (``parallel/gossip.py``), and running the
dense mix on every rank would repeat it silently.
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np
import torch

from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.topology import BaseTopologyManager
from fedml_tpu_torch.utils.device import device_count, resolve_device
from fedml_tpu_torch.utils.pytree import split_variables

log = logging.getLogger(__name__)


def _mix(stacked: dict, W: torch.Tensor) -> dict:
    """x_i <- sum_j W[i, j] x_j for every leaf of a node-stacked dict."""
    return {k: torch.einsum("ij,j...->i...", W, v) for k, v in stacked.items()}


def build_gossip_step(trainer, cfg: FedConfig, push_sum: bool = False) -> Callable:
    """step(x_params, omega, z_vars, batch, W, rng) -> (x_params, omega,
    z_vars, losses): one decentralized iteration over all nodes, each
    node's gradient at z_t, x_{t+1/2} = x_t - lr * grad, then the gossip
    mix and z_{t+1} (ClientDSGD.train / update_local_parameters,
    client_dsgd.py:54-92, and ClientPushsum.train, client_pushsum.py:57-110).

    x_params and z_vars are node-stacked dicts (z_vars with the model state
    beside the parameters), omega [N], batch ``{"x", "y", "mask"}`` with a
    leading node axis, W [N, N] on the device, ``rng`` a CPU generator from
    which each node's dropout seed is drawn. losses: [N] on the device."""
    lr = cfg.lr

    def node_grad(z_node: dict, batch: dict, gen: torch.Generator):
        params, state = split_variables(z_node)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, _ = trainer.loss_fn({**leaves, **state}, batch, gen, True)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, grads)), loss.detach()

    def step(x_params, omega, z_vars, batch, W, rng):
        n = batch["x"].shape[0]
        device = batch["x"].device
        grads, losses = [], []
        for i, seed in enumerate(torch.randint(0, 2 ** 31 - 1, (n,), generator=rng).tolist()):
            gen = torch.Generator(device=device).manual_seed(seed)
            g, loss = node_grad({k: v[i] for k, v in z_vars.items()},
                                {k: v[i] for k, v in batch.items()}, gen)
            grads.append(g)
            losses.append(loss)
        with torch.no_grad():
            # x_{t+1/2} = x_t - lr * grad(z_t)  (client_pushsum.py:82-85)
            x_half = {k: x - lr * torch.stack([g[k] for g in grads])
                      for k, x in x_params.items()}
            if push_sum:
                # push-sum sends with the SENDER's weights (reference
                # send_local_gradient_to_neighbor weights by
                # self.topology[index], client_pushsum.py:92-97): the mix is
                # W^T, column-stochastic for the receiver, so omega moves on
                # directed graphs and z = x / omega de-biases the average
                x_new = _mix(x_half, W.T)
                omega_new = W.T @ omega
                z_params = {k: x / omega_new.reshape((-1,) + (1,) * (x.dim() - 1))
                            for k, x in x_new.items()}
            else:
                x_new = _mix(x_half, W)
                omega_new = omega
                z_params = x_new
        return x_new, omega_new, {**z_vars, **z_params}, torch.stack(losses)

    return step


def seeded_generator(*entropy: int) -> torch.Generator:
    """A CPU generator that is a pure function of ``entropy``: node i's
    initial weights come from (seed, i), iteration t's dropout seeds from
    (seed, t, 1)."""
    state = np.random.SeedSequence(list(entropy)).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & (2 ** 63 - 1))


class DecentralizedFLAPI:
    """Streaming decentralized online learning (reference
    FedML_decentralized_fl, decentralized_fl_api.py:20) on ``device``
    (``cuda`` unless the caller asks for the CPU): every node holds its own
    model; each iteration every node trains on its streaming sample and
    gossips.

    ``run``'s streams are (x, y) arrays shaped [N, T, ...], node-major."""

    def __init__(self, trainer, cfg: FedConfig, topology: BaseTopologyManager,
                 push_sum: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.trainer = trainer
        self.cfg = cfg.validate(device=self.device)
        if cfg.mesh_size() > 1:
            raise NotImplementedError(
                f"decentralized gossip over a process group of {cfg.mesh_size()} ranks is "
                f"not ported to fedml_tpu_torch yet (ROADMAP.md Queue 1 item 2.4, "
                f"parallel/gossip.py); run it in one process")
        if not len(np.asarray(topology.topology)):
            topology.generate_topology()
        self.W = torch.from_numpy(topology.mixing_matrix()).to(self.device)
        self.n = int(self.W.shape[0])
        self.push_sum = push_sum
        devices = device_count(self.device)
        if cfg.backend == "shard_map" and self.n > devices:
            log.warning("backend='shard_map' wants one device per gossip node "
                        "(%d nodes > %d devices) — using the dense single-chip "
                        "W @ x mix instead", self.n, devices)
        self.step = build_gossip_step(trainer, cfg, push_sum)
        self.loss_history: list[float] = []

    def init_nodes(self) -> dict:
        """Independent per-node models (the reference makes one model a
        client), node i's from ``seeded_generator(seed, i)``, stacked."""
        inits = [self.trainer.init(seeded_generator(self.cfg.seed, i), self.device)
                 for i in range(self.n)]
        return {k: torch.stack([v[k] for v in inits]) for k in inits[0]}

    def run(self, x_stream, y_stream, iterations: int | None = None,
            variables: dict | None = None) -> dict:
        """x_stream, y_stream: [N, T, ...] host arrays; ``variables``, the
        node-stacked initial models (default ``init_nodes()``). Returns the
        final node-stacked z. The streams go to the device once and the
        iterations' losses come back in one transfer at the end."""
        T = x_stream.shape[1] if iterations is None else iterations
        z = self.init_nodes() if variables is None else variables
        x_params = split_variables(z)[0]
        omega = torch.ones((self.n,), dtype=torch.float32, device=self.device)
        xs = torch.from_numpy(np.ascontiguousarray(x_stream)).to(self.device)
        ys = torch.from_numpy(np.ascontiguousarray(y_stream)).to(self.device)
        mask = torch.ones((self.n, 1), dtype=torch.float32, device=self.device)
        losses = []
        for t in range(T):
            ti = t % xs.shape[1]
            batch = {"x": xs[:, ti, None], "y": ys[:, ti, None], "mask": mask}
            x_params, omega, z, node_losses = self.step(
                x_params, omega, z, batch, self.W, seeded_generator(self.cfg.seed, t, 1))
            losses.append(node_losses.mean())
        if losses:
            self.loss_history += torch.stack(losses).double().cpu().tolist()
        return z

    def regret(self) -> float:
        """Average online loss so far (reference cal_regret,
        decentralized_fl_api.py:11-17)."""
        return float(np.mean(self.loss_history)) if self.loss_history else 0.0
