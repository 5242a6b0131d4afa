"""Decentralized-FL topologies -> row-stochastic mixing matrices (a copy of
``fedml_tpu/core/topology.py``, numpy only; the port imports nothing of
the JAX package).

Reference fedml_core/distributed/topology/symmetric_topology_manager.py:21-52
and asymmetric_topology_manager.py:7-60 (also the standalone variant at
fedml_api/standalone/decentralized/topology_manager.py:38-130). The
reference builds graphs with networkx Watts-Strogatz at rewire-p=0, which is
exactly a ring lattice, constructed here directly. The matrix IS the
communication pattern: one gossip step is ``W @ stacked_params``
(``algorithms/decentralized.py``). The asymmetric manager's coin flips come
from the caller's ``RandomState`` in the JAX package's order, so the
matrices equal the JAX package's bit for bit
(``tests/test_torch_decentralized.py``).
"""

from __future__ import annotations

import numpy as np


def _ring_lattice(n: int, k: int) -> np.ndarray:
    """Adjacency of a ring lattice: each node linked to k//2 neighbors per
    side (Watts-Strogatz with rewire probability 0, no self loops)."""
    adj = np.zeros((n, n), np.float32)
    half = max(1, k // 2)
    for i in range(n):
        for d in range(1, half + 1):
            adj[i, (i + d) % n] = 1
            adj[i, (i - d) % n] = 1
    return adj


class BaseTopologyManager:
    """Reference base_topology_manager.py:4-23 contract."""

    n: int
    topology: np.ndarray

    def generate_topology(self):
        raise NotImplementedError

    def get_in_neighbor_weights(self, node_index):
        if node_index >= self.n:
            return []
        return self.topology[node_index]

    def get_out_neighbor_weights(self, node_index):
        if node_index >= self.n:
            return []
        return self.topology[:, node_index] if getattr(self, "directed", False) else self.topology[node_index]

    def get_in_neighbor_idx_list(self, node_index):
        w = self.get_in_neighbor_weights(node_index)
        return [i for i, v in enumerate(w) if v > 0 and i != node_index]

    def get_out_neighbor_idx_list(self, node_index):
        w = self.get_out_neighbor_weights(node_index)
        return [i for i, v in enumerate(w) if v > 0 and i != node_index]

    # standalone-decentralized API names (topology_manager.py:38-130)
    def get_symmetric_neighbor_list(self, node_index):
        return self.get_in_neighbor_weights(node_index)

    def get_asymmetric_neighbor_list(self, node_index):
        return self.get_in_neighbor_weights(node_index)

    def mixing_matrix(self) -> np.ndarray:
        return np.asarray(self.topology, np.float32)


class SymmetricTopologyManager(BaseTopologyManager):
    """Ring + extra symmetric ring-lattice links, row-normalized."""

    directed = False

    def __init__(self, n: int, neighbor_num: int = 2):
        self.n = n
        self.neighbor_num = neighbor_num
        self.topology = np.array([])

    def generate_topology(self):
        adj = _ring_lattice(self.n, 2)
        extra = _ring_lattice(self.n, int(self.neighbor_num))
        adj = np.maximum(adj, extra)
        np.fill_diagonal(adj, 1)
        self.topology = adj / adj.sum(axis=1, keepdims=True)


class AsymmetricTopologyManager(BaseTopologyManager):
    """Symmetric base + random one-way links (reference
    asymmetric_topology_manager.py:23-60), rows normalized -> row-stochastic
    but not doubly-stochastic (push-sum territory)."""

    directed = True

    def __init__(self, n: int, undirected_neighbor_num: int = 3,
                 out_directed_neighbor: int = 3, rng: np.random.RandomState | None = None):
        self.n = n
        self.undirected_neighbor_num = undirected_neighbor_num
        self.out_directed_neighbor = out_directed_neighbor
        self.rng = rng or np.random.RandomState(0)
        self.topology = np.array([])

    def generate_topology(self):
        adj = np.maximum(_ring_lattice(self.n, 2),
                         _ring_lattice(self.n, self.undirected_neighbor_num))
        np.fill_diagonal(adj, 1)
        # randomly add directed links on the empty slots (reference flips a
        # coin per zero entry, in row-major order)
        zeros = np.argwhere(adj == 0)
        for i, j in zeros:
            if self.rng.randint(2) == 1:
                adj[i, j] = 1
        self.topology = adj / adj.sum(axis=1, keepdims=True)


class FullyConnectedTopologyManager(BaseTopologyManager):
    """Uniform averaging: one gossip step = exact FedAvg (the equivalence
    oracle of the decentralized path)."""

    directed = False

    def __init__(self, n: int):
        self.n = n
        self.topology = np.array([])

    def generate_topology(self):
        self.topology = np.full((self.n, self.n), 1.0 / self.n, np.float32)
