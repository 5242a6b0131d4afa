"""Fixed-shape client packing (numpy copy of ``fedml_tpu/data/packing.py``).

Each client's rows are padded to the largest client's size and paired with
its sample count: leaves [num_clients, n_max, ...] held as host numpy. A
round selects its clients' rows (a small host gather) and ships only those
to the device."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PackedClients:
    """Per-client padded arrays. x: [C, n_max, ...]; y: [C, n_max, ...];
    counts: [C] true sample numbers."""

    x: np.ndarray
    y: np.ndarray
    counts: np.ndarray

    @property
    def num_clients(self) -> int:
        return self.x.shape[0]

    @property
    def n_max(self) -> int:
        return self.x.shape[1]

    @property
    def total_samples(self) -> int:
        return int(self.counts.sum())

    def select(self, client_indices):
        """Gather a round's client rows (host-side)."""
        idx = np.asarray(client_indices)
        return self.x[idx], self.y[idx], self.counts[idx]


def pack_client_data(x: np.ndarray, y: np.ndarray, dataidx_map: dict,
                     n_max: int | None = None) -> PackedClients:
    """Pack a global (x, y) pair into per-client padded rows using a
    partition index map."""
    client_num = len(dataidx_map)
    counts = np.array([len(dataidx_map[i]) for i in range(client_num)], dtype=np.int32)
    if n_max is None:
        n_max = int(counts.max())
    px = np.zeros((client_num, n_max) + x.shape[1:], dtype=x.dtype)
    py = np.zeros((client_num, n_max) + y.shape[1:], dtype=y.dtype)
    for i in range(client_num):
        idx = np.asarray(dataidx_map[i], dtype=np.int64)[:n_max]
        px[i, :len(idx)] = x[idx]
        py[i, :len(idx)] = y[idx]
    np.minimum(counts, n_max, out=counts)
    return PackedClients(px, py, counts)


def pack_client_lists(xs: list, ys: list, n_max: int | None = None) -> PackedClients:
    """Pack naturally split per-client arrays (e.g. FEMNIST per-writer
    groups)."""
    client_num = len(xs)
    counts = np.array([len(a) for a in xs], dtype=np.int32)
    if n_max is None:
        n_max = int(counts.max())
    px = np.zeros((client_num, n_max) + xs[0].shape[1:], dtype=xs[0].dtype)
    py = np.zeros((client_num, n_max) + ys[0].shape[1:], dtype=ys[0].dtype)
    for i in range(client_num):
        k = min(len(xs[i]), n_max)
        px[i, :k] = xs[i][:k]
        py[i, :k] = ys[i][:k]
        counts[i] = k
    return PackedClients(px, py, counts)


def pad_clients(x: np.ndarray, y: np.ndarray, counts: np.ndarray, multiple: int):
    """Pad a round's client batch to a multiple of ``multiple`` rows with
    zero-count clients (weight-0 no-ops in every aggregator)."""
    pad = (-len(counts)) % multiple
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        y = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
        counts = np.concatenate([counts, np.zeros(pad, counts.dtype)])
    return x, y, counts


def pack_eval_batches(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Pad a flat eval set to [num_batches, batch_size, ...] plus a mask."""
    n = x.shape[0]
    nb = max(1, -(-n // batch_size))
    total = nb * batch_size
    px = np.zeros((total,) + x.shape[1:], dtype=x.dtype)
    py = np.zeros((total,) + y.shape[1:], dtype=y.dtype)
    mask = np.zeros((total,), dtype=np.float32)
    px[:n], py[:n], mask[:n] = x, y, 1.0
    return (px.reshape((nb, batch_size) + x.shape[1:]),
            py.reshape((nb, batch_size) + y.shape[1:]),
            mask.reshape(nb, batch_size))
