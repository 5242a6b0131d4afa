"""Streaming per-client image store: lazy decode under an LRU byte budget
(PyTorch port's copy of ``fedml_tpu/data/streaming.py``; host numpy, no
torch).

The reference's at-scale image loaders read from disk a batch at a time
(reference ImageNet/data_loader.py's dataset ``__getitem__``,
Landmarks/data_loader.py): ILSVRC2012 (about 1.28 M images) and gld160k
cannot be held as host float32 arrays.

``StreamingPackedClients`` keeps only file paths and labels resident. A
client's images are decoded on its first ``select()`` (the round's sampled
client gather, the ``PackedClients.select`` contract) and cached under an
LRU byte budget, so a round touches only its sampled clients and memory
stays bounded however large the federation is.

Duck-typed to ``data.packing.PackedClients``: ``num_clients`` / ``n_max`` /
``counts`` / ``total_samples`` / ``select`` / ``x`` / ``y``. ``y`` is a real
padded array (labels are cheap); ``x`` is a lazy facade that decodes only
the clients an indexing expression touches: ``train.x[:1, 0]`` decodes one
client, and ``train.x.shape`` none.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np

from fedml_tpu_torch import telemetry

log = logging.getLogger(__name__)


class _LazyX:
    """Indexing facade over the decoded-on-demand client rows: ``x[k]``
    (one client's row) and first-axis slices or fancy indices (only the
    touched clients decode, then the rest of the key applies). ``shape``
    decodes nothing; a whole-array read (``np.asarray``) decodes every
    client, which is legal, and the LRU still bounds the cache."""

    def __init__(self, store: "StreamingPackedClients"):
        self._store = store

    @property
    def shape(self):
        return (self._store.num_clients, self._store.n_max) + self._store.sample_shape

    @property
    def dtype(self):
        return np.float32

    def __len__(self):
        return self._store.num_clients

    def __getitem__(self, key):
        first = key[0] if isinstance(key, tuple) else key
        rest = key[1:] if isinstance(key, tuple) else ()
        idx = np.arange(self._store.num_clients)[first]
        if np.ndim(idx) == 0:
            rows = self._store._client_row(int(idx))
            return rows[rest] if rest else rows
        rows = np.stack([self._store._client_row(int(k)) for k in idx])
        return rows[(slice(None),) + rest] if rest else rows

    def __array__(self, dtype=None, copy=None):
        out = self[:]
        return out.astype(dtype) if dtype is not None else out


class StreamingPackedClients:
    """PackedClients over lazily decoded per-client image file lists."""

    def __init__(self, client_files: Sequence[Sequence[str]],
                 client_labels: Sequence[np.ndarray],
                 decode_fn: Callable[[str], np.ndarray],
                 n_max: int | None = None,
                 byte_budget: int = 4 << 30):
        assert len(client_files) == len(client_labels)
        self._files = [list(f) for f in client_files]
        self.counts = np.asarray([len(f) for f in self._files], np.int64)
        self._n_max = int(n_max) if n_max else int(self.counts.max())
        self._decode = decode_fn
        self.byte_budget = int(byte_budget)
        self._cache: OrderedDict[int, np.ndarray] = OrderedDict()
        self._resident_bytes = 0
        self._sample_shape: tuple | None = None
        # the pipelined drive's stager thread (data/prefetch.py) calls
        # select() while the main thread may evaluate: the LRU and its byte
        # count need one lock. It guards only the cache's lookup, insert and
        # evict; decodes run outside it, so the two threads never serialize
        # on codec work. Reentrant: sample_shape's lazy init may nest under
        # a _client_row caller.
        self._lock = threading.RLock()
        # labels are cheap: the padded [C, n_max] array is held eagerly
        self.y = np.zeros((len(self._files), self._n_max), np.int32)
        for k, lab in enumerate(client_labels):
            self.y[k, :len(lab)] = np.asarray(lab, np.int32)

    # ---- the PackedClients surface ---------------------------------------
    @property
    def num_clients(self) -> int:
        return len(self._files)

    @property
    def n_max(self) -> int:
        return self._n_max

    @property
    def total_samples(self) -> int:
        return int(self.counts.sum())

    @property
    def x(self) -> _LazyX:
        return _LazyX(self)

    @property
    def sample_shape(self) -> tuple:
        with self._lock:
            if self._sample_shape is None:
                for files in self._files:
                    if files:
                        self._sample_shape = tuple(self._decode(files[0]).shape)
                        break
                else:
                    raise ValueError("no files in any client")
            return self._sample_shape

    def row_bytes(self) -> int:
        """The bytes of one decoded, padded client row."""
        return self._n_max * int(np.prod(self.sample_shape)) * 4

    def select(self, client_indices):
        """A round's client rows: decodes at most the sampled clients, and
        everything else stays on disk. Every sampled row is pinned at once,
        so a round needing more than the budget raises ``MemoryError``.
        The lock is held for the cache's bookkeeping only, never across a
        decode: the stager thread and the main thread (eval chunks, guard
        re-stages) decode different clients concurrently."""
        idx = np.asarray(client_indices)
        need = len(idx) * self.row_bytes()
        if need > self.byte_budget:
            raise MemoryError(
                f"one round needs {need >> 20} MiB of decoded client rows "
                f"({len(idx)} clients x n_max={self._n_max} x "
                f"{self.sample_shape}) but the stream budget is "
                f"{self.byte_budget >> 20} MiB. Lower client_num_per_round / "
                "image_size, cap samples per client (the ILSVRC2012 loader's "
                "samples_per_client), or raise FEDML_TPU_STREAM_BUDGET.")
        pin = set(int(k) for k in idx)
        stats = {"hit": 0, "miss": 0}
        x = np.stack([self._client_row(int(k), pin=pin, stats=stats) for k in idx])
        telemetry.gauge("store_decode_hit", store="streaming", count=stats["hit"])
        telemetry.gauge("store_decode_miss", store="streaming", count=stats["miss"])
        with self._lock:
            resident = self._resident_bytes
        telemetry.gauge("store_resident_bytes", store="streaming", bytes=resident)
        return x, self.y[idx], self.counts[idx]

    # ---- introspection ----------------------------------------------------
    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes

    def resident_clients(self) -> list[int]:
        """The cached clients, least recently used first."""
        with self._lock:
            return list(self._cache)

    # ---- internals ----------------------------------------------------------
    def _client_row(self, k: int, pin: set | None = None,
                    stats: dict | None = None) -> np.ndarray:
        """One client's decoded [n_max, *sample] row. The lock brackets the
        cache lookup and the insert/evict only. Two threads racing on the
        same client may both decode it; the first insert wins and the other
        adopts the cached copy (the decode is pure in k, so the bytes are
        the same either way)."""
        with self._lock:
            row = self._cache.get(k)
            if row is not None:
                self._cache.move_to_end(k)
                if stats is not None:
                    stats["hit"] += 1
                return row
        row = self._decode_row(k)  # the expensive part, outside the lock
        with self._lock:
            existing = self._cache.get(k)
            if existing is not None:  # lost a same-client race: keep the winner
                self._cache.move_to_end(k)
                if stats is not None:
                    stats["hit"] += 1
                return existing
            if stats is not None:
                stats["miss"] += 1
            self._cache[k] = row
            self._resident_bytes += row.nbytes
            self._evict(pin or {k})
        return row

    def _decode_row(self, k: int) -> np.ndarray:
        files = self._files[k]
        shape = self.sample_shape
        row = np.zeros((self._n_max,) + shape, np.float32)
        # decode in parallel (PIL releases the GIL around codec work), the
        # reference DataLoader's num_workers
        todo = files[: self._n_max]
        if len(todo) > 8:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=8) as pool:
                imgs = list(pool.map(self._decode, todo))
        else:
            imgs = [self._decode(f) for f in todo]
        for i, img in enumerate(imgs):
            if tuple(img.shape) != shape:
                raise ValueError(f"decode_fn returned {img.shape}, expected {shape}")
            row[i] = img
        return row

    def _evict(self, pin: set):
        while self._resident_bytes > self.byte_budget and len(self._cache) > len(pin):
            for old in self._cache:
                if old not in pin:
                    dropped = self._cache.pop(old)
                    self._resident_bytes -= dropped.nbytes
                    break
            else:
                break


def make_image_decoder(size: int | None = None, mean: np.ndarray | None = None,
                       std: np.ndarray | None = None) -> Callable[[str], np.ndarray]:
    """decode_fn: path -> [h, w, 3] float32, resized and channel-normalized
    (``readers.load_image`` and the eager loaders' normalization)."""
    from fedml_tpu_torch.data.readers import load_image

    def decode(path: str) -> np.ndarray:
        img = load_image(path, size)
        if mean is not None:
            img = (img - mean) / std
        return img

    return decode


def decode_global_subset(files: Sequence[str], labels: np.ndarray,
                         decode_fn: Callable[[str], np.ndarray], cap: int, seed: int,
                         sample_shape: tuple) -> tuple[np.ndarray, np.ndarray]:
    """A seeded random subset of a flat (files, labels) list, decoded: the
    ``*_global`` arrays of a streaming dataset. A prefix of the class- or
    user-sorted list would cover only the first classes."""
    n = len(files)
    labels = np.asarray(labels, np.int32)
    if n == 0:
        return np.zeros((0,) + tuple(sample_shape), np.float32), labels[:0]
    k = min(int(cap), n)
    idx = np.random.RandomState(seed).choice(n, size=k, replace=False)
    idx.sort()
    x = np.stack([decode_fn(files[i]) for i in idx])
    return x, labels[idx]


def materialize(store):
    """Decode a StreamingPackedClients into an eager, mutable PackedClients
    (for paths that write into client rows, such as the backdoor's
    poisoning). Refuses a federation whose decoded size exceeds the store's
    byte budget: at that size in-place mutation is the wrong tool."""
    from fedml_tpu_torch.data.packing import PackedClients

    if isinstance(store, PackedClients):
        return store
    total = store.num_clients * store.row_bytes()
    if total > store.byte_budget:
        raise ValueError(
            f"materializing this streaming dataset needs {total >> 20} MiB "
            f"(budget {store.byte_budget >> 20} MiB) — too large to hold "
            "eagerly; run this experiment on a subset (cap_per_class) or "
            "raise FEDML_TPU_STREAM_BUDGET")
    x = np.stack([store._client_row(k) for k in range(store.num_clients)])
    return PackedClients(x, store.y.copy(), np.asarray(store.counts, np.int64))
