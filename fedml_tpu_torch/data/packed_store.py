"""Out-of-core packed client store: mmap shards with O(cohort) staging
(PyTorch port's copy of ``fedml_tpu/data/packed_store.py``, on the same
on-disk format, so a store written by one package opens in the other).

``PackedClients`` (``data/packing.py``) holds the whole federation as padded
host numpy: the 3400-client FEMNIST surrogate pads to 3400 x 480 x 784
float32, 5.12 GB. This module keeps the same duck-typed surface
(``num_clients`` / ``n_max`` / ``counts`` / ``total_samples`` / ``select`` /
``x`` / ``y``) over memory-mapped shard files, so a round's host footprint
is O(cohort): ``select(client_indices)`` reads only the sampled client rows
and nothing else becomes resident.

Directory format (one store = one directory):

    store.json       header: version, num_clients, n_max, sample_shape,
                     x/y dtypes, per-shard row counts (client k lives in the
                     shard whose [start, stop) covers k, at local row
                     k - start)
    counts.bin       [num_clients] true sample counts (dtype kept from the
                     source: header ``counts_dtype``)
    shard_00000.x    [rows, n_max, *sample_shape] x_dtype
    shard_00000.y    [rows, n_max, *y_shape] y_dtype
    ...

Writers never hold the whole federation: ``write_packed_shards`` streams
bounded chunks of ``source.select(...)`` into sequential shard appends, and
``ShardWriter.append`` takes rows from loaders that produce clients a chunk
at a time. ``create_synthetic_store`` builds stores of any size as sparse
files (``ftruncate`` holes read as zeros and take no disk): the substrate of
``experiments/scale_rss.py``.

A whole-store read (``np.asarray(store.x)``, ``store.x[:]``) defeats the
point; ``materialize`` is the one place that does it, under a byte budget.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence

import numpy as np

from fedml_tpu_torch import telemetry
from fedml_tpu_torch.data.packing import PackedClients

HEADER_NAME = "store.json"
STORE_VERSION = 1
DEFAULT_CLIENTS_PER_SHARD = 4096


def _shard_paths(store_dir: str, i: int) -> tuple:
    return (os.path.join(store_dir, f"shard_{i:05d}.x"),
            os.path.join(store_dir, f"shard_{i:05d}.y"))


class ShardWriter:
    """Incremental shard writer: append client rows in order; ``close()``
    seals the header. Holds at most one appended chunk in RAM; the geometry
    (n_max, sample shape, dtypes) comes from the first append."""

    def __init__(self, store_dir: str,
                 clients_per_shard: int = DEFAULT_CLIENTS_PER_SHARD):
        if clients_per_shard < 1:
            raise ValueError(f"clients_per_shard must be >= 1, got "
                             f"{clients_per_shard}")
        self.store_dir = store_dir
        self.clients_per_shard = int(clients_per_shard)
        os.makedirs(store_dir, exist_ok=True)
        self._geom = None  # (n_max, sample_shape, x_dtype, y_shape, y_dtype)
        self._counts: List[np.ndarray] = []
        self._shard_rows: List[int] = []  # sealed shards
        self._cur_rows = 0
        self._xf = self._yf = None
        self._closed = False

    def _open_next_shard(self):
        xp, yp = _shard_paths(self.store_dir, len(self._shard_rows))
        self._xf, self._yf = open(xp, "wb"), open(yp, "wb")
        self._cur_rows = 0

    def _seal_shard(self):
        if self._xf is not None:
            self._xf.close()
            self._yf.close()
            self._xf = self._yf = None
            self._shard_rows.append(self._cur_rows)

    def append(self, x_rows: np.ndarray, y_rows: np.ndarray,
               counts: np.ndarray) -> None:
        """Append ``k`` client rows: x [k, n_max, *sample], y [k, n_max,
        *tail], counts [k]. Client order is append order."""
        x_rows = np.ascontiguousarray(x_rows)
        y_rows = np.ascontiguousarray(y_rows)
        if self._geom is None:
            self._geom = (int(x_rows.shape[1]), tuple(x_rows.shape[2:]),
                          x_rows.dtype, tuple(y_rows.shape[2:]), y_rows.dtype)
        n_max, sshape, xdt, yshape, ydt = self._geom
        if tuple(x_rows.shape[1:]) != (n_max,) + sshape:
            raise ValueError(f"x chunk shape {x_rows.shape[1:]} != "
                             f"{(n_max,) + sshape}")
        # the counts keep the source's dtype: a select from the store must
        # return the bytes the in-RAM source would
        self._counts.append(np.asarray(counts))
        pos = 0
        while pos < len(x_rows):
            if self._xf is None:
                self._open_next_shard()
            take = min(len(x_rows) - pos,
                       self.clients_per_shard - self._cur_rows)
            x_rows[pos:pos + take].astype(xdt, copy=False).tofile(self._xf)
            y_rows[pos:pos + take].astype(ydt, copy=False).tofile(self._yf)
            self._cur_rows += take
            pos += take
            if self._cur_rows == self.clients_per_shard:
                self._seal_shard()

    def close(self) -> str:
        """Seal the last shard, write counts.bin and the header. Returns the
        store directory."""
        if self._closed:
            return self.store_dir
        self._seal_shard()
        if self._geom is None:
            raise ValueError("ShardWriter.close() before any append()")
        n_max, sshape, xdt, yshape, ydt = self._geom
        counts = (np.concatenate(self._counts) if self._counts
                  else np.zeros(0, np.int64))
        counts.tofile(os.path.join(self.store_dir, "counts.bin"))
        header = {
            "version": STORE_VERSION,
            "num_clients": int(counts.shape[0]),
            "n_max": n_max,
            "sample_shape": list(sshape),
            "x_dtype": np.dtype(xdt).name,
            "y_shape": list(yshape),
            "y_dtype": np.dtype(ydt).name,
            "counts_dtype": counts.dtype.name,
            "shard_rows": self._shard_rows,
        }
        with open(os.path.join(self.store_dir, HEADER_NAME), "w") as f:
            json.dump(header, f, indent=2)
            f.write("\n")
        self._closed = True
        return self.store_dir


def write_packed_shards(store_dir: str, source,
                        clients_per_shard: int = DEFAULT_CLIENTS_PER_SHARD,
                        chunk_clients: int = 256) -> str:
    """Convert any PackedClients-shaped source (``PackedClients``, another
    store) into a shard store, streaming ``chunk_clients``-sized ``select()``
    windows so the whole federation is never resident."""
    writer = ShardWriter(store_dir, clients_per_shard=clients_per_shard)
    total = int(source.num_clients)
    for lo in range(0, total, chunk_clients):
        x, y, counts = source.select(np.arange(lo, min(lo + chunk_clients, total)))
        writer.append(x, y, counts)
    return writer.close()


def create_synthetic_store(store_dir: str, num_clients: int, n_max: int,
                           sample_shape: Sequence[int],
                           clients_per_shard: int = 65536,
                           x_dtype: str = "float32",
                           y_dtype: str = "int32") -> str:
    """A store of any size in O(1) time and near-zero disk: the shard files
    are created sparse (truncated to their logical size: holes read back as
    zeros), and only counts.bin (8 bytes a client, n_max everywhere) is
    written. ``select`` and training behave as on a real store of zeros."""
    os.makedirs(store_dir, exist_ok=True)
    sshape = tuple(int(s) for s in sample_shape)
    xdt, ydt = np.dtype(x_dtype), np.dtype(y_dtype)
    x_row = n_max * int(np.prod(sshape, dtype=np.int64)) * xdt.itemsize
    y_row = n_max * ydt.itemsize
    shard_rows = []
    for i, lo in enumerate(range(0, num_clients, clients_per_shard)):
        rows = min(clients_per_shard, num_clients - lo)
        for path, row_bytes in zip(_shard_paths(store_dir, i), (x_row, y_row)):
            with open(path, "wb") as f:
                f.truncate(rows * row_bytes)
        shard_rows.append(rows)
    np.full(num_clients, n_max, np.int64).tofile(
        os.path.join(store_dir, "counts.bin"))
    header = {
        "version": STORE_VERSION,
        "num_clients": int(num_clients),
        "n_max": int(n_max),
        "sample_shape": list(sshape),
        "x_dtype": xdt.name,
        "y_shape": [],
        "y_dtype": ydt.name,
        "counts_dtype": "int64",
        "shard_rows": shard_rows,
        "synthetic": True,
    }
    with open(os.path.join(store_dir, HEADER_NAME), "w") as f:
        json.dump(header, f, indent=2)
        f.write("\n")
    return store_dir


class _MmapField:
    """Lazy indexing facade over one sharded field (x or y). Takes the
    access patterns the port uses (``x[k]``, ``x[:1, 0]``, fancy first-axis
    indexing) by gathering only the touched client rows; ``shape``,
    ``dtype`` and ``nbytes`` come from the header without touching data.
    Not an ndarray, so no caller stages the whole store by accident."""

    def __init__(self, store: "MmapPackedStore", field: str):
        self._store = store
        self._field = field

    @property
    def shape(self):
        h = self._store.header
        tail = tuple(h["sample_shape"] if self._field == "x" else h["y_shape"])
        return (h["num_clients"], h["n_max"]) + tail

    @property
    def dtype(self):
        h = self._store.header
        return np.dtype(h["x_dtype"] if self._field == "x" else h["y_dtype"])

    @property
    def nbytes(self) -> int:
        """The logical size, from the header alone."""
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    def __len__(self):
        return self._store.num_clients

    def __getitem__(self, key):
        first = key[0] if isinstance(key, tuple) else key
        rest = key[1:] if isinstance(key, tuple) else ()
        idx = np.arange(self._store.num_clients)[first]
        scalar = np.ndim(idx) == 0
        rows = self._store._gather(np.atleast_1d(idx), self._field)
        if scalar:
            rows = rows[0]
            return rows[rest] if rest else rows
        return rows[(slice(None),) + rest] if rest else rows

    def __array__(self, dtype=None, copy=None):
        out = self[:]
        return out.astype(dtype) if dtype is not None else out


class MmapPackedStore:
    """PackedClients over memory-mapped shard files: O(cohort) ``select``.

    ``cache_budget`` > 0 keeps an LRU of recently selected client rows as
    real (non-mmap) arrays, for cohorts that revisit clients on a slow
    backing store; 0 (the default) reads through the page cache. Each
    ``select`` emits the ``store_resident_bytes``, ``store_decode_hit`` and
    ``store_decode_miss`` gauges through the telemetry seam."""

    def __init__(self, store_dir: str, cache_budget: int = 0):
        self.store_dir = store_dir
        with open(os.path.join(store_dir, HEADER_NAME)) as f:
            self.header = json.load(f)
        if self.header.get("version") != STORE_VERSION:
            raise ValueError(
                f"store {store_dir} has version {self.header.get('version')},"
                f" this build reads version {STORE_VERSION}")
        self._starts = np.concatenate(
            [[0], np.cumsum(self.header["shard_rows"])]).astype(np.int64)
        if int(self._starts[-1]) != self.header["num_clients"]:
            raise ValueError(
                f"store {store_dir} header is inconsistent: shard rows sum "
                f"to {int(self._starts[-1])} but num_clients is "
                f"{self.header['num_clients']}")
        self.counts = np.memmap(
            os.path.join(store_dir, "counts.bin"),
            dtype=np.dtype(self.header["counts_dtype"]), mode="r",
            shape=(self.header["num_clients"],))
        self._fds: dict = {}  # (field, shard_i) -> O_RDONLY fd
        self._counts_fd: int | None = None
        self.cache_budget = int(cache_budget)
        self._cache: "dict[int, tuple]" = {}  # client -> (x_row, y_row)
        self._cache_order: List[int] = []
        self._resident_bytes = 0
        self._total_samples = None
        self._closed = False

    # ---- PackedClients surface -------------------------------------------
    @property
    def num_clients(self) -> int:
        return int(self.header["num_clients"])

    @property
    def n_max(self) -> int:
        return int(self.header["n_max"])

    @property
    def sample_shape(self) -> tuple:
        return tuple(self.header["sample_shape"])

    @property
    def total_samples(self) -> int:
        if self._total_samples is None:
            # a streaming sum over the counts map, 8 B a client
            self._total_samples = int(np.sum(self.counts, dtype=np.int64))
        return self._total_samples

    @property
    def x(self) -> _MmapField:
        return _MmapField(self, "x")

    @property
    def y(self) -> _MmapField:
        return _MmapField(self, "y")

    def select(self, client_indices):
        """Gather one round's client rows: only the sampled rows are read
        (a pread a row, or an LRU hit)."""
        idx = np.asarray(client_indices, np.int64)
        hits = 0
        if self.cache_budget > 0 and self._cache:
            hits = sum(1 for k in idx if int(k) in self._cache)
        x = self._gather(idx, "x")
        y = self._gather(idx, "y")
        counts = self._gather_counts(idx)
        if self.cache_budget > 0:
            self._cache_insert(idx, x, y)
        telemetry.gauge("store_decode_hit", store="mmap", count=hits)
        telemetry.gauge("store_decode_miss", store="mmap", count=int(len(idx) - hits))
        telemetry.gauge("store_resident_bytes", store="mmap", bytes=self._resident_bytes)
        return x, y, counts

    # ---- introspection (tests) -------------------------------------------
    @property
    def resident_bytes(self) -> int:
        return self._resident_bytes

    def resident_clients(self) -> list:
        return list(self._cache_order)

    # ---- internals --------------------------------------------------------
    def _gather(self, idx: np.ndarray, field: str) -> np.ndarray:
        """[len(idx), n_max, *tail] copy of the requested client rows, read
        shard by shard."""
        idx = np.asarray(idx, np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.num_clients):
            raise IndexError(
                f"client index out of range [0, {self.num_clients}): "
                f"{idx.min()}..{idx.max()}")
        h = self.header
        tail = tuple(h["sample_shape"] if field == "x" else h["y_shape"])
        dtype = np.dtype(h["x_dtype"] if field == "x" else h["y_dtype"])
        out = np.empty((len(idx), h["n_max"]) + tail, dtype)
        if not len(idx):
            return out
        shard_of = np.searchsorted(self._starts, idx, side="right") - 1
        fi = 0 if field == "x" else 1
        row_nbytes = int(out[0].nbytes)
        for s in np.unique(shard_of):
            where = np.flatnonzero(shard_of == s)
            needed = []
            for j in where:
                row = self._cache.get(int(idx[j])) if self.cache_budget > 0 else None
                if row is not None:
                    out[j] = row[fi]
                else:
                    needed.append(j)
            if needed:
                # a pread a row, not a fancy mmap read: a cold page fault
                # on a sparse shard costs about 1000x a pread of the same
                # row (the JAX package's 1M-client scale measurement); the
                # bytes are the same, holes read as zeros
                fd = self._fd(field, int(s))
                for j, r in zip(needed, idx[needed] - self._starts[s]):
                    buf = os.pread(fd, row_nbytes, int(r) * row_nbytes)
                    out[j] = np.frombuffer(buf, dtype).reshape(out.shape[1:])
        return out

    def _fd(self, field: str, shard_i: int) -> int:
        if self._closed:
            raise ValueError(f"store {self.store_dir} is closed")
        key = (field, shard_i)
        fd = self._fds.get(key)
        if fd is None:
            path = _shard_paths(self.store_dir, shard_i)[0 if field == "x" else 1]
            fd = os.open(path, os.O_RDONLY)
            self._fds[key] = fd
        return fd

    def _gather_counts(self, idx: np.ndarray) -> np.ndarray:
        """A pread of counts.bin a client, as the shard rows are read (the
        counts map stays for whole-store scans such as total_samples)."""
        if self._closed:
            raise ValueError(f"store {self.store_dir} is closed")
        if self._counts_fd is None:
            self._counts_fd = os.open(
                os.path.join(self.store_dir, "counts.bin"), os.O_RDONLY)
        dt = self.counts.dtype
        out = np.empty(len(idx), dt)
        for j, k in enumerate(idx):
            out[j] = np.frombuffer(
                os.pread(self._counts_fd, dt.itemsize, int(k) * dt.itemsize), dt)[0]
        return out

    def _cache_insert(self, idx: np.ndarray, x: np.ndarray, y: np.ndarray) -> None:
        for j, k in enumerate(idx):
            k = int(k)
            if k in self._cache:
                self._cache_order.remove(k)
                self._cache_order.append(k)
                continue
            row = (np.array(x[j]), np.array(y[j]))
            self._cache[k] = row
            self._cache_order.append(k)
            self._resident_bytes += row[0].nbytes + row[1].nbytes
        pin = {int(k) for k in idx}
        while self._resident_bytes > self.cache_budget and len(self._cache) > len(pin):
            old = next(k for k in self._cache_order if k not in pin)
            dropped = self._cache.pop(old)
            self._cache_order.remove(old)
            self._resident_bytes -= dropped[0].nbytes + dropped[1].nbytes

    def close(self) -> None:
        """Close every file; later reads raise. A resumed run opens a new
        MmapPackedStore on the same directory."""
        for fd in self._fds.values():
            os.close(fd)
        self._fds.clear()
        if self._counts_fd is not None:
            os.close(self._counts_fd)
            self._counts_fd = None
        self._cache.clear()
        self._cache_order.clear()
        self._resident_bytes = 0
        self._closed = True


def materialize(store, budget: int = 4 << 30) -> PackedClients:
    """The one whole-store read: copy a store into an eager, mutable
    PackedClients (for paths that write into client rows, such as the
    backdoor's poisoning). Refuses an mmap store whose x exceeds ``budget``
    bytes: at that size in-place mutation is the wrong tool. A streaming
    store (``data/streaming.py``) decodes under its own byte budget
    (``streaming.materialize``)."""
    if isinstance(store, PackedClients):
        return store
    if not isinstance(store, MmapPackedStore):
        from fedml_tpu_torch.data import streaming

        return streaming.materialize(store)
    total = store.x.nbytes
    if total > budget:
        raise ValueError(
            f"materializing this mmap store needs {total >> 20} MiB "
            f"(budget {budget >> 20} MiB): too large to hold eagerly; keep "
            "it out of core (select a cohort) or raise the budget")
    return PackedClients(np.asarray(store.x), np.asarray(store.y),
                         np.array(store.counts, np.int64))  # a copy, not the map


def resident_train_arrays(store, device, budget: int = 4 << 30):
    """(x, y, counts) of a whole train store as tensors on ``device``, or
    None when it does not fit ``budget`` bytes: residency is an
    optimization, never a requirement. An MmapPackedStore goes through
    ``materialize``."""
    import torch

    if isinstance(store, MmapPackedStore):
        if store.x.nbytes > budget:
            return None
        store = materialize(store, budget=budget)
    if not isinstance(store, PackedClients) or not isinstance(store.x, np.ndarray):
        return None
    nbytes = store.x.nbytes + store.y.nbytes + np.asarray(store.counts).nbytes
    if nbytes > budget:
        return None
    telemetry.gauge("store_resident_bytes", store="resident", bytes=nbytes)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (store.x, store.y, store.counts))
