"""Per-client personalization at a real population: a packed mmap bank of
per-client rank-r LoRA adapter rows with O(cohort) gather and scatter
(PyTorch port of ``fedml_tpu/models/adapter_bank.py``; numpy only, and the
same files, so a bank written by either package reads the same in the
other).

  bank.json          header: version, num_rows, rows_per_shard,
                     shard_rows, row_nbytes, the packed-leaf layout of
                     one adapter row (utils/packed_leaves.leaf_layout
                     over the template adapter tree)
  bank_00000.rows    sparse [rows, row_nbytes] uint8, one fixed-width
                     packed adapter row per client; ``truncate`` holes
                     read as zeros, so an untouched client costs no bytes
                     AND its personal adapter is exactly the zero tree
                     (the personalization identity: effective params ==
                     global params)
  bank_00000.mat     sparse [rows] uint8 materialized flag
  bank_00000.lift    sparse [rows] float32 last measured accuracy lift

A template is the port's flat adapter dict (``{"block0.qkv.weight.lora_A":
[d_in, r], ...}``, tensors or arrays): a row packs its leaves in
``models.lora.adapter_order``, which is the JAX package's
``jax.tree.flatten`` order of the nested adapter tree, with the same
shapes (the port keeps flax's adapter layout), so the header and the bytes
match the JAX package's.

``gather(ids) -> {key: [C, ...]}`` and ``scatter(ids, rows)`` go through
sorted, coalesced ``os.pread``/``os.pwrite`` (a cold page fault on a sparse
shard costs far more than a pread of the same row), so a round's cost is
O(cohort) and host RSS stays bounded by the pages a cohort touches, never
by ``num_rows``. The drive scatters through ``apply()`` blocks fetched by
``RoundRecordLog.flush``'s deferred transfer, as the client ledger's; the
same seed therefore writes byte-identical shard files.

With ``--adapter_clusters K`` the bank holds K cluster rows instead of one
per client (cluster id = a static EMA-loss bucket from the client ledger);
the layout is the same, only ``num_rows`` shrinks.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Tuple

import numpy as np

from fedml_tpu_torch import telemetry
from fedml_tpu_torch.models.lora import adapter_order
from fedml_tpu_torch.utils import packed_leaves

HEADER_NAME = "bank.json"
BANK_VERSION = 1
DEFAULT_ROWS_PER_SHARD = 262144

#: per-row sidecar columns (ledger-style sparse files): a uint8
#: materialized flag and the last measured per-client accuracy lift
SIDE_COLUMNS: Tuple[Tuple[str, type], ...] = (
    ("mat", np.uint8),
    ("lift", np.float32),
)


def _shard_path(root: str, shard: int, kind: str) -> str:
    return os.path.join(root, f"bank_{shard:05d}.{kind}")


def _np_dtype(leaf) -> np.dtype:
    """The numpy dtype of an array's or a tensor's elements."""
    dtype = leaf.dtype
    return np.dtype(str(dtype).replace("torch.", "")) if not isinstance(
        dtype, np.dtype) else dtype


class _Leaf:
    def __init__(self, shape, dtype):
        self.shape, self.dtype = shape, dtype


def _template_layout(template) -> Tuple[List[Dict], int, List[str]]:
    """(entries, row_nbytes, keys) of one adapter row: ``template`` is the
    per-client adapter dict (arrays or tensors), its keys taken in
    ``adapter_order``."""
    keys = adapter_order(template)
    leaves = [_Leaf(tuple(template[k].shape), _np_dtype(template[k])) for k in keys]
    entries, row_nbytes = packed_leaves.leaf_layout(leaves)
    if len(entries) != len(leaves):
        raise ValueError("adapter template has empty leaves — every "
                         "personal adapter leaf must pack into the row")
    return entries, row_nbytes, keys


def create_bank(root: str, num_rows: int, template,
                rows_per_shard: int = DEFAULT_ROWS_PER_SHARD
                ) -> "AdapterBank":
    """Create an empty bank: header + sparse shard files (near-zero disk
    at any `num_rows` — the zero row IS the untouched client's adapter)."""
    if num_rows <= 0:
        raise ValueError(f"num_rows must be positive, got {num_rows}")
    entries, row_nbytes, _ = _template_layout(template)
    os.makedirs(root, exist_ok=True)
    shard_rows = []
    remaining = num_rows
    while remaining > 0:
        shard_rows.append(min(rows_per_shard, remaining))
        remaining -= shard_rows[-1]
    for i, rows in enumerate(shard_rows):
        sizes = [("rows", rows * row_nbytes)]
        sizes += [(col, rows * np.dtype(dt).itemsize)
                  for col, dt in SIDE_COLUMNS]
        for kind, nbytes in sizes:
            with open(_shard_path(root, i, kind), "wb") as f:
                f.truncate(nbytes)
    header = {
        "version": BANK_VERSION,
        "num_rows": num_rows,
        "rows_per_shard": rows_per_shard,
        "shard_rows": shard_rows,
        "row_nbytes": row_nbytes,
        "leaves": entries,
    }
    with open(os.path.join(root, HEADER_NAME), "w") as f:
        json.dump(header, f, indent=2)
    return AdapterBank(root, template)


def open_or_create(root: str, num_rows: int, template,
                   rows_per_shard: int = DEFAULT_ROWS_PER_SHARD
                   ) -> "AdapterBank":
    """Open an existing bank (resume) or create a fresh one. Resume
    validates row count AND row layout — a bank written under a
    different adapter geometry must not be silently reinterpreted."""
    if os.path.exists(os.path.join(root, HEADER_NAME)):
        bank = AdapterBank(root, template)
        if bank.num_rows != num_rows:
            raise ValueError(
                f"adapter bank at {root} holds {bank.num_rows} rows, "
                f"run needs {num_rows}")
        return bank
    return create_bank(root, num_rows, template, rows_per_shard)


class AdapterBank:
    """mmap-backed per-client personal adapter rows with O(cohort)
    gather/scatter. Shard fds open lazily and stay open for the run;
    only the pages a cohort's rows land in become resident."""

    def __init__(self, root: str, template):
        self.root = root
        with open(os.path.join(root, HEADER_NAME)) as f:
            self.header = json.load(f)
        if self.header.get("version") != BANK_VERSION:
            raise ValueError(
                f"unsupported bank version {self.header.get('version')}")
        entries, row_nbytes, keys = _template_layout(template)
        if (self.header["row_nbytes"] != row_nbytes
                or self.header["leaves"] != entries):
            raise ValueError(
                f"adapter bank at {root} was written for a different "
                f"adapter layout ({self.header['row_nbytes']} B/row vs "
                f"this run's {row_nbytes} B/row)")
        self.entries = entries
        self.row_nbytes = row_nbytes
        self.keys = keys
        self.num_rows = int(self.header["num_rows"])
        self.shard_rows = [int(r) for r in self.header["shard_rows"]]
        # shard i covers row ids [_starts[i], _starts[i+1])
        self._starts = np.concatenate(
            [[0], np.cumsum(self.shard_rows)]).astype(np.int64)
        self._fds: Dict[int, int] = {}
        self._maps: Dict[Tuple[int, str], np.memmap] = {}
        # resume restores the materialized count from the flag columns
        # (1 B/row through the page cache — 1 MB at 1M rows)
        self.rows_materialized = int(sum(
            int(np.sum(self._map(s, "mat"), dtype=np.int64))
            for s in range(len(self.shard_rows))))

    # -- internals ---------------------------------------------------------

    def _fd(self, shard: int) -> int:
        fd = self._fds.get(shard)
        if fd is None:
            fd = os.open(_shard_path(self.root, shard, "rows"), os.O_RDWR)
            self._fds[shard] = fd
        return fd

    def _map(self, shard: int, column: str) -> np.memmap:
        key = (shard, column)
        m = self._maps.get(key)
        if m is None:
            dtype = dict(SIDE_COLUMNS)[column]
            m = np.memmap(_shard_path(self.root, shard, column), mode="r+",
                          dtype=dtype, shape=(self.shard_rows[shard],))
            self._maps[key] = m
        return m

    def _by_shard(self, row_ids: np.ndarray
                  ) -> Iterable[Tuple[int, np.ndarray, np.ndarray]]:
        """Yield (shard, local_rows, positions-into-row_ids) groups."""
        idx = np.asarray(row_ids, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.num_rows):
            raise IndexError("row id out of adapter bank range")
        shards = np.searchsorted(self._starts, idx, side="right") - 1
        for shard in np.unique(shards):
            pos = np.nonzero(shards == shard)[0]
            yield int(shard), idx[pos] - self._starts[shard], pos

    # -- gather / scatter --------------------------------------------------

    def gather(self, row_ids) -> dict:
        """{key: [C, ...] numpy array}, the stacked personal adapters of one
        cohort: O(cohort) coalesced preads; never-scattered rows come back
        as zero adapters (sparse holes), the personalization identity."""
        idx = np.asarray(row_ids, np.int64)
        buf = np.empty((idx.size, self.row_nbytes), np.uint8)
        for shard, rows, pos in self._by_shard(idx):
            buf[pos] = packed_leaves.read_rows(
                self._fd(shard), rows, self.row_nbytes)
        stacked = packed_leaves.unpack_rows(buf, self.entries)
        return dict(zip(self.keys, stacked))

    def scatter(self, row_ids, rows_tree) -> None:
        """Write one cohort's updated personal rows ({key: [C, ...]}, host
        arrays or CPU tensors) back: O(cohort) coalesced pwrites plus the
        materialized-flag scatter."""
        idx = np.asarray(row_ids, np.int64)
        leaves = [np.asarray(rows_tree[k]) for k in self.keys]
        buf = packed_leaves.pack_rows(leaves, self.entries, self.row_nbytes)
        for shard, rows, pos in self._by_shard(idx):
            packed_leaves.write_rows(self._fd(shard), rows, buf[pos])
            mat = self._map(shard, "mat")
            # unique: duplicate row ids (cluster mode maps many clients
            # onto one cluster row) must not double-count
            fresh_rows = np.unique(rows)
            fresh = int(np.sum(mat[fresh_rows] == 0, dtype=np.int64))
            mat[fresh_rows] = 1
            self.rows_materialized += fresh

    def write_lift(self, row_ids, lift) -> None:
        """Scatter the probe cohort's measured per-client accuracy lift
        (personalized minus global) into the lift sidecar column."""
        lift = np.asarray(lift, np.float32)
        for shard, rows, pos in self._by_shard(row_ids):
            self._map(shard, "lift")[rows] = lift[pos]

    def apply(self, block: dict) -> None:
        """Dispatch one drive-loop bank block (already fetched to the host).

        `rows` may carry mesh-padded cohort stacking; entries past
        len(client_idx) are synthetic and dropped here. Emits the
        `bank_rows_materialized` / `bank_bytes_physical` gauges the
        trace summary surfaces."""
        idx = np.asarray(block["client_idx"])
        n = len(idx)
        if "rows" in block:
            rows_tree = {k: np.asarray(a)[:n] for k, a in block["rows"].items()}
            self.scatter(idx, rows_tree)
        elif "lift" in block:
            self.write_lift(idx, np.asarray(block["lift"])[:n])
        else:
            raise ValueError(f"unknown bank block keys: {sorted(block)}")
        telemetry.gauge("bank_rows_materialized", rows=n,
                        total_rows=self.rows_materialized)
        telemetry.gauge("bank_bytes_physical", bytes=self.bytes_physical())

    # -- reads / introspection --------------------------------------------

    def lift_column(self) -> np.ndarray:
        """Materialize the lift sidecar across shards (4 B/row)."""
        return np.concatenate([
            np.asarray(self._map(s, "lift"))
            for s in range(len(self.shard_rows))])

    def materialized_column(self) -> np.ndarray:
        """Materialize the materialized-flag sidecar (1 B/row)."""
        return np.concatenate([
            np.asarray(self._map(s, "mat"))
            for s in range(len(self.shard_rows))])

    def bytes_physical(self) -> int:
        """Blocks actually allocated under the row shards (sparse holes
        excluded) — the honest bank footprint at 1M rows."""
        total = 0
        for s in range(len(self.shard_rows)):
            st = os.stat(_shard_path(self.root, s, "rows"))
            total += st.st_blocks * 512
        return int(total)

    def flush(self) -> None:
        for m in self._maps.values():
            m.flush()
        for fd in self._fds.values():
            os.fsync(fd)

    def close(self) -> None:
        self.flush()
        self._maps.clear()
        for fd in self._fds.values():
            os.close(fd)
        self._fds.clear()


def read_side_columns(root: str) -> Dict[str, np.ndarray]:
    """Header-only read of a bank's sidecar columns (`mat`, `lift`) —
    no adapter template needed, so offline tooling (tools/client_report)
    can fold a bank it did not build. O(num_rows) bytes: 1 + 4 per row."""
    with open(os.path.join(root, HEADER_NAME)) as f:
        header = json.load(f)
    return {col: np.concatenate([
        np.fromfile(_shard_path(root, s, col), dtype=dt)
        for s in range(len(header["shard_rows"]))])
        for col, dt in SIDE_COLUMNS}


def cluster_rows(ema_loss: np.ndarray, num_clusters: int) -> np.ndarray:
    """Static EMA-loss bucketing for `--adapter_clusters K`: cluster id =
    `digitize` of the client's ledger EMA loss over K-1 fixed edges in
    [0, 4] (cross-entropy scale) — O(cohort), no learned centroids, and
    stable across rounds so a client's cluster only moves when its loss
    does. Loss 0 (never observed) lands in bucket 0."""
    if num_clusters <= 0:
        raise ValueError(f"num_clusters must be positive, got "
                         f"{num_clusters}")
    edges = np.linspace(0.0, 4.0, num_clusters + 1, dtype=np.float32)[1:-1]
    return np.digitize(np.asarray(ema_loss, np.float32), edges
                       ).astype(np.int64)
