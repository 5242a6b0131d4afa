"""Out-of-core per-client health ledger: mmap-backed fixed-width columns
(PyTorch port's copy of ``fedml_tpu/telemetry/client_ledger.py``; numpy
only, and the same files, so a ledger written by either package reads the
same in the other).

The ledger answers per-client questions the round spans cannot: which
clients the sampler starves, which are quarantined repeatedly, whose update
norms drift, how stale the FedBuff tail is. It mirrors the packed store's
shard layout: a ``ledger.json`` header plus per-shard, per-column files
(``ledger_{i:05d}.<column>``) of fixed-width int32/float32 rows, so a
1M-client ledger is a handful of sparse files and host RSS stays bounded
by the pages a cohort touches, not by the federation's size.

Writes are O(cohort) scatters: the drive loops attach per-cohort stats
blocks to ``RoundRecordLog`` records (fetched with the records' deferred
host transfer, in its ``metrics_fetch`` span: no new sync point), and
``apply()`` fans each block out to the shards its client ids land in.
Column semantics:

  participation_count  int32  rounds the client was dispatched and alive
  drop_count           int32  rounds the client was sampled but dropped
  quarantine_count     int32  alive rounds whose update was non-finite
  staleness_sum        int32  FedBuff commit_round - dispatch_round, summed
  last_seen_round      int32  latest alive dispatch round (-1 = never)
  ema_update_norm      f32    EMA (beta=0.9) of the update L2-norm
  ema_loss             f32    EMA (beta=0.9) of the client's mean loss

EMAs are seeded from the first *healthy* (alive and finite) observation
rather than decayed from zero, so a client's first round is not an
artificial outlier; quarantined updates never touch the EMAs.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Tuple

import numpy as np

from fedml_tpu_torch import telemetry

HEADER_NAME = "ledger.json"
LEDGER_VERSION = 1

# (column, dtype, fill) — fill != 0 columns are written densely at create
# time; zero-filled columns are sparse `truncate` holes like the packed
# store's shards, so creating a 1M-client ledger costs near-zero disk.
COLUMNS: Tuple[Tuple[str, type, float], ...] = (
    ("participation_count", np.int32, 0),
    ("drop_count", np.int32, 0),
    ("quarantine_count", np.int32, 0),
    ("staleness_sum", np.int32, 0),
    ("last_seen_round", np.int32, -1),
    ("ema_update_norm", np.float32, 0.0),
    ("ema_loss", np.float32, 0.0),
)

EMA_BETA = 0.9
DEFAULT_CLIENTS_PER_SHARD = 262144


def _shard_path(root: str, shard: int, column: str) -> str:
    return os.path.join(root, f"ledger_{shard:05d}.{column}")


def create_ledger(root: str, num_clients: int,
                  clients_per_shard: int = DEFAULT_CLIENTS_PER_SHARD
                  ) -> "ClientLedger":
    """Create an empty ledger: header + sparse per-column shard files."""
    if num_clients <= 0:
        raise ValueError(f"num_clients must be positive, got {num_clients}")
    os.makedirs(root, exist_ok=True)
    shard_rows = []
    remaining = num_clients
    while remaining > 0:
        shard_rows.append(min(clients_per_shard, remaining))
        remaining -= shard_rows[-1]
    for i, rows in enumerate(shard_rows):
        for column, dtype, fill in COLUMNS:
            path = _shard_path(root, i, column)
            if fill == 0:
                # sparse hole: reads as zeros without allocating blocks
                with open(path, "wb") as f:
                    f.truncate(rows * np.dtype(dtype).itemsize)
            else:
                np.full(rows, fill, dtype=dtype).tofile(path)
    header = {
        "version": LEDGER_VERSION,
        "num_clients": num_clients,
        "clients_per_shard": clients_per_shard,
        "shard_rows": shard_rows,
        "columns": [{"name": c, "dtype": np.dtype(d).name, "fill": f}
                    for c, d, f in COLUMNS],
    }
    with open(os.path.join(root, HEADER_NAME), "w") as f:
        json.dump(header, f, indent=2)
    return ClientLedger(root)


def open_or_create(root: str, num_clients: int,
                   clients_per_shard: int = DEFAULT_CLIENTS_PER_SHARD
                   ) -> "ClientLedger":
    """Open an existing ledger (resume) or create a fresh one."""
    if os.path.exists(os.path.join(root, HEADER_NAME)):
        ledger = ClientLedger(root)
        if ledger.num_clients != num_clients:
            raise ValueError(
                f"ledger at {root} holds {ledger.num_clients} clients, "
                f"run has {num_clients}")
        return ledger
    return create_ledger(root, num_clients, clients_per_shard)


class ClientLedger:
    """mmap-backed per-client health columns with O(cohort) scatter writes.

    Maps are opened lazily per (shard, column) and kept open for the run;
    only the pages a cohort's rows land in become resident, so RSS is
    bounded by touched pages, not `num_clients`.
    """

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, HEADER_NAME)) as f:
            self.header = json.load(f)
        if self.header.get("version") != LEDGER_VERSION:
            raise ValueError(
                f"unsupported ledger version {self.header.get('version')}")
        self.num_clients = int(self.header["num_clients"])
        self.shard_rows = [int(r) for r in self.header["shard_rows"]]
        self._dtypes = {c: np.dtype(d) for c, d, _ in COLUMNS}
        expected = [c["name"] for c in self.header["columns"]]
        if expected != [c for c, _, _ in COLUMNS]:
            raise ValueError(f"ledger column mismatch: {expected}")
        # shard i covers global ids [_starts[i], _starts[i+1])
        self._starts = np.concatenate(
            [[0], np.cumsum(self.shard_rows)]).astype(np.int64)
        self._maps: Dict[Tuple[int, str], np.memmap] = {}
        self._rows_written = 0

    # -- mapping ----------------------------------------------------------

    def _map(self, shard: int, column: str) -> np.memmap:
        key = (shard, column)
        m = self._maps.get(key)
        if m is None:
            m = np.memmap(_shard_path(self.root, shard, column), mode="r+",
                          dtype=self._dtypes[column],
                          shape=(self.shard_rows[shard],))
            self._maps[key] = m
        return m

    def _by_shard(self, client_idx: np.ndarray
                  ) -> Iterable[Tuple[int, np.ndarray, np.ndarray]]:
        """Yield (shard, local_rows, positions-into-client_idx) groups."""
        idx = np.asarray(client_idx, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.num_clients):
            raise IndexError("client index out of ledger range")
        shards = np.searchsorted(self._starts, idx, side="right") - 1
        for shard in np.unique(shards):
            pos = np.nonzero(shards == shard)[0]
            yield int(shard), idx[pos] - self._starts[shard], pos

    # -- writes -----------------------------------------------------------

    def update(self, round_idx: int, client_idx: np.ndarray,
               participated: np.ndarray, update_norm: np.ndarray,
               finite: np.ndarray, loss_sum: np.ndarray,
               total: np.ndarray) -> None:
        """Scatter one cohort's health stats: O(cohort) touched rows."""
        participated = np.asarray(participated, dtype=bool)
        finite = np.asarray(finite, dtype=bool)
        update_norm = np.asarray(update_norm, dtype=np.float32)
        loss = (np.asarray(loss_sum, dtype=np.float32)
                / np.maximum(np.asarray(total, dtype=np.float32), 1.0))
        for shard, rows, pos in self._by_shard(client_idx):
            part = participated[pos]
            healthy = part & finite[pos]
            pc = self._map(shard, "participation_count")
            qc = self._map(shard, "quarantine_count")
            # EMA seeding needs the pre-update state: a client is "seen"
            # once it has at least one prior healthy observation
            seen_before = (pc[rows] - qc[rows]) > 0
            np.add.at(pc, rows, part.astype(np.int32))
            np.add.at(self._map(shard, "drop_count"), rows,
                      (~part).astype(np.int32))
            np.add.at(qc, rows, (part & ~finite[pos]).astype(np.int32))
            alive_rows = rows[part]
            self._map(shard, "last_seen_round")[alive_rows] = round_idx
            for column, x in (("ema_update_norm", update_norm[pos]),
                              ("ema_loss", loss[pos])):
                m = self._map(shard, column)
                old = m[rows]
                ema = np.where(seen_before,
                               EMA_BETA * old + (1.0 - EMA_BETA) * x,
                               x).astype(np.float32)
                m[rows[healthy]] = ema[healthy]
        self._rows_written += int(len(np.asarray(client_idx)))

    def add_staleness(self, client_idx: np.ndarray,
                      staleness: np.ndarray) -> None:
        """Accumulate FedBuff commit staleness (commit - dispatch round)."""
        staleness = np.asarray(staleness, dtype=np.int32)
        for shard, rows, pos in self._by_shard(client_idx):
            np.add.at(self._map(shard, "staleness_sum"), rows,
                      staleness[pos])

    def apply(self, block: dict) -> None:
        """Dispatch one drive-loop ledger block (already fetched to the host).

        Stats blocks may carry mesh-padded stats vectors (padded cohorts
        round up to the device count); rows past len(client_idx) are
        synthetic and dropped here.
        """
        idx = np.asarray(block["client_idx"])
        n = len(idx)
        if "stats" in block:
            s = block["stats"]
            self.update(int(block["round"]), idx,
                        np.asarray(block["participated"])[:n],
                        np.asarray(s["update_norm"])[:n],
                        np.asarray(s["finite"])[:n],
                        np.asarray(s["loss_sum"])[:n],
                        np.asarray(s["total"])[:n])
        elif "staleness" in block:
            self.add_staleness(idx, np.asarray(block["staleness"])[:n])
        else:
            raise ValueError(f"unknown ledger block keys: {sorted(block)}")
        telemetry.gauge("ledger_scatter", rows=n,
                        total_rows=self._rows_written)

    # -- reads ------------------------------------------------------------

    def column(self, name: str) -> np.ndarray:
        """Materialize one column across all shards (num_clients rows).

        4 bytes/client — 4 MB at 1M clients — so the report tool can
        afford full-column reads without breaking the RSS envelope.
        """
        if name not in self._dtypes:
            raise KeyError(name)
        return np.concatenate([
            np.asarray(self._map(shard, name))
            for shard in range(len(self.shard_rows))])

    def flush(self) -> None:
        for m in self._maps.values():
            m.flush()

    def close(self) -> None:
        self.flush()
        self._maps.clear()
