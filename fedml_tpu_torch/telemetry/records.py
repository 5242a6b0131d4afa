"""The one round-record path of the eager and pipelined drive loops
(PyTorch form of ``fedml_tpu/telemetry/records.py``).

- ``add(record)`` parks a record whose values may still be 0-d tensors on
  the device (the pipelined loop's deferred train metrics, the superstep's
  K rounds of metrics, each a view of a [K] tensor);
- ``flush()`` fetches every pending tensor in ONE host transfer per dtype
  (concatenated on the device, one ``.cpu()``, inside a ``metrics_fetch``
  span), applies the ``_ledger`` and ``_bank`` blocks to an attached client
  ledger and adapter bank, appends the records to ``history`` as Python
  scalars, mirrors them to the metrics logger, logs the round line and
  emits a ``round_committed`` event with the robustness counters.

The eager loop calls ``add`` + ``flush`` every round; the pipelined loop
calls ``flush`` only at its sync points (guard, eval, checkpoint, a
backlog of ``max(4, 2 * depth)`` records, the end of the drive).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import torch

from fedml_tpu_torch.telemetry.tracer import NULL_TRACER

log = logging.getLogger("fedml_tpu_torch.fedavg")

#: record keys mirrored into the `round_committed` ledger event: the
#: robustness counters a crash mid-flush must not lose.
_LEDGER_KEYS = ("participated_count", "quarantined_count", "guard_retries",
                "chaos_dropped", "chaos_nan", "chaos_corrupt")


def fetch_scalars(values: List[torch.Tensor]) -> List[float]:
    """Python floats of 0-d tensors of one device, in one host transfer.
    float64 holds every float32 and every int below 2**53 exactly."""
    if not values:
        return []
    return torch.stack([v.detach().double() for v in values]).cpu().tolist()


def fetch_tree(tree):
    """``tree`` (dicts, lists and tuples) with every tensor replaced by its
    host numpy array: one transfer per device and dtype (the tensors of a
    group concatenated flat on their device), so a flush fetches a
    cohort's stats rows and personal adapter rows together. Bits are kept:
    nothing is converted."""
    from fedml_tpu_torch.utils.pytree import tree_leaves

    tensors = [t for _, t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    groups: Dict[tuple, list] = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    host: Dict[int, Any] = {}
    for ts in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts]).cpu().numpy()
        offset = 0
        for t in ts:
            host[id(t)] = flat[offset:offset + t.numel()].reshape(tuple(t.shape))
            offset += t.numel()

    def rebuild(node):
        if isinstance(node, torch.Tensor):
            return host[id(node)]
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v) for v in node)
        return node

    return rebuild(tree)


class RoundRecordLog:
    """Owns pending round records from `add()` until `flush()` commits them
    to history, the metrics logger and the telemetry ledger.

    The reserved keys ``_ledger`` (per-cohort client-ledger blocks: stats
    rows and staleness) and ``_bank`` (personal adapter rows) never reach
    history. Their tensors ride the flush's transfer, then the blocks go to
    ``ledger.apply`` (``telemetry/client_ledger.py``) and ``bank.apply``
    (``models/adapter_bank.py``). With nothing attached, ``add`` drops
    them, before the transfer could fetch what they hold."""

    def __init__(self, tracer=None, history: Optional[List[Dict]] = None,
                 metrics_logger=None, ledger=None, bank=None):
        self.tracer = tracer or NULL_TRACER
        self.history = history if history is not None else []
        self.metrics_logger = metrics_logger
        self.ledger = ledger
        self.bank = bank
        self._pending: List[Dict[str, Any]] = []
        #: high-water mark of pending records (the pipelined loop's bounded
        #: backlog)
        self.max_pending = 0

    def __len__(self) -> int:
        return len(self._pending)

    def add(self, record: Dict[str, Any]) -> None:
        if self.ledger is None:
            record.pop("_ledger", None)
        if self.bank is None:
            record.pop("_bank", None)
        self._pending.append(record)
        self.max_pending = max(self.max_pending, len(self._pending))

    def flush(self, round_idx: Optional[int] = None) -> None:
        """One host transfer for every pending record, then commit."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        with self.tracer.span("metrics_fetch", round_idx,
                              records=len(pending)):
            slots = [(i, k) for i, rec in enumerate(pending)
                     for k, v in rec.items() if isinstance(v, torch.Tensor)]
            fetched = fetch_scalars([pending[i][k] for i, k in slots])
            for (i, k), v in zip(slots, fetched):
                pending[i][k] = v
            blocks = [rec[k] for rec in pending for k in ("_ledger", "_bank") if k in rec]
            if blocks:
                host = fetch_tree(blocks)
                for rec in pending:
                    for k in ("_ledger", "_bank"):
                        if k in rec:
                            rec[k] = host.pop(0)
        for rec in pending:
            ledger_blocks = rec.pop("_ledger", None)
            if ledger_blocks:
                with self.tracer.span("ledger_write", round_idx, blocks=len(ledger_blocks)):
                    for block in ledger_blocks:
                        self.ledger.apply(block)
            bank_blocks = rec.pop("_bank", None)
            if bank_blocks:
                with self.tracer.span("bank_write", round_idx, blocks=len(bank_blocks)):
                    for block in bank_blocks:
                        self.bank.apply(block)
            self.history.append(rec)
            if self.metrics_logger is not None:
                self.metrics_logger.log(
                    {k: v for k, v in rec.items() if k != "round"},
                    step=rec["round"])
            log.info("round %d: %s", rec["round"],
                     {k: v for k, v in rec.items() if k != "round"})
            self.tracer.event(
                "round_committed", round=rec["round"],
                **{k: rec[k] for k in _LEDGER_KEYS if k in rec})
