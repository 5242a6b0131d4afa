"""The one round-record path of the eager and pipelined drive loops
(PyTorch form of ``fedml_tpu/telemetry/records.py``).

- ``add(record)`` parks a record whose values may still be 0-d tensors on
  the device (the pipelined loop's deferred train metrics);
- ``flush()`` fetches every pending tensor in ONE host transfer (stacked on
  the device, one ``.cpu()``, inside a ``metrics_fetch`` span), appends the
  records to ``history`` as Python scalars, mirrors them to the metrics
  logger, logs the round line and emits a ``round_committed`` event with
  the robustness counters.

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


class RoundRecordLog:
    """Owns pending round records from `add()` until `flush()` commits them
    to history, the metrics logger and the telemetry ledger. The client
    ledger (``_ledger`` blocks) and the adapter bank (``_bank`` blocks) are
    not ported: a record carrying either raises."""

    def __init__(self, tracer=None, history: Optional[List[Dict]] = None,
                 metrics_logger=None):
        self.tracer = tracer or NULL_TRACER
        self.history = history if history is not None else []
        self.metrics_logger = metrics_logger
        self._pending: List[Dict[str, Any]] = []
        #: high-water mark of pending records (the pipelined loop's bounded
        #: backlog)
        self.max_pending = 0

    def __len__(self) -> int:
        return len(self._pending)

    def add(self, record: Dict[str, Any]) -> None:
        for key in ("_ledger", "_bank"):
            if key in record:
                raise NotImplementedError(
                    f"{key} record blocks (the client ledger and the adapter "
                    f"bank) are not ported to fedml_tpu_torch yet")
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
        for rec in pending:
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
