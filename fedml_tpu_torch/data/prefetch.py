"""Bounded cohort prefetch for the pipelined drive (PyTorch form of
``fedml_tpu/data/prefetch.py``).

Client sampling is a pure function of the round index, and so are the
chaos fault schedule and the cohort's geometry, so round t+1's cohort is
known while round t runs. ``CohortPrefetcher`` runs ONE staging thread
(stagings are serialised: ordering stays trivial and the host holds one
cohort in progress) and keeps at most ``depth`` staged or in-progress
cohorts. The staging callback does the gather, the faults and the copy to
the card (``engine.stage_to_device``: a pinned host buffer, a
``non_blocking`` copy on a side stream, an event recorded there); this
class owns only scheduling, the bound and rollback invalidation.

Contract (``tests/test_torch_drive.py``):
- staging is a pure function of ``round_idx``: a re-staged cohort holds the
  same bytes, so guard retries and misses stage on demand;
- a consumed cohort leaves the prefetcher;
- ``invalidate()`` (guard rollback) drops every in-flight staging, so a
  retried round never consumes a cohort staged before the rollback.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from fedml_tpu_torch import telemetry


@dataclass
class StagedCohort:
    """One round's inputs on the device, staged ahead of their round.

    ``x``/``y``/``counts`` (and ``participation`` when chaos is armed) are
    tensors on the run's device; ``faults`` is the round's host
    ``FaultEvents``; ``client_idx`` the sampled cohort. On the card the
    copies run on a side stream: ``ready`` is the event recorded there
    after them, and ``host`` holds their pinned sources until the copies
    are known to be done (``wait``, ``release``). Both are None on the
    CPU."""

    round_idx: int
    x: Any
    y: Any
    counts: Any
    participation: Any | None
    faults: Any | None
    client_idx: np.ndarray
    ready: Any | None = None
    host: tuple | None = None

    def device_tensors(self) -> list:
        return [t for t in (self.x, self.y, self.counts, self.participation)
                if t is not None]

    def wait(self) -> None:
        """Order the calling thread's current stream (the one that will read
        the cohort) after the staging copies, and tell the caching
        allocator that the cohort's memory is in use there, so it is not
        handed to a later staging while the round still reads it. A no-op
        on the CPU."""
        if self.ready is None:
            return
        stream = torch.cuda.current_stream(self.x.device)
        stream.wait_event(self.ready)
        for t in self.device_tensors():
            t.record_stream(stream)

    def release(self) -> None:
        """Drop the pinned sources once their copies are done."""
        if self.ready is not None:
            self.ready.synchronize()
        self.host = None


class CohortPrefetcher:
    """Depth-bounded background stager keyed by round index.

    `prefetch(r)` schedules staging of round r if there is room; `get(r)`
    returns round r's StagedCohort, staging it on demand on a miss (first
    round, guard retry after `invalidate()`, depth exhausted);
    `invalidate()` forgets every in-flight staging. `staged_rounds`,
    `consumed_rounds`, `misses` and `invalidations` expose the schedule.
    (The JAX prefetcher's `job=` keys serve its multi-tenant scheduler,
    which is not ported.)"""

    def __init__(self, stage_fn: Callable[[int], StagedCohort], depth: int = 2):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self._stage_fn = stage_fn
        self.depth = int(depth)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="cohort-prefetch")
        self._inflight: dict[int, Future] = {}
        self._lock = threading.Lock()
        self.staged_rounds: list[int] = []   # every staging that actually ran
        self.consumed_rounds: list[int] = []
        self.misses = 0
        self.invalidations = 0
        self._staged_at: dict[int, float] = {}  # round -> staging-done time

    def _submit(self, round_idx: int) -> Future:
        def work():
            # one worker: the appends are ordered
            self.staged_rounds.append(round_idx)
            staged = self._stage_fn(round_idx)
            # under the lock: the write must not resurrect a round that
            # invalidate() cleared meanwhile
            with self._lock:
                self._staged_at[round_idx] = time.monotonic()
            return staged

        return self._pool.submit(work)

    def prefetch(self, round_idx: int) -> bool:
        """Schedule round `round_idx` for background staging. False when it
        is already in flight or the pipeline is at depth."""
        with self._lock:
            if round_idx in self._inflight or len(self._inflight) >= self.depth:
                return False
            self._inflight[round_idx] = self._submit(round_idx)
            return True

    def get(self, round_idx: int) -> StagedCohort:
        """Round `round_idx`'s staged cohort; blocks until it is staged. The
        cohort leaves the prefetcher. A miss stages on demand (the same
        bytes: staging is pure)."""
        with self._lock:
            fut = self._inflight.pop(round_idx, None)
            miss = fut is None
            depth_in_flight = len(self._inflight)
            if miss:
                self.misses += 1
                fut = self._submit(round_idx)
        staged = fut.result()
        self.consumed_rounds.append(round_idx)
        # how deep the pipeline was when this round was consumed, and how
        # long its cohort sat staged (0 on a miss)
        with self._lock:
            done_at = self._staged_at.pop(round_idx, None)
        ahead_s = max(0.0, time.monotonic() - done_at) if done_at else 0.0
        telemetry.gauge("prefetch_occupancy", round=round_idx,
                        inflight=depth_in_flight, ahead_s=round(ahead_s, 6),
                        miss=miss)
        return staged

    def invalidate(self) -> None:
        """Drop every in-flight staging (guard rollback): the retried round
        re-stages from scratch. A staging that already ran is waited for
        and released, so its pinned sources outlive its copies."""
        with self._lock:
            dropped = list(self._inflight.values())
            self._inflight.clear()
            self._staged_at.clear()
        for fut in dropped:
            if not fut.cancel() and fut.exception() is None:
                fut.result().release()
        self.invalidations += 1
        telemetry.gauge("prefetch_invalidate", dropped=len(dropped))

    def close(self) -> None:
        self.invalidate()
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "CohortPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
