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

The serving scheduler (``serving/scheduler.py``) shares one prefetcher
across tenant jobs: stagings are keyed by ``(job, round_idx)``, and
``invalidate(job=X)`` drops only X's.
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
    CPU. ``personal`` (None unless the run personalizes) is ``{"rows": host
    bank row ids, "tree": {key: [C, ...] tensor on the device}}``, the
    cohort's personal adapter rows, gathered when the drive takes the
    cohort to dispatch (after the previous rounds' bank writes), so the
    scatter back targets exactly the rows that were fed."""

    round_idx: int
    x: Any
    y: Any
    counts: Any
    participation: Any | None
    faults: Any | None
    client_idx: np.ndarray
    ready: Any | None = None
    host: tuple | None = None
    personal: Any | None = None

    def host_counts(self):
        """The counts on the host: their pinned source on the card, the
        tensor itself on the CPU (where ``host`` is None)."""
        return self.counts if self.host is None else self.host[2]

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


#: invalidate()'s default scope: every job's in-flight stagings
_ALL_JOBS = object()


class CohortPrefetcher:
    """Depth-bounded background stager keyed by (job, round index).

    `prefetch(r)` schedules staging of round r if there is room; `get(r)`
    returns round r's StagedCohort, staging it on demand on a miss (first
    round, guard retry after `invalidate()`, depth exhausted);
    `invalidate()` forgets every in-flight staging. `staged_rounds`,
    `consumed_rounds`, `misses` and `invalidations` expose the schedule.

    Multi-tenant scope (`job=` on prefetch, get and invalidate): the
    serving scheduler shares ONE prefetcher across its tenants, so
    stagings are keyed by `(job, round_idx)` and `invalidate(job=X)` drops
    only X's: one tenant's rollback or eviction never drops another's
    staged rounds. `job=None` everywhere (the single-job drive loops) is
    the single-job behaviour, `invalidate()` dropping all. With a job the
    staging callback is called as `stage_fn(round_idx, job)`, under
    `telemetry.job_scope(job)`, so the stager thread's spans carry the
    tenant's label."""

    def __init__(self, stage_fn: Callable[..., StagedCohort], depth: int = 2):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self._stage_fn = stage_fn
        self.depth = int(depth)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="cohort-prefetch")
        # (job, round_idx) -> Future; job is None for single-job drives
        self._inflight: dict[tuple, Future] = {}
        self._lock = threading.Lock()
        self.staged_rounds: list[int] = []   # every staging that actually ran
        self.consumed_rounds: list[int] = []
        self.misses = 0
        self.invalidations = 0
        self._staged_at: dict[tuple, float] = {}  # key -> staging-done time

    def _submit(self, round_idx: int, job=None) -> Future:
        def work():
            # one worker: the appends are ordered
            self.staged_rounds.append(round_idx)
            if job is None:
                staged = self._stage_fn(round_idx)
            else:
                with telemetry.job_scope(job):
                    staged = self._stage_fn(round_idx, job)
            # under the lock: the write must not resurrect a round that
            # invalidate() cleared meanwhile
            with self._lock:
                self._staged_at[(job, round_idx)] = time.monotonic()
            return staged

        return self._pool.submit(work)

    def prefetch(self, round_idx: int, job=None) -> bool:
        """Schedule round `round_idx` (of `job`, when serving) for
        background staging. False when it is already in flight or the
        pipeline is at depth."""
        key = (job, round_idx)
        with self._lock:
            if key in self._inflight or len(self._inflight) >= self.depth:
                return False
            self._inflight[key] = self._submit(round_idx, job)
            return True

    def get(self, round_idx: int, job=None) -> StagedCohort:
        """Round `round_idx`'s staged cohort; blocks until it is staged. The
        cohort leaves the prefetcher. A miss stages on demand (the same
        bytes: staging is pure)."""
        key = (job, round_idx)
        with self._lock:
            fut = self._inflight.pop(key, None)
            miss = fut is None
            depth_in_flight = len(self._inflight)
            if miss:
                self.misses += 1
                fut = self._submit(round_idx, job)
        staged = fut.result()
        self.consumed_rounds.append(round_idx)
        # how deep the pipeline was when this round was consumed, and how
        # long its cohort sat staged (0 on a miss)
        with self._lock:
            done_at = self._staged_at.pop(key, None)
        ahead_s = max(0.0, time.monotonic() - done_at) if done_at else 0.0
        telemetry.gauge("prefetch_occupancy", round=round_idx,
                        inflight=depth_in_flight, ahead_s=round(ahead_s, 6),
                        miss=miss)
        return staged

    def invalidate(self, job=_ALL_JOBS) -> None:
        """Drop in-flight stagings (guard rollback, eviction): the retried
        round re-stages from scratch. The default scope is every job;
        `invalidate(job=X)` drops only job X's. A staging that already ran
        is waited for and released, so its pinned sources outlive its
        copies."""
        with self._lock:
            keys = [k for k in self._inflight if job is _ALL_JOBS or k[0] == job]
            dropped = [self._inflight.pop(k) for k in keys]
            for k in keys:
                self._staged_at.pop(k, None)
            if job is _ALL_JOBS:
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
