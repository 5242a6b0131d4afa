"""The multi-tenant scheduler: deterministic dispatch of several federated
jobs over one card (PyTorch form of ``fedml_tpu/serving/scheduler.py``).

``JobQueue`` holds tenant jobs in submission order; ``Scheduler`` owns
WHICH job steps next. Two policies, both seeded by nothing but submission
order, the tick count and the scheduler's ``seed`` (no wall clock, no
thread race), so a schedule repeats bit for bit:

- ``round_robin``: cycle submission order, skipping finished jobs.
- ``fair_share``: deficit round-robin. Every tick each active job accrues
  its ``weight``; the job with the largest deficit runs and pays the total
  active weight (ties break by a seeded blake2s hash of the job name). A
  weight-2 tenant gets 2 of every 3 ticks next to a weight-1 tenant.

Overload:

- **SLO tiers**: tenants declaring ``slo="latency"`` form a strictly prior
  tier: while one is active, throughput-bound tenants neither run nor
  accrue deficit. With no latency tenant the pick is the plain policy's.
- **Checkpointed preemption**: ``max_resident=N`` bounds how many tenants
  hold device memory at once. A picked non-resident tenant evicts a
  deterministic victim (throughput-bound residents first, latest
  submission first) through ``Job.evict()`` (snapshots spill to the mmap
  ``EvictionStore`` under ``spill_dir``) and resumes it bit for bit later.
  ``max_resident=None`` builds every tenant at submission.
- **Admission control**: ``admission="reject"`` bounces submissions past
  ``max_queued`` active tenants (a ``job_rejected`` event; ``submit``
  returns None); ``"shed"`` lets a latency-bound arrival cancel the
  youngest never-dispatched throughput-bound tenant instead; ``"queue"``
  (the default) admits all. ``cancel(name)`` removes a tenant: it leaves
  the active set with its deficit, and the others' schedule is unchanged.
- **SLO ledger**: tenants with ``deadline_s`` get deadline-miss counters
  (``slo_ledger``) and ``deadline_miss`` events, measured on the tracer's
  clock as telemetry only, never read by the pick. ``check_slo()`` gates
  the miss counts.
- **Warm pool**: tenants are fingerprinted by their program-shape config;
  a submission matching an earlier tenant's is flagged ``warm_start``.

Compile accounting: around every step (and build) the scheduler folds the
tracer's ``compile_cache`` events into a per-tenant ledger, and
``check_compile_budgets()`` holds each tenant's requests against its
drive's ``max_compiles`` in COMPILE_BUDGET.json. The port has no JIT and
emits no ``compile_cache`` events, so the ledger reads zeros on a tracer
that keeps events (None on the null tracer) and the report keeps its shape
(ROADMAP.md Queue 3).

One ``CohortPrefetcher`` is shared: it stages cohorts ahead for the jobs
that want it (``cfg.pipeline_depth > 0`` and round-pure staging), keyed by
``(job, round_idx)``, so one tenant's rollback, eviction or end never drops
another tenant's staged rounds (``data/prefetch.py``).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Union

from fedml_tpu_torch import telemetry
from fedml_tpu_torch.data.prefetch import CohortPrefetcher
from fedml_tpu_torch.serving.evict_store import EvictionStore
from fedml_tpu_torch.serving.job import Job, JobDescriptor

#: compile_cache event-name tails -> ledger keys (the JAX package forwards
#: its compiler's cache events under names ending in these segments)
_COMPILE_TAILS = {
    "compile_requests_use_cache": "requests",
    "cache_hits": "cache_hits",
    "cache_misses": "cache_misses",
}


def _zero_counts() -> Dict[str, int]:
    return {"requests": 0, "cache_hits": 0, "cache_misses": 0}


def load_compile_budgets(path: Optional[str] = None) -> dict:
    """COMPILE_BUDGET.json as a dict (drive -> budget entry)."""
    if path is None:
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        path = os.path.join(repo_root, "COMPILE_BUDGET.json")
    with open(path) as f:
        return json.load(f)


def _warm_signature(desc: JobDescriptor) -> str:
    """Program-shape fingerprint for the warm-start pool: everything that
    shapes this tenant's rounds, nothing that only shapes its data stream
    (seed) or its schedule (comm_round, weight, slo, deadline)."""
    cfg = desc.config.replace(seed=0, comm_round=1)
    return (f"{desc.aggregator_name}|{desc.partial_dispatch}|"
            f"{desc.trainer_factory is not None}|{cfg!r}")


class JobQueue:
    """Submission-ordered tenant jobs, addressable by unique name."""

    def __init__(self):
        self._jobs: List[Job] = []
        self._by_name: Dict[str, Job] = {}

    def submit(self, job: Job) -> Job:
        if job.name in self._by_name:
            raise ValueError(f"duplicate job name {job.name!r}")
        self._jobs.append(job)
        self._by_name[job.name] = job
        return job

    def get(self, name: str) -> Job:
        return self._by_name[name]

    def active(self) -> List[Job]:
        return [j for j in self._jobs if not j.closed]

    def all_done(self) -> bool:
        return all(j.closed for j in self._jobs)

    def cancel(self, name: str) -> bool:
        """Terminal removal with deterministic deficit-ledger cleanup: the
        job leaves the active set carrying its accrued deficit with it
        (deficits are per-job state, so nothing else changes), and its
        device refs / parked snapshot are dropped. Returns False when the
        job is already terminal."""
        job = self._by_name[name]
        if job.closed:
            return False
        job.cancel()
        return True

    def __iter__(self):
        return iter(self._jobs)

    def __len__(self) -> int:
        return len(self._jobs)

    def __getitem__(self, i: int) -> Job:
        return self._jobs[i]


class Scheduler:
    """Dispatch loop over a JobQueue. `tick()` steps exactly one job (the
    policy's pick) under its `telemetry.job_scope`; `run()` ticks until the
    queue drains. `prefetch_depth` bounds staged-ahead cohorts across ALL
    tenants (0 disables the shared prefetcher). See the module docstring
    for the graft-slo knobs (max_resident / admission / max_queued / seed /
    spill_dir)."""

    POLICIES = ("round_robin", "fair_share")
    ADMISSIONS = ("queue", "reject", "shed")

    def __init__(self, policy: str = "round_robin", tracer=None,
                 budgets: Optional[dict] = None, prefetch_depth: int = 4,
                 max_resident: Optional[int] = None,
                 admission: str = "queue",
                 max_queued: Optional[int] = None,
                 seed: int = 0,
                 spill_dir: Optional[str] = None):
        if policy not in self.POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; choose from {self.POLICIES}")
        if admission not in self.ADMISSIONS:
            raise ValueError(f"unknown admission policy {admission!r}; "
                             f"choose from {self.ADMISSIONS}")
        if max_resident is not None and max_resident < 1:
            raise ValueError(f"max_resident must be >= 1, got {max_resident}")
        self.policy = policy
        self.tracer = tracer if tracer is not None else telemetry.NULL_TRACER
        self.budgets = budgets
        self.queue = JobQueue()
        self.compile_ledger: Dict[str, Dict[str, int]] = {}
        self.ticks = 0
        self._rr_cursor = 0
        self._prefetch_depth = int(prefetch_depth)
        self._prefetcher: Optional[CohortPrefetcher] = None
        # graft-slo state
        self.max_resident = max_resident
        self.admission = admission
        self.max_queued = max_queued
        self.seed = int(seed)
        self.spill_store = EvictionStore(spill_dir) if spill_dir else None
        self.evictions = 0
        self.rejections = 0
        self.slo_ledger: Dict[str, Dict[str, object]] = {}
        self.warm_pool: Dict[str, str] = {}  # signature -> first tenant
        self._submit_seq = 0

    # ------------------------------------------------------------- submit
    def submit(self, job: Union[Job, JobDescriptor],
               submit_t: Optional[float] = None) -> Optional[Job]:
        """Enqueue a tenant, subject to the admission policy (a bounced
        submission emits `job_rejected` and returns None). With
        `max_resident` set, descriptor builds are deferred to first
        dispatch; otherwise a descriptor is built here, under the tenant's
        job scope, so what its construction emits carries its label."""
        desc = job.desc if isinstance(job, Job) else job
        if not self._admit(desc):
            return None
        if isinstance(job, JobDescriptor):
            sig = _warm_signature(job)
            warm = sig in self.warm_pool
            if not warm:
                self.warm_pool[sig] = job.name
            if self.max_resident is not None:
                # deferred build: admitted tenants cost no device memory
                # until the pick reaches them (_ensure_resident builds)
                job = Job(job, build=False)
                self.compile_ledger.setdefault(job.name, _zero_counts())
            else:
                before = self._compile_counts()
                with telemetry.job_scope(job.name):
                    job = job.build()
                self._account(job, before)
            job.warm_start = warm
        else:
            self.compile_ledger.setdefault(job.name, _zero_counts())
        job.submit_t = submit_t if submit_t is not None else self.tracer.now()
        job._submit_seq = self._submit_seq
        self._submit_seq += 1
        out = self.queue.submit(job)
        self.tracer.gauge("queue_depth", depth=len(self.queue.active()))
        return out

    def _admit(self, desc: JobDescriptor) -> bool:
        """Admission control: True admits. `queue` always admits; past
        `max_queued` active tenants, `reject` bounces the arrival and
        `shed` sacrifices the youngest never-dispatched throughput-bound
        tenant to a latency-bound arrival (bouncing the arrival when no
        such victim exists)."""
        if self.admission == "queue" or self.max_queued is None:
            return True
        depth = len(self.queue.active())
        if depth < self.max_queued:
            return True
        if self.admission == "shed" and desc.slo == "latency":
            victims = [j for j in self.queue.active()
                       if j.desc.slo == "throughput"
                       and j.dispatched_ticks == 0]
            if victims:
                self.cancel(victims[-1].name, reason="shed")
                return True
        self.rejections += 1
        self.tracer.event("job_rejected", job=desc.name, reason="queue_full",
                          slo=desc.slo)
        self.tracer.gauge("queue_depth", depth=depth, rejected=1)
        return False

    def cancel(self, name: str, reason: str = "cancelled") -> bool:
        """Cancel an admitted tenant (deterministic deficit cleanup — see
        JobQueue.cancel). Surfaced in the ledger as a `job_rejected` event
        with this reason."""
        job = self.queue.get(name)
        if not self.queue.cancel(name):
            return False
        self.tracer.event("job_rejected", job=name, reason=reason,
                          slo=job.desc.slo)
        if self._prefetcher is not None:
            self._prefetcher.invalidate(job=name)
        return True

    # ------------------------------------------------------------ policies
    def _tiebreak(self, job: Job) -> int:
        """Seeded, name-stable tiebreak key: reruns replay it exactly,
        and no wall clock or id() leaks in."""
        h = hashlib.blake2s(f"{self.seed}:{job.name}".encode(),
                            digest_size=8)
        return int.from_bytes(h.digest(), "big")

    def _pick(self) -> Optional[Job]:
        active = self.queue.active()
        if not active:
            return None
        # SLO tier: latency-bound tenants are strictly prior — while any
        # is active, throughput-bound tenants neither run nor accrue
        # deficit. Empty tier == the legacy pick, byte-identical.
        lat = [j for j in active if j.desc.slo == "latency"]
        pool = lat if lat else active
        if self.policy == "round_robin":
            n = len(self.queue)
            for _ in range(n):
                job = self.queue[self._rr_cursor % n]
                self._rr_cursor += 1
                if not job.closed and (not lat
                                       or job.desc.slo == "latency"):
                    return job
            return None
        # fair_share: deficit round-robin over the pick pool
        total = 0.0
        for job in pool:
            job.deficit += job.desc.weight
            total += job.desc.weight
        picked = pool[0]
        for job in pool[1:]:
            if job.deficit > picked.deficit or (
                    job.deficit == picked.deficit
                    and self._tiebreak(job) < self._tiebreak(picked)):
                picked = job
        picked.deficit -= total
        return picked

    # ------------------------------------------------- residency / eviction
    def _resident_jobs(self) -> List[Job]:
        return [j for j in self.queue if j.resident and not j.closed]

    def _evict_victim(self, exclude: Job) -> Optional[Job]:
        """Deterministic preemption victim: throughput-bound residents
        before latency-bound ones, latest submission first."""
        cands = [j for j in self._resident_jobs() if j is not exclude]
        if not cands:
            return None
        cands.sort(key=lambda j: (
            0 if j.desc.slo == "throughput" else 1, -j._submit_seq))
        return cands[0]

    def _evict(self, job: Job, reason: str = "preempted") -> None:
        if job.evict(self.tracer, reason=reason, store=self.spill_store):
            self.evictions += 1
            self.tracer.gauge("evicted_jobs", count=self.evictions,
                              job=job.name)
            if self._prefetcher is not None:
                self._prefetcher.invalidate(job=job.name)

    def _ensure_resident(self, job: Job) -> None:
        """Give the picked job a slot: evict deterministic victims while
        at `max_resident`, then materialize (first dispatch) or resume
        (evicted) under the tenant's job scope."""
        if job.resident:
            return
        if self.max_resident is not None:
            while len(self._resident_jobs()) >= self.max_resident:
                victim = self._evict_victim(exclude=job)
                if victim is None:
                    break  # nothing evictable: oversubscribe, don't stall
                self._evict(victim)
        before = self._compile_counts()
        with telemetry.job_scope(job.name):
            if job.state == "evicted":
                job.resume(self.tracer)
            else:
                job.materialize()
        self._account(job, before)

    # ---------------------------------------------------------------- tick
    def tick(self) -> Optional[str]:
        """Step the policy's pick one round (evicting / resuming around it
        as residency demands). Returns the stepped job's name, or None
        when every job has committed."""
        job = self._pick()
        if job is None:
            return None
        self.ticks += 1
        self._ensure_resident(job)
        job.dispatched_ticks += 1
        if job.start_t is None:
            job.start_t = self.tracer.now()
        before = self._compile_counts()
        with telemetry.job_scope(job.name):
            staged = self._take_prefetched(job)
            done = job.step(self.tracer, staged=staged)
        self._account(job, before)
        self.tracer.gauge("queue_depth", depth=len(self.queue.active()))
        if done:
            job.finish_t = self.tracer.now()
            wall = job.finish_t - (job.start_t or job.finish_t)
            self.tracer.event("job_committed", job=job.name,
                              rounds=job.round_idx, wall_s=round(wall, 6))
            self._ledger_deadline(job)
            if self._prefetcher is not None:
                self._prefetcher.invalidate(job=job.name)
        else:
            self._prefetch_ahead(job)
        return job.name

    def _ledger_deadline(self, job: Job) -> None:
        """Deadline bookkeeping at completion — measured telemetry from
        the tracer clock, never an input to `_pick`, so replays stay
        bit-identical under an injected deterministic clock."""
        ddl = job.desc.deadline_s
        if ddl is None or job.submit_t is None:
            return
        latency = job.finish_t - job.submit_t
        entry = self.slo_ledger.setdefault(
            job.name, {"slo": job.desc.slo, "deadline_s": ddl,
                       "latency_s": None, "misses": 0})
        entry["latency_s"] = round(latency, 6)
        if latency > ddl:
            entry["misses"] += 1
            self.tracer.event("deadline_miss", job=job.name, deadline_s=ddl,
                              latency_s=round(latency, 6))

    def run(self) -> int:
        """Tick until the queue drains; returns the tick count. Installs
        the tracer for the duration so module-level telemetry (chaos,
        prefetch gauges) lands in it."""
        install = hasattr(self.tracer, "find_events")
        if install:
            telemetry.install(self.tracer)
        try:
            while self.tick() is not None:
                pass
        finally:
            if install:
                telemetry.uninstall(self.tracer)
            self.close()
        return self.ticks

    def close(self) -> None:
        """Shut the dispatch plane down WITHOUT abandoning device state:
        any still-active resident tenant (an interrupted run) is evicted —
        its buffers snapshotted to host and freed — so a later scheduler
        can resume it; then the shared prefetcher drains."""
        for job in self.queue:
            if job.resident and not job.closed:
                self._evict(job, reason="close")
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None

    # ------------------------------------------------------- prefetch seam
    def _wants_prefetch(self, job: Job) -> bool:
        return (self._prefetch_depth > 0 and job.prefetchable
                and job.api.cfg.pipeline_depth > 0)

    def _ensure_prefetcher(self) -> CohortPrefetcher:
        if self._prefetcher is None:
            self._prefetcher = CohortPrefetcher(
                lambda r, jobname: self.queue.get(jobname).stage(r),
                depth=self._prefetch_depth)
        return self._prefetcher

    def _take_prefetched(self, job: Job):
        if not self._wants_prefetch(job):
            return None
        return self._ensure_prefetcher().get(job.round_idx, job=job.name)

    def _prefetch_ahead(self, job: Job) -> None:
        if not self._wants_prefetch(job):
            return
        pf = self._ensure_prefetcher()
        for k in range(job.api.cfg.pipeline_depth):
            r = job.round_idx + k
            if r >= job.desc.rounds:
                break
            pf.prefetch(r, job=job.name)

    # --------------------------------------------------- compile accounting
    def _compile_counts(self) -> Optional[Dict[str, int]]:
        """Fold the tracer's compile_cache event ledger into cumulative
        {requests, cache_hits, cache_misses}; None when the tracer keeps no
        event ledger (NullTracer). The port emits no such event (it has no
        JIT), so a tracer that keeps events reads zeros."""
        if not hasattr(self.tracer, "find_events"):
            return None
        totals = _zero_counts()
        for e in self.tracer.find_events("compile_cache"):
            key = _COMPILE_TAILS.get(str(e.get("name", "")).rsplit("/", 1)[-1])
            if key is not None:
                totals[key] += 1
        return totals

    def _account(self, job: Job, before: Optional[Dict[str, int]]) -> None:
        ledger = self.compile_ledger.setdefault(job.name, _zero_counts())
        if before is None:
            return
        after = self._compile_counts()
        for key in ledger:
            ledger[key] += after[key] - before[key]

    def check_compile_budgets(self, budgets: Optional[dict] = None):
        """Gate every tenant's compile requests against its drive's
        `max_compiles` ceiling in COMPILE_BUDGET.json. Returns
        (ok, report) — ok is False if ANY tenant exceeded its ceiling;
        tenants whose drive pins no ceiling are SKIP lines."""
        if budgets is None:
            budgets = self.budgets if self.budgets is not None \
                else load_compile_budgets()
        lines = []
        ok = True
        for job in self.queue:
            counts = self.compile_ledger.get(job.name, _zero_counts())
            drive = job.desc.drive
            ceiling = (budgets.get(drive) or {}).get("max_compiles")
            if ceiling is None:
                lines.append(f"SKIP tenant={job.name} drive={drive} "
                             f"requests={counts['requests']} "
                             f"(no ceiling pinned)")
                continue
            verdict = "OK" if counts["requests"] <= ceiling else "FAIL"
            if verdict == "FAIL":
                ok = False
            lines.append(
                f"{verdict} tenant={job.name} drive={drive} "
                f"requests={counts['requests']} <= max {ceiling} "
                f"(hits={counts['cache_hits']} "
                f"misses={counts['cache_misses']})")
        return ok, "\n".join(lines)

    def check_slo(self, miss_ceiling: int = 0):
        """Gate every deadline-armed tenant's miss count against
        `miss_ceiling`, mirroring check_compile_budgets' (ok, report)
        shape. Tenants without a pinned deadline are SKIP lines; cancelled
        tenants never count (they have no completion to miss)."""
        lines = []
        ok = True
        for job in self.queue:
            ddl = job.desc.deadline_s
            if ddl is None:
                lines.append(f"SKIP tenant={job.name} slo={job.desc.slo} "
                             f"(no deadline pinned)")
                continue
            entry = self.slo_ledger.get(
                job.name, {"misses": 0, "latency_s": None})
            verdict = "OK" if entry["misses"] <= miss_ceiling else "FAIL"
            if verdict == "FAIL":
                ok = False
            lines.append(
                f"{verdict} tenant={job.name} slo={job.desc.slo} "
                f"misses={entry['misses']} <= max {miss_ceiling} "
                f"(deadline_s={ddl} latency_s={entry['latency_s']})")
        return ok, "\n".join(lines)
