"""Declarative federated jobs: a round as a schedulable unit (PyTorch form
of ``fedml_tpu/serving/job.py``).

The drive loops own the whole process: one job, one ``train()`` call to
its end. ``JobDescriptor`` lifts the inputs of such a run (model,
algorithm, FedConfig, client store, seed, round budget) into a value, and
``Job`` wraps the runtime so that ONE round is a ``step()`` the scheduler
can interleave with other tenants.

Bit-reproducibility: everything a round consumes is a pure function of
``(cfg.seed, round_idx)`` (sampling, staging, the round's generator, chaos
faults and straggler latencies), and each Job owns its ``FedAvgAPI``
(globals, aggregator state, rounds) and its round counter. Interleaving
tenants cannot perturb a tenant's stream: a job stepped under the
scheduler trains the same bits as the same job run alone through
``FedAvgAPI.train`` (``tests/test_torch_serving.py``).

Synchronous jobs run the eager loop's round (``FedAvgAPI._eager_round``,
guard retries included); buffered jobs (``cfg.buffer_size > 0``) run
``algorithms.buffered.BufferedRunner``, the classic buffered loop's step
and drain, optionally in ``partial_dispatch`` mode (each dispatch stages
only as many replacement clients as arrivals have freed,
``FedAvgAPI.stage_partial_cohort``).

Eviction: ``evict()`` moves the job's whole checkpoint surface to the host
(``_ckpt_tree`` and ``_ckpt_meta``, the buffered runner's buffer, birth
tags and pending arrivals through ``BufferedRunner`` and its host state,
the guard's loss window), then drops every reference to the card's memory
the tenant holds, so the card's allocated bytes fall: its slot is free.
``resume()`` rebuilds the API and the runner from the descriptor (the port
has no JIT to warm: a rebuild is Python objects and the tenant's tensors)
and restores the snapshot; an evicted and resumed tenant trains the same
bits as its uninterrupted solo run, for sync, buffered (straggler-armed)
and personalized tenants. Snapshots may spill to the mmap-backed
``serving.evict_store.EvictionStore``. Under LoRA the snapshot holds the
adapters only (``_ckpt_tree`` strips the frozen base, a pure function of
the seed), so eviction is O(adapter bytes).
"""

from __future__ import annotations

import gc
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from fedml_tpu_torch.algorithms.buffered import BufferedRunner, _sum_metrics
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.robustness.chaos import summarize as chaos_summary
from fedml_tpu_torch.telemetry.records import RoundRecordLog
from fedml_tpu_torch.utils.device import synchronize
from fedml_tpu_torch.utils.pytree import tree_leaves, tree_map

#: SLO classes a tenant may declare: latency-bound tenants form a strict
#: priority tier in the scheduler's pick and may preempt throughput-bound
#: residents via evict(); throughput-bound tenants absorb the slack.
SLO_CLASSES = ("throughput", "latency")


def _to_host(tree):
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


@dataclass(frozen=True)
class JobDescriptor:
    """Everything needed to (re)build one tenant's federated run.

    ``weight`` feeds the scheduler's deficit-weighted fair share;
    ``partial_dispatch`` opts a buffered job into replacement-client
    dispatch. ``trainer_factory`` defaults to the classification trainer
    over ``create_model(cfg.model, output_dim=dataset.class_num)``.
    ``device`` is where the tenant runs (``cuda`` unless the caller asks
    for the CPU).

    ``slo`` declares the tenant's class (``SLO_CLASSES``); ``deadline_s``
    arms the scheduler's deadline-miss ledger (completion - submission >
    deadline_s -> a ``deadline_miss`` event: measured telemetry, never an
    input of the pick); ``guard`` attaches a round guard, with the solo
    drive's rollback-and-retry semantics. ``bank`` (a
    ``models.adapter_bank.AdapterBank``) is required when
    ``config.personalize``: host state, owned by the caller and kept across
    evict and resume (eviction flushes it, never closes it), so a resumed
    tenant gathers exactly the rows its evicted self scattered."""

    name: str
    config: FedConfig
    dataset: Any  # data.registry.FederatedDataset (any backing store)
    aggregator_name: str = "fedavg"
    trainer_factory: Optional[Callable[[], Any]] = None
    chaos: Any = None  # robustness.chaos.FaultPlan
    weight: float = 1.0
    partial_dispatch: bool = False
    slo: str = "throughput"
    deadline_s: Optional[float] = None
    guard: Any = None  # robustness.guard.RoundGuard
    bank: Any = None
    device: str = "cuda"
    extra: dict = field(default_factory=dict, hash=False, compare=False)

    def __post_init__(self):
        if self.slo not in SLO_CLASSES:
            raise ValueError(
                f"unknown slo class {self.slo!r}; choose from {SLO_CLASSES}")

    @property
    def kind(self) -> str:
        return "buffered" if self.config.buffer_size > 0 else "sync"

    @property
    def codec(self) -> str:
        """This tenant's update codec ("none" without one): a per-tenant
        choice riding ``config.update_codec`` into the job's own API."""
        return self.config.update_codec or "none"

    @property
    def drive(self) -> str:
        """The drive this tenant's compile accounting is held against
        (``Scheduler.check_compile_budgets``)."""
        return "buffered" if self.config.buffer_size > 0 else "eager"

    @property
    def rounds(self) -> int:
        return int(self.config.comm_round)

    def build_trainer(self):
        """The tenant's trainer, through the LoRA seam
        (``models.lora.maybe_wrap_lora``): a descriptor with ``lora_rank``
        > 0 federates adapters however its trainer was made."""
        from fedml_tpu_torch.models.lora import maybe_wrap_lora

        if self.trainer_factory is not None:
            return maybe_wrap_lora(self.trainer_factory(), self.config)
        from fedml_tpu_torch.core.trainer import ClassificationTrainer
        from fedml_tpu_torch.models.registry import create_model

        module = create_model(self.config.model, output_dim=self.dataset.class_num,
                              dtype=self.config.dtype,
                              input_shape=self.dataset.train.x.shape[2:])
        return maybe_wrap_lora(ClassificationTrainer(module), self.config)

    def build_api(self) -> FedAvgAPI:
        """A fresh FedAvgAPI for this descriptor: the construction a solo
        ``train()`` run uses."""
        return FedAvgAPI(self.dataset, self.config, self.build_trainer(),
                         aggregator_name=self.aggregator_name, device=self.device)

    def build(self) -> "Job":
        return Job(self)


class Job:
    """One tenant's runtime: (queued ->) pending -> running -> committed,
    with evicted as a parked detour and cancelled as the other end.

    ``step(tracer)`` runs exactly one dispatch round (buffered jobs also
    drain after their last) and returns True once the job has consumed its
    round budget. The scheduler owns WHEN steps happen; the job owns WHAT a
    step does, independent of the interleaving.

    ``build=False`` defers ``desc.build_api()`` to ``materialize()``: an
    admission-controlled scheduler admits tenants without paying device
    memory for any that never reach the card."""

    def __init__(self, desc: JobDescriptor, build: bool = True):
        self.desc = desc
        self.name = desc.name
        self.api: Optional[FedAvgAPI] = None
        self.runner: Optional[BufferedRunner] = None
        self.records: Optional[RoundRecordLog] = None
        self.round_idx = 0
        self.state = "queued"
        # eviction snapshot (a host tree, or an EvictionStore holding it)
        self._snapshot = None
        self._spill_store = None
        # scheduler bookkeeping (deficit-weighted fair share, timing)
        self.deficit = 0.0
        self.dispatched_ticks = 0
        self.submit_t: Optional[float] = None
        self.start_t: Optional[float] = None
        self.finish_t: Optional[float] = None
        self._submit_seq = 0  # scheduler-stamped submission index
        self.warm_start = False  # a tenant of the same program shape ran before
        # one-shot handoff of a cohort from the scheduler's shared
        # prefetcher into the API's stage seam (sync jobs)
        self._staged_override = None
        if build:
            self.materialize()

    def materialize(self) -> None:
        """Build (or rebuild, on resume) the device-facing runtime: the
        FedAvgAPI, the buffered runner and the stage-override seam.
        Idempotent while an API is live."""
        if self.api is not None:
            return
        self.api = self.desc.build_api()
        if self.desc.bank is not None:
            # the drive loops attach through train(bank=...); a served job
            # steps the eager round directly, so the seam is here
            self.api.bank = self.desc.bank
        if self.desc.kind == "buffered":
            self.runner = BufferedRunner(self.api, chaos=self.desc.chaos,
                                         partial_dispatch=self.desc.partial_dispatch)
        self._orig_stage_fn = self.api.stage_fn
        self.api.stage_fn = self._stage_or_override
        if self.state == "queued":
            self.state = "pending"

    # ------------------------------------------------------------- plumbing
    @property
    def done(self) -> bool:
        return self.state == "committed"

    @property
    def closed(self) -> bool:
        """Terminal either way: committed or cancelled."""
        return self.state in ("committed", "cancelled")

    @property
    def resident(self) -> bool:
        """Whether this job holds memory on its device (a slot)."""
        return self.api is not None

    @property
    def history(self):
        return self.api.history

    @property
    def prefetchable(self) -> bool:
        """Whether this job's cohorts can be staged ahead by round index:
        staging must be pure in the round, which partial dispatch is not
        (its width depends on the capacity in flight)."""
        return not (self.desc.kind == "buffered" and self.desc.partial_dispatch)

    def _stage_or_override(self, round_idx, **kw):
        staged = self._staged_override
        if staged is not None and staged.round_idx == round_idx:
            self._staged_override = None
            return staged
        return self._orig_stage_fn(round_idx, **kw)

    def stage(self, round_idx: int):
        """Stage one cohort of this job: the shared prefetcher's staging
        callback (pure in the round; chaos faults drawn per round)."""
        return self._orig_stage_fn(round_idx, chaos=self.desc.chaos)

    # ------------------------------------------------------ evict / resume
    def evict(self, tracer, reason: str = "preempted", store=None) -> bool:
        """Checkpointed preemption: move the job's whole state surface to
        the host, drop every reference to device memory (the card's
        allocated bytes fall), park the snapshot (spilled into ``store``,
        an EvictionStore, when given). Called at step boundaries only,
        where the record log is flushed and no staged cohort is in flight.
        Returns False when there is nothing resident to evict."""
        if self.api is None or self.closed:
            return False
        if self.records is not None:
            self.records.flush(self.round_idx)
        if self.desc.bank is not None:
            # after the flush above scattered any pending _bank blocks: the
            # parked tenant's rows are on disk before its slot frees
            self.desc.bank.flush()
        api = self.api
        synchronize(api.device)
        buf = host_snap = None
        in_flight = 0
        if self.runner is not None:
            if api._buffer is not None:
                buf = _to_host(api._buffer)
            host_snap = _to_host(self.runner.host.snapshot())
            in_flight = self.runner.in_flight
        guard = self.desc.guard
        snap = {
            "tree": _to_host(api._ckpt_tree()),
            "meta": api._ckpt_meta(),
            "buffer": buf,
            "host": host_snap,
            "in_flight": in_flight,
            "round_idx": self.round_idx,
            "state": self.state,
            "guard_losses": list(guard._losses) if guard is not None else None,
        }
        if store is not None:
            store.save(self.name, snap)
            self._snapshot = None
            self._spill_store = store
        else:
            self._snapshot = snap
            self._spill_store = None
        # free the slot: every reference to device memory goes
        self._drop_runtime()
        self.state = "evicted"
        tracer.event("job_evicted", job=self.name, round=self.round_idx, reason=reason)
        return True

    def _drop_runtime(self) -> None:
        device = self.api.device if self.api is not None else None
        self.api = None
        self.runner = None
        self.records = None
        self._staged_override = None
        self._orig_stage_fn = None
        # the API, its rounds and staged cohorts reference each other: free
        # them now, not at the next collection
        gc.collect()
        if device is not None and device.type == "cuda":
            torch.cuda.empty_cache()

    def resume(self, tracer) -> bool:
        """Rebuild the runtime from the descriptor and restore the parked
        snapshot: the resumed run continues the evicted one bit for bit."""
        if self.state != "evicted":
            return False
        snap = (self._spill_store.load(self.name)
                if self._spill_store is not None else self._snapshot)
        self._snapshot = None
        self._spill_store = None
        self.materialize()
        api = self.api
        tree = _on_device(snap["tree"], api.device)
        api._ckpt_load(tree, snap["meta"])
        if self.runner is not None:
            if snap["buffer"] is not None:
                api._buffer = _on_device(snap["buffer"], api.device)
            self.runner.host.restore(_on_device(snap["host"], api.device))
            self.runner.in_flight = snap["in_flight"]
        guard = self.desc.guard
        if guard is not None and snap["guard_losses"] is not None:
            guard._losses.clear()
            guard._losses.extend(snap["guard_losses"])
        self.round_idx = snap["round_idx"]
        self.state = snap["state"]
        if self.state == "running":
            # _ckpt_load restored the history into api.history in place;
            # the new record log binds to that list
            self.records = RoundRecordLog(tracer, api.history, None, bank=self.desc.bank)
        tracer.event("job_resumed", job=self.name, round=self.round_idx)
        return True

    def cancel(self) -> None:
        """Terminal removal (admission shed, a caller's cancel): device
        references and any parked snapshot go; the job never runs again."""
        if self.api is not None:
            self._drop_runtime()
        self._snapshot = None
        self._spill_store = None
        self.state = "cancelled"

    # ----------------------------------------------------------------- step
    def step(self, tracer, staged=None) -> bool:
        """One schedulable unit of this job. ``staged`` (optional) is a
        prefetched cohort of ``self.round_idx``. Returns True when the job
        has just finished (drain included)."""
        if self.closed:
            return True
        if self.api is None:
            self.materialize()
        if self.state == "pending":
            self.state = "running"
            self.records = RoundRecordLog(tracer, self.api.history, None,
                                          bank=self.desc.bank)
        if self.desc.kind == "sync":
            self._step_sync(tracer, staged)
        else:
            self._step_buffered(tracer, staged)
        if self.round_idx >= self.desc.rounds:
            self.state = "committed"
        return self.done

    def _step_sync(self, tracer, staged) -> None:
        """One sync round, guard retries included, through the eager loop's
        own ``FedAvgAPI._eager_round``: a prefetched cohort reaches it
        through the stage seam (``_stage_or_override``), consumed by the
        first attempt, so a guard retry stages its cohort again, as a solo
        run does."""
        self._staged_override = staged
        self.round_idx = self.api._eager_round(
            self.round_idx, self.records, chaos=self.desc.chaos, guard=self.desc.guard,
            tracer=tracer, ckpt_dir=None, ckpt_every=1)

    def _step_buffered(self, tracer, staged) -> None:
        """One buffered dispatch round, guard retries included, as
        ``train_buffered`` runs it (the runner's snapshot and restore over
        globals, buffer and arrival schedule, a salted generator, restaging
        on retry)."""
        api = self.api
        cfg = api.cfg
        runner = self.runner
        host = runner.host
        guard = self.desc.guard
        r = self.round_idx
        retries = 0
        while True:
            with tracer.round(r) as rspan:
                if staged is None:
                    staged = self._stage_buffered(r, tracer)
                snapshot = runner.snapshot() if guard is not None else None
                out = runner.step(r, staged, runner.base_rng(r, retries), tracer, retries)
                train_metrics: dict = {}
                if out["commit_metrics"]:
                    with tracer.span("metrics_fetch", r):
                        train_metrics = _sum_metrics(out["commit_metrics"])
                if guard is not None and out["commit_metrics"]:
                    total = max(train_metrics.get("total", 1.0), 1.0)
                    loss = train_metrics.get("loss_sum", 0.0) / total
                    with tracer.span("guard_verdict", r):
                        verdict = guard.inspect(r, loss, api.global_variables)
                    tracer.event("guard_verdict", round=r, ok=verdict.ok,
                                 reason=verdict.reason)
                    if not verdict.ok and retries < guard.max_retries:
                        retries += 1
                        tracer.event("guard_rollback", round=r, retry=retries)
                        runner.restore(snapshot)
                        staged = None  # restage against the restored timeline
                        continue
                    if not verdict.ok:
                        tracer.event("guard_exhausted", round=r)
                record = {"round": r, "round_time": rspan.elapsed(),
                          "buffer_commits": out["n_commits"],
                          "committed_updates": host.committed_updates,
                          "buffer_fill": host.fill, "_ledger": out["ledger_blocks"]}
                for key in ("loss_sum", "total", "participated_count",
                            "quarantined_count", "staleness_sum", "staleness_max"):
                    if key in train_metrics:
                        record[key] = train_metrics[key]
                if staged is not None and staged.faults is not None:
                    record.update(chaos_summary(staged.faults))
                if guard is not None and retries:
                    record["guard_retries"] = retries
                if api._is_test_round(r):
                    with tracer.span("eval", r):
                        record.update(api.local_test_on_all_clients(r))
                        record.update(api.test_global(r))
                self.records.add(record)
                self.records.flush(r)
            break
        self.round_idx += 1
        if self.round_idx >= cfg.comm_round:
            self._drain_buffered(tracer)

    def _stage_buffered(self, round_idx: int, tracer):
        """This dispatch round's cohort: the whole seeded sample in classic
        mode, the freed-capacity prefix (padded to the cohort's width) in
        partial mode, or None when nothing is free (the round only
        processes arrivals)."""
        api = self.api
        cohort = min(api.cfg.client_num_per_round, api.dataset.client_num)
        width = self.runner.capacity(cohort)
        if width <= 0:
            return None
        if width >= cohort:
            return api.stage_fn(round_idx, chaos=self.desc.chaos, tracer=tracer)
        return api.stage_partial_cohort(round_idx, width, cohort, chaos=self.desc.chaos,
                                        tracer=tracer)

    def _drain_buffered(self, tracer) -> None:
        out = self.runner.drain(tracer)
        if not out["n_commits"]:
            return
        host = self.runner.host
        cfg = self.api.cfg
        record = {"round": cfg.comm_round, "round_time": 0.0,
                  "buffer_commits": out["n_commits"],
                  "committed_updates": host.committed_updates,
                  "buffer_fill": host.fill, "_ledger": out["ledger_blocks"]}
        with tracer.span("metrics_fetch", out["drain_round"]):
            record.update(_sum_metrics(out["commit_metrics"]))
        self.records.add(record)
        self.records.flush(cfg.comm_round)

    def final_params(self) -> dict:
        """Host copy of the final globals (bitwise-comparable)."""
        return _to_host(self.api.global_variables)

    def __repr__(self) -> str:  # pragma: no cover - debug nicety
        return (f"Job({self.name!r}, kind={self.desc.kind}, "
                f"round={self.round_idx}/{self.desc.rounds}, state={self.state})")


def _on_device(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def params_equal(a, b) -> bool:
    """Bitwise equality of two variable trees (same keys, same bits)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False
    return all(torch.equal(torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu())
               for (_, x), (_, y) in zip(la, lb))
