"""The port's multi-tenant serving plane (``fedml_tpu_torch/serving``)
against the JAX package's ``fedml_tpu/serving``: the same descriptors give
the same pick sequence, evictions, resumptions and rejections under the
fair-share policy with a residency bound and admission control (explicit
``submit_t``, so no wall clock decides); each tenant (sync with chaos and
the shared prefetcher, buffered with stragglers in partial dispatch,
personalized from a bank) equals its solo run bit for bit through eviction
and resumption, spilled or in memory; ``close()`` evicts jobs in flight;
the prefetcher is scoped by job; eviction composes with the guard's
rollback; admission ``reject`` and ``shed`` behave as the JAX package's;
the compile ledger reads zeros and the budget and SLO reports keep their
shape.

MNIST logistic regression on 8 homo clients capped at 48 rows (the
personalized tenant behind rank-4 LoRA)."""

import os

import numpy as np
import pytest
import torch

from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.robustness.chaos import FaultPlan as JaxPlan
from fedml_tpu.serving import JobDescriptor as JaxDescriptor
from fedml_tpu.serving import Scheduler as JaxScheduler
from fedml_tpu.telemetry.tracer import Tracer as JaxTracer
from fedml_tpu_torch import FedConfig
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.data.prefetch import CohortPrefetcher, StagedCohort
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.models import adapter_bank
from fedml_tpu_torch.models.lora import strip_lora_base
from fedml_tpu_torch.robustness.chaos import FaultPlan
from fedml_tpu_torch.robustness.guard import GuardVerdict, RoundGuard
from fedml_tpu_torch.serving import JobDescriptor, Scheduler, params_equal
from fedml_tpu_torch.telemetry import Tracer
from fedml_tpu_torch.utils.pytree import split_variables
from test_torch_fedavg import _capped

LEDGER_KINDS = ("job_evicted", "job_resumed", "job_committed", "job_rejected")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ds8():
    return _capped(load_dataset("mnist", client_num_in_total=8, partition_method="homo",
                                seed=0), PackedClients, 48, 256)


def _cfg_kw(**kw):
    return {**dict(dataset="mnist", model="lr", client_num_in_total=8,
                   client_num_per_round=4, batch_size=16, lr=0.1, comm_round=3, seed=0,
                   pipeline_depth=0), **kw}


def _desc(name, ds, chaos=None, partial=False, slo="throughput", weight=1.0, guard=None,
          bank=None, deadline_s=None, **kw):
    return JobDescriptor(name=name, config=FedConfig(**_cfg_kw(**kw)), dataset=ds,
                         chaos=chaos, partial_dispatch=partial, slo=slo, weight=weight,
                         guard=guard, bank=bank, deadline_s=deadline_s, device="cpu")


def _solo(desc):
    """The descriptor run alone: through ``FedAvgAPI.train``, or, in partial
    dispatch (which the drive loops do not run), as a lone Job stepped to
    its end."""
    if desc.partial_dispatch:
        job, tracer = desc.build(), Tracer()
        while not job.step(tracer):
            pass
        return job.api
    api = desc.build_api()
    api.train(chaos=desc.chaos, guard=desc.guard, bank=desc.bank)
    return api


def _events(tracer):
    return [(e["kind"], e.get("job"), e.get("round"), e.get("reason"))
            for e in tracer.find_events() if e["kind"] in LEDGER_KINDS]


def _drive(sched, submissions):
    """Submit ``submissions`` ((descriptor, tick to submit at)), ticking in
    between; returns the pick sequence."""
    order, pending = [], list(submissions)
    while True:
        while pending and pending[0][1] <= len(order):
            sched.submit(pending.pop(0)[0], submit_t=0.0)
        name = sched.tick()
        if name is None and not pending:
            break
        if name is not None:
            order.append(name)
    sched.close()
    return order


def test_schedule_matches_jax():
    """Three tenants (weights 1, 2 and a buffered one with stragglers)
    under fair share with two slots, a latency tenant arriving at tick 3,
    and a fifth submission bounced by ``reject`` at ``max_queued`` 4: the
    port's picks, evictions, resumptions, commits and rejections equal the
    JAX scheduler's."""
    tds = _capped(load_dataset("mnist", client_num_in_total=8, partition_method="homo",
                               seed=0), PackedClients, 48, 256)
    jds = _capped(jax_load_dataset("mnist", client_num_in_total=8, partition_method="homo",
                                   seed=0), JaxPacked, 48, 256)
    runs = {}
    for name, desc_cls, cfg_cls, plan_cls, sched_cls, tracer_cls, ds, extra in (
            ("jax", JaxDescriptor, JaxConfig, JaxPlan, JaxScheduler, JaxTracer, jds, {}),
            ("torch", JobDescriptor, FedConfig, FaultPlan, Scheduler, Tracer, tds,
             {"device": "cpu"})):
        def d(job, slo="throughput", weight=1.0, chaos=None, **kw):
            return desc_cls(name=job, config=cfg_cls(**_cfg_kw(**kw)), dataset=ds,
                            slo=slo, weight=weight, chaos=chaos, **extra)

        tracer = tracer_cls()
        sched = sched_cls(policy="fair_share", tracer=tracer, max_resident=2,
                          admission="reject", max_queued=4, seed=3)
        order = _drive(sched, [
            (d("a", comm_round=3), 0),
            (d("b", weight=2.0, seed=1, comm_round=4), 0),
            (d("c", seed=2, buffer_size=3, chaos=plan_cls(
                seed=1, straggler_rate=0.3, straggler_rounds=2)), 0),
            (d("lat", slo="latency", seed=3, comm_round=2), 3),
            (d("late", seed=4), 3)])
        runs[name] = (order, _events(tracer), sched.evictions, sched.rejections)
    assert runs["torch"] == runs["jax"]
    order, events, evictions, rejections = runs["torch"]
    assert evictions >= 1 and rejections == 1
    assert order[3:5] == ["lat", "lat"]


def _bank_for(root, ds, rows=8):
    """A fresh bank for the personalized tenant's adapter layout."""
    api = _desc("tmp", ds, lora_rank=4, personalize=True).build_api()
    return adapter_bank.create_bank(
        root, rows, split_variables(strip_lora_base(api.global_variables))[0])


def _tenants(ds, bank):
    return [
        _desc("sync", ds, chaos=FaultPlan(seed=2, drop_rate=0.25, nan_rate=0.2),
              pipeline_depth=2, comm_round=4),
        _desc("fedbuff", ds, chaos=FaultPlan(seed=1, straggler_rate=0.3,
                                              straggler_rounds=2),
              partial=True, buffer_size=3, staleness_alpha=0.5, seed=1),
        _desc("pfl", ds, bank=bank, lora_rank=4, personalize=True, seed=2,
              pipeline_depth=2),
    ]


def _bank_bytes(root):
    return {n: open(os.path.join(root, n), "rb").read() for n in sorted(os.listdir(root))}


@pytest.mark.parametrize("spill", [True, False], ids=["spilled", "in_memory"])
def test_each_tenant_equals_its_solo_run(ds8, tmp_path, spill):
    """A sync tenant (chaos; the shared prefetcher), a FedBuff tenant
    (stragglers, partial dispatch) and a personalized tenant from a bank,
    under fair share with ONE slot: every switch evicts and resumes. Each
    tenant's final parameters equal its solo run bit for bit, and the
    personalized tenant's bank files the solo run's."""
    solo_bank = _bank_for(str(tmp_path / "solo_bank"), ds8)
    solo = {d.name: _solo(d).global_variables for d in _tenants(ds8, solo_bank)}
    solo_bank.close()
    bank = _bank_for(str(tmp_path / "bank"), ds8)
    tracer = Tracer()
    sched = Scheduler(policy="fair_share", tracer=tracer, max_resident=1,
                      spill_dir=str(tmp_path / "spill") if spill else None)
    order = _drive(sched, [(d, 0) for d in _tenants(ds8, bank)])
    assert sched.evictions >= 3 and len(order) == 4 + 3 + 3
    assert len(tracer.find_events("job_resumed")) >= 2
    for name, gv in solo.items():
        job = sched.queue.get(name)
        assert job.done and params_equal(job.final_params(), gv), name
    bank.close()
    assert _bank_bytes(str(tmp_path / "bank")) == _bank_bytes(str(tmp_path / "solo_bank"))


def test_close_evicts_jobs_in_flight(ds8):
    """``close()`` parks the resident tenants of an interrupted run; a
    parked job resumes and finishes as its solo run."""
    tracer = Tracer()
    sched = Scheduler(tracer=tracer)
    sched.submit(_desc("t", ds8, comm_round=3), submit_t=0.0)
    sched.tick()
    sched.close()
    job = sched.queue.get("t")
    assert job.state == "evicted" and not job.resident
    evs = tracer.find_events("job_evicted")
    assert len(evs) == 1 and evs[0]["reason"] == "close"
    assert job.resume(tracer)
    while not job.step(tracer):
        pass
    assert params_equal(job.final_params(), _solo(_desc("t", ds8)).global_variables)


def _staged(round_idx):
    z = torch.zeros(1)
    return StagedCohort(round_idx, z, z, z, None, None, np.arange(1))


def test_prefetcher_is_scoped_by_job():
    """Two jobs' stagings of the same round are distinct entries; dropping
    one job's leaves the other's staged (no miss), and the stager runs each
    job's staging under its label."""
    calls = []

    def stage(round_idx, job=None):
        from fedml_tpu_torch.telemetry import current_job

        calls.append((job, round_idx, current_job()))
        return _staged(round_idx)

    with CohortPrefetcher(stage, depth=4) as pf:
        assert pf.prefetch(0, job="a") and pf.prefetch(0, job="b")
        assert not pf.prefetch(0, job="a")  # already in flight
        pf.invalidate(job="a")
        assert pf.get(0, job="b").round_idx == 0 and pf.misses == 0
        assert pf.get(0, job="a").round_idx == 0 and pf.misses == 1
    assert ("b", 0, "b") in calls and calls.count(("a", 0, "a")) == 2


class _RejectOnce(RoundGuard):
    """A RoundGuard that rejects round ``bad_round`` once."""

    def __init__(self, bad_round):
        super().__init__()
        self.bad_round, self.fired = bad_round, False

    def inspect(self, round_idx, loss, global_variables=None):
        if round_idx == self.bad_round and not self.fired:
            self.fired = True
            return GuardVerdict(False, "forced test rejection")
        return super().inspect(round_idx, loss, global_variables)


def test_eviction_composes_with_the_guards_rollback(ds8):
    """A guarded tenant whose round 1 is rejected once, evicted between
    every round by a second tenant, equals its guarded solo run (the
    guard's loss window travels with the snapshot)."""
    solo = _solo(_desc("g", ds8, guard=_RejectOnce(1), chaos=FaultPlan(seed=3,
                                                                        drop_rate=0.25)))
    tracer = Tracer()
    sched = Scheduler(tracer=tracer, max_resident=1)
    _drive(sched, [(_desc("g", ds8, guard=_RejectOnce(1),
                          chaos=FaultPlan(seed=3, drop_rate=0.25)), 0),
                   (_desc("other", ds8, seed=5), 0)])
    assert len(tracer.find_events("guard_rollback")) == 1
    assert sched.evictions >= 2
    job = sched.queue.get("g")
    assert params_equal(job.final_params(), solo.global_variables)
    assert job.history[1]["guard_retries"] == 1


def test_admission_reject_and_shed_match_jax():
    """Deferred builds (``max_resident``): ``reject`` bounces past
    ``max_queued``; ``shed`` cancels the youngest never-dispatched
    throughput tenant for a latency arrival and bounces a throughput one;
    ``cancel`` takes a tenant out. Returns, states and events equal the JAX
    scheduler's."""
    tds = load_dataset("mnist", client_num_in_total=8, partition_method="homo", seed=0)
    jds = jax_load_dataset("mnist", client_num_in_total=8, partition_method="homo", seed=0)
    runs = {}
    for name, desc_cls, cfg_cls, sched_cls, tracer_cls, ds, extra in (
            ("jax", JaxDescriptor, JaxConfig, JaxScheduler, JaxTracer, jds, {}),
            ("torch", JobDescriptor, FedConfig, Scheduler, Tracer, tds, {"device": "cpu"})):
        def d(job, slo="throughput"):
            return desc_cls(name=job, config=cfg_cls(**_cfg_kw()), dataset=ds, slo=slo,
                            **extra)

        out = []
        for admission in ("reject", "shed"):
            tracer = tracer_cls()
            sched = sched_cls(tracer=tracer, admission=admission, max_queued=2,
                              max_resident=1)
            got = [sched.submit(d(j, slo), submit_t=0.0) is not None
                   for j, slo in (("a", "throughput"), ("b", "throughput"),
                                  ("c", "throughput"), ("lat", "latency"))]
            cancelled = sched.cancel("a")
            out.append((got, cancelled, [(j.name, j.state) for j in sched.queue],
                        sched.rejections, _events(tracer)))
            sched.close()
        runs[name] = out
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][1][2][1] == ("b", "cancelled")  # shed for the latency tenant
    with pytest.raises(ValueError, match="unknown slo class"):
        _desc("x", tds, slo="fast")
    with pytest.raises(ValueError, match="unknown admission"):
        Scheduler(admission="maybe")


def test_compile_ledger_reads_zeros_and_reports_keep_their_shape(ds8):
    """The port emits no compile_cache event: every tenant's compile
    ledger is zeros (None-free on a tracer that keeps events) and the
    budget report passes in its usual shape; ``check_slo`` reports the
    deadline-armed tenant and skips the other."""
    tracer = Tracer()
    sched = Scheduler(tracer=tracer, max_resident=1)
    _drive(sched, [(_desc("a", ds8, comm_round=2, deadline_s=1e6), 0),
                   (_desc("b", ds8, buffer_size=2, comm_round=2), 0)])
    assert sched.compile_ledger == {n: {"requests": 0, "cache_hits": 0, "cache_misses": 0}
                                    for n in ("a", "b")}
    ok, report = sched.check_compile_budgets()
    assert ok and report.splitlines()[0].startswith("OK tenant=a drive=eager requests=0")
    ok, report = sched.check_slo()
    assert ok and report.splitlines() == [
        f"OK tenant=a slo=throughput misses=0 <= max 0 (deadline_s=1000000.0 "
        f"latency_s={sched.slo_ledger['a']['latency_s']})",
        "SKIP tenant=b slo=throughput (no deadline pinned)"]
    assert Scheduler()._compile_counts() is None
