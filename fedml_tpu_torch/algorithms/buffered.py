"""Staleness-aware buffered asynchronous aggregation (FedBuff), the drive
loop without a global round barrier (PyTorch form of
``fedml_tpu/algorithms/buffered.py``).

Client updates are admitted into a K-row buffer on the device the moment
they arrive, tagged with their birth round, and committed into the globals
(and a server optimizer's moments) only when K updates have accumulated: a
slow client delays nobody, and its update lands late, discounted by
``weight * (1 + staleness) ** -alpha`` (``aggregators
.make_staleness_discount``).

The arrival schedule is a pure function of the seed. At dispatch round t
the whole cohort's updates are computed against the globals as of dispatch
(the round's client step, no aggregation); each client arrives at round
t + latency, the latency drawn from the seeded straggler plan
(``robustness.chaos.FaultPlan.latencies``). Arrivals are processed in
(arrival, birth, slot) order, so the sequence of admits and commits, and
the final model, repeat bit for bit. The degenerate buffer (size = cohort,
alpha 0, no stragglers) admits each round's cohort in slot order and
commits once a round with zero staleness: the synchronous round's
aggregation, bit for bit.

The guard's snapshot holds the globals, the aggregator state, a clone of
the buffer (admits write it in place) and the host-side schedule, so a
rollback rewinds the whole asynchronous timeline; the retried round runs
with a salted generator, as in the synchronous loops.

Random streams: the client step draws from the round's generator
(``fedavg.round_generator(seed, round, salt)``) exactly as the synchronous
round does, and the round's first commit continues that generator (a
synchronous round's aggregator draws after its clients); the round's
later commits get generators of their own, seeded from (seed, round,
salt, commit). Only the robust rule draws.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from fedml_tpu_torch import telemetry
from fedml_tpu_torch.algorithms.aggregators import (build_buffer_admit,
                                                    build_buffer_commit,
                                                    init_buffer,
                                                    make_staleness_discount)
from fedml_tpu_torch.algorithms.engine import _batched_update, cohort_stats
from fedml_tpu_torch.data.prefetch import CohortPrefetcher
from fedml_tpu_torch.models.lora import strip_lora_base
from fedml_tpu_torch.robustness.chaos import summarize as chaos_summary
from fedml_tpu_torch.telemetry.records import RoundRecordLog, fetch_scalars
from fedml_tpu_torch.utils.pytree import tree_map

log = logging.getLogger(__name__)


def build_client_step_fn(trainer, cfg):
    """client_step(global_variables, x, y, counts, rng, host_counts, stats)
    -> (stacked LocalResult, ledger stats rows or None): the synchronous
    round's client loop without the aggregation, drawing the clients'
    streams from ``rng`` as the round does, so a buffered and a synchronous
    run at the same generator train the same client updates bit for bit.
    The stats rows (``engine.cohort_stats``) are computed when ``stats``;
    they only read the results."""
    batched = _batched_update(trainer, cfg)

    def client_step(global_variables, x, y, counts, rng, host_counts=None, stats=True):
        result = batched(global_variables, x, y, counts, rng, None, None, host_counts)
        return result, (cohort_stats(strip_lora_base(global_variables), result)
                        if stats else None)

    return client_step


def commit_generator(seed: int, round_idx: int, salt: int, seq: int) -> torch.Generator:
    """The generator of a round's commit number ``seq`` > 0."""
    state = np.random.SeedSequence([seed, round_idx, salt, seq]).generate_state(
        1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & (2 ** 63 - 1))


class _HostState:
    """The host-side mirror of the asynchronous schedule: everything the
    guard's snapshot must hold beside the device tensors."""

    def __init__(self):
        # birth -> {"vars", "steps", "metrics", "counts", "client_idx",
        # "remaining"}: a cohort's stacked results, held until every
        # arriving row is admitted (only read, never written)
        self.pending: Dict[int, Dict[str, Any]] = {}
        # arrival round -> [(birth, slot), ...]
        self.arrivals: Dict[int, List[Tuple[int, int]]] = {}
        self.fill = 0  # rows of the buffer in use
        self.births: List[int] = []  # birth round of each filled row
        self.row_clients: List[int] = []  # global client id of each row
        self.commits = 0
        self.committed_updates = 0

    def snapshot(self):
        return ({b: dict(d) for b, d in self.pending.items()},
                {r: list(v) for r, v in self.arrivals.items()},
                self.fill, list(self.births), self.commits,
                self.committed_updates, list(self.row_clients))

    def restore(self, snap) -> None:
        (pending, arrivals, fill, births, commits, committed, row_clients) = snap
        self.pending = {b: dict(d) for b, d in pending.items()}
        self.arrivals = {r: list(v) for r, v in arrivals.items()}
        self.fill = fill
        self.births = list(births)
        self.commits = commits
        self.committed_updates = committed
        self.row_clients = list(row_clients)


class BufferedRunner:
    """One buffered job's admit and commit machinery as a schedulable unit:
    the device buffer, the host-side arrival schedule (``_HostState``) and
    the client step, admit and commit, exposing one dispatch round as
    ``step()`` and the end of the drive as ``drain()``. ``train_buffered``
    drives it; a scheduler of several jobs would drive the same class.

    ``partial_dispatch=True``: a dispatch round stages only as many
    replacement clients as arrivals have freed (``capacity()`` = cohort -
    in flight), as a prefix of the round's seeded sample padded back to the
    cohort's width (``FedAvgAPI.stage_partial_cohort``); a round with no
    capacity passes ``staged=None`` to ``step()``, which then only
    processes arrivals. With no stragglers the capacity is always the full
    cohort, and partial dispatch is full dispatch bit for bit."""

    def __init__(self, api, chaos=None, discount_fn=None,
                 partial_dispatch: bool = False):
        cfg = api.cfg
        k = int(cfg.buffer_size)
        if k < 1:
            raise ValueError(f"buffer_size must be >= 1 in buffered mode, got {k}")
        if discount_fn is None:
            discount_fn = make_staleness_discount(cfg.staleness_alpha)
        self.api = api
        self.cfg = cfg
        self.k = k
        self.chaos = chaos
        self.partial_dispatch = bool(partial_dispatch)
        self.codec = getattr(api, "codec", None)
        self.admit_fn = build_buffer_admit(codec=self.codec)
        self.commit_fn = build_buffer_commit(api.aggregator, discount_fn)
        self.client_step = build_client_step_fn(api.trainer, cfg)
        self.host = _HostState()
        # dispatched updates not yet admitted: partial dispatch's capacity
        self.in_flight = 0
        api._buffer = None  # the device buffer, made at the first dispatch
        api._buffer_host = self.host

    def base_rng(self, round_idx: int, salt: int = 0) -> torch.Generator:
        from fedml_tpu_torch.algorithms.fedavg import round_generator

        return round_generator(self.cfg.seed, round_idx, salt)

    def capacity(self, cohort: int) -> int:
        """How many replacement clients the next dispatch round may stage:
        the cohort in full dispatch, cohort - in flight in partial."""
        if not self.partial_dispatch:
            return cohort
        return max(0, cohort - self.in_flight)

    def snapshot(self):
        """The guard's pre-round state, cloned where admits and rounds
        write in place (the globals, the state and the buffer)."""
        buf = (tree_map(torch.clone, self.api._buffer)
               if self.api._buffer is not None else None)
        return (*self.api._snapshot(), buf, self.host.snapshot(), self.in_flight)

    def restore(self, snap) -> None:
        tree, meta, buf, host_snap, in_flight = snap
        self.api._ckpt_load(tree, meta)
        self.api._buffer = buf
        self.host.restore(host_snap)
        self.in_flight = in_flight

    def _do_commit(self, commit_round: int, rng, commit_metrics,
                   ledger_blocks, tracer) -> None:
        """One buffer commit; appends its metrics (0-d device tensors)."""
        api, host = self.api, self.host
        with tracer.span("commit", commit_round):
            api.global_variables, api.agg_state, m = self.commit_fn(
                api.global_variables, api.agg_state, api._buffer, host.fill,
                host.births, commit_round, rng)
        staleness = [commit_round - b for b in host.births]
        p50 = float(np.median(staleness)) if staleness else 0.0
        smax = max(staleness) if staleness else 0
        tracer.event("buffer_committed", round=commit_round, size=host.fill,
                     staleness_p50=p50, staleness_max=int(smax))
        telemetry.gauge("staleness", round=commit_round, p50=p50, max=int(smax))
        # per-client staleness for the client ledger (the record log drops
        # it when none is attached)
        ledger_blocks.append({"round": commit_round,
                              "client_idx": np.asarray(host.row_clients, np.int64),
                              "staleness": np.asarray(staleness, np.int32)})
        host.committed_updates += host.fill
        host.commits += 1
        host.fill = 0
        host.births = []
        host.row_clients = []
        commit_metrics.append(m)

    def process_arrivals(self, now: int, rng_round, commit_metrics,
                         ledger_blocks, tracer, salt: int = 0) -> int:
        """Admit round ``now``'s due arrivals in (birth, slot) order and
        commit every time the buffer fills. Returns the commits made."""
        api, host = self.api, self.host
        due = sorted(host.arrivals.pop(now, []))
        n_commits = 0
        for birth, slot in due:
            src = host.pending[birth]
            with tracer.span("admit", now):
                # a codec's admit decodes the row's delta against the
                # current globals, the reference the commit applies it to;
                # stripped: under LoRA the rows are adapters only
                api._buffer = self.admit_fn(
                    api._buffer, src["vars"], src["steps"], src["metrics"],
                    src["counts"], slot, host.fill,
                    strip_lora_base(api.global_variables)
                    if self.codec is not None else None)
            host.fill += 1
            self.in_flight -= 1
            host.births.append(birth)
            host.row_clients.append(int(src["client_idx"][slot]))
            tracer.event("update_admitted", round=now, birth=birth, fill=host.fill)
            src["remaining"] -= 1
            if src["remaining"] == 0:
                del host.pending[birth]
            if host.fill == self.k:
                rng = (rng_round if n_commits == 0 else
                       commit_generator(self.cfg.seed, now, salt, n_commits))
                self._do_commit(now, rng, commit_metrics, ledger_blocks, tracer)
                n_commits += 1
        return n_commits

    def step(self, round_idx: int, staged, rng_round, tracer, salt: int = 0) -> dict:
        """One dispatch round: the client step over ``staged`` (skipped
        when None), each surviving client's arrival scheduled at round +
        latency (0 without chaos), then round ``round_idx``'s arrivals
        admitted and committed. Returns {ledger_blocks, commit_metrics,
        n_commits}."""
        api, host = self.api, self.host
        ledger_blocks: list = []
        if staged is not None:
            staged.wait()
            with tracer.span("dispatch", round_idx):
                # the ledger's rows, while one is attached
                result, stats = self.client_step(api.global_variables, staged.x,
                                                 staged.y, staged.counts, rng_round,
                                                 staged.host_counts(),
                                                 api._drive_ledger is not None)
            if api._buffer is None:
                api._buffer = init_buffer(result, self.k)
            n = len(staged.client_idx)
            lat = (self.chaos.latencies(round_idx, n) if self.chaos is not None
                   else np.zeros(n, np.int32)).tolist()
            surviving = [c for c in range(n) if staged.faults is None
                         or bool(staged.faults.participation[c])]
            for c in surviving:
                host.arrivals.setdefault(round_idx + lat[c], []).append((round_idx, c))
            self.in_flight += len(surviving)
            if surviving:
                host.pending[round_idx] = {
                    "vars": result.variables, "steps": result.num_steps,
                    "metrics": result.metrics, "counts": staged.counts,
                    "client_idx": np.asarray(staged.client_idx),
                    "remaining": len(surviving)}
            participated = (np.asarray(staged.faults.participation, bool)
                            if staged.faults is not None else np.ones(n, bool))
            ledger_blocks.append({"round": round_idx,
                                  "client_idx": np.asarray(staged.client_idx),
                                  "participated": participated, "stats": stats})
            staged.release()
        commit_metrics: list = []
        n_commits = self.process_arrivals(round_idx, rng_round, commit_metrics,
                                          ledger_blocks, tracer, salt)
        telemetry.gauge("buffer_fill", round=round_idx, fill=host.fill,
                        commits=n_commits)
        return {"ledger_blocks": ledger_blocks, "commit_metrics": commit_metrics,
                "n_commits": n_commits}

    def drain(self, tracer) -> dict:
        """The outstanding straggler arrivals land on virtual rounds past
        the last dispatch, then the last partial buffer flushes through the
        masked commit. No client work runs here. Returns {ledger_blocks,
        commit_metrics, n_commits, drain_round}."""
        host = self.host
        drain_round = self.cfg.comm_round
        commit_metrics: list = []
        ledger_blocks: list = []
        n_commits = 0
        while host.arrivals:
            n_commits += self.process_arrivals(drain_round, self.base_rng(drain_round),
                                               commit_metrics, ledger_blocks, tracer)
            drain_round += 1
        if host.fill > 0:
            self._do_commit(drain_round, self.base_rng(drain_round), commit_metrics,
                            ledger_blocks, tracer)
            n_commits += 1
        return {"ledger_blocks": ledger_blocks, "commit_metrics": commit_metrics,
                "n_commits": n_commits, "drain_round": drain_round}


def _sum_metrics(commit_metrics: list) -> dict:
    """The commits' metrics summed per key, in one host transfer."""
    slots = [(key, v) for m in commit_metrics for key, v in m.items()]
    out: dict = {}
    for (key, _), value in zip(slots, fetch_scalars([v for _, v in slots])):
        out[key] = out.get(key, 0.0) + value
    return out


def train_buffered(api, start_round: int, ckpt_dir, ckpt_every, metrics_logger,
                   chaos, guard, tracer, ledger=None, discount_fn=None) -> None:
    """The buffered drive loop (``cfg.buffer_size > 0``), called from
    ``FedAvgAPI.train`` inside its tracer and checkpoint scaffolding.

    Each dispatch round stages its cohort through the ``stage_fn`` seam
    (with ``cfg.pipeline_depth > 0`` a background prefetcher stages rounds
    t+1..t+depth while t runs) and hands it to the ``BufferedRunner``.
    After the last dispatch round, ``drain()`` lands the outstanding
    arrivals on virtual rounds and flushes the last partial buffer into a
    record of round ``comm_round``."""
    cfg = api.cfg
    runner = BufferedRunner(api, chaos=chaos, discount_fn=discount_fn)
    api._last_runner = runner
    host = runner.host
    records = RoundRecordLog(tracer, api.history, metrics_logger, ledger=ledger)
    prefetcher = None
    if cfg.pipeline_depth > 0:
        prefetcher = CohortPrefetcher(lambda r: api.stage_fn(r, chaos=chaos),
                                      depth=cfg.pipeline_depth)
        api._last_prefetcher = prefetcher

    round_idx = start_round
    retries = 0
    try:
        while round_idx < cfg.comm_round:
            with tracer.round(round_idx) as rspan:
                with tracer.span("stage_wait", round_idx):
                    staged = (prefetcher.get(round_idx) if prefetcher else
                              api.stage_fn(round_idx, chaos=chaos, tracer=tracer))
                if staged.round_idx != round_idx:
                    raise RuntimeError(f"round {round_idx} was handed round "
                                       f"{staged.round_idx}'s cohort")
                if prefetcher:
                    for ahead in range(1, cfg.pipeline_depth + 1):
                        if round_idx + ahead < cfg.comm_round:
                            prefetcher.prefetch(round_idx + ahead)
                snapshot = runner.snapshot() if guard is not None else None
                rng_round = runner.base_rng(round_idx, retries)
                out = runner.step(round_idx, staged, rng_round, tracer, retries)
                train_metrics: dict = {}
                if out["commit_metrics"]:
                    with tracer.span("metrics_fetch", round_idx):
                        train_metrics = _sum_metrics(out["commit_metrics"])
                if guard is not None and out["commit_metrics"]:
                    total = max(train_metrics.get("total", 1.0), 1.0)
                    loss = train_metrics.get("loss_sum", 0.0) / total
                    with tracer.span("guard_verdict", round_idx):
                        verdict = guard.inspect(round_idx, loss, api.global_variables)
                    tracer.event("guard_verdict", round=round_idx, ok=verdict.ok,
                                 reason=verdict.reason)
                    if not verdict.ok and retries < guard.max_retries:
                        retries += 1
                        log.warning("guard: %s — rolled back (buffer + schedule), "
                                    "retrying with fresh rng (%d/%d)",
                                    verdict.reason, retries, guard.max_retries)
                        tracer.event("guard_rollback", round=round_idx, retry=retries)
                        runner.restore(snapshot)
                        if prefetcher:
                            prefetcher.invalidate()
                        continue
                    if not verdict.ok:
                        log.warning("guard: %s — retries exhausted, accepting the "
                                    "round", verdict.reason)
                        tracer.event("guard_exhausted", round=round_idx)
                record = {"round": round_idx, "round_time": rspan.elapsed(),
                          "buffer_commits": out["n_commits"],
                          "committed_updates": host.committed_updates,
                          "buffer_fill": host.fill,
                          "_ledger": out["ledger_blocks"]}
                for key in ("loss_sum", "total", "participated_count",
                            "quarantined_count", "staleness_sum", "staleness_max"):
                    if key in train_metrics:
                        record[key] = train_metrics[key]
                if staged.faults is not None:
                    record.update(chaos_summary(staged.faults))
                if guard is not None and retries:
                    record["guard_retries"] = retries
                retries = 0
                if api._is_test_round(round_idx):
                    with tracer.span("eval", round_idx):
                        record.update(api.local_test_on_all_clients(round_idx))
                        record.update(api.test_global(round_idx))
                records.add(record)
                records.flush(round_idx)
                api._maybe_save(ckpt_dir, ckpt_every, round_idx, tracer)
            round_idx += 1
    finally:
        if prefetcher:
            prefetcher.close()

    out = runner.drain(tracer)
    if out["n_commits"]:
        record = {"round": cfg.comm_round, "round_time": 0.0,
                  "buffer_commits": out["n_commits"],
                  "committed_updates": host.committed_updates,
                  "buffer_fill": host.fill, "_ledger": out["ledger_blocks"]}
        with tracer.span("metrics_fetch", out["drain_round"]):
            record.update(_sum_metrics(out["commit_metrics"]))
        records.add(record)
        records.flush(cfg.comm_round)
