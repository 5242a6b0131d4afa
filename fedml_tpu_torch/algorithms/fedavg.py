"""FedAvg simulator API — PyTorch form of ``fedml_tpu/algorithms/fedavg.py``
(reference fedml_api/standalone/fedavg/fedavg_api.py:13-215).

Ported: ``client_sampling`` (bitwise), and ``FedAvgAPI`` with its drive:
the stage seam (``stage_fn``), ``train_one_round``, the eager loop and the
pipelined loop (``cfg.pipeline_depth`` > 0: cohorts staged ahead on a
background thread and a side CUDA stream, train metrics fetched in one
deferred transfer), chaos faults, the round guard's rollback and salted
retry, checkpoints and resume, the tracer and the metrics logger,
``test_global`` and ``local_test_on_all_clients``. The client ledger, the
adapter bank and the superstep and buffered drives raise
``NotImplementedError`` when asked for.
"""

from __future__ import annotations

import logging
import os
from collections import deque
from typing import Any

import numpy as np
import torch

from fedml_tpu_torch import telemetry
from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import (build_eval_fn, build_round_fn,
                                               stage_to_device)
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.packing import pack_eval_batches, pad_clients
from fedml_tpu_torch.data.prefetch import CohortPrefetcher, StagedCohort
from fedml_tpu_torch.data.registry import FederatedDataset
from fedml_tpu_torch.robustness.chaos import apply_faults, summarize as chaos_summary
from fedml_tpu_torch.telemetry.records import RoundRecordLog, fetch_scalars
from fedml_tpu_torch.utils.checkpoint import Checkpointable
from fedml_tpu_torch.utils.device import resolve_device, synchronize
from fedml_tpu_torch.utils.pytree import tree_map

log = logging.getLogger(__name__)

# local_test_on_all_clients evaluates whole clients, several per forward
# pass: at most _EVAL_ROWS rows and _EVAL_LOGITS logits (rows x outputs per
# row) a pass. 4096 FEMNIST rows make 254k logits; one NWP row makes
# 20 x 10,004, so there the logits bound the pass (512 MiB of float32).
_EVAL_ROWS = 4096
_EVAL_LOGITS = 2 ** 27


def client_sampling(round_idx: int, client_num_in_total: int,
                    client_num_per_round: int) -> np.ndarray:
    """Seeded per-round sampling (reference FedAVGAggregator.py:89-97):
    np.random.seed(round_idx), then choice without replacement."""
    if client_num_in_total == client_num_per_round:
        return np.arange(client_num_in_total)
    num = min(client_num_per_round, client_num_in_total)
    rng = np.random.RandomState(round_idx)
    return rng.choice(client_num_in_total, num, replace=False)


def round_generator(seed: int, round_idx: int, salt: int = 0) -> torch.Generator:
    """The CPU generator of one round, a pure function of (seed, round,
    salt); a guard retry salts it with its retry count."""
    state = np.random.SeedSequence([seed, round_idx, salt]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & (2 ** 63 - 1))


class FedAvgAPI(Checkpointable):
    """Single-controller federated simulator on one device (``cuda`` unless
    the caller passes ``device="cpu"``). ``global_variables`` holds the
    model's parameters and its state (a BatchNorm's running statistics);
    the rounds carry both, and the evaluations read the running
    statistics (eval mode)."""

    def __init__(self, dataset: FederatedDataset, config: FedConfig,
                 model_trainer, aggregator_name: str = "fedavg",
                 device="cuda"):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.cfg = config.validate()
        self.trainer = model_trainer
        self.aggregator = make_aggregator(aggregator_name, config)
        self.round_fn = build_round_fn(model_trainer, config, self.aggregator,
                                       device=self.device)
        self.eval_fn = build_eval_fn(model_trainer)
        self.history: list[dict[str, Any]] = []
        self.global_variables = model_trainer.init(
            torch.Generator().manual_seed(config.seed), self.device)
        self.agg_state = self.aggregator.init_state(self.global_variables)
        bs = config.batch_size if config.batch_size > 0 else 256
        self._test_batches = tuple(
            torch.from_numpy(a).to(self.device)
            for a in pack_eval_batches(*dataset.test_global, max(bs, 64)))
        # the side stream of the cohorts' copies to the card
        self._h2d_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        # The stage seam: every cohort, eager or pipelined, reaches the
        # device through this one callable, stage_fn(round_idx, *,
        # chaos=None, faults=None, tracer=None) -> StagedCohort.
        self.stage_fn = self._stage_cohort

    # ------------------------------------------------------------------ train
    def train_one_round(self, round_idx: int, faults=None, rng_salt: int = 0,
                        tracer=None) -> dict[str, float]:
        """One synchronous round: stage the cohort (``faults``, this round's
        ``FaultEvents``, injects drops, NaN and corruption and arms the
        participation mask and quarantine), run it with the round's
        generator (salted by ``rng_salt``, 0 for the first attempt), and
        return the summed train metrics in one host transfer. Staging goes
        through ``self.stage_fn``, the seam the pipelined loop's stager
        calls, so both drives feed the round the same bytes."""
        if tracer is None:
            tracer = telemetry.get_tracer() or telemetry.NULL_TRACER
        staged = self.stage_fn(round_idx, faults=faults, tracer=tracer)
        with tracer.span("dispatch", round_idx):
            metrics = self._dispatch(staged, rng_salt)
        with tracer.span("metrics_fetch", round_idx):
            metrics = self._fetch(metrics)
        staged.release()
        return metrics

    def _dispatch(self, staged: StagedCohort, rng_salt: int) -> dict:
        """Run the round on a staged cohort; returns the train metrics as
        0-d tensors on the device. On the card the compute stream first
        waits for the cohort's copies."""
        staged.wait()
        rng = round_generator(self.cfg.seed, staged.round_idx, rng_salt)
        self.global_variables, self.agg_state, metrics = self.round_fn(
            self.global_variables, self.agg_state, staged.x, staged.y,
            staged.counts, rng, staged.participation)
        return metrics

    @staticmethod
    def _fetch(metrics: dict) -> dict[str, float]:
        return dict(zip(metrics, fetch_scalars(list(metrics.values()))))

    def train(self, ckpt_dir: str | None = None, ckpt_every: int = 25,
              metrics_logger=None, chaos=None, guard=None, tracer=None,
              ledger=None, bank=None) -> list[dict[str, Any]]:
        """Drive loop. ``chaos`` (``robustness.chaos.FaultPlan``) injects a
        seeded fault schedule per round; ``guard``
        (``robustness.guard.RoundGuard``) inspects every round and, on a bad
        verdict, restores the pre-round snapshot and re-runs the round with
        a salted generator, up to ``guard.max_retries`` times before it
        accepts. ``ckpt_dir`` resumes from its latest checkpoint and saves
        every ``ckpt_every`` rounds and at the end.

        ``cfg.pipeline_depth > 0`` runs the pipelined loop
        (``_train_pipelined``), equal to the eager loop bit for bit.

        ``tracer`` (``telemetry.Tracer``) records the phase spans and the
        event ledger; when None, one is made (writing ``TRACE.jsonl`` next
        to the checkpoints when ``ckpt_dir`` is given) and closed at the
        end. The tracer is installed as the telemetry seam for the drive,
        so the chaos harness, the prefetcher and checkpoints emit into it,
        from the stager thread too. ``ledger`` and ``bank`` are not ported
        and raise."""
        for name, value in (("ledger", ledger), ("bank", bank)):
            if value is not None:
                raise NotImplementedError(
                    f"train({name}=...) is not ported to fedml_tpu_torch yet")
        cfg = self.cfg.validate(chaos=chaos is not None)
        owns_tracer = tracer is None
        if tracer is None:
            tracer = telemetry.Tracer(
                jsonl_path=os.path.join(ckpt_dir, "TRACE.jsonl")
                if ckpt_dir else None)
        start_round = self.maybe_restore(ckpt_dir) if ckpt_dir else 0
        telemetry.install(tracer)
        try:
            with tracer.span("drive"):
                loop = (self._train_pipelined if cfg.pipeline_depth > 0
                        else self._train_eager)
                loop(start_round, ckpt_dir, ckpt_every, metrics_logger, chaos,
                     guard, tracer)
                if ckpt_dir:
                    with tracer.span("checkpoint"):
                        self.save_checkpoint(ckpt_dir, cfg.comm_round)
        finally:
            telemetry.uninstall(tracer)
            if owns_tracer:
                tracer.close()
        return self.history

    def _is_test_round(self, round_idx: int) -> bool:
        cfg = self.cfg
        return (round_idx % cfg.frequency_of_the_test == 0
                or round_idx == cfg.comm_round - 1)

    def _train_eager(self, start_round, ckpt_dir, ckpt_every, metrics_logger,
                     chaos, guard, tracer) -> None:
        """Synchronous drive loop: stage, dispatch, wait, fetch, every phase
        in turn. Records commit through the RoundRecordLog of the pipelined
        loop, flushed every round."""
        records = RoundRecordLog(tracer, self.history, metrics_logger)
        round_idx = start_round
        while round_idx < self.cfg.comm_round:
            round_idx = self._eager_round(round_idx, records, chaos=chaos,
                                          guard=guard, tracer=tracer,
                                          ckpt_dir=ckpt_dir,
                                          ckpt_every=ckpt_every)

    def _eager_round(self, round_idx, records, *, chaos, guard, tracer,
                     ckpt_dir, ckpt_every) -> int:
        """One eager round, guard retries included. Returns round_idx + 1."""
        cfg = self.cfg
        retries = 0
        while True:
            with tracer.round(round_idx) as rspan:
                faults = None
                if chaos is not None:
                    n_cohort = min(cfg.client_num_per_round, self.dataset.client_num)
                    faults = chaos.events(round_idx, n_cohort)
                snapshot = self._snapshot() if guard is not None else None
                train_metrics = self.train_one_round(round_idx, faults=faults,
                                                     rng_salt=retries,
                                                     tracer=tracer)
                with tracer.span("device_wait", round_idx):
                    synchronize(self.device)
                if guard is not None and self._rolled_back(
                        guard, round_idx, train_metrics, retries, snapshot, tracer):
                    retries += 1
                    continue
                self._commit(round_idx, rspan, train_metrics, faults, guard,
                             retries, records, tracer)
                records.flush(round_idx)
                self._maybe_save(ckpt_dir, ckpt_every, round_idx, tracer)
            return round_idx + 1

    def _rolled_back(self, guard, round_idx, train_metrics, retries, snapshot,
                     tracer) -> bool:
        """Ask the guard about a finished round (its loss and the globals);
        on a bad verdict with retries left, restore ``snapshot`` and return
        True. Every verdict is ledgered as a ``guard_verdict`` event."""
        total = max(train_metrics.get("total", 1.0), 1.0)
        loss = train_metrics.get("loss_sum", 0.0) / total
        with tracer.span("guard_verdict", round_idx):
            verdict = guard.inspect(round_idx, loss, self.global_variables)
        tracer.event("guard_verdict", round=round_idx, ok=verdict.ok,
                     reason=verdict.reason)
        if verdict.ok:
            return False
        if retries < guard.max_retries:
            log.warning("guard: %s — rolled back, retrying with fresh rng "
                        "(%d/%d)", verdict.reason, retries + 1, guard.max_retries)
            tracer.event("guard_rollback", round=round_idx, retry=retries + 1)
            self._ckpt_load(*snapshot)
            return True
        log.warning("guard: %s — retries exhausted, accepting the round",
                    verdict.reason)
        tracer.event("guard_exhausted", round=round_idx)
        return False

    def _commit(self, round_idx, rspan, train_metrics, faults, guard, retries,
                records, tracer) -> None:
        """Assemble the round's history record (train metrics, which may
        still be tensors on the device, the chaos counts, the guard's
        retries and, on test rounds, the evaluations) and add it to
        ``records``."""
        record = {"round": round_idx, "round_time": rspan.elapsed(),
                  **train_metrics}
        if faults is not None:
            record.update(chaos_summary(faults))
        if guard is not None and retries:
            record["guard_retries"] = retries
        if self._is_test_round(round_idx):
            with tracer.span("eval", round_idx):
                record.update(self.local_test_on_all_clients(round_idx))
                record.update(self.test_global(round_idx))
        records.add(record)

    def _maybe_save(self, ckpt_dir, ckpt_every, round_idx, tracer) -> None:
        if ckpt_dir and (round_idx + 1) % ckpt_every == 0:
            with tracer.span("checkpoint", round_idx):
                self.save_checkpoint(ckpt_dir, round_idx + 1)

    # --------------------------------------------------------- stage seam
    def _stage_cohort(self, round_idx: int, chaos=None, faults=None,
                      tracer=None) -> StagedCohort:
        """The host half of one round as a pure function of ``round_idx``:
        sample, gather, chaos faults and the participation mask, then the
        copy to the device (``engine.stage_to_device``). The eager loop
        calls it inline with the round's ``faults``; the pipelined loop's
        stager thread calls it with the ``chaos`` plan, and it draws the
        faults itself. Staging draws nothing from a ``torch.Generator``,
        so the two feed the round the same bytes. Spans go to the
        installed tracer when none is passed (tagged thread="stager" when
        staged ahead)."""
        cfg = self.cfg
        if tracer is None:
            tracer = telemetry.get_tracer() or telemetry.NULL_TRACER
        with tracer.span("stage", round_idx):
            idx = client_sampling(round_idx, self.dataset.client_num,
                                  cfg.client_num_per_round)
            if faults is None and chaos is not None:
                faults = chaos.events(round_idx, len(idx))
            x, y, counts = self.dataset.train.select(idx)
            participation = None
            if faults is not None:
                x = apply_faults(faults, x)
                participation = np.asarray(faults.participation, bool)
        with tracer.span("h2d", round_idx):
            (dx, dy, dc, dp), ready, pinned = stage_to_device(
                x, y, counts, participation, self.device, self._h2d_stream)
        return StagedCohort(round_idx, dx, dy, dc, dp, faults, idx, ready, pinned)

    def _train_pipelined(self, start_round, ckpt_dir, ckpt_every,
                         metrics_logger, chaos, guard, tracer) -> None:
        """Asynchronous drive loop (``cfg.pipeline_depth`` > 0).

        While round t runs, a background stager prepares cohorts
        t+1..t+depth (``stage_fn`` via ``data.prefetch.CohortPrefetcher``;
        on the card through pinned buffers and a side stream). Train metrics
        stay 0-d tensors on the device and are fetched in one transfer per
        flush: forced when the guard needs the loss, on test and
        checkpoint rounds, and once ``max(4, 2 * depth)`` records are
        pending. The host runs at most ``depth`` rounds ahead of the card:
        each round records a CUDA event after its dispatch, and round t
        waits on round t - depth's event (not on the whole device).

        A guard rollback restores the snapshot, drops every in-flight
        staging (``invalidate``) and re-stages the retried round on demand:
        staging is pure in the round, so the retry sees the same bytes and
        the salted generator, as in the eager loop."""
        cfg = self.cfg
        depth = cfg.pipeline_depth
        prefetcher = CohortPrefetcher(
            lambda r: self.stage_fn(r, chaos=chaos), depth=depth)
        self._last_prefetcher = prefetcher
        records = RoundRecordLog(tracer, self.history, metrics_logger)
        self._last_records = records
        inflight: deque = deque()  # (done event or None, staged cohort)
        round_idx = start_round
        retries = 0
        try:
            while round_idx < cfg.comm_round:
                with tracer.round(round_idx) as rspan:
                    with tracer.span("stage_wait", round_idx):
                        staged = prefetcher.get(round_idx)
                    if staged.round_idx != round_idx:
                        raise RuntimeError(
                            f"round {round_idx} was handed round "
                            f"{staged.round_idx}'s cohort")
                    for ahead in range(1, depth + 1):
                        if round_idx + ahead < cfg.comm_round:
                            prefetcher.prefetch(round_idx + ahead)
                    snapshot = self._snapshot() if guard is not None else None
                    with tracer.span("dispatch", round_idx):
                        train_metrics = self._dispatch(staged, retries)
                        inflight.append((self._done_event(), staged))
                    if len(inflight) > depth:
                        with tracer.span("device_wait", round_idx):
                            self._retire(inflight.popleft())
                    is_ckpt = bool(ckpt_dir) and (round_idx + 1) % ckpt_every == 0
                    if guard is not None:
                        with tracer.span("metrics_fetch", round_idx):
                            train_metrics = self._fetch(train_metrics)
                        if self._rolled_back(guard, round_idx, train_metrics,
                                             retries, snapshot, tracer):
                            retries += 1
                            prefetcher.invalidate()
                            while inflight:
                                self._retire(inflight.popleft())
                            continue
                    self._commit(round_idx, rspan, train_metrics, staged.faults,
                                 guard, retries, records, tracer)
                    retries = 0
                    if (guard is not None or self._is_test_round(round_idx)
                            or is_ckpt or len(records) >= max(4, 2 * depth)):
                        records.flush(round_idx)
                    self._maybe_save(ckpt_dir, ckpt_every, round_idx, tracer)
                round_idx += 1
        finally:
            prefetcher.close()
        while inflight:
            self._retire(inflight.popleft())
        records.flush()

    def _done_event(self):
        """An event recorded on the compute stream after a round's work
        (None on the CPU, where the round ran synchronously)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    @staticmethod
    def _retire(entry) -> None:
        """Wait for an in-flight round and drop its cohort's pinned sources."""
        done, staged = entry
        if done is not None:
            done.synchronize()
        staged.release()

    # -- checkpoint state (utils.checkpoint.Checkpointable): the globals
    # (model state included), the aggregator's state (a server optimizer's
    # moments) and the history
    def _ckpt_tree(self):
        return {"variables": self.global_variables, "agg_state": self.agg_state}

    def _ckpt_meta(self):
        # a copy: the snapshot must not alias the list a later flush extends
        return {"history": list(self.history)}

    def _snapshot(self):
        """The guard's pre-round state. Cloned: unlike JAX arrays, tensors
        can be written in place, and a round that did so would otherwise
        corrupt the state a rollback restores."""
        return tree_map(torch.clone, self._ckpt_tree()), self._ckpt_meta()

    def _ckpt_load(self, tree, meta):
        self.global_variables = tree["variables"]
        self.agg_state = tree["agg_state"]
        # in place: the drive loop's RoundRecordLog holds this list
        self.history[:] = meta.get("history", [])

    # ------------------------------------------------------------------- eval
    def test_global(self, round_idx: int) -> dict[str, float]:
        m = self.eval_fn(self.global_variables, *self._test_batches)
        m = {k: float(v) for k, v in m.items()}
        total = max(m.get("test_total", 1.0), 1.0)
        return {"Test/Acc": m.get("test_correct", 0.0) / total,
                "Test/Loss": m.get("test_loss", 0.0) / total}

    def local_test_on_all_clients(self, round_idx: int) -> dict[str, float]:
        """The global model on every client's train and test split,
        sample-weighted (reference fedavg_api.py:119-183); CI mode
        evaluates one client. Each forward pass takes whole clients, their
        padded rows masked, as the JAX drive's vmap over clients does: the
        NWP trainer's reported loss is a per-client quantity."""
        ds = self.dataset
        out = {}
        for split_name, packed in (("Train", ds.train), ("Test", ds.test or ds.train)):
            sums = None
            for bx, by, bm, clients in self._client_chunks(packed):
                m = self.eval_fn(self.global_variables, bx, by, bm, clients)
                sums = m if sums is None else {k: sums[k] + m[k] for k in m}
            sums = {k: float(v) for k, v in sums.items()}
            total = max(sums.get("test_total", 0.0), 1.0)
            out[f"{split_name}/Acc"] = sums.get("test_correct", 0.0) / total
            out[f"{split_name}/Loss"] = sums.get("test_loss", 0.0) / total
        return out

    def _client_chunks(self, packed):
        """(x [1, k * n_max, ...], y, mask, k) on the device for each run of
        k clients of a split; the last run is padded with empty clients."""
        num = 1 if self.cfg.ci else packed.num_clients
        n_max = packed.n_max
        per_row = self.dataset.class_num * int(np.prod(packed.y.shape[2:], dtype=np.int64))
        rows = min(_EVAL_ROWS, _EVAL_LOGITS // max(per_row, 1))
        k = max(1, min(num, rows // max(n_max, 1)))
        for start in range(0, num, k):
            x, y, counts = packed.select(np.arange(start, min(start + k, num)))
            x, y, counts = pad_clients(x, y, counts, k)
            mask = (np.arange(n_max)[None] < counts[:, None]).astype(np.float32)
            yield (*(torch.from_numpy(np.ascontiguousarray(
                a.reshape((1, k * n_max) + a.shape[2:]))).to(self.device)
                for a in (x, y, mask)), k)
