"""FedAvg simulator API — PyTorch form of ``fedml_tpu/algorithms/fedavg.py``
(reference fedml_api/standalone/fedavg/fedavg_api.py:13-215).

Ported: ``client_sampling`` and ``fast_client_sampling`` (bitwise; the
latter with ``cfg.fast_sampling``), and ``FedAvgAPI`` with its drive:
the stage seam (``stage_fn``), ``train_one_round``, the eager loop, the
pipelined loop (``cfg.pipeline_depth`` > 0: cohorts staged ahead on a
background thread and a side CUDA stream, train metrics fetched in one
deferred transfer), the buffered loop (``cfg.buffer_size`` > 0,
``algorithms/buffered.py``), the superstep loop (``cfg.rounds_per_dispatch``
> 1: K rounds a dispatch from the device-resident store), the update
codecs (``cfg.update_codec``), chaos faults, the round guard's rollback
and salted retry, checkpoints and resume, the tracer and the metrics
logger, ``test_global`` and ``local_test_on_all_clients``; federated LoRA
(``cfg.lora_rank``: adapters-only rounds and checkpoints), the client
ledger (``train(ledger=)``) and per-client personalization from the
adapter bank (``cfg.personalize`` with ``train(bank=)``: the personalized
round in the eager and pipelined loops, ``--adapter_clusters`` rows and
``personalization_lift``); the silo-grouped round
(``cfg.silo_threshold`` > 0, ``algorithms/silo_grouped.py``); the resident
federation eval (``cfg.resident_eval``); and the clients-sharded round
(``cfg.backend="shard_map"`` over a process group of more than one rank,
``parallel/sharded.py``).
"""

from __future__ import annotations

import copy
import logging
import os
from collections import deque
from typing import Any

import numpy as np
import torch

from fedml_tpu_torch import telemetry
from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import (build_client_eval_fn, build_eval_fn,
                                               build_federation_eval_fn,
                                               build_personal_client_eval_fn,
                                               build_personal_round_fn, build_round_fn,
                                               pack_test_batches, stage_to_device,
                                               test_metrics)
from fedml_tpu_torch.algorithms.sampling import feistel_host
from fedml_tpu_torch.codecs import make_codec
from fedml_tpu_torch.core.builder import wrap_codec
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.packed_store import MmapPackedStore, materialize
from fedml_tpu_torch.data.packing import pad_clients
from fedml_tpu_torch.data.prefetch import CohortPrefetcher, StagedCohort
from fedml_tpu_torch.data.registry import FederatedDataset
from fedml_tpu_torch.models.lora import attach_lora_base, maybe_wrap_lora, strip_lora_base
from fedml_tpu_torch.robustness.chaos import (FaultEvents, apply_faults,
                                             summarize as chaos_summary)
from fedml_tpu_torch.telemetry.records import RoundRecordLog, fetch_scalars
from fedml_tpu_torch.utils.checkpoint import Checkpointable
from fedml_tpu_torch.utils.device import resolve_device, synchronize, to_device
from fedml_tpu_torch.utils.pytree import tree_map

log = logging.getLogger(__name__)

# local_test_on_all_clients evaluates whole clients, several per forward
# pass: at most _EVAL_ROWS rows and _EVAL_LOGITS logits (rows x outputs per
# row) a pass. 4096 FEMNIST rows make 254k logits; one NWP row makes
# 20 x 10,004, so there the logits bound the pass (512 MiB of float32).
_EVAL_ROWS = 4096
_EVAL_LOGITS = 2 ** 27
_NEEDS_BANK = ("personalize=True needs an attached adapter bank "
               "(models/adapter_bank.py) — pass --adapter_bank_dir on the "
               "CLI or train(bank=...)")


def client_sampling(round_idx: int, client_num_in_total: int,
                    client_num_per_round: int) -> np.ndarray:
    """Seeded per-round sampling (reference FedAVGAggregator.py:89-97):
    np.random.seed(round_idx), then choice without replacement."""
    if client_num_in_total == client_num_per_round:
        return np.arange(client_num_in_total)
    num = min(client_num_per_round, client_num_in_total)
    rng = np.random.RandomState(round_idx)
    return rng.choice(client_num_in_total, num, replace=False)


def fast_client_sampling(round_idx: int, client_num_in_total: int,
                         client_num_per_round: int) -> np.ndarray:
    """O(cohort) uniform sampling without replacement, bitwise the JAX
    package's: the first ``num`` values of a seeded Feistel permutation of
    [0, N).

    ``client_sampling``'s ``rng.choice(N, num, replace=False)`` shuffles all
    N ids, O(N) a round. A balanced 4-round Feistel network over the
    enclosing power-of-four domain is a keyed bijection, so walking ids
    0..num-1 through it (cycle-walking values that land >= N back through
    the network, under 2 passes expected) gives distinct ids in [0, N) in
    O(num) work and memory. The keys come from RandomState(round_idx), so
    the cohort is a pure function of the round, but not
    ``client_sampling``'s: the path is opt-in (``cfg.fast_sampling``).
    The arithmetic is numpy uint64, which wraps the splitmix64 products
    modulo 2**64 as the JAX package's does (``sampling.feistel_host``;
    ``sampling.feistel_cohort_in_graph`` is its twin on the device)."""
    n = int(client_num_in_total)
    if n == client_num_per_round:
        return np.arange(n)
    return feistel_host(round_idx, n, client_num_per_round)[0]


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
    statistics (eval mode).

    With ``cfg.lora_rank`` > 0 the trainer is wrapped in LoRA
    (``models.lora.maybe_wrap_lora``; a LoRA trainer passes as it is): the
    globals then hold the adapters and the frozen base under
    ``lora_base/``, and the aggregator, its state and the checkpoints see
    the adapters only."""

    def __init__(self, dataset: FederatedDataset, config: FedConfig,
                 model_trainer, aggregator_name: str = "fedavg",
                 device="cuda"):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.cfg = config.validate(device=self.device)
        #: the process-group mesh of the clients-sharded round
        #: (backend="shard_map" over more than one rank), else None
        self.mesh = None
        if config.backend == "shard_map" and config.mesh_size() > 1:
            from fedml_tpu_torch.parallel import make_mesh

            self.mesh = make_mesh(tuple(config.mesh_shape or ()) or None, device=self.device)
            self.device = self.mesh.device
        model_trainer = maybe_wrap_lora(model_trainer, config)
        self.trainer = model_trainer
        self.aggregator = make_aggregator(aggregator_name, config)
        # the compressed update transport: None keeps every path as it was
        self.codec = make_codec(config.update_codec, config)
        if self.codec is not None and config.buffer_size == 0:
            # wrapped here, before init_state, so that the state (which
            # checkpoints and the guard's snapshot carry) holds the
            # residuals; a buffered drive keeps the inner aggregator: its
            # codec stage is the admit (algorithms/buffered.py). Sharded,
            # a rank holds the residual rows of its block of the padded
            # cohort
            slots = min(config.client_num_per_round, dataset.client_num)
            if self.mesh is not None:
                slots = -(-slots // self.mesh.world_size)
            self.aggregator = wrap_codec(self.aggregator, self.codec, slots)
        # the rounds compute the client ledger's stats rows while a ledger
        # is attached (_dispatch's stats flag); the rows only read a round's
        # results, so the globals are the same bits with a ledger or without
        self._personalized = bool(config.personalize)
        if self.mesh is not None:
            from fedml_tpu_torch.parallel import build_sharded_round_fn

            self.round_fn = build_sharded_round_fn(model_trainer, config, self.aggregator,
                                                   self.mesh, collect_stats=True)
        elif config.silo_threshold > 0:
            from fedml_tpu_torch.algorithms.silo_grouped import (build_silo_round_fn,
                                                                 silo_trainer)

            # the silos train together with the grouped convolutions; the
            # evaluations keep the original trainer. The silo round has no
            # ledger stats rows (its fourth output is always None)
            self.round_fn = build_silo_round_fn(
                silo_trainer(model_trainer, config.silo_threshold), config, self.aggregator,
                device=self.device, collect_stats=True)
        else:
            build = build_personal_round_fn if self._personalized else build_round_fn
            self.round_fn = build(model_trainer, config, self.aggregator, device=self.device,
                                  collect_stats=True)
        #: the attached personal adapter bank (models/adapter_bank.py), set
        #: by train(bank=...) or directly; a personalized run needs one
        self.bank = None
        self._drive_ledger = None
        self._last_dispatch = None
        self._last_personal = None
        self.eval_fn = build_eval_fn(model_trainer)
        self.client_eval_fn = build_client_eval_fn(model_trainer)
        self._personal_eval_fn = (build_personal_client_eval_fn(model_trainer)
                                  if self._personalized else None)
        # the resident federation eval: its program, and the splits on the
        # device (None until the first eval; {} when they cannot be resident)
        self._fed_eval_fn = build_federation_eval_fn(model_trainer)
        self._resident_cache = None
        #: the bytes the resident eval staged (0 until it stages)
        self.resident_eval_bytes = 0
        self.history: list[dict[str, Any]] = []
        self.global_variables = model_trainer.init(
            torch.Generator().manual_seed(config.seed), self.device)
        self.agg_state = self.aggregator.init_state(strip_lora_base(self.global_variables))
        self._test_batches = pack_test_batches(dataset.test_global, config.batch_size,
                                               self.device)
        # the side stream of the cohorts' copies to the card
        self._h2d_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        # the superstep's programs, keyed by (K, chaos),
        # and the train store on the device (None until first use; () when
        # it cannot be resident)
        self._superstep_cache: dict = {}
        self._resident_train = None
        # The stage seam: every cohort, eager or pipelined, reaches the
        # device through this one callable, stage_fn(round_idx, *,
        # chaos=None, faults=None, tracer=None) -> StagedCohort. Sharded,
        # a rank stages only its block of the cohort.
        self.stage_fn = (self._stage_cohort if self.mesh is None
                         else self._stage_sharded_cohort)

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
        self._gather_personal(staged, tracer)
        with tracer.span("dispatch", round_idx):
            metrics = self._dispatch(staged, rng_salt)
        with tracer.span("metrics_fetch", round_idx):
            metrics = self._fetch(metrics)
        staged.release()
        return metrics

    def _dispatch(self, staged: StagedCohort, rng_salt: int) -> dict:
        """Run the round on a staged cohort; returns the train metrics as
        0-d tensors on the device. On the card the compute stream first
        waits for the cohort's copies, and the round reads the counts from
        their pinned source: nothing in the round waits for the device.
        The round's ledger stats (computed only while a ledger is attached)
        and, personalized, the new personal rows (of the cohort's gathered
        ``personal``) stay on the device in ``_last_dispatch`` /
        ``_last_personal`` until the record log's deferred fetch."""
        staged.wait()
        rng = round_generator(self.cfg.seed, staged.round_idx, rng_salt)
        args = [self.global_variables, self.agg_state, staged.x, staged.y,
                staged.counts, rng]
        if self._personalized:
            args.append(staged.personal["tree"])
        # the sharded round draws the whole cohort's randomness from the
        # real cohort's counts; the last argument: whether the round
        # computes the ledger's rows
        host_counts = (staged.host_counts() if staged.cohort_counts is None
                       else staged.cohort_counts)
        out = self.round_fn(*args, staged.participation, None, None, host_counts,
                            self._drive_ledger is not None)
        self.global_variables, self.agg_state, metrics, stats = out[:4]
        self._last_dispatch = (staged, stats)
        self._last_personal = ((staged.personal["rows"], out[4])
                               if self._personalized else None)
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

        ``cfg.buffer_size > 0`` runs the buffered loop
        (``buffered.train_buffered``); else ``cfg.pipeline_depth > 0`` the
        pipelined loop (``_train_pipelined``), and ``cfg.rounds_per_dispatch
        > 1`` the superstep loop (``_train_superstep``), both equal to the
        eager loop bit for bit.

        ``tracer`` (``telemetry.Tracer``) records the phase spans and the
        event ledger; when None, one is made (writing ``TRACE.jsonl`` next
        to the checkpoints when ``ckpt_dir`` is given) and closed at the
        end. The tracer is installed as the telemetry seam for the drive,
        so the chaos harness, the prefetcher and checkpoints emit into it,
        from the stager thread too.

        ``ledger`` (``telemetry.client_ledger.ClientLedger``) attaches the
        per-client health ledger: every round's stats rows scatter into it
        from the record log's flush. It changes no round and adds no sync
        point: the globals are the same bits with it on or off.

        Over a sharded mesh each rank runs this loop: the train metrics
        and the globals are the same on every rank, every rank evaluates
        the whole federation, and checkpoints go to ``ckpt_dir/rank<r>``
        (a rank's codec residuals are its own). A client ledger is per
        process and is refused there.

        ``bank`` (``models.adapter_bank.AdapterBank``) attaches the personal
        adapter bank a personalized run needs: the cohort's rows are
        gathered when the loop takes the cohort, the round's updated rows ride the record log's
        deferred fetch and scatter back at its flush, and test rounds
        measure ``personalization_lift``. Cluster rows
        (``cfg.adapter_clusters``) are assigned from the attached ledger's
        ``ema_loss`` column."""
        cfg = self.cfg.validate(chaos=chaos is not None, device=self.device)
        if bank is not None:
            self.bank = bank
        if cfg.personalize and self.bank is None:
            raise ValueError(_NEEDS_BANK)
        if self.mesh is not None:
            if ledger is not None:
                raise ValueError("a client ledger records one process's cohorts: it is "
                                 "not supported with backend='shard_map' over several ranks")
            if ckpt_dir:
                ckpt_dir = os.path.join(ckpt_dir, f"rank{self.mesh.rank}")
        self._drive_ledger = ledger
        owns_tracer = tracer is None
        if tracer is None:
            tracer = telemetry.Tracer(
                jsonl_path=os.path.join(ckpt_dir, "TRACE.jsonl")
                if ckpt_dir else None)
        start_round = self.maybe_restore(ckpt_dir) if ckpt_dir else 0
        telemetry.install(tracer)
        try:
            with tracer.span("drive"):
                if cfg.buffer_size > 0:
                    from fedml_tpu_torch.algorithms.buffered import train_buffered

                    loop = train_buffered
                    args = (self,)
                else:
                    loop = (self._train_pipelined if cfg.pipeline_depth > 0
                            else self._train_superstep if cfg.rounds_per_dispatch > 1
                            else self._train_eager)
                    args = ()
                loop(*args, start_round, ckpt_dir, ckpt_every, metrics_logger,
                     chaos, guard, tracer, ledger)
                if ckpt_dir:
                    with tracer.span("checkpoint"):
                        self.save_checkpoint(ckpt_dir, cfg.comm_round)
        finally:
            if self.bank is not None:
                # a resumed run must read the bank's rows bit for bit
                self.bank.flush()
            telemetry.uninstall(tracer)
            if owns_tracer:
                tracer.close()
        return self.history

    def _is_test_round(self, round_idx: int) -> bool:
        cfg = self.cfg
        return (round_idx % cfg.frequency_of_the_test == 0
                or round_idx == cfg.comm_round - 1)

    def _records(self, tracer, metrics_logger, ledger) -> RoundRecordLog:
        return RoundRecordLog(tracer, self.history, metrics_logger, ledger=ledger,
                              bank=self.bank)

    def _train_eager(self, start_round, ckpt_dir, ckpt_every, metrics_logger,
                     chaos, guard, tracer, ledger=None) -> None:
        """Synchronous drive loop: stage, dispatch, wait, fetch, every phase
        in turn. Records commit through the RoundRecordLog of the pipelined
        loop, flushed every round."""
        records = self._records(tracer, metrics_logger, ledger)
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
                             retries, records, tracer, self._round_blocks(round_idx))
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
                records, tracer, blocks=None) -> None:
        """Assemble the round's history record (train metrics, which may
        still be tensors on the device, the chaos counts, the guard's
        retries, ``blocks``: the ``_ledger``/``_bank`` blocks, and on test
        rounds the evaluations) and add it to ``records``."""
        record = {"round": round_idx, "round_time": rspan.elapsed(),
                  **train_metrics, **(blocks or {})}
        if faults is not None:
            record.update(chaos_summary(faults))
        if guard is not None and retries:
            record["guard_retries"] = retries
        if self._is_test_round(round_idx):
            with tracer.span("eval", round_idx):
                record.update(self.local_test_on_all_clients(round_idx))
                record.update(self.test_global(round_idx))
                record.update(self.personalization_lift(round_idx))
        records.add(record)

    def _round_blocks(self, round_idx: int) -> dict:
        """The last dispatch's ``_ledger`` and ``_bank`` record blocks:
        device tensors until the record log's deferred fetch."""
        staged, stats = self._last_dispatch
        blocks = {}
        block = self._ledger_block(round_idx, staged, stats)
        if block is not None:
            blocks["_ledger"] = [block]
        if self._last_personal is not None:
            rows, new_personal = self._last_personal
            blocks["_bank"] = [{"round": round_idx, "client_idx": np.asarray(rows),
                                "rows": new_personal}]
        return blocks

    @staticmethod
    def _ledger_block(round_idx, staged, stats):
        """One cohort's stats block for a record's ``_ledger`` key (None
        without stats)."""
        if stats is None:
            return None
        n = len(staged.client_idx)
        participated = (np.asarray(staged.faults.participation, bool)
                        if staged.faults is not None else np.ones(n, bool))
        return {"round": round_idx, "client_idx": np.asarray(staged.client_idx),
                "participated": participated, "stats": stats}

    def _bank_rows(self, idx) -> np.ndarray:
        """The bank rows of a cohort: the client ids (one row a client), or
        with ``cfg.adapter_clusters`` K their EMA-loss cluster buckets
        (``adapter_bank.cluster_rows``) from the attached ledger's
        ``ema_loss`` column (a missing ledger reads as loss 0, bucket 0)."""
        idx = np.asarray(idx, np.int64)
        k = self.cfg.adapter_clusters
        if k <= 0:
            return idx
        from fedml_tpu_torch.models.adapter_bank import cluster_rows

        ledger = self._drive_ledger
        ema = (np.asarray(ledger.column("ema_loss"))[idx] if ledger is not None
               else np.zeros(idx.size, np.float32))
        return cluster_rows(ema, k)

    def _gather_personal(self, staged: StagedCohort, tracer) -> None:
        """Personalized, set ``staged.personal`` to {"rows": the cohort's
        bank rows, "tree": their adapters on the device}: the host gather
        (O(cohort) preads), then pinned copies that do not wait for the
        device. A loop calls it when it takes a cohort to dispatch, after
        the previous rounds' ``_bank`` scatters (read after write); a
        no-op for a shared run."""
        if not self._personalized:
            return
        if self.bank is None:
            raise ValueError(_NEEDS_BANK)
        rows = self._bank_rows(staged.client_idx)
        with tracer.span("bank_gather", staged.round_idx, rows=len(rows)):
            gathered = self.bank.gather(rows)
        staged.personal = {"rows": rows,
                           "tree": {k: to_device(torch.from_numpy(a), self.device)
                                    for k, a in gathered.items()}}

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
            sampler = fast_client_sampling if cfg.fast_sampling else client_sampling
            idx = sampler(round_idx, self.dataset.client_num, cfg.client_num_per_round)
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

    def _stage_sharded_cohort(self, round_idx: int, chaos=None, faults=None,
                              tracer=None) -> StagedCohort:
        """``_stage_cohort`` for a rank of the sharded round: the whole
        cohort sampled from the round (``multihost.sample_sharded_cohort``,
        the same on every rank, no communication), this rank's block of it
        gathered (``stage_local_cohort``; pad rows have zero counts), the
        round's faults drawn for the whole cohort and applied to the block
        (pad rows do not participate), and the real cohort's host counts
        kept for the round's draws (``StagedCohort.cohort_counts``)."""
        from fedml_tpu_torch.parallel.multihost import (sample_sharded_cohort,
                                                        stage_local_cohort)

        cfg = self.cfg
        if tracer is None:
            tracer = telemetry.get_tracer() or telemetry.NULL_TRACER
        with tracer.span("stage", round_idx):
            cohort = sample_sharded_cohort(
                round_idx, self.dataset.client_num, cfg.client_num_per_round,
                process_index=self.mesh.rank, process_count=self.mesh.world_size,
                sampler=fast_client_sampling if cfg.fast_sampling else client_sampling)
            if faults is None and chaos is not None:
                faults = chaos.events(round_idx, len(cohort.full_idx))
            x, y, counts = stage_local_cohort(self.dataset.train, cohort)
            participation = None
            if faults is not None:
                local = FaultEvents(*(_pad_to(np.asarray(m, bool), len(cohort.padded_idx))
                                      [cohort.local_slice] for m in faults))
                x = apply_faults(local, x)
                participation = local.participation
            cohort_counts = np.asarray(self.dataset.train.counts)[cohort.full_idx]
        with tracer.span("h2d", round_idx):
            (dx, dy, dc, dp), ready, pinned = stage_to_device(
                x, y, counts, participation, self.device, self._h2d_stream)
        return StagedCohort(round_idx, dx, dy, dc, dp, faults, cohort.full_idx, ready,
                            pinned, cohort_counts=cohort_counts)

    def stage_partial_cohort(self, round_idx: int, width: int, cohort: int,
                             chaos=None, tracer=None) -> StagedCohort:
        """The first ``width`` clients of round ``round_idx``'s seeded
        ``cohort``-sized sample, padded back to ``cohort`` rows (a buffered
        runner's partial dispatch: the slots freed by arrivals). Padding
        rows have zero counts, so they take no step, and are not in
        ``client_idx``. With ``width == cohort`` this stages
        ``_stage_cohort``'s bytes."""
        cfg = self.cfg
        if tracer is None:
            tracer = telemetry.get_tracer() or telemetry.NULL_TRACER
        with tracer.span("stage", round_idx, width=width):
            sampler = fast_client_sampling if cfg.fast_sampling else client_sampling
            idx = sampler(round_idx, self.dataset.client_num, cohort)[:width]
            faults = chaos.events(round_idx, len(idx)) if chaos is not None else None
            x, y, counts = self.dataset.train.select(idx)
            if faults is not None:
                x = apply_faults(faults, x)
            if counts.shape[0] < cohort:
                x, y, counts = pad_clients(x, y, counts, cohort)
        with tracer.span("h2d", round_idx):
            (dx, dy, dc, _), ready, pinned = stage_to_device(
                x, y, counts, None, self.device, self._h2d_stream)
        return StagedCohort(round_idx, dx, dy, dc, None, faults, idx, ready, pinned)

    # ------------------------------------------------- the superstep loop
    def _resident_train_arrays(self):
        """(x, y, counts) of the whole train store on the device, made
        once; None when the store cannot be resident (streaming, or over
        the byte budget), and the drive then runs the eager loop."""
        if self._resident_train is None:
            from fedml_tpu_torch.data.packed_store import resident_train_arrays

            res = resident_train_arrays(self.dataset.train, self.device)
            self._resident_train = res if res is not None else ()
        return self._resident_train or None

    def _superstep_fn(self, num_rounds: int, chaos_armed: bool):
        """The K-round superstep for this (K, chaos), built once."""
        key = (num_rounds, chaos_armed)
        fn = self._superstep_cache.get(key)
        if fn is None:
            from fedml_tpu_torch.algorithms.engine import build_superstep_fn

            fn = build_superstep_fn(self.trainer, self.cfg, self.aggregator,
                                    num_rounds,
                                    client_num_in_total=self.dataset.client_num,
                                    chaos_armed=chaos_armed, collect_stats=True)
            self._superstep_cache[key] = fn
        return fn

    def _superstep_k(self, round_idx: int, ckpt_dir, ckpt_every: int) -> int:
        """The rounds the next dispatch may take: up to
        ``cfg.rounds_per_dispatch``, cut so that an eval round or a
        checkpoint round ends its dispatch (both read the model after that
        round). 1 means the next round is such a boundary and runs
        eagerly."""
        cfg = self.cfg
        k_max = min(cfg.rounds_per_dispatch, cfg.comm_round - round_idx)
        for j in range(k_max):
            r = round_idx + j
            if (self._is_test_round(r)
                    or (ckpt_dir and (r + 1) % ckpt_every == 0)):
                return j + 1
        return k_max

    def _train_superstep(self, start_round, ckpt_dir, ckpt_every,
                         metrics_logger, chaos, guard, tracer, ledger=None) -> None:
        """The superstep loop (``cfg.rounds_per_dispatch`` K > 1): up to K
        rounds a dispatch (``engine.build_superstep_fn``), their cohorts
        gathered on the device from the resident train store, the chaos
        masks sent as [K, C] tensors, each round on the eager round's
        generator, so the globals, the aggregator state (moments, codec
        residuals) and the records are the eager loop's bit for bit. The K
        records flush with one transfer.

        A streaming or over-budget store, or chaos on integer inputs
        (whose faults depend on the data, on the host), runs the eager
        loop instead, with a warning. A guard rejection inside a dispatch
        rolls the whole chunk back and replays it eagerly, one round at a
        time, with the eager loop's retries."""
        cfg = self.cfg
        resident = self._resident_train_arrays()
        reason = None
        if resident is None:
            reason = "train store is streaming or over the resident byte budget"
        elif chaos is not None and not resident[0].is_floating_point():
            reason = ("chaos faults on integer inputs are data-dependent on the "
                      "host and cannot be replayed in-graph")
        if reason is not None:
            log.warning("superstep (rounds_per_dispatch=%d) unavailable: %s — "
                        "running the eager loop", cfg.rounds_per_dispatch, reason)
            self._train_eager(start_round, ckpt_dir, ckpt_every, metrics_logger,
                              chaos, guard, tracer, ledger)
            return
        records = self._records(tracer, metrics_logger, ledger)
        round_idx = start_round
        while round_idx < cfg.comm_round:
            k = self._superstep_k(round_idx, ckpt_dir, ckpt_every)
            if k == 1:
                round_idx = self._eager_round(
                    round_idx, records, chaos=chaos, guard=guard, tracer=tracer,
                    ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)
            else:
                round_idx = self._superstep_chunk(
                    round_idx, k, records, resident, chaos=chaos, guard=guard,
                    tracer=tracer, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)

    def _superstep_inputs(self, r0: int, k: int, chaos) -> tuple:
        """The host half of a K-round dispatch: (per_round with its device
        tensors, the host cohorts [K, C], each round's FaultEvents or
        None). The cohorts are drawn here, as the eager loop draws them,
        and sent to the device once a dispatch."""
        cfg = self.cfg
        n_total = self.dataset.client_num
        cohort = min(cfg.client_num_per_round, n_total)
        rounds = list(range(r0, r0 + k))
        sampler = fast_client_sampling if cfg.fast_sampling else client_sampling
        idx_block = np.stack([sampler(r, n_total, cfg.client_num_per_round)
                              for r in rounds]).astype(np.int64)
        counts = np.asarray(self.dataset.train.counts)
        per_round = {"round_idx": rounds, "host_counts": counts[idx_block]}
        device_parts = {"idx": idx_block}
        faults_list = None
        if chaos is not None:
            faults_list, masks = chaos.events_block(r0, k, cohort)
            device_parts.update(masks)
        for name, a in device_parts.items():
            per_round[name] = to_device(torch.from_numpy(np.ascontiguousarray(a)),
                                        self.device)
        return per_round, idx_block, faults_list

    def _superstep_chunk(self, r0, k, records, resident, *, chaos, guard,
                         tracer, ckpt_dir, ckpt_every) -> int:
        """One K-round dispatch: the host inputs, the dispatch, the guard's
        verdict on each round, then K records (or the chunk rolled back and
        replayed eagerly). Returns r0 + k."""
        cfg = self.cfg
        rollback = False
        with tracer.round(r0) as rspan:
            with tracer.span("stage", r0, rounds=k):
                per_round, idx_block, faults_list = self._superstep_inputs(
                    r0, k, chaos)
            snapshot = guard_state = None
            if guard is not None:
                snapshot = self._snapshot()
                # the guard is stateful (its loss window): a replay must
                # inspect from the same state
                guard_state = copy.deepcopy(vars(guard))
            superstep = self._superstep_fn(k, chaos is not None)
            with tracer.span("dispatch", r0, rounds=k):
                new_gv, new_st, metrics, stats = superstep(
                    self.global_variables, self.agg_state, *resident, per_round,
                    stats=self._drive_ledger is not None)
            with tracer.span("device_wait", r0):
                synchronize(self.device)
            if guard is not None:
                with tracer.span("metrics_fetch", r0):
                    names = list(metrics)
                    host = torch.stack([metrics[n].double() for n in names]).cpu()
                for j in range(k):
                    r = r0 + j
                    m_j = {n: float(host[i, j]) for i, n in enumerate(names)}
                    total = max(m_j.get("total", 1.0), 1.0)
                    loss = m_j.get("loss_sum", 0.0) / total
                    # the chunk's final globals stand for round j's: a
                    # non-finite value persists, and the eager replay then
                    # finds the round
                    with tracer.span("guard_verdict", r):
                        verdict = guard.inspect(r, loss, new_gv)
                    tracer.event("guard_verdict", round=r, ok=verdict.ok,
                                 reason=verdict.reason)
                    if not verdict.ok:
                        rollback = True
                        log.warning("guard: %s at round %d inside a %d-round "
                                    "superstep — chunk rolled back, replaying "
                                    "eagerly to localize", verdict.reason, r, k)
                        tracer.event("guard_rollback", round=r, retry=0)
                        self._ckpt_load(*snapshot)
                        guard.__dict__.update(guard_state)
                        break
            if not rollback:
                self.global_variables, self.agg_state = new_gv, new_st
                elapsed = rspan.elapsed()
                for j in range(k):
                    r = r0 + j
                    record = {"round": r, "round_time": elapsed / k,
                              **{n: v[j] for n, v in metrics.items()}}
                    if stats is not None:
                        participated = (np.asarray(faults_list[j].participation, bool)
                                        if faults_list is not None
                                        else np.ones(idx_block.shape[1], bool))
                        record["_ledger"] = [{"round": r, "client_idx": idx_block[j],
                                              "participated": participated,
                                              "stats": {n: v[j] for n, v in stats.items()}}]
                    if faults_list is not None:
                        record.update(chaos_summary(faults_list[j]))
                    if j == k - 1 and self._is_test_round(r):
                        with tracer.span("eval", r):
                            record.update(self.local_test_on_all_clients(r))
                            record.update(self.test_global(r))
                    records.add(record)
                records.flush(r0 + k - 1)
                tracer.event("superstep_committed", round=r0, rounds=k,
                             k=cfg.rounds_per_dispatch)
                if ckpt_dir and (r0 + k) % ckpt_every == 0:
                    with tracer.span("checkpoint", r0 + k - 1):
                        self.save_checkpoint(ckpt_dir, r0 + k)
        if rollback:
            r = r0
            while r < r0 + k:
                r = self._eager_round(r, records, chaos=chaos, guard=guard,
                                      tracer=tracer, ckpt_dir=ckpt_dir,
                                      ckpt_every=ckpt_every)
        return r0 + k

    def _train_pipelined(self, start_round, ckpt_dir, ckpt_every,
                         metrics_logger, chaos, guard, tracer, ledger=None) -> None:
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
        the salted generator, as in the eager loop.

        Personalized, a round's personal rows are gathered when it is taken
        from the prefetcher, after the record log has flushed the previous
        rounds' ``_bank`` scatters: its cohort was staged before those
        writes (read after write), and the eager loop's order of writes and
        reads is kept, so the two loops agree bit for bit."""
        cfg = self.cfg
        depth = cfg.pipeline_depth
        prefetcher = CohortPrefetcher(
            lambda r: self.stage_fn(r, chaos=chaos), depth=depth)
        self._last_prefetcher = prefetcher
        records = self._records(tracer, metrics_logger, ledger)
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
                    if self._personalized:
                        records.flush(round_idx)
                    self._gather_personal(staged, tracer)
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
                                 guard, retries, records, tracer,
                                 self._round_blocks(round_idx))
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
    # moments) and the history. Under LoRA the globals are stored adapters
    # only: the frozen base is a pure function of cfg.seed, and resume and
    # rollback re-attach the live one.
    def _ckpt_tree(self):
        return {"variables": strip_lora_base(self.global_variables),
                "agg_state": self.agg_state}

    def _ckpt_meta(self):
        # a copy: the snapshot must not alias the list a later flush extends
        return {"history": list(self.history)}

    def _snapshot(self):
        """The guard's pre-round state. Cloned: unlike JAX arrays, tensors
        can be written in place, and a round that did so would otherwise
        corrupt the state a rollback restores."""
        return tree_map(torch.clone, self._ckpt_tree()), self._ckpt_meta()

    def _ckpt_load(self, tree, meta):
        self.global_variables = attach_lora_base(tree["variables"], self.global_variables)
        self.agg_state = tree["agg_state"]
        # in place: the drive loop's RoundRecordLog holds this list
        self.history[:] = meta.get("history", [])

    # ------------------------------------------------------------------- eval
    def test_global(self, round_idx: int) -> dict[str, float]:
        return test_metrics(self.eval_fn, self.global_variables, self._test_batches)

    def personalization_lift(self, round_idx: int, probe: int = 64) -> dict[str, float]:
        """The accuracy lift of the personalized model over the global one
        on a sampled probe cohort: each probe client evaluates on its test
        split under the globals plus its personal row AND under the bare
        globals; the per-client difference goes to the bank's lift column
        and its mean is logged as ``Personalization/Lift``. O(probe) reads
        and work. {} when the run does not personalize."""
        if self.bank is None or not self.cfg.personalize:
            return {}
        ds = self.dataset
        idx = client_sampling(round_idx, ds.client_num, min(probe, ds.client_num))
        rows = self._bank_rows(idx)
        x, y, counts = (torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                        for a in (ds.test or ds.train).select(idx))
        personal = {k: torch.from_numpy(a).to(self.device)
                    for k, a in self.bank.gather(rows).items()}
        m_p = self._personal_eval_fn(self.global_variables, personal, x, y, counts)
        m_g = self.client_eval_fn(self.global_variables, x, y, counts)
        correct_p, correct_g, total = (m[k].double().cpu().numpy() for m, k in (
            (m_p, "test_correct"), (m_g, "test_correct"), (m_g, "test_total")))
        lift = (correct_p - correct_g) / np.maximum(total, 1.0)
        self.bank.write_lift(rows, lift)
        return {"Personalization/Lift": float(lift.mean())}

    def local_test_on_all_clients(self, round_idx: int) -> dict[str, float]:
        """The global model on every client's train and test split,
        sample-weighted (reference fedavg_api.py:119-183); CI mode
        evaluates one client. Each forward pass takes whole clients, their
        padded rows masked, as the JAX drive's vmap over clients does: the
        NWP trainer's reported loss is a per-client quantity.

        With ``cfg.resident_eval`` (the default) the splits are staged on
        the device once a run (``_resident_eval_data``) and each split
        evaluates from there (``engine.build_federation_eval_fn``): between
        evals only the globals change. CI mode, a streaming split and
        splits over ``cfg.resident_eval_budget`` stage chunks from the host
        at every eval (``_client_chunks``), with the same chunks and the
        same sums. Either way the sums come back in one transfer a split."""
        ds = self.dataset
        splits = (("Train", ds.train), ("Test", ds.test or ds.train))
        resident = None if self.cfg.ci else self._resident_eval_data(splits)
        out = {}
        for split_name, packed in splits:
            chunks = [resident[split_name]] if resident else self._client_chunks(packed)
            sums = None
            for chunk in chunks:
                m = self._fed_eval_fn(self.global_variables, *chunk)
                sums = m if sums is None else {k: sums[k] + m[k] for k in m}
            sums = self._fetch(sums)
            total = max(sums.get("test_total", 0.0), 1.0)
            out[f"{split_name}/Acc"] = sums.get("test_correct", 0.0) / total
            out[f"{split_name}/Loss"] = sums.get("test_loss", 0.0) / total
        return out

    def _resident_eval_data(self, splits):
        """{split name: (xs [nc, k * n_max, ...], ys, counts [nc, k])} on the
        device, staged once a run in ``_client_chunks``' geometry (the JAX
        drive's ``_resident_eval_data``); None when ``cfg.resident_eval`` is
        off, a split streams (staging it would decode it whole), or the
        staged bytes exceed ``cfg.resident_eval_budget``. An in-budget
        ``MmapPackedStore`` is read once through ``materialize``."""
        if not self.cfg.resident_eval:
            return None
        if self._resident_cache is not None:
            return self._resident_cache or None  # {}: refused before
        uniq = {id(p): p for _, p in splits}  # the test split may be the train split
        if not all(isinstance(p.x, np.ndarray) or isinstance(p, MmapPackedStore)
                   for p in uniq.values()):
            log.info("resident_eval disabled: streaming (lazy-decode) split — "
                     "using chunked eval")
            self._resident_cache = {}
            return None
        chunk = {key: self._eval_chunk(p) for key, p in uniq.items()}

        def staged_bytes(key, p):
            # what staging puts on the device: padded to a chunk multiple
            ratio = (-(-p.num_clients // chunk[key]) * chunk[key]) / p.num_clients
            return (p.x.nbytes + p.y.nbytes + np.asarray(p.counts).nbytes) * ratio

        total = sum(staged_bytes(key, p) for key, p in uniq.items())
        if total > self.cfg.resident_eval_budget:
            log.warning("resident_eval disabled: packed splits are %.1f GiB > budget "
                        "%.1f GiB — falling back to chunked streaming eval",
                        total / 2 ** 30, self.cfg.resident_eval_budget / 2 ** 30)
            self._resident_cache = {}
            return None
        staged = {key: self._stage_split(p, chunk[key]) for key, p in uniq.items()}
        self._resident_cache = {name: staged[id(p)] for name, p in splits}
        self.resident_eval_bytes = int(total)
        return self._resident_cache

    def _stage_split(self, packed, k: int) -> tuple:
        """A whole split on the device as [nc, k * n_max, ...] chunks of k
        clients (the last padded with empty clients) and its counts [nc, k]."""
        if isinstance(packed, MmapPackedStore):
            packed = materialize(packed, budget=self.cfg.resident_eval_budget)
        n, n_max = packed.num_clients, packed.n_max
        nc = -(-n // k)
        out = []
        for a in (packed.x, packed.y, packed.counts):
            t = torch.from_numpy(np.ascontiguousarray(a))
            padded = t.new_zeros((nc * k,) + t.shape[1:], device=self.device)
            padded[:n].copy_(t)
            out.append(padded)
        xs, ys, counts = out
        return (xs.reshape((nc, k * n_max) + tuple(xs.shape[2:])),
                ys.reshape((nc, k * n_max) + tuple(ys.shape[2:])), counts.reshape(nc, k))

    def _eval_chunk(self, packed) -> int:
        """Clients a forward pass of the eval takes: at most _EVAL_ROWS rows
        and _EVAL_LOGITS logits (one client in CI mode)."""
        num = 1 if self.cfg.ci else packed.num_clients
        per_row = self.dataset.class_num * int(np.prod(packed.y.shape[2:], dtype=np.int64))
        rows = min(_EVAL_ROWS, _EVAL_LOGITS // max(per_row, 1))
        return max(1, min(num, rows // max(packed.n_max, 1)))

    def _client_chunks(self, packed):
        """(x [1, k * n_max, ...], y, counts [1, k]) on the device for each run
        of k clients of a split, the last run padded with empty clients: one
        chunk at a time in the resident eval's layout."""
        num = 1 if self.cfg.ci else packed.num_clients
        n_max = packed.n_max
        k = self._eval_chunk(packed)
        budget = getattr(packed, "byte_budget", None)
        if budget is not None:
            # a streaming split decodes a chunk at a time, never the whole
            # split (the JAX drive's rule: no resident eval of a lazy store),
            # and a chunk's rows all stay pinned in its LRU at once
            k = max(1, min(k, budget // packed.row_bytes()))
            log.info("eval of a streaming (lazy-decode) split: chunked, %d clients a "
                     "chunk under its %d MiB budget", k, budget >> 20)
        for start in range(0, num, k):
            x, y, counts = packed.select(np.arange(start, min(start + k, num)))
            x, y, counts = pad_clients(x, y, counts, k)
            yield tuple(torch.from_numpy(np.ascontiguousarray(
                a.reshape((1, k * n_max) + a.shape[2:]) if a.ndim > 1 else a.reshape(1, k)))
                .to(self.device) for a in (x, y, counts))


def _pad_to(mask: np.ndarray, n: int) -> np.ndarray:
    """A cohort's bool mask padded with False to the padded cohort's n rows."""
    return np.concatenate([mask, np.zeros(n - len(mask), bool)])
