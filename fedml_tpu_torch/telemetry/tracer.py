"""Phase spans, gauges and a structured event ledger for the drive loop
(PyTorch form of ``fedml_tpu/telemetry/tracer.py``; the event schemas,
record layout and ``TRACE.jsonl`` format are the JAX package's, so the two
packages' traces read the same).

- **spans**: named monotonic-clock intervals (``stage``, ``h2d``,
  ``dispatch``, ``device_wait``, ``metrics_fetch``, ``eval``,
  ``checkpoint``, ``guard_verdict``, ...) per round, from any thread. A
  span brackets host calls; on the card, work those calls queue may still
  run after the span closes, and ``device_wait`` is the span that waits
  for it.
- **events**: schema-checked ledger entries (chaos injections, guard
  verdicts and rollbacks, committed round records, checkpoints), written
  and flushed to the JSONL sink the moment they occur, so a crash mid-run
  cannot lose what already happened.
- **gauges**: free-form instantaneous measurements (pipeline occupancy)
  with no cross-mode equality contract.

Sinks: an in-memory store (summary tables, tests), an optional JSONL file
(``TRACE.jsonl``, one flushed line per record, rotated past ``max_bytes``),
an optional metrics logger (per-round ``trace/<phase>_s`` keys), and an
optional ``torch.profiler`` window (``profile_rounds="A:B"`` captures rounds
[A, B) into a Chrome trace in ``profile_dir``).

Module-level seam: collaborators that carry no tracer argument (the chaos
harness, the prefetcher, checkpoints) call ``telemetry.emit(...)`` /
``telemetry.gauge(...)``, which route to the installed tracer and do
nothing when none is installed. ``FedAvgAPI.train`` installs its tracer
for the drive.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger(__name__)

# ----------------------------------------------------------------- schemas

#: Stable event ledger schemas: kind -> required field names, the JAX
#: package's table whole, kinds of its unported modules included. Extra
#: fields are allowed; a missing required field or an unknown kind is a
#: ValueError at emit time.
EVENT_SCHEMAS: Dict[str, set] = {
    # chaos harness (robustness/chaos.py): one per FaultPlan.events() call
    "chaos_inject": {"round", "dropped", "nan", "corrupt"},
    # round guard (robustness/guard.py + drive loop)
    "guard_verdict": {"round", "ok", "reason"},
    "guard_rollback": {"round", "retry"},
    "guard_exhausted": {"round"},
    # unified record path (telemetry/records.py): the history record landed
    "round_committed": {"round"},
    # superstep drive (algorithms/fedavg.py): one fused K-round dispatch
    # committed — `round` is the chunk's first round, `rounds` how many it
    # fused (k_eff after cadence clamping), `k` the configured ceiling
    "superstep_committed": {"round", "rounds", "k"},
    # checkpointing (utils/checkpoint.py)
    "checkpoint_save": {"step"},
    # self-healing comms (comm/mqtt.py)
    "mqtt_reconnect": {"client_id", "ok", "attempts"},
    # persistent compile cache (the JAX package's utils/cache.py)
    "compile_cache": {"name"},
    # round-program construction (algorithms/engine.py)
    "round_fn_built": {"program", "donate"},
    # buffered aggregation (algorithms/buffered.py): one per admitted client
    # update (`fill` = buffer occupancy after the admit) and one per buffer
    # commit (`size` = rows committed, staleness in dispatch rounds)
    "update_admitted": {"round", "birth", "fill"},
    "buffer_committed": {"round", "size", "staleness_p50", "staleness_max"},
    # data plane download retries (data/acquire.py), mirroring mqtt_reconnect
    "download_retry": {"attempt", "status", "backoff_s"},
    # JSONL sink rotation (--trace_max_mb): last record of a retired segment
    # names its archive file, so fold() can chain segments back together
    "trace_rotated": {"rotated_to", "segment", "bytes"},
    # client-health fleet report (tools/client_report.py): one per flagged
    # client — quarantine recidivist or update-norm z-score outlier
    "client_flagged": {"client", "reason", "value"},
    # serving plane (serving/scheduler.py): a tenant job ran its full round
    # budget (drain included) and left the queue
    "job_committed": {"job", "rounds", "wall_s"},
    # overload robustness: checkpointed preemption — a tenant
    # was snapshotted off the mesh (`round` = its next round when it
    # resumes) and later restored byte-identically
    "job_evicted": {"job", "round", "reason"},
    "job_resumed": {"job", "round"},
    # admission control: a submission bounced (reason "queue_full"), a
    # queued tenant was shed for a latency-bound arrival (reason "shed"),
    # or a caller cancelled it (reason "cancelled")
    "job_rejected": {"job", "reason", "slo"},
    # SLO ledger: a tenant finished past its declared deadline_s (measured
    # telemetry only — never a scheduling input, so picks stay replayable)
    "deadline_miss": {"job", "deadline_s", "latency_s"},
}


# --------------------------------------------------------- job labeling
# The serving plane multiplexes N tenant jobs through ONE tracer; every
# record written while a job_scope is active carries a "job" field so
# TRACE.jsonl lines and --trace_summary can be split per tenant. Thread-
# local on purpose: the prefetcher's staging thread enters its own scope
# for the job it is staging, independent of what the scheduler thread is
# dispatching.
_JOB_CTX = threading.local()


def current_job() -> Optional[str]:
    """The active job label on THIS thread, or None outside any scope."""
    return getattr(_JOB_CTX, "label", None)


@contextmanager
def job_scope(label: Optional[str]):
    """Tag every span/event/gauge recorded on this thread with `label`.
    Nests (innermost wins, restored on exit); `label=None` clears."""
    prev = getattr(_JOB_CTX, "label", None)
    _JOB_CTX.label = label
    try:
        yield
    finally:
        _JOB_CTX.label = prev


def _thread_label() -> str:
    name = threading.current_thread().name
    return "stager" if name.startswith("cohort-prefetch") else "main"


class _SpanHandle:
    """Live span: open time is queryable before the span closes (the drive
    loop reads `elapsed()` for the history record's `round_time` while the
    round span is still open)."""

    __slots__ = ("_tracer", "t0")

    def __init__(self, tracer: "Tracer", t0: float):
        self._tracer = tracer
        self.t0 = t0

    def elapsed(self) -> float:
        return self._tracer.now() - self.t0


class Tracer:
    """Thread-safe span/event/gauge recorder with pluggable clock and sinks.

    `clock` is injectable (tests drive a fake monotonic clock);
    `jsonl_path` enables the durable sink (every record is written and
    flushed immediately); `metrics_logger` mirrors per-round phase totals
    as `trace/<phase>_s` through the wandb-compatible seam;
    `profile_rounds="A:B"` + `profile_dir` arm a `torch.profiler` window
    capturing rounds [A, B) into `profile_dir/rounds_A_B.json` (a Chrome
    trace; CUDA activity included when the card is there).
    """

    def __init__(self, jsonl_path: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None,
                 metrics_logger=None,
                 profile_rounds: Optional[str] = None,
                 profile_dir: Optional[str] = None,
                 run_meta: Optional[Dict[str, Any]] = None,
                 mode: str = "w",
                 max_bytes: Optional[int] = None):
        self._clock = clock or time.perf_counter
        self._lock = threading.Lock()
        self.spans: List[Dict[str, Any]] = []
        self.events: List[Dict[str, Any]] = []
        self.gauges: List[Dict[str, Any]] = []
        self._metrics_logger = metrics_logger
        self._round_phase_acc: Dict[int, Dict[str, float]] = {}
        self._profile_window = (parse_profile_rounds(profile_rounds)
                                if profile_rounds else None)
        self._profile_dir = profile_dir or os.path.join(
            tempfile.gettempdir(), "fedml_tpu_torch_trace")
        self._profiler = None
        self._file = None
        self._jsonl_path = jsonl_path
        self._max_bytes = max_bytes
        self._bytes = 0
        self._segment = 0
        if jsonl_path:
            parent = os.path.dirname(jsonl_path)
            if parent:  # ckpt_dir may not exist until the first save
                os.makedirs(parent, exist_ok=True)
            self._file = open(jsonl_path, mode)
            if mode == "a" and os.path.exists(jsonl_path):
                self._bytes = os.path.getsize(jsonl_path)
        self._meta_rec = {"type": "meta", "version": 1, "clock": "monotonic",
                          **(run_meta or {})}
        self._write(self._meta_rec)

    # ------------------------------------------------------------- plumbing
    def now(self) -> float:
        """The tracer's monotonic clock, the one clock a drive loop reads."""
        return self._clock()

    def _write(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if self._file is not None:
                line = json.dumps(rec, default=float) + "\n"
                self._file.write(line)
                self._file.flush()  # durable the moment it happened
                self._bytes += len(line)
                if self._max_bytes and self._bytes >= self._max_bytes:
                    self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Retire the live JSONL segment (caller holds self._lock): archive
        it as `<path>.NNN`, reopen fresh, and re-write the meta record so
        every segment is self-describing. The `trace_rotated` event is
        appended to the retired file FIRST (its last line names the archive
        it becomes), then constructed directly — calling self.event() here
        would deadlock on the non-reentrant lock."""
        archive = f"{self._jsonl_path}.{self._segment:03d}"
        rec = {"type": "event", "kind": "trace_rotated", "t": self.now(),
               "thread": _thread_label(), "rotated_to": archive,
               "segment": self._segment, "bytes": self._bytes}
        line = json.dumps(rec, default=float) + "\n"
        self._file.write(line)
        self._file.flush()
        self._file.close()
        os.replace(self._jsonl_path, archive)
        self.events.append(rec)
        self._segment += 1
        self._file = open(self._jsonl_path, "w")
        meta_line = json.dumps(self._meta_rec, default=float) + "\n"
        self._file.write(meta_line)
        self._file.flush()
        self._bytes = len(meta_line)

    # ---------------------------------------------------------------- spans
    @contextmanager
    def span(self, name: str, round_idx: Optional[int] = None, **attrs):
        t0 = self.now()
        handle = _SpanHandle(self, t0)
        try:
            yield handle
        finally:
            dur = self.now() - t0
            rec = {"type": "span", "name": name, "round": round_idx,
                   "thread": _thread_label(), "t0": t0, "dur_s": dur}
            job = current_job()
            if job is not None:
                rec["job"] = job
            if attrs:
                rec.update(attrs)
            with self._lock:
                self.spans.append(rec)
                if (self._metrics_logger is not None and round_idx is not None
                        and name not in ("round", "drive")):
                    acc = self._round_phase_acc.setdefault(round_idx, {})
                    acc[name] = acc.get(name, 0.0) + dur
            self._write(rec)

    @contextmanager
    def round(self, round_idx: int):
        """One drive-loop round: the parent span every phase nests under,
        plus the `torch.profiler` window trigger and the metrics-logger
        phase-total flush."""
        self._profile_edge(round_idx, starting=True)
        try:
            with self.span("round", round_idx) as handle:
                yield handle
        finally:
            self._profile_edge(round_idx, starting=False)
            self._flush_phase_totals(round_idx)

    def _flush_phase_totals(self, round_idx: int) -> None:
        if self._metrics_logger is None:
            return
        with self._lock:
            acc = self._round_phase_acc.pop(round_idx, None)
        if acc:
            self._metrics_logger.log(
                {f"trace/{name}_s": round(dur, 6) for name, dur in acc.items()},
                step=round_idx)

    def _profile_edge(self, round_idx: int, starting: bool) -> None:
        if self._profile_window is None:
            return
        lo, hi = self._profile_window
        if starting and round_idx == lo and self._profiler is None:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
        elif not starting and round_idx == hi - 1 and self._profiler is not None:
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        """End the profiler window and write its Chrome trace."""
        prof, self._profiler = self._profiler, None
        prof.stop()
        lo, hi = self._profile_window
        os.makedirs(self._profile_dir, exist_ok=True)
        path = os.path.join(self._profile_dir, f"rounds_{lo}_{hi}.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace of rounds [%d, %d) written to %s", lo, hi, path)

    # --------------------------------------------------------------- events
    def event(self, kind: str, **fields) -> None:
        """Ledger entry, persisted (flushed) the moment it occurs."""
        required = EVENT_SCHEMAS.get(kind)
        if required is None:
            raise ValueError(
                f"unknown telemetry event kind {kind!r}; known: "
                f"{sorted(EVENT_SCHEMAS)}")
        missing = required - fields.keys()
        if missing:
            raise ValueError(
                f"event {kind!r} missing required field(s) {sorted(missing)}")
        rec = {"type": "event", "kind": kind, "t": self.now(),
               "thread": _thread_label(), **fields}
        job = current_job()
        if job is not None and "job" not in rec:
            rec["job"] = job
        with self._lock:
            self.events.append(rec)
        self._write(rec)

    def gauge(self, name: str, **fields) -> None:
        """Instantaneous measurement (pipeline occupancy etc.) — no schema,
        no cross-mode equality contract."""
        rec = {"type": "gauge", "name": name, "t": self.now(),
               "thread": _thread_label(), **fields}
        job = current_job()
        if job is not None and "job" not in rec:
            rec["job"] = job
        with self._lock:
            self.gauges.append(rec)
        self._write(rec)

    # ------------------------------------------------------------ accessors
    def find_spans(self, name: Optional[str] = None,
                   round_idx: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            return [s for s in self.spans
                    if (name is None or s["name"] == name)
                    and (round_idx is None or s["round"] == round_idx)]

    def find_events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            return [e for e in self.events
                    if kind is None or e["kind"] == kind]

    # -------------------------------------------------------------- summary
    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-phase {count, total_s, p50_s, p95_s} over all recorded spans."""
        by_name: Dict[str, List[float]] = {}
        with self._lock:
            for s in self.spans:
                by_name.setdefault(s["name"], []).append(s["dur_s"])
        out = {}
        for name, durs in sorted(by_name.items()):
            durs = sorted(durs)
            out[name] = {
                "count": len(durs),
                "total_s": sum(durs),
                "p50_s": durs[len(durs) // 2],
                "p95_s": durs[min(len(durs) - 1, int(len(durs) * 0.95))],
            }
        return out

    def gauge_summary(self) -> Dict[str, Dict[str, Any]]:
        """Per-gauge-name {count, last, total} over all recorded gauges.
        `last` is the latest record's payload (minus type/name/t/thread);
        `total` sums each numeric payload field across records — e.g. the
        store residency gauges (store_decode_hit / store_decode_miss /
        store_resident_bytes, emitted per select() by the streaming and
        mmap stores) fold into whole-drive hit/miss totals here."""
        drop = {"type", "name", "t", "thread"}
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            gauges = list(self.gauges)
        for g in gauges:
            st = out.setdefault(g["name"], {"count": 0, "last": {},
                                            "total": {}})
            st["count"] += 1
            payload = {k: v for k, v in g.items() if k not in drop}
            st["last"] = payload
            for k, v in payload.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    st["total"][k] = st["total"].get(k, 0) + v
        return out

    def job_summary(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """Per-job per-phase {count, total_s} over spans carrying a `job`
        label (serving tenants); {} when no labeled spans were recorded."""
        out: Dict[str, Dict[str, Dict[str, float]]] = {}
        with self._lock:
            spans = list(self.spans)
        for s in spans:
            job = s.get("job")
            if job is None:
                continue
            st = out.setdefault(job, {}).setdefault(
                s["name"], {"count": 0, "total_s": 0.0})
            st["count"] += 1
            st["total_s"] += s["dur_s"]
        return out

    def summary_table(self) -> str:
        """The --trace_summary human table: per-phase span percentiles,
        then a gauges section (count + folded totals + last payload),
        then — when serving-plane job labels are present — a per-tenant
        phase breakdown."""
        rows = [f"{'phase':<16} {'count':>6} {'total_s':>10} "
                f"{'p50_ms':>9} {'p95_ms':>9}"]
        for name, st in self.summary().items():
            rows.append(f"{name:<16} {st['count']:>6d} {st['total_s']:>10.4f} "
                        f"{st['p50_s'] * 1e3:>9.3f} {st['p95_s'] * 1e3:>9.3f}")
        gauges = self.gauge_summary()
        if gauges:
            rows.append("")
            rows.append(f"{'gauge':<24} {'count':>6}  totals / last")
            for name, st in sorted(gauges.items()):
                totals = " ".join(f"{k}={v}" for k, v in st["total"].items())
                last = " ".join(f"{k}={v}" for k, v in st["last"].items()
                                if k not in st["total"])
                detail = "  ".join(p for p in (totals, last) if p)
                rows.append(f"{name:<24} {st['count']:>6d}  {detail}")
        jobs = self.job_summary()
        if jobs:
            rows.append("")
            rows.append(f"{'job':<20} {'phase':<16} {'count':>6} "
                        f"{'total_s':>10}")
            for job, phases in sorted(jobs.items()):
                for name, st in sorted(phases.items()):
                    rows.append(f"{job:<20} {name:<16} {st['count']:>6d} "
                                f"{st['total_s']:>10.4f}")
        return "\n".join(rows)

    # ---------------------------------------------------------------- close
    def close(self) -> None:
        if self._profiler is not None:
            self._stop_profiler()
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullTracer:
    """Drop-everything tracer: the default when nothing is installed, so
    instrumented call sites never branch on `tracer is None`."""

    @contextmanager
    def span(self, name, round_idx=None, **attrs):
        yield _NULL_HANDLE

    @contextmanager
    def round(self, round_idx):
        yield _NULL_HANDLE

    def now(self) -> float:
        return time.perf_counter()

    def event(self, kind, **fields):
        pass

    def gauge(self, name, **fields):
        pass

    def close(self):
        pass


class _NullSpanHandle:
    def elapsed(self) -> float:
        return 0.0


_NULL_HANDLE = _NullSpanHandle()
NULL_TRACER = NullTracer()


def parse_profile_rounds(spec: str) -> tuple:
    """'A:B' -> (A, B): profile rounds A..B-1 (half-open, like range)."""
    try:
        lo, hi = (int(p) for p in spec.split(":"))
    except (ValueError, AttributeError) as e:
        raise ValueError(
            f"--profile_rounds wants 'A:B' (half-open round window), "
            f"got {spec!r}") from e
    if hi <= lo or lo < 0:
        raise ValueError(f"--profile_rounds window {spec!r} is empty")
    return lo, hi


# ----------------------------------------------- installed-tracer seam
_ACTIVE: List[Tracer] = []
_ACTIVE_LOCK = threading.Lock()


def install(tracer: Tracer) -> None:
    """Make `tracer` the destination for module-level emit()/gauge() calls
    (chaos, guard, mqtt, cache, prefetch). Stack discipline: the innermost
    install wins; uninstall() pops."""
    with _ACTIVE_LOCK:
        _ACTIVE.append(tracer)


def uninstall(tracer: Tracer) -> None:
    with _ACTIVE_LOCK:
        if tracer in _ACTIVE:
            _ACTIVE.remove(tracer)


def get_tracer() -> Optional[Tracer]:
    with _ACTIVE_LOCK:
        return _ACTIVE[-1] if _ACTIVE else None


def emit(kind: str, **fields) -> None:
    """Event into the installed tracer; silent no-op when none is active."""
    tracer = get_tracer()
    if tracer is not None:
        tracer.event(kind, **fields)


def gauge(name: str, **fields) -> None:
    """Gauge into the installed tracer; silent no-op when none is active."""
    tracer = get_tracer()
    if tracer is not None:
        tracer.gauge(name, **fields)
