"""Fold a TRACE.jsonl into a BENCH-style report, and the perf-regression
gate: the port's copy of ``fedml_tpu/telemetry/report.py`` (plain Python;
the port imports nothing of the JAX package).

The port's tracer (``telemetry/tracer.py``) writes the JAX package's span
and event schemas, so ``fold()`` gives the JAX package's report on a trace
of either package. ``fold()`` turns a trace into the shape of JSON the
BENCH_*.json artifacts carry (rounds/s, per-phase p50/p95, span coverage,
event counts); ``run_gate()`` compares a measured rounds/s against a BENCH
baseline within a tolerance, skipping when the environments are not
comparable (platform or ``cpu_capped`` mismatch, a different workload);
``run_compile_gate()`` holds a trace's compile requests to a budget. The
port compiles no program (no JIT), so its traces carry no
``compile_cache`` events and that gate skips on them.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

#: Gate floor as a fraction of the baseline rounds/s. Deliberately loose
#: (0.5x): the CI drive is short and a shared box is noisy; the gate exists
#: to catch *silent structural* slowdowns (an accidental per-round host
#: sync, a dropped donation), not 5% jitter.
DEFAULT_TOLERANCE = 0.5

#: Workload keys that must match between the trace's run_meta and the BENCH
#: baseline for rounds/s to be comparable at all.
_WORKLOAD_KEYS = ("model", "clients", "clients_per_round", "batch_size")


def load_trace(path: str) -> List[Dict[str, Any]]:
    """Parse a TRACE.jsonl leniently: a run killed mid-write (OOM, SIGKILL
    during a chaos drive) leaves a truncated final line, and fold() crashing
    on it would lose the entire otherwise-valid trace. Unparseable lines are
    counted, not fatal; the count rides along as a synthetic
    `truncated_lines` record so fold() can surface it in the report."""
    records = []
    truncated = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                truncated += 1
    if truncated:
        records.append({"type": "truncated_lines", "count": truncated})
    return records


def _pcts(durs: List[float]) -> Dict[str, float]:
    durs = sorted(durs)
    return {
        "count": len(durs),
        "total_s": round(sum(durs), 6),
        "p50_s": round(durs[len(durs) // 2], 6),
        "p95_s": round(durs[min(len(durs) - 1, int(len(durs) * 0.95))], 6),
    }


def _union_len(intervals: List[Tuple[float, float]]) -> float:
    """Total length covered by possibly-overlapping [lo, hi) intervals."""
    total, cursor = 0.0, None
    for lo, hi in sorted(intervals):
        if cursor is None or lo > cursor:
            total += hi - lo
            cursor = hi
        elif hi > cursor:
            total += hi - cursor
            cursor = hi
    return total


def coverage(records: List[Dict[str, Any]]) -> float:
    """Fraction of total round wall-clock covered by the union of
    main-thread phase spans nested inside each `round` span — the
    acceptance bar is >= 0.95 (a drive loop whose time mostly falls
    *between* spans is a drive loop we still can't see into)."""
    rounds = [s for s in records
              if s.get("type") == "span" and s.get("name") == "round"]
    phases = [s for s in records
              if s.get("type") == "span" and s.get("thread") == "main"
              and s.get("name") not in ("round", "drive")]
    total = covered = 0.0
    for r in rounds:
        lo, hi = r["t0"], r["t0"] + r["dur_s"]
        total += r["dur_s"]
        windows = []
        for p in phases:
            if p.get("round") != r["round"]:
                continue
            plo, phi = max(p["t0"], lo), min(p["t0"] + p["dur_s"], hi)
            if phi > plo:
                windows.append((plo, phi))
        covered += _union_len(windows)
    return covered / total if total else 0.0


def fold(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """TRACE.jsonl records -> BENCH-style report dict."""
    meta = next((r for r in records if r.get("type") == "meta"), {})
    spans = [r for r in records if r.get("type") == "span"]
    events = [r for r in records if r.get("type") == "event"]

    by_name: Dict[str, List[float]] = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s["dur_s"])

    round_durs = by_name.get("round", [])

    event_counts: Dict[str, int] = {}
    for e in events:
        event_counts[e["kind"]] = event_counts.get(e["kind"], 0) + 1

    # The superstep drive fuses K rounds under ONE `round` span, so the
    # span count undercounts rounds K-fold there; round_committed events
    # (one per committed round, every drive) are the honest count.
    rounds = max(len(round_durs), event_counts.get("round_committed", 0))
    # Drive span total is the honest denominator (includes inter-round
    # work: final pipeline flush, end-of-drive checkpoint); fall back to
    # the round-span sum for partial traces.
    wall_s = sum(by_name.get("drive", [])) or sum(round_durs)
    rps = rounds / wall_s if wall_s else 0.0

    # XLA compile accounting from the forwarded jax.monitoring events (the
    # JAX package's utils/cache.py; a trace of the port has none): every
    # compilation fires one
    # /jax/compilation_cache/compile_requests_use_cache, then exactly one
    # of cache_hits / cache_misses. run_compile_gate checks `requests`
    # against the drive's COMPILE_BUDGET.json max_compiles ceiling.
    compile_events = [e for e in events if e.get("kind") == "compile_cache"]
    compile_counts = None
    if compile_events:
        def _tail(e):
            return str(e.get("name", "")).rsplit("/", 1)[-1]
        compile_counts = {
            "requests": sum(1 for e in compile_events
                            if _tail(e) == "compile_requests_use_cache"),
            "cache_hits": sum(1 for e in compile_events
                              if _tail(e) == "cache_hits"),
            "cache_misses": sum(1 for e in compile_events
                                if _tail(e) == "cache_misses"),
        }

    report = {
        "metric": "fedavg_drive_rounds_per_sec",
        "value": round(rps, 4),
        "unit": "rounds/s",
        "vs_baseline": None,
        "rounds": rounds,
        # jitted programs entered per round: 1.0 for the eager drive,
        # ~1/K under --rounds_per_dispatch K — the superstep's headline
        "dispatches_per_round": (
            round(len(by_name.get("dispatch", [])) / rounds, 4)
            if rounds else None),
        "wall_s": round(wall_s, 4),
        "coverage": round(coverage(records), 4),
        "phases": {name: _pcts(durs) for name, durs in sorted(by_name.items())},
        "events": dict(sorted(event_counts.items())),
        # graft-slo: deadline misses surfaced as a first-class counter so
        # an overload run's SLO health is readable without grepping events
        "deadline_misses": event_counts.get("deadline_miss", 0),
        # lenient-load accounting: >0 means the trace lost its tail
        # (load_trace skipped that many unparseable lines)
        "truncated_lines": sum(r.get("count", 0) for r in records
                               if r.get("type") == "truncated_lines"),
    }
    if compile_counts is not None:
        report["compile"] = compile_counts
    for k in ("platform", "cpu_cores", "cpu_capped", *_WORKLOAD_KEYS):
        if k in meta:
            report[k] = meta[k]
    return report


# ------------------------------------------------------------------- gate

# Bench families that are NOT drive-throughput baselines and must never be
# picked up by the perf gate, whatever keys their schemas grow:
# BENCH_SCALE_* record an RSS-vs-N curve at deliberately tiny round counts,
# BENCH_SHARD_* record per-device param bytes on a forced 8-virtual-device
# mesh, BENCH_BUFF_* record committed-updates/s under a synthetic straggler
# barrier, BENCH_TENANTS_* record multi-tenant jobs/s and job latency under
# the serving scheduler, BENCH_CODEC_* record wire-bytes-per-round and a
# codec-on/off committed-updates/s A/B, BENCH_LORA_* record the
# adapter-only wire shrink and a lora-rank rounds/s A/B, BENCH_SUPERSTEP_*
# record a rounds-per-dispatch K-sweep on a shrunk workload, BENCH_FUSED_*
# record the fused-kernel flagship A/B (cpu_interpret mode off-TPU),
# BENCH_PFL_* record adapter-bank RSS-vs-rows and gather/scatter rows/s at
# deliberately tiny round counts. All would poison the rounds/s comparison.
_GATE_SKIP_PREFIXES = ("BENCH_SCALE_", "BENCH_SHARD_", "BENCH_BUFF_",
                       "BENCH_TENANTS_", "BENCH_CODEC_", "BENCH_LORA_",
                       "BENCH_SUPERSTEP_", "BENCH_FUSED_", "BENCH_PFL_",
                       # budget pin files are not benches at all; the glob
                       # below can't match them today, but skip by NAME so a
                       # future BENCH_-style rename can't poison the gate
                       "COMPILE_BUDGET", "COMMS_BUDGET")


def newest_bench(root: str) -> Optional[Tuple[str, Dict[str, Any]]]:
    """(path, parsed) of the newest BENCH_*.json carrying a rounds/s
    number. 'Newest' is the rNN suffix when present (BENCH_r06 beats
    BENCH_r01 regardless of mtime), mtime otherwise. Files from the
    _GATE_SKIP_PREFIXES schemas are skipped by NAME, not by shape — a
    schema that later grows a rounds_per_sec field stays excluded."""
    def order(path: str):
        m = re.search(r"BENCH_r(\d+)", os.path.basename(path))
        return (1, int(m.group(1))) if m else (0, os.path.getmtime(path))

    for path in sorted(glob.glob(os.path.join(root, "BENCH_*.json")),
                       key=order, reverse=True):
        if os.path.basename(path).startswith(_GATE_SKIP_PREFIXES):
            continue
        try:
            with open(path) as f:
                parsed = json.load(f).get("parsed") or {}
        except (OSError, ValueError):
            continue
        if baseline_rounds_per_sec(parsed) is not None:
            return path, parsed
    return None


def baseline_rounds_per_sec(parsed: Dict[str, Any]) -> Optional[float]:
    """rounds/s from either BENCH schema: the pipeline A/B's eager arm
    (arms["0"], r06) or the flat drive metric (rounds_per_sec, r01–r05)."""
    arms = parsed.get("arms")
    if isinstance(arms, dict) and "0" in arms:
        return arms["0"].get("rounds_per_sec")
    return parsed.get("rounds_per_sec")


def run_gate(report: Dict[str, Any], bench_path: str,
             bench_parsed: Dict[str, Any],
             tolerance: float = DEFAULT_TOLERANCE
             ) -> Tuple[bool, bool, str]:
    """(ok, skipped, message). Skips (ok=True) when baseline and measured
    environments are incomparable; otherwise fails when measured rounds/s
    drops below tolerance * baseline."""
    baseline = baseline_rounds_per_sec(bench_parsed)
    bench_name = os.path.basename(bench_path)
    for key, label in (("platform", "platform"),
                       ("cpu_capped", "cpu_capped")):
        b, m = bench_parsed.get(key), report.get(key)
        if b is not None and m is not None and b != m:
            return True, True, (
                f"perf-regression gate: SKIP — {label} mismatch "
                f"(baseline {bench_name} {label}={b!r}, measured {m!r}); "
                f"rounds/s not comparable across environments")
    for key in _WORKLOAD_KEYS:
        b, m = bench_parsed.get(key), report.get(key)
        if b is not None and m is not None and b != m:
            return True, True, (
                f"perf-regression gate: SKIP — workload mismatch on "
                f"{key!r} (baseline {bench_name} has {b!r}, measured "
                f"{m!r}); rerun with a matching workload")
    measured = report.get("value", 0.0)
    floor = baseline * tolerance
    ratio = measured / baseline if baseline else 0.0
    env = (f"platform={bench_parsed.get('platform')!r}, "
           f"cpu_capped={bench_parsed.get('cpu_capped')}")
    if measured >= floor:
        return True, False, (
            f"perf-regression gate: PASS\n"
            f"  baseline  {bench_name:<16} {baseline:8.2f} rounds/s ({env})\n"
            f"  measured  TRACE            {measured:8.2f} rounds/s "
            f"({ratio:.2f}x baseline, floor {tolerance:.2f}x)")
    return False, False, (
        f"perf-regression gate: FAIL\n"
        f"  baseline  {bench_name:<16} {baseline:8.2f} rounds/s ({env})\n"
        f"  measured  TRACE            {measured:8.2f} rounds/s "
        f"({ratio:.2f}x baseline, floor {tolerance:.2f}x)\n"
        f"  the drive loop regressed past the allowed tolerance: look for a\n"
        f"  new per-round host sync (graft-lint blocking-fetch rule), a lost\n"
        f"  buffer donation, or compile-cache misses (TRACE.jsonl event\n"
        f"  ledger, kind=compile_cache), then rerun tools/bench_pipeline.py\n"
        f"  to re-baseline deliberately if the slowdown is intended")


def run_compile_gate(report: Dict[str, Any], budgets: Dict[str, Any],
                     drive: str) -> Tuple[bool, bool, str]:
    """(ok, skipped, message): the compile-count half of the budget gate.

    `report` is a fold()ed trace; `budgets` is the parsed
    COMPILE_BUDGET.json; `drive` names the budget entry whose
    `max_compiles` ceiling the traced run must not exceed. The ceiling is
    measured ground truth for the FULL 10-round config (drive programs plus
    every op-by-op utility dispatch), so shorter runs of the same config
    always fit under it — any excess means a program compiled that the
    budget never saw: a retrace."""
    comp = report.get("compile")
    if not comp:
        return True, True, (
            "compile gate: SKIP — trace has no compile_cache events "
            "(was the run traced with enable_compile_cache() active?)")
    entry = budgets.get(drive, {})
    ceiling = entry.get("max_compiles")
    if ceiling is None:
        return True, True, (
            f"compile gate: SKIP — no max_compiles ceiling for drive "
            f"{drive!r} in COMPILE_BUDGET.json; run `python -m "
            f"fedml_tpu.analysis --compile --update-budgets` (with "
            f"measurement) to pin one")
    measured = comp["requests"]
    detail = (f"  budget    COMPILE_BUDGET.json[{drive}]  "
              f"max_compiles={ceiling}\n"
              f"  measured  TRACE  {measured} compile request(s) "
              f"({comp['cache_misses']} miss(es), "
              f"{comp['cache_hits']} hit(s))")
    if measured <= ceiling:
        return True, False, f"compile gate: PASS\n{detail}"
    return False, False, (
        f"compile gate: FAIL\n{detail}\n"
        f"  the run compiled {measured - ceiling} more program(s) than the "
        f"budgeted config ever does: a call site is retracing.\n"
        f"  hunt it with the retrace-risk lint (`python -m "
        f"fedml_tpu.analysis --compile`) — look for Python scalars, "
        f"weak-typed literals,\n  or shape-varying operands feeding a "
        f"jitted call — then either fix the call site or re-measure "
        f"deliberately with --update-budgets")
