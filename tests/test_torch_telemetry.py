"""The port's drive-support modules against the JAX package's: the chaos
harness (masks and faulted inputs bit for bit), the round guard (verdicts
and reasons), the tracer (schemas, spans, rotation, the emit seam, the
torch.profiler window), the record log's one-transfer flush, the metrics
logger, the checkpoint format (dtypes kept, a crash mid-save falls back)
and the NaN-filling embedding lookup."""

import json
import os
import threading

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu import telemetry as jax_telemetry
from fedml_tpu.robustness.chaos import FaultPlan as JaxPlan
from fedml_tpu.robustness.chaos import apply_faults as jax_apply_faults
from fedml_tpu.robustness.chaos import summarize as jax_summarize
from fedml_tpu.robustness.guard import RoundGuard as JaxGuard
from fedml_tpu_torch import telemetry
from fedml_tpu_torch.models.cnn import embed
from fedml_tpu_torch.robustness.chaos import FaultPlan, apply_faults, summarize
from fedml_tpu_torch.robustness.guard import RoundGuard
from fedml_tpu_torch.telemetry import records
from fedml_tpu_torch.telemetry.records import RoundRecordLog, fetch_scalars
from fedml_tpu_torch.telemetry.tracer import EVENT_SCHEMAS, Tracer
from fedml_tpu_torch.utils import checkpoint
from fedml_tpu_torch.utils.logging import MetricsLogger, RoundTimer, profile_trace
from fedml_tpu_torch.utils.pytree import tree_leaves


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _outcome(fn, *args):
    """(dtype, shape, bytes) of fn's array, or the type of what it raised:
    integer inputs with both a NaN and a corrupted client overflow in both
    packages (ROADMAP Queue 3)."""
    try:
        out = fn(*args)
    except OverflowError as e:
        return type(e)
    return out.dtype, out.shape, out.tobytes()


# ------------------------------------------------------------------- chaos

PLANS = [
    dict(seed=0, drop_rate=0.3, nan_rate=0.3),
    dict(seed=7, drop_rate=0.1, nan_rate=0.2, corrupt_rate=0.4),
    dict(seed=3, nan_rate=1.0, overrides={2: {"nan_rate": 0.0, "drop_rate": 1.0}}),
    dict(seed=11, corrupt_rate=0.5, straggler_rate=0.5, straggler_rounds=3),
]


@pytest.mark.parametrize("plan", PLANS, ids=["drop-nan", "all-three", "overrides",
                                             "corrupt-stragglers"])
def test_fault_plan_bitwise_equal_to_jax(plan):
    """Masks, the faulted float and integer inputs, the block form, the
    straggler latencies and the summaries are the JAX module's bytes."""
    mine, ref = FaultPlan(**plan), JaxPlan(**plan)
    rng = np.random.RandomState(plan["seed"])
    for round_idx in range(4):
        for n in (1, 5, 16):
            got, want = mine.events(round_idx, n), ref.events(round_idx, n)
            for g, w in zip(got, want):
                assert _same_bytes(g, w)
            assert mine.rates_for(round_idx) == ref.rates_for(round_idx)
            assert summarize(got) == jax_summarize(want)
            assert _same_bytes(mine.latencies(round_idx, n), ref.latencies(round_idx, n))
            xf = rng.normal(size=(n, 6, 4)).astype(np.float32)
            xi = rng.randint(0, 90, size=(n, 6, 20)).astype(np.int32)
            for x in (xf, xi):
                before = x.copy()
                assert _outcome(apply_faults, got, x) == _outcome(jax_apply_faults, want, x)
                assert _same_bytes(x, before)  # the input is untouched
    (evs, masks), (jevs, jmasks) = mine.events_block(2, 3, 8), ref.events_block(2, 3, 8)
    assert len(evs) == len(jevs) == 3 and set(masks) == set(jmasks)
    for k in masks:
        assert _same_bytes(masks[k], jmasks[k])
    assert summarize(None) == jax_summarize(None)


def test_chaos_events_emit_through_the_ports_seam():
    """events() ledgers a chaos_inject into the port's installed tracer and
    into nothing when none is installed (the JAX seam stays untouched)."""
    plan = FaultPlan(seed=1, drop_rate=0.5, nan_rate=0.5)
    FaultPlan(seed=1).events(0, 4)  # no tracer installed: a no-op
    t, jt = Tracer(), jax_telemetry.Tracer()
    jax_telemetry.install(jt)
    telemetry.install(t)
    try:
        ev = plan.events(3, 10)
    finally:
        telemetry.uninstall(t)
        jax_telemetry.uninstall(jt)
    (rec,) = t.find_events("chaos_inject")
    assert rec["round"] == 3 and rec["dropped"] == ev.dropped
    assert rec["nan"] == int(ev.nan_mask.sum()) and rec["corrupt"] == 0
    assert jt.find_events() == []


# ------------------------------------------------------------------- guard

GUARD_CASES = {
    "steady": ([1.0, 0.9, 0.8, 0.85, 0.7, 0.75], {}),
    "spike": ([1.0, 0.9, 0.8, 9.0, 0.7, 12.0, 0.6], {}),
    "early-spike": ([1.0, 50.0, 0.9, 0.8, 0.7, 40.0], dict(min_history=2)),
    "non-finite-loss": ([1.0, float("nan"), 0.9, float("inf"), 0.8], {}),
    "zero-baseline": ([0.0, 0.0, 0.0, 5.0], dict(spike_factor=2.0, window=3)),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_round_guard_verdicts_equal_jax(case):
    losses, kw = GUARD_CASES[case]
    mine, ref = RoundGuard(**kw), JaxGuard(**kw)
    for r, loss in enumerate(losses):
        assert tuple(mine.inspect(r, loss)) == tuple(ref.inspect(r, loss)), (r, loss)


@pytest.mark.parametrize("poison", [None, float("nan"), float("inf")])
def test_round_guard_reads_the_globals_as_jax(poison):
    """A non-finite floating leaf fails the round with the JAX reason;
    integer leaves are not read."""
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    if poison is not None:
        w[1, 2] = poison
    steps = np.array([3, 4], np.int32)
    got = RoundGuard().inspect(5, 0.5, {"w": torch.from_numpy(w),
                                        "steps": torch.from_numpy(steps)})
    want = JaxGuard().inspect(5, 0.5, {"w": jnp.asarray(w), "steps": jnp.asarray(steps)})
    assert tuple(got) == tuple(want) and got.ok == (poison is None)


# ------------------------------------------------------------------ tracer

class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_span_nesting_and_elapsed_with_fake_clock():
    clock = _FakeClock()
    t = Tracer(clock=clock)
    with t.round(0):
        clock.t += 1.0
        with t.span("dispatch", 0) as h:
            clock.t += 2.0
            assert h.elapsed() == pytest.approx(2.0)  # readable while open
        clock.t += 0.5
    inner, = t.find_spans("dispatch")
    outer, = t.find_spans("round")
    assert inner["dur_s"] == pytest.approx(2.0) and outer["dur_s"] == pytest.approx(3.5)
    assert outer["t0"] <= inner["t0"]
    assert inner["t0"] + inner["dur_s"] <= outer["t0"] + outer["dur_s"]
    assert inner["thread"] == outer["thread"] == "main"


def test_event_schemas_are_the_jax_packages_and_round_trip(tmp_path):
    """The table is copied whole, so both packages' TRACE.jsonl files hold
    the same kinds; every kind round-trips through the file; an unknown
    kind or a missing field raises."""
    assert EVENT_SCHEMAS == jax_telemetry.EVENT_SCHEMAS
    path = str(tmp_path / "TRACE.jsonl")
    t = Tracer(jsonl_path=path, run_meta={"model": "lr"})
    for kind, fields in sorted(EVENT_SCHEMAS.items()):
        t.event(kind, **{f: 1 for f in fields})
    t.close()
    lines = [json.loads(ln) for ln in open(path)]
    assert lines[0] == {"type": "meta", "version": 1, "clock": "monotonic", "model": "lr"}
    assert [ln["kind"] for ln in lines[1:]] == sorted(EVENT_SCHEMAS)
    with pytest.raises(ValueError, match="unknown telemetry event kind"):
        Tracer().event("no_such_kind", round=0)
    with pytest.raises(ValueError, match="missing required field"):
        Tracer().event("guard_verdict", round=0, ok=True)


def test_trace_rotation_archives_segments(tmp_path):
    path = str(tmp_path / "TRACE.jsonl")
    t = Tracer(jsonl_path=path, max_bytes=600)
    for r in range(20):
        t.event("round_committed", round=r)
    t.close()
    archives = sorted(p for p in os.listdir(tmp_path) if p.startswith("TRACE.jsonl."))
    assert archives and archives[0] == "TRACE.jsonl.000"
    rounds = []
    for name in archives + ["TRACE.jsonl"]:
        lines = [json.loads(ln) for ln in open(tmp_path / name)]
        assert lines[0]["type"] == "meta"  # every segment describes itself
        rounds += [ln["round"] for ln in lines if ln.get("kind") == "round_committed"]
        if name != "TRACE.jsonl":
            assert lines[-1]["kind"] == "trace_rotated"
    assert rounds == list(range(20))


def test_emit_seam_routes_to_the_installed_tracer_and_labels_the_stager():
    telemetry.emit("guard_exhausted", round=0)  # nothing installed: a no-op
    t = Tracer()
    telemetry.install(t)
    try:
        assert telemetry.get_tracer() is t
        telemetry.emit("guard_exhausted", round=1)
        telemetry.gauge("prefetch_occupancy", round=1, inflight=0)
        worker = threading.Thread(target=lambda: telemetry.emit("guard_exhausted", round=2),
                                  name="cohort-prefetch_0")
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
    finally:
        telemetry.uninstall(t)
    assert telemetry.get_tracer() is None
    assert [(e["round"], e["thread"]) for e in t.find_events()] == [(1, "main"), (2, "stager")]
    assert t.gauge_summary()["prefetch_occupancy"]["count"] == 1


def test_summary_table_and_metrics_mirror():
    clock = _FakeClock()
    logged = []

    class Logger:
        def log(self, metrics, step=None):
            logged.append((step, metrics))

    t = Tracer(clock=clock, metrics_logger=Logger())
    for r in range(3):
        with t.round(r):
            with t.span("dispatch", r):
                clock.t += 0.25
    table = t.summary_table()
    assert table.splitlines()[0].split() == ["phase", "count", "total_s", "p50_ms", "p95_ms"]
    dispatch_row = next(ln for ln in table.splitlines() if ln.startswith("dispatch"))
    assert "250.000" in dispatch_row
    assert logged == [(r, {"trace/dispatch_s": 0.25}) for r in range(3)]


def test_profile_window_writes_a_chrome_trace(tmp_path):
    t = Tracer(profile_rounds="1:3", profile_dir=str(tmp_path / "prof"))
    for r in range(4):
        with t.round(r):
            torch.ones(8).sum()
    t.close()
    (name,) = os.listdir(tmp_path / "prof")
    assert name == "rounds_1_3.json"
    assert "traceEvents" in json.load(open(tmp_path / "prof" / name))
    with pytest.raises(ValueError, match="A:B"):
        Tracer(profile_rounds="3")


# ----------------------------------------------------------------- records

def test_record_log_flushes_pending_tensors_in_one_transfer(monkeypatch):
    calls = []

    def counted(values):
        calls.append(len(values))
        return fetch_scalars(values)

    monkeypatch.setattr(records, "fetch_scalars", counted)
    t = Tracer()
    history = []
    log = RoundRecordLog(t, history)
    for r in range(3):
        log.add({"round": r, "round_time": 0.5, "loss_sum": torch.tensor(r + 0.25),
                 "quarantined_count": torch.tensor(float(r)), "chaos_nan": r})
    assert len(log) == 3 and log.max_pending == 3 and history == []
    log.flush(2)
    assert calls == [6] and len(log) == 0
    assert history[2] == {"round": 2, "round_time": 0.5, "loss_sum": 2.25,
                          "quarantined_count": 2.0, "chaos_nan": 2}
    assert all(type(v) in (int, float) for rec in history for v in rec.values())
    committed = t.find_events("round_committed")
    assert [(e["round"], e["quarantined_count"], e["chaos_nan"]) for e in committed] == [
        (0, 0.0, 0), (1, 1.0, 1), (2, 2.0, 2)]
    (fetch,) = t.find_spans("metrics_fetch")
    assert fetch["records"] == 3
    log.flush()  # nothing pending: no transfer
    assert calls == [6]
    # a client-ledger or adapter-bank block is dropped (none can be
    # attached), and nothing it holds is fetched
    log.add({"round": 3, "round_time": 0.5, "loss_sum": torch.tensor(1.0),
             "_ledger": [{"stats": torch.tensor(7.0)}], "_bank": []})
    log.flush(3)
    assert calls == [6, 1]
    assert history[3] == {"round": 3, "round_time": 0.5, "loss_sum": 1.0}


def test_fetch_scalars_is_exact_for_float32_and_large_ints():
    vals = [torch.tensor(0.1, dtype=torch.float32), torch.tensor(2 ** 40 + 1),
            torch.tensor(True)]
    assert fetch_scalars(vals) == [float(np.float32(0.1)), float(2 ** 40 + 1), 1.0]
    assert fetch_scalars([]) == []


# ----------------------------------------------------------------- logging

def test_metrics_logger_writes_wandb_files(tmp_path):
    run = tmp_path / "run"
    logger = MetricsLogger(run_dir=str(run), config={"lr": 0.1, "seed": 0})
    logger.log({"Test/Acc": 0.5, "quarantined_count": 2.0}, step=0)
    logger.log({"Test/Acc": 0.75}, step=1)
    logger.finish()
    assert json.load(open(run / "config.json")) == {"lr": 0.1, "seed": 0}
    hist = [json.loads(ln) for ln in open(run / "history.jsonl")]
    assert [h["round"] for h in hist] == [0, 1] and hist[1]["Test/Acc"] == 0.75
    summary = json.load(open(run / "wandb-summary.json"))
    assert summary["Test/Acc"] == 0.75 and summary["quarantined_count"] == 2.0
    assert summary["round"] == 1 and "_runtime" in summary


def test_round_timer_and_profile_trace(tmp_path):
    timer = RoundTimer()
    assert timer.summary() == {} and timer.mean == 0.0
    for _ in range(3):
        with timer:
            pass
    s = timer.summary()
    assert len(timer.times) == 3 and s["round_time_max"] >= s["round_time_p50"] >= 0
    with profile_trace(str(tmp_path / "tb")):
        torch.ones(4).sum()
    assert any(name.endswith(".json") for name in os.listdir(tmp_path / "tb"))


# -------------------------------------------------------------- checkpoint

def _tree():
    g = torch.Generator().manual_seed(0)
    return {"variables": {"w": torch.randn(3, 4, generator=g),
                          "h": torch.randn(5, generator=g).to(torch.bfloat16),
                          "bn.mean": torch.zeros(4)},
            "agg_state": {"count": torch.tensor(7, dtype=torch.int32),
                          "mu": {"w": torch.randn(3, 4, generator=g)},
                          "steps": torch.arange(4, dtype=torch.int64)},
            "empty": ()}


def test_checkpoint_round_trips_dtypes_and_keeps_three(tmp_path):
    d = str(tmp_path / "ckpt")
    t = Tracer()
    telemetry.install(t)
    try:
        for step in (1, 2, 3, 4):
            checkpoint.save_checkpoint(d, step, {"tree": _tree(), "meta": {"step": step}})
    finally:
        telemetry.uninstall(t)
    assert checkpoint.all_checkpoint_steps(d) == [2, 3, 4]
    assert not os.path.exists(os.path.join(d, "ckpt_1"))
    assert [e["step"] for e in t.find_events("checkpoint_save")] == [1, 2, 3, 4]
    tree, step, meta = checkpoint.restore_checkpoint(d, _tree())
    assert step == 4 and meta == {"step": 4}
    want = _tree()
    for (p, got), (_, w) in zip(tree_leaves(tree), tree_leaves(want)):
        assert got.dtype == w.dtype and torch.equal(got, w), p
    assert tree["agg_state"]["count"].dtype == torch.int32
    assert tree["variables"]["h"].dtype == torch.bfloat16
    assert checkpoint.restore_checkpoint(str(tmp_path / "none"), want) is None


def test_checkpoint_crash_mid_save_and_mismatches(tmp_path):
    d = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(d, 2, {"tree": _tree(), "meta": {}})
    # a crash mid-save of step 5: a partial tree and an un-renamed meta
    os.makedirs(os.path.join(d, "ckpt_5"))
    with open(os.path.join(d, "ckpt_5", "tree.pt"), "wb") as f:
        f.write(b"\x00truncated-by-crash")
    with open(os.path.join(d, "meta_5.json.tmp"), "w") as f:
        f.write('{"step": 5')
    assert checkpoint.all_checkpoint_steps(d) == [2]
    assert checkpoint.restore_checkpoint(d, _tree())[1] == 2
    other = _tree()
    other["variables"]["extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="holds leaves"):
        checkpoint.restore_checkpoint(d, other)
    other = _tree()
    other["variables"]["w"] = other["variables"]["w"].double()
    with pytest.raises(ValueError, match="float64"):
        checkpoint.restore_checkpoint(d, other)
    with open(os.path.join(d, "meta_9.json"), "w") as f:
        json.dump({"step": 9, "backend": "npz", "meta": {}}, f)
    with pytest.raises(ValueError, match="'npz' backend"):
        checkpoint.restore_checkpoint(d, _tree())


# --------------------------------------------------------------- embedding

def test_embedding_of_out_of_range_ids_is_nan_as_in_jax():
    """flax's Embed gathers with jnp.take, whose fill mode gives a NaN row
    for an id outside [-V, V) (negative ids count from the end); the port's
    lookup does the same, gives F.embedding's bits in range, and no
    gradient to an out-of-range row."""
    V, D = 6, 3
    w = np.random.RandomState(0).normal(size=(V, D)).astype(np.float32)
    ids = np.array([[1, 5, 2 ** 31 - 1], [0, -1, 3], [-6, -7, 6]], np.int32)
    want = np.asarray(fnn.Embed(V, D).apply({"params": {"embedding": jnp.asarray(w)}},
                                            jnp.asarray(ids)))
    wt = torch.from_numpy(w).requires_grad_(True)
    got = embed(torch.from_numpy(ids), wt)
    valid = (ids >= -V) & (ids < V)
    assert np.isnan(want[~valid]).all() and np.isnan(got.detach().numpy()[~valid]).all()
    np.testing.assert_array_equal(got.detach().numpy()[valid], want[valid])
    in_range = torch.from_numpy(np.where(valid, ids % V, 0))
    assert torch.equal(embed(in_range, wt), F.embedding(in_range.long(), wt))
    torch.nan_to_num(got).sum().backward()
    counts = np.bincount(ids[valid] % V, minlength=V).astype(np.float32)
    np.testing.assert_array_equal(wt.grad.numpy(), np.repeat(counts[:, None], D, 1))


@pytest.mark.parametrize("spans, want", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (20, 25)], 15),
    ([(0, 10), (5, 12)], 12),  # two events overlap: counted once
    ([(5, 12), (0, 10), (0, 3), (12, 14)], 14),
    ([(0, 100), (10, 20), (30, 40)], 100),  # nested
])
def test_device_busy_is_the_union_of_event_intervals(spans, want):
    """``profile_fused.measure_rounds`` reads the device's busy time as the
    union of its events' intervals, so a share of the wall cannot pass 1."""
    from fedml_tpu_torch.experiments.profile_fused import busy_ns

    assert busy_ns(spans) == want
