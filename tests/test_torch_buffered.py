"""The port's buffered aggregation (FedBuff, ``algorithms/buffered.py``):
the degenerate buffer is the synchronous round bit for bit (FedAvg and
FedAdam); a straggler run's admit and commit schedule equals the JAX
package's event for event, with the globals within tolerance (also with
the int8 codec at admit); the same run twice, and once with a guard
rollback, bit for bit; an oversized buffer drains through the partial
flush; partial dispatch with no stragglers is full dispatch; the record
log drops the ``_ledger`` blocks the drive attaches; the sharded and fused
configurations are refused.

MNIST logistic regression, 8 homo clients capped at 48 rows, shuffle off
(the LR model has no dropout): both packages train from the same weights
on the same streams."""

import numpy as np
import pytest
import torch

from fedml_tpu import telemetry as jax_telemetry
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.robustness.chaos import FaultPlan as JaxPlan
from fedml_tpu_torch import ClassificationTrainer, FedAvgAPI, FedConfig, telemetry
from fedml_tpu_torch.algorithms.aggregators import make_staleness_discount
from fedml_tpu_torch.algorithms.buffered import BufferedRunner
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.robustness.chaos import FaultPlan
from fedml_tpu_torch.robustness.guard import GuardVerdict
from fedml_tpu_torch.utils.convert import flax_to_torch
from fedml_tpu_torch.utils.pytree import tree_leaves
from test_torch_fedavg import _capped

RULES = {"fedavg": ("fedavg", {}),
         "fedadam": ("fedopt", dict(server_optimizer="adam", server_lr=0.01))}


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


def _kw(rule="fedavg", **kw):
    base = dict(dataset="mnist", model="lr", client_num_in_total=8,
                client_num_per_round=8, batch_size=16, lr=0.1, comm_round=4,
                shuffle=False, seed=0, pipeline_depth=0, **RULES[rule][1])
    return {**base, **kw}


def _api(ds, rule="fedavg", **kw):
    model = create_model("lr", output_dim=10, input_shape=ds.train.x.shape[2:])
    return FedAvgAPI(ds, FedConfig(**_kw(rule, **kw)), ClassificationTrainer(model),
                     aggregator_name=RULES[rule][0], device="cpu")


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def _strip(history):
    return [{k: v for k, v in r.items() if k != "round_time"} for r in history]


def _plan(**kw):
    return dict(seed=5, straggler_rate=0.3, straggler_rounds=2, **kw)


def _schedule(tracer):
    """The admit and commit events, in order, without their clocks."""
    keep = {"update_admitted": ("round", "birth", "fill"),
            "buffer_committed": ("round", "size", "staleness_p50", "staleness_max")}
    return [(e["kind"],) + tuple(e[f] for f in keep[e["kind"]])
            for e in tracer.events if e["kind"] in keep]


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("depth", [0, 2])
def test_degenerate_buffer_is_the_synchronous_round(ds8, rule, depth):
    """buffer_size = cohort, alpha 0, no stragglers: one commit a round with
    zero staleness, and the globals and the aggregator state (FedAdam's
    moments) are the synchronous loop's bit for bit, eager or pipelined."""
    sync = _api(ds8, rule)
    sync.train()
    buf = _api(ds8, rule, buffer_size=8, staleness_alpha=0.0, pipeline_depth=depth)
    hist = buf.train()
    assert [h["buffer_commits"] for h in hist] == [1, 1, 1, 1]
    assert all(h["staleness_max"] == 0.0 for h in hist)
    assert _bitwise(buf.global_variables, sync.global_variables)
    assert _bitwise(buf.agg_state, sync.agg_state)
    for hb, hs in zip(hist, sync.history):
        assert hb["loss_sum"] == hs["loss_sum"] and hb["Test/Acc"] == hs["Test/Acc"]


def test_staleness_discount_is_exactly_one_at_alpha_zero():
    s = torch.tensor([0.0, 1.0, 7.0])
    assert torch.equal(make_staleness_discount(0.0)(s), torch.ones(3))
    half = make_staleness_discount(0.5)(s)
    np.testing.assert_allclose(half.numpy(), (1 + s.numpy()) ** -0.5, rtol=1e-7)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_straggler_schedule_matches_jax(ds8, codec):
    """buffer_size 5, alpha 0.5 and the seeded straggler plan (rate 0.3, 1-2
    rounds late) over 5 dispatch rounds and the drain: the admit and commit
    events (round, birth, fill; size, staleness p50 and max) equal the JAX
    drive's one for one, so do the records' commit counts and staleness;
    the globals within rtol 2e-5 / atol 1e-5 (the staleness pow may differ
    from XLA's by an ulp). With int8 at admit, an ulp between the two
    packages' deltas can move an element of t / scale across a rounding
    midpoint, a whole quantization step: there at most 0.2% of the elements
    may miss (rtol 2e-5, atol 1e-5), by at most 1e-4 (a step of the rows'
    deltas, amax / 127, weighted by the commit)."""
    kw = _kw(buffer_size=5, staleness_alpha=0.5, comm_round=5, update_codec=codec)
    jds = _capped(jax_load_dataset("mnist", client_num_in_total=8, partition_method="homo",
                                   seed=0), JaxPacked, 48, 256)
    japi = JaxFedAvgAPI(jds, JaxConfig(**kw), JaxTrainer(jax_create_model("lr", output_dim=10)))
    tm = create_model("lr", output_dim=10, input_shape=ds8.train.x.shape[2:])
    tapi = FedAvgAPI(ds8, FedConfig(**kw), ClassificationTrainer(tm), device="cpu")
    tapi.global_variables = flax_to_torch(japi.global_variables, module=tm)
    jt, tt = jax_telemetry.Tracer(), telemetry.Tracer()
    jhist = japi.train(chaos=JaxPlan(**_plan()), tracer=jt)
    thist = tapi.train(chaos=FaultPlan(**_plan()), tracer=tt)
    sched = _schedule(tt)
    assert sched == _schedule(jt)
    assert any(e[0] == "buffer_committed" and e[4] > 0 for e in sched)  # stale commits
    keys = ("round", "buffer_commits", "committed_updates", "buffer_fill",
            "staleness_max", "participated_count")
    assert [{k: h.get(k) for k in keys} for h in thist] == [
        {k: h.get(k) for k in keys} for h in jhist]
    np.testing.assert_allclose([h.get("staleness_sum", 0.0) for h in thist],
                               [h.get("staleness_sum", 0.0) for h in jhist], rtol=1e-6)
    assert "_ledger" not in thist[0]
    want = flax_to_torch(japi.global_variables, module=tm)
    for k in want:
        got, ref = tapi.global_variables[k].numpy(), want[k].numpy()
        if codec == "none":
            np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5, err_msg=k)
            continue
        miss = ~np.isclose(got, ref, rtol=2e-5, atol=1e-5)
        assert miss.mean() <= 2e-3, (k, miss.sum())
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4, err_msg=k)


class _RejectOnce:
    max_retries = 2

    def __init__(self, bad_round):
        self.bad_round, self.fired = bad_round, False

    def inspect(self, round_idx, loss, global_variables=None):
        if round_idx == self.bad_round and not self.fired:
            self.fired = True
            return GuardVerdict(False, "forced test rejection")
        return GuardVerdict(True, "")


@pytest.mark.parametrize("rule", sorted(RULES))
def test_straggler_run_repeats_and_rolls_back_bitwise(ds8, rule):
    """The straggler run twice, and once with a guard that rejects round 2
    once (the rollback restores the globals, the state, the buffer written
    in place and the schedule; the salted retry draws nothing here), give
    the same globals, state, history and admit/commit events bit for bit."""
    runs = []
    for guard in (None, None, _RejectOnce(2)):
        api = _api(ds8, rule, buffer_size=5, comm_round=5)
        tracer = telemetry.Tracer()
        api.train(chaos=FaultPlan(**_plan(nan_rate=0.1)), guard=guard, tracer=tracer)
        runs.append((api, tracer))
    (a, ta), (b, tb), (g, tg) = runs
    assert g.history[2]["guard_retries"] == 1
    assert len(tg.find_events("guard_rollback")) == 1
    for other, tracer in ((b, tb), (g, tg)):
        assert _bitwise(other.global_variables, a.global_variables)
        assert _bitwise(other.agg_state, a.agg_state)
        assert [{k: v for k, v in h.items() if k != "guard_retries"}
                for h in _strip(other.history)] == _strip(a.history)
    assert _schedule(tb) == _schedule(ta)
    # round 2's admits and commits twice: the rejected attempt, then the
    # retry from the restored buffer and schedule
    sched = _schedule(ta)
    r2 = [e for e in sched if e[1] == 2]
    assert r2 and _schedule(tg) == ([e for e in sched if e[1] < 2] + r2 + r2
                                    + [e for e in sched if e[1] > 2])


def test_oversized_buffer_drains_through_partial_flush(ds8):
    """A buffer larger than every update of the run: no commit during the
    dispatch rounds, then the drain flushes it once through the masked
    commit, into a record of round comm_round, and the model moves."""
    api = _api(ds8, buffer_size=64, comm_round=3)
    init = {k: v.clone() for k, v in api.global_variables.items()}
    hist = api.train()
    host = api._buffer_host
    assert host.commits == 1 and host.committed_updates == 3 * 8
    assert [h["buffer_commits"] for h in hist] == [0, 0, 0, 1]
    assert hist[-1]["round"] == 3 and hist[-1]["participated_count"] == 24.0
    assert all(torch.isfinite(v).all() for v in api.global_variables.values())
    assert not _bitwise(api.global_variables, init)


def test_partial_dispatch_without_stragglers_is_full_dispatch(ds8):
    """``BufferedRunner(partial_dispatch=True)`` driven round by round
    through ``stage_partial_cohort`` at its ``capacity()``: with no
    stragglers the capacity is always the cohort, and the globals equal the
    full-dispatch drive's bit for bit. A narrower stage pads zero-count
    rows that never reach the buffer."""
    full = _api(ds8, "fedadam", buffer_size=4, client_num_per_round=6)
    full.train()
    api = _api(ds8, "fedadam", buffer_size=4, client_num_per_round=6)
    runner = BufferedRunner(api, partial_dispatch=True)
    tracer = telemetry.NULL_TRACER
    for r in range(api.cfg.comm_round):
        width = runner.capacity(6)
        assert width == 6
        staged = api.stage_partial_cohort(r, width, 6)
        runner.step(r, staged, runner.base_rng(r), tracer)
    runner.drain(tracer)
    assert _bitwise(api.global_variables, full.global_variables)
    assert _bitwise(api.agg_state, full.agg_state)
    narrow = api.stage_partial_cohort(0, 2, 6)
    assert tuple(narrow.x.shape[:1]) == (6,) and narrow.counts[2:].sum() == 0
    assert len(narrow.client_idx) == 2
    partial = BufferedRunner(api, partial_dispatch=True)
    partial.step(0, narrow, partial.base_rng(0), tracer)
    # only the 2 real rows arrive (both on time) and enter the buffer
    assert partial.host.fill == 2 and partial.host.births == [0, 0]
    assert partial.in_flight == 0 and partial.capacity(6) == 6


def test_buffered_records_drop_the_ledger_blocks(ds8):
    """The buffered drive attaches ``_ledger`` blocks to every record; with
    no client ledger they are dropped before history and the logger."""
    logged = []

    class Logger:
        def log(self, row, step=None):
            logged.append(row)

    hist = _api(ds8, buffer_size=8, comm_round=2).train(metrics_logger=Logger())
    assert len(hist) == 2 and len(logged) == 2
    assert all(not k.startswith("_") for rec in hist + logged for k in rec)


def test_buffered_rejects_sharded_and_fused_configs(ds8):
    """buffer_size with backend='shard_map' (even over one device) or the
    fused kernel raises the reference's ValueError."""
    trainer = ClassificationTrainer(create_model("lr", output_dim=10,
                                                 input_shape=ds8.train.x.shape[2:]))
    with pytest.raises(ValueError, match="buffer_size"):
        FedAvgAPI(ds8, FedConfig(**_kw(buffer_size=4, backend="shard_map",
                                       mesh_shape=(1,))), trainer, device="cpu")
    with pytest.raises(ValueError, match="--fused_kernel is mutually exclusive with "
                                         "--buffer_size"):
        FedConfig(buffer_size=4, fused_kernel=True).validate()
    with pytest.raises(ValueError, match="buffer_size must be >= 1"):
        BufferedRunner(_api(ds8))
