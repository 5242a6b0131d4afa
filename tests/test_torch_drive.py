"""The port's drive layer: the pipelined loop equal to the eager loop bit
for bit (depths 1, 2 and 4, FedAvg and FedAdam, with chaos), the guard's
rollback (prefetches invalidated, the retry re-staged with the same bytes,
the pre-round state restored even after in-place writes), the bounded
record backlog, checkpoint resume equal to a straight run (both drives,
FedAvg, FedAdam, FedAvgM and a BatchNorm model), the CLI's run directory,
and a chaos + guard drive and an NWP round with a NaN-faulted client
against the JAX package's drive.

The port-only cases run MNIST logistic regression, 8 homo clients capped
at 48 rows (``tests/test_pipeline.py``'s configuration at a smaller size);
the JAX comparisons run the same seeds through both packages."""

import json
import os

import numpy as np
import pytest
import torch

from fedml_tpu import telemetry as jax_telemetry
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.core.trainer import NWPTrainer as JaxNWPTrainer
from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.data.registry import FederatedDataset as JaxDataset
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.models.transformer import TransformerLM as JaxTLM
from fedml_tpu.robustness.chaos import FaultPlan as JaxPlan
from fedml_tpu.robustness.guard import GuardVerdict as JaxVerdict
from fedml_tpu.robustness.guard import RoundGuard as JaxGuard
from fedml_tpu_torch import ClassificationTrainer, FedAvgAPI, FedConfig, NWPTrainer
from fedml_tpu_torch import telemetry
from fedml_tpu_torch.algorithms.engine import stage_to_device
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.data.registry import FederatedDataset, load_dataset
from fedml_tpu_torch.experiments import main_fedavg
from fedml_tpu_torch.models import resnet
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.robustness.chaos import FaultPlan
from fedml_tpu_torch.robustness.guard import GuardVerdict, RoundGuard
from fedml_tpu_torch.utils.checkpoint import all_checkpoint_steps
from fedml_tpu_torch.utils.convert import flax_to_torch
from fedml_tpu_torch.utils.pytree import tree_leaves
from test_torch_fedavg import _capped
from test_torch_state_rounds import CLASSES, _datasets


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ds8():
    ds = load_dataset("mnist", client_num_in_total=8, partition_method="homo", seed=0)
    return _capped(ds, PackedClients, 48, 256)


RULES = {
    "fedavg": ("fedavg", {}),
    "fedadam": ("fedopt", dict(server_optimizer="adam", server_lr=0.01)),
    "fedavgm": ("fedopt", dict(server_optimizer="sgd", server_lr=1.0, server_momentum=0.9)),
}


def _cfg(comm_round, rule="fedavg", **kw):
    kw.setdefault("client_num_per_round", 8)
    return FedConfig(dataset="mnist", model="lr", comm_round=comm_round, batch_size=8,
                     lr=0.05, client_num_in_total=8, seed=0, **RULES[rule][1], **kw)


def _api(ds, cfg, rule="fedavg"):
    model = create_model("lr", output_dim=ds.class_num, input_shape=ds.train.x.shape[2:])
    return FedAvgAPI(ds, cfg, ClassificationTrainer(model), aggregator_name=RULES[rule][0],
                     device="cpu")


def _plan():
    return FaultPlan(seed=3, drop_rate=0.25, nan_rate=0.25)


def _bitwise_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    return all(x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def _strip_times(history):
    return [{k: v for k, v in r.items() if k != "round_time"} for r in history]


def _same_run(a, b):
    assert _bitwise_equal(a.global_variables, b.global_variables)
    assert _bitwise_equal(a.agg_state, b.agg_state)
    assert _strip_times(a.history) == _strip_times(b.history)


class _RejectOnce:
    """A guard that rejects one round once and accepts everything else."""

    max_retries = 2

    def __init__(self, bad_round=2, verdict=GuardVerdict):
        self.bad_round = bad_round
        self.verdict = verdict
        self.fired = False

    def inspect(self, round_idx, loss, global_variables=None):
        if round_idx == self.bad_round and not self.fired:
            self.fired = True
            return self.verdict(False, "forced test rejection")
        return self.verdict(True, "")


# ------------------------------------------------------------ bit identity

@pytest.fixture(scope="module")
def eager_chaos_runs(ds8):
    """The eager drive with chaos, once per rule."""
    runs = {}
    for rule in ("fedavg", "fedadam"):
        api = _api(ds8, _cfg(5, rule), rule)
        api.train(chaos=_plan())
        runs[rule] = api
    return runs


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("rule", ["fedavg", "fedadam"])
def test_pipelined_bit_identical_to_eager(ds8, eager_chaos_runs, depth, rule):
    piped = _api(ds8, _cfg(5, rule, pipeline_depth=depth), rule)
    piped.train(chaos=_plan())
    _same_run(piped, eager_chaos_runs[rule])
    assert any(h["quarantined_count"] > 0 for h in piped.history)
    pf = piped._last_prefetcher
    assert pf.consumed_rounds == list(range(5)) and sorted(pf.staged_rounds) == list(range(5))


def test_guard_rollback_invalidates_and_restages_the_same_bytes(ds8):
    """A rejected round drops every in-flight staging; the retried round is
    staged again, from the same bytes, and consumed twice; the outcome is
    the eager loop's under the same guard."""
    eager = _api(ds8, _cfg(5))
    eager.train(chaos=_plan(), guard=_RejectOnce())
    piped = _api(ds8, _cfg(5, pipeline_depth=2))
    staged_x = {}
    stage = piped.stage_fn

    def recording(round_idx, **kw):
        staged = stage(round_idx, **kw)
        staged_x.setdefault(round_idx, []).append(staged.x.numpy().tobytes())
        return staged

    piped.stage_fn = recording
    tracer = telemetry.Tracer()
    piped.train(chaos=_plan(), guard=_RejectOnce(), tracer=tracer)
    pf = piped._last_prefetcher
    assert pf.staged_rounds.count(2) == 2 and pf.consumed_rounds.count(2) == 2
    assert len(staged_x[2]) == 2 and staged_x[2][0] == staged_x[2][1]
    assert [r["round"] for r in piped.history] == list(range(5))
    assert piped.history[2]["guard_retries"] == 1
    assert any(g["dropped"] > 0 for g in tracer.gauges if g["name"] == "prefetch_invalidate")
    (rollback,) = tracer.find_events("guard_rollback")
    assert rollback["round"] == 2 and rollback["retry"] == 1
    _same_run(piped, eager)


def test_pending_backlog_stays_bounded(ds8):
    """Without sync points (no guard, rare eval) the deferred records still
    flush once max(4, 2 * depth) are pending, and the run stays the eager
    one."""
    depth = 4
    eager = _api(ds8, _cfg(12, frequency_of_the_test=100))
    eager.train()
    piped = _api(ds8, _cfg(12, pipeline_depth=depth, frequency_of_the_test=100))
    piped.train()
    assert 4 <= piped._last_records.max_pending <= max(4, 2 * depth)
    _same_run(piped, eager)


@pytest.mark.parametrize("drive", ["eager", "pipelined"])
def test_rollback_restores_the_pre_round_state_after_in_place_writes(ds8, drive):
    """The rejected attempt of round 2 writes the globals and the server
    optimizer's state in place before its round runs; the rollback must
    restore them exactly, so the run equals one without the writes."""
    depth = 2 if drive == "pipelined" else 0
    clean = _api(ds8, _cfg(4, "fedadam", pipeline_depth=depth), "fedadam")
    clean.train(guard=_RejectOnce())
    dirty = _api(ds8, _cfg(4, "fedadam", pipeline_depth=depth), "fedadam")
    inner, calls = dirty.round_fn, []

    def writing(gv, agg_state, *args):
        calls.append(1)
        if len(calls) == 3:  # round 2's first attempt
            for _, leaf in tree_leaves((gv, agg_state)):
                if leaf.is_floating_point():
                    leaf.add_(1.0)
        return inner(gv, agg_state, *args)

    dirty.round_fn = writing
    dirty.train(guard=_RejectOnce())
    assert len(calls) == 5
    _same_run(dirty, clean)


# ------------------------------------------------------------------ resume

def _bn_api(cfg, rule):
    tds = _datasets()[1]
    return FedAvgAPI(tds, cfg, ClassificationTrainer(
        resnet.ResNetCifar(resnet.BasicBlock, (1, 1, 1), CLASSES)),
        aggregator_name=RULES[rule][0], device="cpu")


@pytest.mark.parametrize("drive", ["eager", "pipelined"])
@pytest.mark.parametrize("case", ["fedavg", "fedadam", "fedavgm", "batchnorm"])
def test_resume_bit_identical_to_straight_run(ds8, tmp_path, drive, case):
    """5 straight rounds against 3 rounds, a checkpoint, a NEW api restored
    from it and 2 more: globals (BatchNorm statistics included), server
    optimizer state and history equal bit for bit."""
    depth = 2 if drive == "pipelined" else 0
    if case == "batchnorm":
        def make(rounds):
            cfg = FedConfig(client_num_in_total=3, client_num_per_round=3, batch_size=8,
                            lr=0.05, comm_round=rounds, seed=0, pipeline_depth=depth)
            return _bn_api(cfg, "fedavg")
    else:
        def make(rounds):
            return _api(ds8, _cfg(rounds, case, pipeline_depth=depth), case)
    straight = make(5)
    straight.train()
    d = str(tmp_path / "ckpt")
    make(3).train(ckpt_dir=d, ckpt_every=100)
    assert all_checkpoint_steps(d) == [3]
    resumed = make(5)
    hist = resumed.train(ckpt_dir=d, ckpt_every=100)
    assert len(hist) == 5 and all_checkpoint_steps(d) == [3, 5]
    _same_run(resumed, straight)
    if case == "batchnorm":
        assert any(k.endswith(".var") for k in resumed.global_variables)
    with open(os.path.join(d, "TRACE.jsonl")) as f:  # next to the checkpoints
        kinds = [json.loads(ln).get("kind") for ln in f]
    assert kinds.count("round_committed") == 2 and "checkpoint_save" in kinds


def test_crash_mid_save_falls_back_to_the_previous_step(ds8, tmp_path):
    d = str(tmp_path / "ckpt")
    api = _api(ds8, _cfg(2))
    api.train(ckpt_dir=d, ckpt_every=100)
    os.makedirs(os.path.join(d, "ckpt_5"))
    with open(os.path.join(d, "ckpt_5", "tree.pt"), "wb") as f:
        f.write(b"\x00truncated-by-crash")
    with open(os.path.join(d, "meta_5.json.tmp"), "w") as f:
        f.write('{"step": 5')
    assert all_checkpoint_steps(d) == [2]
    fresh = _api(ds8, _cfg(4))
    assert fresh.maybe_restore(d) == 2
    assert _bitwise_equal(fresh.global_variables, api.global_variables)
    assert _strip_times(fresh.history) == _strip_times(api.history)


def test_fused_drive_pipelined_and_resumed_equals_eager(tmp_path):
    """The fused round (its plain version on the CPU) through both drives
    and a resume; chaos is excluded up front with the JAX package's
    reason."""
    ds = _capped(load_dataset("femnist", client_num_in_total=4, seed=1), PackedClients, 20, 32)

    def make(rounds, depth):
        cfg = FedConfig(dataset="femnist", model="cnn", client_num_in_total=4,
                        client_num_per_round=2, batch_size=20, lr=0.1, comm_round=rounds,
                        fused_kernel=True, pipeline_depth=depth)
        return FedAvgAPI(ds, cfg, ClassificationTrainer(create_model("cnn", output_dim=62)),
                         device="cpu")

    eager = make(3, 0)
    eager.train()
    d = str(tmp_path / "ckpt")
    make(2, 2).train(ckpt_dir=d)
    resumed = make(3, 2)
    resumed.train(ckpt_dir=d)
    _same_run(resumed, eager)
    with pytest.raises(ValueError, match="no participation/quarantine"):
        make(1, 2).train(chaos=_plan())


# --------------------------------------------------------------------- CLI

def test_cli_writes_its_run_directory_and_resumes(tmp_path):
    """The CLI on the CPU, pipelined at its default depth 2, with chaos and
    the guard: TRACE.jsonl, history.jsonl and a wandb-summary.json holding
    quarantined_count in --run_dir; a second call with more rounds resumes
    from --ckpt_dir."""
    run, ckpt = tmp_path / "run", tmp_path / "ckpt"
    argv = ["--device", "cpu", "--client_num_in_total", "6", "--client_num_per_round", "4",
            "--batch_size", "64", "--run_dir", str(run), "--ckpt_dir", str(ckpt),
            "--chaos", "1", "--chaos_seed", "7", "--chaos_drop_rate", "0.3",
            "--chaos_nan_rate", "0.3", "--guard", "1", "--trace_summary", "1"]
    hist = main_fedavg.main(argv + ["--comm_round", "3"])
    assert len(hist) == 3 and all_checkpoint_steps(str(ckpt)) == [3]
    summary = json.load(open(run / "wandb-summary.json"))
    assert "quarantined_count" in summary and summary["round"] == 2
    assert sum(h["quarantined_count"] for h in hist) >= 1
    lines = [json.loads(ln) for ln in open(run / "TRACE.jsonl")]
    assert lines[0]["type"] == "meta" and lines[0]["pipeline_depth"] == 2
    kinds = [ln.get("kind") for ln in lines]
    assert {"chaos_inject", "guard_verdict", "round_committed", "checkpoint_save"} <= set(kinds)
    assert any(ln.get("name") == "stage" and ln["thread"] == "stager" for ln in lines)
    assert len(open(run / "history.jsonl").readlines()) == 3
    hist = main_fedavg.main(argv + ["--comm_round", "5"])
    assert [h["round"] for h in hist] == list(range(5))
    assert all_checkpoint_steps(str(ckpt)) == [3, 5]


# --------------------------------------------------------- against the JAX drive

_DRIVE_KINDS = ("chaos_inject", "guard_verdict", "guard_rollback", "guard_exhausted",
                "round_committed")


def _ledger(path):
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    return [{k: v for k, v in ln.items() if k not in ("t", "thread")}
            for ln in lines if ln.get("kind") in _DRIVE_KINDS]


@pytest.mark.parametrize("guard", ["round-guard", "reject-once"])
def test_chaos_guard_drive_matches_jax(tmp_path, guard):
    """4 eager rounds of MNIST LR, 8 clients, drop 0.3 and NaN 0.3, shuffle
    off, from the same weights: the quarantine and retry counts are equal,
    the globals within rtol 2e-5 / atol 1e-5, and the two TRACE.jsonl files
    hold the same events in the same order."""
    kw = dict(dataset="mnist", model="lr", client_num_in_total=8, client_num_per_round=8,
              batch_size=32, lr=0.05, comm_round=4, shuffle=False, seed=0)
    jds = jax_load_dataset("mnist", client_num_in_total=8, partition_method="homo", seed=0)
    tds = load_dataset("mnist", client_num_in_total=8, partition_method="homo", seed=0)
    tm = create_model("lr", output_dim=10, input_shape=tds.train.x.shape[2:])
    japi = JaxFedAvgAPI(jds, JaxConfig(**kw), JaxTrainer(jax_create_model("lr", output_dim=10)))
    tapi = FedAvgAPI(tds, FedConfig(**kw), ClassificationTrainer(tm), device="cpu")
    tapi.global_variables = flax_to_torch(japi.global_variables, module=tm)
    guards = ((JaxGuard(), RoundGuard()) if guard == "round-guard"
              else (_RejectOnce(1, JaxVerdict), _RejectOnce(1)))
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    jt, tt = jax_telemetry.Tracer(jsonl_path=jpath), telemetry.Tracer(jsonl_path=tpath)
    jhist = japi.train(chaos=JaxPlan(seed=0, drop_rate=0.3, nan_rate=0.3), guard=guards[0],
                       tracer=jt)
    thist = tapi.train(chaos=FaultPlan(seed=0, drop_rate=0.3, nan_rate=0.3), guard=guards[1],
                       tracer=tt)
    jt.close()
    tt.close()
    keys = ("participated_count", "quarantined_count", "guard_retries", "chaos_dropped",
            "chaos_nan", "chaos_corrupt")
    assert [{k: h.get(k) for k in keys} for h in thist] == [
        {k: h.get(k) for k in keys} for h in jhist]
    assert sum(h["quarantined_count"] for h in thist) >= 1
    if guard == "reject-once":
        assert thist[1]["guard_retries"] == 1
    for key in ("Train/Acc", "Train/Loss", "Test/Acc", "Test/Loss"):
        np.testing.assert_allclose([h[key] for h in thist], [h[key] for h in jhist],
                                   rtol=2e-5, atol=1e-5, err_msg=key)
    want = flax_to_torch(japi.global_variables, module=tm)
    for k in want:
        np.testing.assert_allclose(tapi.global_variables[k].numpy(), want[k].numpy(),
                                   rtol=2e-5, atol=1e-5, err_msg=k)
    assert _ledger(tpath) == _ledger(jpath)
    assert len(_ledger(tpath)) >= 12


V, T, CL, N = 40, 12, 3, 8


def _token_datasets():
    rng = np.random.RandomState(0)
    x = rng.randint(1, V, size=(CL, N, T)).astype(np.int32)
    y = np.concatenate([x[..., 1:], rng.randint(1, V, size=(CL, N, 1))], -1).astype(np.int32)
    counts = np.full(CL, N, np.int32)
    flat = (x.reshape(-1, T), y.reshape(-1, T))

    def make(dataset_cls, packed_cls):
        return dataset_cls(name="tokens", train=packed_cls(x, y, counts.copy()), test=None,
                           train_global=flat, test_global=flat, class_num=V,
                           meta={"task": "nwp"})

    return make(JaxDataset, JaxPacked), make(FederatedDataset, PackedClients)


def test_nwp_client_with_out_of_range_ids_is_quarantined_in_both():
    """A NaN fault on token inputs fills them with iinfo(int32).max. flax's
    Embed (jnp.take's fill mode) reads NaN rows there and the quarantine
    drops the client; the port's lookup does the same, so both packages
    quarantine it and the globals agree."""
    seed = next(s for s in range(100)
                if FaultPlan(seed=s, nan_rate=0.4).events(0, CL).nan_mask.sum() == 1)
    kw = dict(dataset="tokens", model="transformer_nwp", client_num_in_total=CL,
              client_num_per_round=CL, batch_size=4, lr=0.3, comm_round=1, shuffle=False,
              seed=0)
    model = dict(d_model=16, heads=2, num_layers=1, max_len=T)
    jds, tds = _token_datasets()
    japi = JaxFedAvgAPI(jds, JaxConfig(**kw), JaxNWPTrainer(JaxTLM(vocab_size=V, **model)))
    tm = create_model("transformer_nwp", output_dim=V, **model)
    tapi = FedAvgAPI(tds, FedConfig(**kw), NWPTrainer(tm), device="cpu")
    tapi.global_variables = flax_to_torch(japi.global_variables)
    (jr,) = japi.train(chaos=JaxPlan(seed=seed, nan_rate=0.4))
    (tr,) = tapi.train(chaos=FaultPlan(seed=seed, nan_rate=0.4))
    assert jr["quarantined_count"] == tr["quarantined_count"] == 1
    assert jr["participated_count"] == tr["participated_count"] == CL - 1
    want = flax_to_torch(japi.global_variables)
    for k in want:
        assert torch.isfinite(tapi.global_variables[k]).all(), k
        np.testing.assert_allclose(tapi.global_variables[k].numpy(), want[k].numpy(),
                                   rtol=2e-5, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------- staging

def test_stage_to_device_on_the_cpu():
    x = np.arange(12, dtype=np.float32).reshape(2, 3, 2)
    (dx, dy, dc, dp), ready, pinned = stage_to_device(
        x, np.ones((2, 3), np.int32), np.array([3, 2]), None, "cpu")
    assert ready is None and pinned is None and dp is None
    assert dx.numpy().tobytes() == x.tobytes() and dy.dtype == torch.int32
    (_, _, _, dp), _, _ = stage_to_device(x, x, x, np.array([True, False]), "cpu")
    assert dp.dtype == torch.bool and dp.tolist() == [True, False]


@pytest.mark.cuda
def test_stage_to_device_pins_and_copies_on_a_side_stream():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the side-stream copy has no CPU form")
    dev = torch.device("cuda", 0)
    stream = torch.cuda.Stream(dev)
    x = np.random.RandomState(0).normal(size=(4, 5, 3)).astype(np.float32)
    part = np.array([True, False, True, True])
    (dx, _, _, dp), ready, pinned = stage_to_device(x, x, x[:, 0, 0], part, dev, stream)
    assert all(p.is_pinned() for p in pinned)
    torch.cuda.current_stream(dev).wait_event(ready)
    assert dx.device == dev and dx.cpu().numpy().tobytes() == x.tobytes()
    assert dp.cpu().tolist() == part.tolist()
    with pytest.raises(ValueError, match="side stream"):
        stage_to_device(x, x, x, None, dev)
