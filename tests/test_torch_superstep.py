"""The port's superstep (``engine.build_superstep_fn`` and
``FedAvgAPI._train_superstep``): K = 2-4 rounds a dispatch equal the same
rounds of the eager loop bit for bit (globals, FedAdam's moments, codec
residuals, records), with float chaos masks and with the Feistel
cohorts; the dispatches drop K-fold; K = 1 builds nothing; a store that
cannot be resident and chaos on token inputs run the eager loop with the
reference's warning; checkpoint and eval rounds end their dispatch; a
guard rejection rolls the chunk back and replays it eagerly; incompatible
modes are refused; and the superstep lands within tolerance of the JAX
package's.

MNIST logistic regression, 8 homo clients capped at 48 rows, 4 a round,
shuffle on in the port-only cases (the superstep must replay the eager
round's generator) and off against JAX."""

import logging

import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.robustness.chaos import FaultPlan as JaxPlan
from fedml_tpu_torch import ClassificationTrainer, FedAvgAPI, FedConfig, NWPTrainer, telemetry
from fedml_tpu_torch.data import packed_store
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.data.registry import FederatedDataset, load_dataset
from fedml_tpu_torch.experiments import main_fedavg
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.robustness.chaos import FaultPlan
from fedml_tpu_torch.robustness.guard import GuardVerdict
from fedml_tpu_torch.utils.checkpoint import all_checkpoint_steps
from fedml_tpu_torch.utils.convert import flax_to_torch, optax_state_to_torch
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
                client_num_per_round=4, batch_size=16, lr=0.1, comm_round=9,
                frequency_of_the_test=100, seed=0, **RULES[rule][1])
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


def _same_run(a, b):
    assert _bitwise(a.global_variables, b.global_variables)
    assert _bitwise(a.agg_state, b.agg_state)
    assert _strip(a.history) == _strip(b.history)


def _dispatches(tracer):
    return tracer.find_spans("dispatch")


def _plan():
    return FaultPlan(seed=4, drop_rate=0.2, nan_rate=0.2, corrupt_rate=0.2)


CASES = {"fedavg": ("fedavg", {}, False),
         "fedadam+int8": ("fedadam", dict(update_codec="int8"), False),
         "fedavg+topk+fast": ("fedavg", dict(update_codec="topk", codec_k=32,
                                             fast_sampling=True), False),
         "fedadam+chaos": ("fedadam", {}, True),
         "fedavg+int8+fast+chaos": ("fedavg", dict(update_codec="int8",
                                                   fast_sampling=True), True)}


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_superstep_equals_eager_rounds(ds8, k, case):
    """9 rounds (round 0 and the last evaluate, so they end dispatches) at
    K a dispatch: the globals, the aggregator state (FedAdam's moments, the
    codec's residual rows) and the history equal the eager loop's bit for
    bit, with shuffle on, float chaos masks applied on the device, and the
    Feistel cohorts gathered there; the dispatches drop to the chunks'."""
    rule, kw, chaos = CASES[case]
    eager, fused = _api(ds8, rule, **kw), _api(ds8, rule, rounds_per_dispatch=k, **kw)
    te, tf = telemetry.Tracer(), telemetry.Tracer()
    eager.train(chaos=_plan() if chaos else None, tracer=te)
    fused.train(chaos=_plan() if chaos else None, tracer=tf)
    _same_run(fused, eager)
    chunks = -(-8 // k)  # round 0 eager, then rounds 1-8 in dispatches of K
    assert len(_dispatches(te)) == 9 and len(_dispatches(tf)) == 1 + chunks
    assert [e["rounds"] for e in tf.find_events("superstep_committed")] == \
        [k] * (8 // k) + ([8 % k] if 8 % k else [])
    if chaos:
        assert sum(h["quarantined_count"] for h in fused.history) >= 1
        assert sum(h["chaos_corrupt"] for h in fused.history) >= 1


def test_one_round_a_dispatch_builds_no_superstep(ds8):
    """K = 1 is the eager loop: no superstep built, one dispatch a round."""
    api = _api(ds8, comm_round=3)
    tracer = telemetry.Tracer()
    api.train(tracer=tracer)
    assert api._superstep_cache == {} and api._resident_train is None
    assert len(_dispatches(tracer)) == 3


def test_store_that_cannot_be_resident_runs_eagerly(ds8, monkeypatch, caplog):
    monkeypatch.setattr(packed_store, "resident_train_arrays", lambda store, device: None)
    eager = _api(ds8, comm_round=4)
    eager.train()
    fused = _api(ds8, comm_round=4, rounds_per_dispatch=2)
    with caplog.at_level(logging.WARNING):
        fused.train()
    assert "over the resident byte budget — running the eager loop" in caplog.text
    assert fused._superstep_cache == {}
    _same_run(fused, eager)


V, T, CL, N = 40, 12, 4, 8


def _tokens():
    rng = np.random.RandomState(0)
    x = rng.randint(1, V, size=(CL, N, T)).astype(np.int32)
    y = np.concatenate([x[..., 1:], rng.randint(1, V, size=(CL, N, 1))], -1).astype(np.int32)
    flat = (x.reshape(-1, T), y.reshape(-1, T))
    return FederatedDataset(name="tokens", train=PackedClients(x, y, np.full(CL, N, np.int32)),
                            test=None, train_global=flat, test_global=flat, class_num=V,
                            meta={"task": "nwp"})


def _nwp_api(ds, **kw):
    cfg = FedConfig(dataset="tokens", model="transformer_nwp", client_num_in_total=CL,
                    client_num_per_round=2, batch_size=4, lr=0.3, comm_round=4,
                    frequency_of_the_test=100, seed=0, **kw)
    tm = create_model("transformer_nwp", output_dim=V, d_model=16, heads=2, num_layers=1,
                      max_len=T)
    return FedAvgAPI(ds, cfg, NWPTrainer(tm), device="cpu")


def test_token_inputs_superstep_and_chaos_fallback(caplog):
    """Token inputs run the superstep (the gather keeps their dtype) bit for
    bit the eager loop; with chaos their faults are data-dependent on the
    host, so the drive runs the eager loop with the reference's warning."""
    ds = _tokens()
    eager, fused = _nwp_api(ds), _nwp_api(ds, rounds_per_dispatch=2)
    eager.train()
    fused.train()
    _same_run(fused, eager)
    assert fused._superstep_cache
    plan = FaultPlan(seed=1, nan_rate=0.3)
    eager, fused = _nwp_api(ds), _nwp_api(ds, rounds_per_dispatch=2)
    eager.train(chaos=plan)
    with caplog.at_level(logging.WARNING):
        fused.train(chaos=plan)
    assert "chaos faults on integer inputs are data-dependent" in caplog.text
    assert fused._superstep_cache == {}
    _same_run(fused, eager)


def test_checkpoint_and_eval_rounds_end_their_dispatch(ds8, tmp_path):
    """``_superstep_k`` cuts K at eval rounds (every 3rd here and the last)
    and checkpoint rounds (every 4th); the run saves the eager loop's
    checkpoints and equals it bit for bit, and a resume continues it."""
    api = _api(ds8, rounds_per_dispatch=4, frequency_of_the_test=3, comm_round=10)
    assert [api._superstep_k(r, str(tmp_path), 4) for r in range(10)] == \
        [1, 3, 2, 1, 3, 2, 1, 1, 2, 1]
    assert [api._superstep_k(r, None, 4) for r in (1, 4, 7, 8)] == [3, 3, 3, 2]
    eager = _api(ds8, frequency_of_the_test=3, comm_round=10)
    eager.train(ckpt_dir=str(tmp_path / "eager"), ckpt_every=4)
    tracer = telemetry.Tracer()
    api.train(ckpt_dir=str(tmp_path / "fused"), ckpt_every=4, tracer=tracer)
    _same_run(api, eager)
    assert all_checkpoint_steps(str(tmp_path / "fused")) == [4, 8, 10]
    # rounds 1-3, 4-6 and 8-9 in dispatches; 0, 7 (checkpointed) eagerly
    assert [(e["round"], e["rounds"]) for e in tracer.find_events("superstep_committed")] \
        == [(1, 3), (4, 3), (8, 2)]
    resumed = _api(ds8, rounds_per_dispatch=4, frequency_of_the_test=3, comm_round=12)
    resumed.train(ckpt_dir=str(tmp_path / "fused"), ckpt_every=4)
    straight = _api(ds8, frequency_of_the_test=3, comm_round=12)
    straight.train()
    assert _bitwise(resumed.global_variables, straight.global_variables)


class _RejectOnce:
    """Rejects one round once; its ``seen`` list is state the replay must
    find as it was before the chunk."""

    max_retries = 2

    def __init__(self, bad_round):
        self.bad_round, self.fired, self.seen = bad_round, False, []

    def inspect(self, round_idx, loss, global_variables=None):
        self.seen.append(round_idx)
        if round_idx == self.bad_round and not self.fired:
            self.fired = True
            return GuardVerdict(False, "forced test rejection")
        return GuardVerdict(True, "")


@pytest.mark.parametrize("rule", sorted(RULES))
def test_guard_rejection_replays_the_chunk_eagerly(ds8, rule):
    """A rejection of round 3 inside the dispatch of rounds 1-4 rolls the
    chunk back (globals, state, the guard's own state) and replays rounds
    1-4 eagerly, where the eager retry of round 3 runs on the salted
    generator: the run equals the eager loop with the same guard bit for
    bit, history included."""
    eager, fused = _api(ds8, rule, comm_round=6), _api(ds8, rule, comm_round=6,
                                                       rounds_per_dispatch=4)
    ge, gf = _RejectOnce(3), _RejectOnce(3)
    tracer = telemetry.Tracer()
    eager.train(guard=ge)
    fused.train(guard=gf, tracer=tracer)
    _same_run(fused, eager)
    assert fused.history[3]["guard_retries"] == 1
    assert [e["round"] for e in tracer.find_events("guard_rollback")] == [3, 3]
    assert gf.seen[-len(ge.seen):] == ge.seen


def test_incompatible_modes_are_refused(ds8):
    for kw, match in ((dict(pipeline_depth=2), "pipeline_depth"),
                      (dict(buffer_size=4), "buffer_size"),
                      (dict(fused_kernel=True), "fused_kernel"),
                      (dict(backend="shard_map", mesh_shape=(1,)), "shard_map")):
        with pytest.raises(ValueError, match=match):
            FedConfig(rounds_per_dispatch=4, **kw).validate()
    # the CLI drops its pipeline default for a superstep run
    args = main_fedavg.add_args(__import__("argparse").ArgumentParser()).parse_args(
        ["--rounds_per_dispatch", "4", "--device", "cpu"])
    assert main_fedavg.start_run(args).pipeline_depth == 0


@pytest.mark.parametrize("flags", [
    ["--update_codec", "topk", "--codec_k", "16"],
    ["--buffer_size", "5", "--chaos", "1", "--chaos_straggler_rate", "0.3",
     "--chaos_straggler_rounds", "2"],
    ["--rounds_per_dispatch", "2", "--fast_sampling", "1", "--update_codec", "int8"]])
def test_cli_trains_each_axis(tmp_path, flags):
    """``main_fedavg`` takes the codec, buffer, straggler and superstep flags
    (the superstep drops the CLI's pipeline default) and trains: 3 rounds of
    the CLI's MNIST LR on the CPU, finite and evaluated."""
    hist = main_fedavg.main(["--device", "cpu", "--run_dir", str(tmp_path),
                             "--comm_round", "3", "--client_num_per_round", "4",
                             "--frequency_of_the_test", "3"] + flags)
    last = [h for h in hist if "Test/Loss" in h][-1]  # a drain record has no eval
    assert last["round"] == 2 and np.isfinite(last["Test/Loss"]) and last["Test/Acc"] > 0.1
    if "--buffer_size" in flags:
        assert sum(h["buffer_commits"] for h in hist) >= 2


@pytest.mark.parametrize("case", ["fedadam+chaos", "fedavg+int8"])
def test_superstep_matches_jax(ds8, case):
    """6 rounds at K = 2, shuffle off, from the same weights, against the
    JAX package's superstep: FedAdam with float chaos (the records' counts
    and test metrics, the globals and the moments within rtol 2e-5 / atol
    1e-5), and FedAvg with int8, where an ulp between the packages' deltas
    can move an element of t / scale across a rounding midpoint, a whole
    quantization step: there at most 0.2% of the elements may miss (rtol
    2e-5, atol 1e-5), by at most 1e-4."""
    rule, codec = ("fedadam", "none") if case == "fedadam+chaos" else ("fedavg", "int8")
    chaos = case.endswith("chaos")
    kw = _kw(rule, comm_round=6, rounds_per_dispatch=2, update_codec=codec,
             shuffle=False, pipeline_depth=0)
    jds = _capped(jax_load_dataset("mnist", client_num_in_total=8, partition_method="homo",
                                   seed=0), JaxPacked, 48, 256)
    japi = JaxFedAvgAPI(jds, JaxConfig(**kw), JaxTrainer(jax_create_model("lr", output_dim=10)),
                        aggregator_name=RULES[rule][0])
    tm = create_model("lr", output_dim=10, input_shape=ds8.train.x.shape[2:])
    tapi = FedAvgAPI(ds8, FedConfig(**kw), ClassificationTrainer(tm),
                     aggregator_name=RULES[rule][0], device="cpu")
    tapi.global_variables = flax_to_torch(japi.global_variables, module=tm)
    plan = dict(seed=4, drop_rate=0.2, nan_rate=0.2, corrupt_rate=0.2)
    jhist = japi.train(chaos=JaxPlan(**plan) if chaos else None)
    thist = tapi.train(chaos=FaultPlan(**plan) if chaos else None)
    keys = ("participated_count", "quarantined_count", "chaos_dropped", "chaos_nan")
    assert [{k: h.get(k) for k in keys} for h in thist] == [
        {k: h.get(k) for k in keys} for h in jhist]
    if chaos:
        assert sum(h["quarantined_count"] for h in thist) >= 1
    for key in ("Test/Acc", "Test/Loss"):
        np.testing.assert_allclose([h[key] for h in thist if key in h],
                                   [h[key] for h in jhist if key in h],
                                   rtol=2e-5, atol=1e-5, err_msg=key)
    pairs = [(tapi.global_variables, flax_to_torch(japi.global_variables, module=tm), "")]
    if rule == "fedadam":
        want = optax_state_to_torch(japi.agg_state)
        pairs += [(tapi.agg_state[m], want[m], m) for m in ("mu", "nu")]
    for got, want, tag in pairs:
        for k in want:
            a, b = got[k].numpy(), want[k].numpy()
            if codec == "none":
                np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-5, err_msg=f"{tag} {k}")
                continue
            miss = ~np.isclose(a, b, rtol=2e-5, atol=1e-5)
            assert miss.mean() <= 2e-3, (k, miss.sum())
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=k)
