"""The port's client ledger (``fedml_tpu_torch/telemetry/client_ledger.py``)
against the JAX package's: the same blocks applied by both give the same
shard files byte for byte, and a ledger written by either reads the same in
the other; a drive's ledger matches the JAX drive's (its counters bit for
bit, its float columns within 2e-5); the ledger on or off gives the same
globals bit for bit; the buffered drive's staleness lands in it as in the
JAX package's; resume and the mismatch checks.

MNIST logistic regression on 8 homo clients capped at 48 rows, shuffle
off (no dropout in the model): both packages train from the same weights
on the same streams, with the same seeded fault plans."""

import os

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
from fedml_tpu.telemetry import client_ledger as jax_ledger
from fedml_tpu_torch import ClassificationTrainer, FedAvgAPI, FedConfig
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.robustness.chaos import FaultPlan
from fedml_tpu_torch.telemetry import client_ledger
from fedml_tpu_torch.utils.convert import flax_to_torch
from fedml_tpu_torch.utils.pytree import tree_leaves
from test_torch_fedavg import _capped

INT_COLUMNS = ("participation_count", "drop_count", "quarantine_count", "staleness_sum",
               "last_seen_round")
FLOAT_COLUMNS = ("ema_update_norm", "ema_loss")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files(root):
    return {name: open(os.path.join(root, name), "rb").read()
            for name in sorted(os.listdir(root))}


def _blocks(seed=0, n=12, rounds=4, cohort=5):
    rng = np.random.RandomState(seed)
    out = []
    for r in range(rounds):
        idx = rng.choice(n, cohort, replace=False)
        out.append({"round": r, "client_idx": idx,
                    "participated": rng.rand(cohort) > 0.2,
                    "stats": {"update_norm": rng.rand(cohort).astype(np.float32) * 3,
                              "finite": rng.rand(cohort) > 0.2,
                              "loss_sum": rng.rand(cohort).astype(np.float32) * 10,
                              "total": rng.randint(1, 9, cohort).astype(np.float32)}})
        out.append({"round": r, "client_idx": idx[:2],
                    "staleness": rng.randint(0, 4, 2).astype(np.int32)})
    return out


def test_same_blocks_give_byte_identical_shards(tmp_path):
    """Stats and staleness blocks over three shards, applied by each
    package to its own ledger: every file is the same bytes; each package
    reads the other's ledger to the same columns."""
    roots = {}
    for name, mod in (("jax", jax_ledger), ("torch", client_ledger)):
        roots[name] = str(tmp_path / name)
        led = mod.create_ledger(roots[name], 12, clients_per_shard=5)
        for block in _blocks():
            led.apply(block)
        led.close()
    assert _files(roots["jax"]) == _files(roots["torch"])
    theirs = client_ledger.open_or_create(roots["jax"], 12)
    ours = jax_ledger.open_or_create(roots["torch"], 12)
    for column, _, _ in client_ledger.COLUMNS:
        assert np.array_equal(theirs.column(column), ours.column(column))
    assert client_ledger.COLUMNS == jax_ledger.COLUMNS


@pytest.fixture(scope="module")
def datasets():
    jds = _capped(jax_load_dataset("mnist", client_num_in_total=8, partition_method="homo",
                                   seed=0), JaxPacked, 48, 256)
    tds = _capped(load_dataset("mnist", client_num_in_total=8, partition_method="homo",
                               seed=0, flatten=True), PackedClients, 48, 256)
    return jds, tds


def _kw(**kw):
    return {**dict(dataset="mnist", model="lr", client_num_in_total=8,
                   client_num_per_round=5, batch_size=16, lr=0.1, comm_round=4,
                   shuffle=False, seed=0, pipeline_depth=0), **kw}


def _pair(datasets, **kw):
    jds, tds = datasets
    japi = JaxFedAvgAPI(jds, JaxConfig(**_kw(**kw)),
                        JaxTrainer(jax_create_model("lr", output_dim=10)))
    tm = create_model("lr", output_dim=10, input_shape=tds.train.x.shape[2:])
    tapi = FedAvgAPI(tds, FedConfig(**_kw(**kw)), ClassificationTrainer(tm), device="cpu")
    tapi.global_variables = flax_to_torch(japi.global_variables, module=tm)
    return japi, tapi


def _assert_ledgers_match(tled, jled):
    for column in INT_COLUMNS:
        assert np.array_equal(tled.column(column), jled.column(column)), column
    for column in FLOAT_COLUMNS:
        np.testing.assert_allclose(tled.column(column), jled.column(column),
                                   rtol=2e-5, atol=2e-5, err_msg=column)


@pytest.mark.parametrize("depth", [0, 2])
def test_drive_ledger_matches_jax(datasets, tmp_path, depth):
    """A 4-round drive with drops and NaN faults, eager and pipelined: the
    counters equal the JAX drive's, the EMAs within 2e-5."""
    japi, tapi = _pair(datasets, pipeline_depth=depth)
    jled = jax_ledger.create_ledger(str(tmp_path / "jax"), 8)
    tled = client_ledger.create_ledger(str(tmp_path / "torch"), 8)
    plan = dict(seed=4, drop_rate=0.2, nan_rate=0.2)
    japi.train(chaos=JaxPlan(**plan), ledger=jled)
    tapi.train(chaos=FaultPlan(**plan), ledger=tled)
    assert tled.column("quarantine_count").sum() > 0
    assert tled.column("drop_count").sum() > 0
    _assert_ledgers_match(tled, jled)


def test_superstep_ledger_equals_the_eager_loops(datasets, tmp_path):
    """The superstep's stats rows ([K, C]) fill the ledger as the eager
    loop's do, bit for bit."""
    _, tds = datasets
    leds = []
    for i, kw in enumerate((dict(), dict(rounds_per_dispatch=3, frequency_of_the_test=100))):
        tm = create_model("lr", output_dim=10, input_shape=tds.train.x.shape[2:])
        api = FedAvgAPI(tds, FedConfig(**_kw(comm_round=5, **kw)), ClassificationTrainer(tm),
                        device="cpu")
        led = client_ledger.create_ledger(str(tmp_path / str(i)), 8)
        api.train(ledger=led, chaos=FaultPlan(seed=2, drop_rate=0.2))
        leds.append(led)
    for column, _, _ in client_ledger.COLUMNS:
        assert np.array_equal(leds[0].column(column), leds[1].column(column)), column


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


@pytest.mark.parametrize("kw", [dict(pipeline_depth=2), dict(buffer_size=3),
                                dict(lora_rank=4, pipeline_depth=2),
                                dict(rounds_per_dispatch=2, frequency_of_the_test=100)],
                         ids=["pipelined", "buffered", "lora", "superstep"])
def test_ledger_on_and_off_are_bitwise_equal(datasets, tmp_path, kw):
    _, tds = datasets
    runs = []
    for ledger in (None, client_ledger.create_ledger(str(tmp_path / "led"), 8)):
        tm = create_model("lr", output_dim=10, input_shape=tds.train.x.shape[2:])
        api = FedAvgAPI(tds, FedConfig(**_kw(**kw)), ClassificationTrainer(tm), device="cpu")
        api.train(ledger=ledger)
        runs.append(api)
    assert _bitwise(runs[0].global_variables, runs[1].global_variables)
    assert _bitwise(runs[0].agg_state, runs[1].agg_state)
    assert not any(k.startswith("_") for h in runs[1].history for k in h)


@pytest.mark.parametrize("kw", [dict(), dict(buffer_size=3),
                                dict(rounds_per_dispatch=2, frequency_of_the_test=100)],
                         ids=["eager", "buffered", "superstep"])
def test_stats_rows_are_computed_only_with_a_ledger(datasets, tmp_path, monkeypatch, kw):
    """Without a ledger no round computes the ledger's stats rows; with
    one attached, the rounds do."""
    from fedml_tpu_torch.algorithms import buffered, engine

    calls = []
    real = engine.cohort_stats

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(engine, "cohort_stats", counting)
    monkeypatch.setattr(buffered, "cohort_stats", counting)
    _, tds = datasets
    counts = []
    for ledger in (None, client_ledger.create_ledger(str(tmp_path / "led"), 8)):
        calls.clear()
        tm = create_model("lr", output_dim=10, input_shape=tds.train.x.shape[2:])
        api = FedAvgAPI(tds, FedConfig(**_kw(**kw)), ClassificationTrainer(tm), device="cpu")
        api.train(ledger=ledger)
        counts.append(len(calls))
    assert counts[0] == 0 and counts[1] > 0, counts


def test_buffered_staleness_lands_in_the_ledger(datasets, tmp_path):
    """FedBuff under the straggler plan: the per-client staleness sums and
    the participation counters equal the JAX drive's, and some update was
    committed stale."""
    kw = dict(buffer_size=4, staleness_alpha=0.5, comm_round=5)
    japi, tapi = _pair(datasets, **kw)
    jled = jax_ledger.create_ledger(str(tmp_path / "jax"), 8)
    tled = client_ledger.create_ledger(str(tmp_path / "torch"), 8)
    plan = dict(seed=5, straggler_rate=0.3, straggler_rounds=2)
    japi.train(chaos=JaxPlan(**plan), ledger=jled)
    tapi.train(chaos=FaultPlan(**plan), ledger=tled)
    assert tled.column("staleness_sum").sum() > 0
    _assert_ledgers_match(tled, jled)


def test_resume_and_mismatch_checks(tmp_path):
    root = str(tmp_path / "led")
    led = client_ledger.open_or_create(root, 10, clients_per_shard=4)
    assert led.shard_rows == [4, 4, 2]
    assert np.all(led.column("last_seen_round") == -1)
    led.update(0, client_idx=[1, 5, 9], participated=[True, True, False],
               update_norm=[1.0, 2.0, 3.0], finite=[True, False, True],
               loss_sum=[2.0, 4.0, 6.0], total=[2.0, 2.0, 2.0])
    assert led.column("ema_update_norm")[[1, 5, 9]].tolist() == [1.0, 0.0, 0.0]
    led.close()
    reopened = client_ledger.open_or_create(root, 10)
    assert reopened.shard_rows == [4, 4, 2]  # the header wins over the default
    assert reopened.column("participation_count")[[1, 5, 9]].tolist() == [1, 1, 0]
    assert reopened.column("quarantine_count")[[1, 5, 9]].tolist() == [0, 1, 0]
    with pytest.raises(IndexError):
        reopened.update(0, client_idx=[10], participated=[True], update_norm=[0.0],
                        finite=[True], loss_sum=[0.0], total=[1.0])
    with pytest.raises(ValueError, match="unknown ledger block"):
        reopened.apply({"round": 0, "client_idx": np.array([0])})
    reopened.close()
    with pytest.raises(ValueError, match="holds 10 clients"):
        client_ledger.open_or_create(root, 11)
    with pytest.raises(ValueError, match="num_clients must be positive"):
        client_ledger.create_ledger(str(tmp_path / "empty"), 0)


def test_cli_client_ledger_dir(tmp_path):
    """``--client_ledger_dir`` on the CLI: the ledger covers the whole
    population and counts every dispatched client."""
    from fedml_tpu_torch.experiments import main_fedavg

    main_fedavg.main(["--device", "cpu", "--client_num_in_total", "6",
                      "--client_num_per_round", "3", "--comm_round", "2",
                      "--run_dir", str(tmp_path / "run"),
                      "--client_ledger_dir", str(tmp_path / "led")])
    led = client_ledger.open_or_create(str(tmp_path / "led"), 6)
    assert led.column("participation_count").sum() == 6
