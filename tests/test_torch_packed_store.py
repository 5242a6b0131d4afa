"""The port's out-of-core data plane against the JAX package's: the mmap
shard store (``fedml_tpu_torch/data/packed_store.py``, the same on-disk
format: a store written by either package opens in the other, ``select``
byte-identical for seeded cohorts), the Feistel sampler
(``fast_client_sampling``, bitwise), ``FedAvgAPI`` over a store equal bit
for bit to the in-RAM run (eager, pipelined, with chaos, across a store
close and reopen), the store's gauges through the port's tracer, and the
round's host counts (the same bits with and without them; a round in
which no client survives keeps the aggregator state, selected on the
device). The cases mirror ``tests/test_packed_store.py`` at the same
sizes: MNIST logistic regression, 8 homo clients capped at 48 rows."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import fast_client_sampling as jax_fast_client_sampling
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.data.packed_store import MmapPackedStore as JaxStore
from fedml_tpu.data.packed_store import write_packed_shards as jax_write_packed_shards
from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch import ClassificationTrainer, FedAvgAPI, FedConfig, telemetry
from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import build_round_fn
from fedml_tpu_torch.algorithms import fedavg as fedavg_module
from fedml_tpu_torch.algorithms.fedavg import client_sampling, fast_client_sampling
from fedml_tpu_torch.data import packed_store
from fedml_tpu_torch.data.packed_store import (DEFAULT_CLIENTS_PER_SHARD, MmapPackedStore,
                                               create_synthetic_store, materialize,
                                               resident_train_arrays, write_packed_shards)
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.robustness.chaos import FaultPlan
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.utils.pytree import tree_leaves
from test_torch_fedavg import _capped

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _cfg(comm_round, **kw):
    kw.setdefault("client_num_per_round", 8)
    return FedConfig(dataset="mnist", model="lr", comm_round=comm_round, batch_size=8,
                     lr=0.05, client_num_in_total=8, seed=0, **kw)


def _api(ds, cfg, aggregator="fedavg"):
    model = create_model("lr", output_dim=ds.class_num, input_shape=ds.train.x.shape[2:])
    return FedAvgAPI(ds, cfg, ClassificationTrainer(model), aggregator_name=aggregator,
                     device="cpu")


def _bitwise_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    return all(x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def _same_run(a, b):
    assert _bitwise_equal(a.global_variables, b.global_variables)
    assert _bitwise_equal(a.agg_state, b.agg_state)
    strip = lambda h: [{k: v for k, v in r.items() if k != "round_time"} for r in h]
    assert strip(a.history) == strip(b.history)


def _random_packed(clients=37, n_max=5, shape=(4, 3), seed=0, cls=PackedClients):
    rng = np.random.RandomState(seed)
    x = rng.rand(clients, n_max, *shape).astype(np.float32)
    y = rng.randint(0, 7, size=(clients, n_max)).astype(np.int32)
    counts = rng.randint(1, n_max + 1, size=clients).astype(np.int64)
    return cls(x, y, counts)


def _store_ds(ds, tmp_path, name="mnist_store", clients_per_shard=3):
    """``ds`` with its train split rewritten through a shard store (3
    clients a shard: every cohort gathers from several shards)."""
    d = str(tmp_path / name)
    write_packed_shards(d, ds.train, clients_per_shard=clients_per_shard)
    return dataclasses.replace(ds, train=MmapPackedStore(d)), d


# ------------------------------------------------------------ the store


WRITERS = {"port": write_packed_shards, "jax": jax_write_packed_shards}
READERS = {"port": MmapPackedStore, "jax": JaxStore}


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_store_select_bit_identical_for_seeded_cohorts(tmp_path, writer, reader):
    """A store written by either package reads back in either with the
    source's bytes: header, counts, ``select`` of seeded cohorts, the
    facade's reads."""
    packed = _random_packed(cls=PackedClients if writer == "port" else JaxPacked)
    d = str(tmp_path / "store")
    WRITERS[writer](d, packed, clients_per_shard=8, chunk_clients=5)
    store = READERS[reader](d)
    assert store.num_clients == packed.num_clients
    assert store.n_max == packed.n_max
    assert store.total_samples == int(packed.counts.sum())
    assert np.array_equal(np.asarray(store.counts), packed.counts)
    for round_idx in range(12):
        idx = client_sampling(round_idx, packed.num_clients, 9)
        sx, sy, sc = store.select(idx)
        px, py, pc = packed.select(idx)
        for got, want in ((sx, px), (sy, py), (sc, pc)):
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert np.array_equal(np.asarray(store.x[:1, 0]), packed.x[:1, 0])
    assert np.array_equal(np.asarray(store.y[11]), packed.y[11])
    store.close()


def test_store_header_and_multi_shard_layout(tmp_path):
    packed = _random_packed(clients=10)
    d = str(tmp_path / "store")
    write_packed_shards(d, packed, clients_per_shard=4)
    with open(os.path.join(d, "store.json")) as f:
        header = json.load(f)
    assert header["num_clients"] == 10
    assert header["shard_rows"] == [4, 4, 2]  # a new shard every 4 clients
    assert os.path.exists(os.path.join(d, "shard_00002.x"))
    store = MmapPackedStore(d)
    idx = np.array([9, 0, 5, 3, 8])  # a cohort across all three shards
    assert np.array_equal(store.select(idx)[0], packed.x[idx])
    with pytest.raises(IndexError):
        store.select(np.array([10]))
    store.close()


def test_materialize_and_resident_arrays_are_the_whole_reads(tmp_path):
    packed = _random_packed(clients=6)
    d = str(tmp_path / "store")
    write_packed_shards(d, packed, clients_per_shard=4)
    store = MmapPackedStore(d)
    full = materialize(store)
    assert np.array_equal(full.x, packed.x) and np.array_equal(full.y, packed.y)
    with pytest.raises(ValueError):  # the byte budget refuses a whole pull
        materialize(store, budget=16)
    x, y, counts = resident_train_arrays(store, torch.device("cpu"))
    assert torch.equal(x, torch.from_numpy(packed.x))
    assert torch.equal(counts, torch.from_numpy(packed.counts))
    assert resident_train_arrays(store, torch.device("cpu"), budget=16) is None
    store.close()


def test_synthetic_store_is_sparse_and_zero_filled(tmp_path):
    d = str(tmp_path / "synth")
    create_synthetic_store(d, 5000, n_max=4, sample_shape=(8,), clients_per_shard=2048)
    store = MmapPackedStore(d)
    x, y, counts = store.select(np.array([0, 4999, 2048]))
    assert not x.any() and not y.any()  # holes read as zeros
    assert (counts == 4).all()
    logical = sum(os.stat(os.path.join(d, f)).st_size for f in os.listdir(d))
    physical = sum(os.stat(os.path.join(d, f)).st_blocks * 512 for f in os.listdir(d))
    assert physical < logical / 10  # sparse on disk
    store.close()


def test_closed_store_refuses_reads(tmp_path):
    d = str(tmp_path / "store")
    write_packed_shards(d, _random_packed(clients=4))
    store = MmapPackedStore(d)
    store.close()
    with pytest.raises(ValueError):
        store.select(np.array([0]))


def test_default_shard_size_sane():
    # a shard never holds zero clients
    assert DEFAULT_CLIENTS_PER_SHARD >= 1
    with pytest.raises(ValueError):
        packed_store.ShardWriter("unused", clients_per_shard=0)


# ------------------------------------------------------ drive identity


@pytest.mark.parametrize("drive,chaos", [("eager", False), ("eager", True),
                                         ("pipelined", True)])
def test_fedavg_from_store_bit_identical_to_in_ram(ds8, tmp_path, drive, chaos, monkeypatch):
    """FedAvgAPI over a store equals the in-RAM eager run bit for bit
    (globals, state, history with every round's evaluation), the pipelined
    drive's stager thread gathering from the store under a fault schedule.
    One read of the whole store, and only one: the resident eval's
    ``materialize`` of the in-budget train split at the first evaluation
    (the JAX drive's rule); otherwise the facade's ``__array__`` is never
    called and no gather takes more clients than a cohort."""
    plan = (lambda: FaultPlan(seed=3, drop_rate=0.25, nan_rate=0.25)) if chaos else None
    ram = _api(ds8, _cfg(5))
    ram.train(chaos=plan and plan())
    store_ds, _ = _store_ds(ds8, tmp_path)
    gathered, reads = [], []
    gather = MmapPackedStore._gather
    array = packed_store._MmapField.__array__

    def counted(self, idx, field):
        gathered.append(len(idx))
        return gather(self, idx, field)

    def whole(*_):
        raise AssertionError("a whole-store read")

    def resident_read(store, budget):
        reads.append(store)
        with monkeypatch.context() as m:
            m.setattr(packed_store._MmapField, "__array__", array)
            return packed_store.materialize(store, budget=budget)

    monkeypatch.setattr(MmapPackedStore, "_gather", counted)
    monkeypatch.setattr(packed_store._MmapField, "__array__", whole)
    monkeypatch.setattr(fedavg_module, "materialize", resident_read)
    stored = _api(store_ds, _cfg(5, pipeline_depth=2 if drive == "pipelined" else 0))
    stored.train(chaos=plan and plan())
    _same_run(stored, ram)
    assert reads == [store_ds.train]
    assert max(gathered) <= 8
    store_ds.train.close()


@pytest.mark.parametrize("drive", ["eager", "pipelined"])
def test_checkpoint_resume_across_store_close_reopen(ds8, tmp_path, drive):
    """Stop at round 3, close the store (the process dies), reopen the same
    directory in a new store and API: the resumed run equals a straight
    in-RAM run."""
    depth = 2 if drive == "pipelined" else 0
    straight = _api(ds8, _cfg(6))
    straight.train()
    ck = str(tmp_path / "ckpt")
    store_ds, store_dir = _store_ds(ds8, tmp_path)
    first = _api(store_ds, _cfg(3, pipeline_depth=depth))
    first.train(ckpt_dir=ck, ckpt_every=100)
    store_ds.train.close()
    reopened = dataclasses.replace(ds8, train=MmapPackedStore(store_dir))
    resumed = _api(reopened, _cfg(6, pipeline_depth=depth))
    assert len(resumed.train(ckpt_dir=ck, ckpt_every=100)) == 6
    assert _bitwise_equal(resumed.global_variables, straight.global_variables)
    assert _bitwise_equal(resumed.agg_state, straight.agg_state)
    reopened.train.close()


# ------------------------------------------------------ observability


def test_store_gauges_flow_through_telemetry_seam(tmp_path):
    packed = _random_packed(clients=12)
    d = str(tmp_path / "store")
    write_packed_shards(d, packed, clients_per_shard=4)
    store = MmapPackedStore(d, cache_budget=1 << 20)
    t = telemetry.Tracer()
    telemetry.install(t)
    try:
        store.select(np.array([0, 5, 9]))
        store.select(np.array([0, 5, 9]))  # the second pass hits the row cache
    finally:
        telemetry.uninstall(t)
    by_name = {}
    for g in t.gauges:
        by_name.setdefault(g["name"], []).append(g)
    assert by_name["store_decode_miss"][0]["count"] == 3
    assert by_name["store_decode_hit"][-1]["count"] == 3
    assert by_name["store_resident_bytes"][-1]["bytes"] > 0
    assert all(g["store"] == "mmap" for gs in by_name.values() for g in gs)
    table = t.summary_table()
    assert "store_decode_hit" in table and "store_resident_bytes" in table
    assert store.resident_clients() == [0, 5, 9]
    store.close()


def test_row_cache_evicts_to_its_budget(tmp_path):
    """The LRU keeps the newest rows within ``cache_budget`` bytes, never
    evicting the cohort being selected."""
    packed = _random_packed(clients=12)
    d = str(tmp_path / "store")
    write_packed_shards(d, packed, clients_per_shard=4)
    row = packed.x[0].nbytes + packed.y[0].nbytes
    store = MmapPackedStore(d, cache_budget=4 * row)
    store.select(np.array([0, 1, 2]))
    x, _, _ = store.select(np.array([3, 4]))
    assert store.resident_clients() == [1, 2, 3, 4]
    assert store.resident_bytes == 4 * row
    assert np.array_equal(x, packed.x[[3, 4]])
    store.close()


# ------------------------------------------------------ sampling


@pytest.mark.parametrize("total,per_round", [
    (2, 1), (2, 2), (3, 5), (10, 10), (17, 5), (1000, 10), (3400, 10), (65537, 64),
    (100_000, 64), (1_000_000, 64), (1_000_000, 1000)])
@pytest.mark.parametrize("round_idx", [0, 1, 7, 1499])
def test_fast_client_sampling_bitwise(round_idx, total, per_round):
    got = fast_client_sampling(round_idx, total, per_round)
    want = jax_fast_client_sampling(round_idx, total, per_round)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert len(set(got.tolist())) == len(got) == min(total, per_round)
    assert got.min() >= 0 and got.max() < total


def test_fast_sampling_drive_matches_jax():
    """``fast_sampling`` samples the JAX drive's client ids in every round,
    and three rounds of the engine (shuffle off) end within the engine
    parity tests' tolerance of the JAX drive's globals."""
    kw = dict(dataset="mnist", model="lr", client_num_in_total=20, client_num_per_round=4,
              batch_size=16, lr=0.1, epochs=1, comm_round=3, shuffle=False, seed=0,
              fast_sampling=True)
    load = dict(client_num_in_total=20, partition_method="homo", seed=0)
    jds = _capped(jax_load_dataset("mnist", **load), JaxPacked, 32, 64)
    tds = _capped(load_dataset("mnist", **load), PackedClients, 32, 64)
    jcfg, tcfg = JaxConfig(**kw), FedConfig(**kw)
    japi = JaxFedAvgAPI(jds, jcfg, JaxTrainer(jax_create_model("lr", output_dim=10)))
    model = create_model("lr", output_dim=10, input_shape=tds.train.x.shape[2:])
    tapi = FedAvgAPI(tds, tcfg, ClassificationTrainer(model), device="cpu")
    for r in range(5):
        want = np.asarray(japi._stage_cohort(r).client_idx)
        got = tapi._stage_cohort(r).client_idx
        assert np.array_equal(got, want)
        assert not np.array_equal(got, client_sampling(r, 20, 4))
    tapi.global_variables = flax_to_torch(japi.global_variables)
    japi.train()
    tapi.train()
    got = torch_to_flax(tapi.global_variables)["params"]
    for layer, leaves in japi.global_variables["params"].items():
        for kind, want in leaves.items():
            np.testing.assert_allclose(got[layer][kind], np.asarray(want), rtol=2e-5,
                                       atol=1e-5, err_msg=f"{layer}.{kind}")


def test_cli_takes_fast_sampling(tmp_path):
    from fedml_tpu_torch.experiments import main_fedavg

    hist = main_fedavg.main(["--client_num_in_total", "6", "--client_num_per_round", "2",
                             "--comm_round", "1", "--fast_sampling", "1", "--device", "cpu",
                             "--run_dir", str(tmp_path)])
    with open(tmp_path / "config.json") as f:
        assert json.load(f)["fast_sampling"] == 1
    assert len(hist) == 1 and np.isfinite(hist[0]["loss_sum"])


# ------------------------------------------------------ host counts


@pytest.mark.parametrize("rule,mask", [("fedavg", None), ("fedadam", "some"),
                                       ("fedadam", "none")])
def test_round_bits_do_not_depend_on_host_counts(ds8, rule, mask):
    """The engine round reads the counts from ``host_counts`` when given,
    else from the device: the same bits. A round in which no client
    survives keeps FedAdam's state (selected on the device) and the
    globals; one with survivors moves them."""
    extra = dict(server_optimizer="adam", server_lr=0.01) if rule == "fedadam" else {}
    cfg = _cfg(1, **extra)
    aggregator = make_aggregator("fedopt" if rule == "fedadam" else "fedavg", cfg)
    model = create_model("lr", output_dim=ds8.class_num, input_shape=ds8.train.x.shape[2:])
    trainer = ClassificationTrainer(model)
    round_fn = build_round_fn(trainer, cfg, aggregator, device="cpu")
    gv = trainer.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    state = aggregator.init_state(gv)
    x, y, counts = ds8.train.select(np.arange(8))
    counts = counts.copy()
    counts[::3] = [5, 17, 40]  # ragged: shuffles and masks depend on the counts
    part = {None: None, "some": np.arange(8) % 4 != 1, "none": np.zeros(8, bool)}[mask]
    args = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(counts))
    part = None if part is None else torch.from_numpy(part)
    runs = [round_fn(gv, state, *args, torch.Generator().manual_seed(4), part, None, None,
                     host) for host in (None, counts)]
    assert _bitwise_equal(runs[0], runs[1])
    new_gv, new_state, _ = runs[0]
    if mask == "none":
        assert _bitwise_equal((new_gv, new_state), (gv, state))
    else:
        assert not _bitwise_equal(new_gv, gv)
        if rule == "fedadam":
            assert int(new_state["count"]) == 1


# ------------------------------------------------------ phase 7's builder


def test_flagship_store_builder_holds_the_surrogate(tmp_path):
    """``chip_smoke.build_femnist_store`` streams the FEMNIST surrogate into
    train and test stores padded to the surrogate's clip: the rows, counts
    and global test set of ``load_dataset("femnist")``, padding zeros; at
    12 clients no client reaches the clip, so the width check refuses
    them."""
    built = chip_smoke.build_femnist_store(str(tmp_path), 12, seed=0, chunk=5)
    ds = load_dataset("femnist", client_num_in_total=12, seed=0)
    for split, packed in (("train", ds.train), ("test", ds.test)):
        store = MmapPackedStore(str(tmp_path / split))
        x, y, counts = store.select(np.arange(12))
        n = packed.n_max
        assert store.n_max == built["widths"][split] > n == built["largest"][split]
        assert counts.dtype == packed.counts.dtype and np.array_equal(counts, packed.counts)
        assert x[:, :n].tobytes() == packed.x.tobytes() and not x[:, n:].any()
        assert y[:, :n].tobytes() == packed.y.tobytes() and not y[:, n:].any()
        store.close()
    with np.load(tmp_path / "test_global.npz") as f:
        assert f["x"].tobytes() == ds.test_global[0].tobytes()
        assert f["y"].tobytes() == ds.test_global[1].tobytes()
    with pytest.raises(RuntimeError, match="padded widths"):
        chip_smoke.check_store_widths(built)


def test_flagship_tolerance_rejects_faulted_results():
    """``chip_smoke.TOL_480``, phase 7's float32 limits at 10 x 480 rows,
    passes a copy off by float32 rounding and rejects the 17 faulted copies
    of ``check_controls`` (rel_max stays under a skipped leaf's 1) and a
    copy with one exponent bit of one element flipped."""
    from fedml_tpu_torch.ops import fused_sgd
    from test_torch_fused_sgd import _data, _flax_params, _specs

    tol = chip_smoke.TOL_480
    x, y, seeds = _data()
    gv = flax_to_torch(_flax_params(x))
    _, spec = _specs("float32")
    plain, _ = fused_sgd.fused_epoch_reference(spec, gv, torch.from_numpy(x),
                                               torch.from_numpy(y), torch.from_numpy(seeds))
    gen = torch.Generator().manual_seed(0)
    sound = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen)) for k, v in plain.items()}
    chip_smoke.check_agreement("sound", sound, plain, gv, tol, tol["outliers"])
    assert chip_smoke.check_controls("controls", plain, gv, tol, tol["outliers"]) == 17
    key = "linear_1.weight"
    faulted = plain[key].clone()
    faulted.view(-1)[:1].view(torch.int32).bitwise_xor_(1 << 30)
    with pytest.raises(chip_smoke.Disagreement):
        chip_smoke.check_agreement("one bit", {**plain, key: faulted}, plain, gv, tol,
                                   tol["outliers"])


def test_store_and_scale_modules_import_no_jax():
    code = ("import sys\n"
            "import fedml_tpu_torch.data.packed_store, fedml_tpu_torch.experiments.scale_rss\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'fedml_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
