"""The port's personal adapter bank (``fedml_tpu_torch/models/adapter_bank.py``)
and personalized round against the JAX package's: ``pack_rows``,
``unpack_rows`` and ``spill_leaves`` give the JAX bytes; a bank written by
either package reads the same in the other (header, rows and sidecars);
``cluster_rows`` is bitwise; one personalized round matches the JAX
round's; a fresh bank's round (every row zero) is the shared round bit for
bit; dead clients' rows pass through; the personalized drive pipelined
equals it eager, and resumes bit for bit; layout mismatches are rejected.

The personalized rounds run MNIST logistic regression behind rank-4 LoRA,
shuffle off (no dropout in the model), the JAX package's adapters injected
through the converter. Tolerances rtol 2e-5, atol 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.aggregators import make_aggregator as jax_aggregator
from fedml_tpu.algorithms.engine import build_personal_round_fn as jax_personal_round_fn
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.core.trainer import NWPTrainer as JaxNWPTrainer
from fedml_tpu.models import adapter_bank as jax_bank
from fedml_tpu.models.lora import LoRATrainer as JaxLoRA
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.models.transformer import TransformerLM as JaxTLM
from fedml_tpu.utils import packed_leaves as jax_packed
from fedml_tpu_torch import ClassificationTrainer, FedAvgAPI, FedConfig, NWPTrainer
from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import build_personal_round_fn, build_round_fn
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.models import adapter_bank
from fedml_tpu_torch.models.lora import LoRATrainer, strip_lora_base
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.robustness.chaos import FaultPlan
from fedml_tpu_torch.telemetry import client_ledger
from fedml_tpu_torch.utils import packed_leaves
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.utils.pytree import split_variables, tree_leaves
from test_torch_fedavg import _capped

RANK = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_packed_leaf_bytes_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    leaves = [rng.randn(3, 4, 2).astype(np.float32), np.arange(6, dtype=np.int32),
              np.float32(2.5) * np.ones((), np.float32), None, 7,
              np.zeros((0, 3), np.float32), rng.randn(3, 5).astype(np.float16)]
    got = packed_leaves.spill_leaves(str(tmp_path / "t.bin"), leaves)
    want = jax_packed.spill_leaves(str(tmp_path / "j.bin"), leaves)
    assert got == want
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    back = packed_leaves.load_leaves(str(tmp_path / "j.bin"), *want[:2])
    for a, b in zip(back, leaves):
        if isinstance(b, np.ndarray):
            assert np.array_equal(a, b) and a.shape == b.shape
    stacked = [rng.randn(5, 3, 2).astype(np.float32), rng.randn(5, 4).astype(np.float32)]
    entries, width = packed_leaves.leaf_layout([s[0] for s in stacked])
    assert (entries, width) == jax_packed.leaf_layout([s[0] for s in stacked])
    rows = packed_leaves.pack_rows(stacked, entries, width)
    assert np.array_equal(rows, jax_packed.pack_rows(stacked, entries, width))
    for a, b in zip(packed_leaves.unpack_rows(rows, entries), stacked):
        assert np.array_equal(a, b)
    runs = list(packed_leaves.coalesced_runs(np.array([1, 2, 3, 3, 7, 8])))
    assert runs == list(jax_packed.coalesced_runs(np.array([1, 2, 3, 3, 7, 8])))


def _templates():
    """The JAX and the port's adapter templates of the same small
    transformer at rank 4 (zeros)."""
    jm = JaxTLM(vocab_size=64, d_model=32, heads=2, num_layers=1, max_len=24)
    jgv = JaxLoRA(JaxNWPTrainer(jm), rank=RANK).init(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, 20), jnp.int32))
    jtmpl = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jgv["params"])
    tm = create_model("transformer_nwp", output_dim=64, d_model=32, heads=2, num_layers=1,
                      max_len=24)
    tgv = LoRATrainer(NWPTrainer(tm), rank=RANK).init(torch.Generator().manual_seed(0), "cpu")
    return jtmpl, split_variables(strip_lora_base(tgv))[0], tm


def test_banks_read_the_same_in_both_packages(tmp_path):
    """JAX writes rows (and lift) into a 3-shard bank; the port opens it
    with its own template (the header's layout is the same), gathers the
    same values, scatters more rows; the JAX package reads those back.
    Two banks given the same scatters are the same files byte for byte."""
    jtmpl, ttmpl, tm = _templates()
    root = str(tmp_path / "bank")
    jb = jax_bank.create_bank(root, 10, jtmpl, rows_per_shard=4)
    rng = np.random.RandomState(1)
    rows = {p: rng.randn(3, *a.shape).astype(np.float32)
            for p, a in zip(range(len(jax.tree.leaves(jtmpl))), jax.tree.leaves(jtmpl))}
    jrows = jax.tree.unflatten(jax.tree.structure(jtmpl), list(rows.values()))
    jb.scatter([1, 6, 9], jrows)
    jb.write_lift([6], [0.25])
    jb.close()
    tb = adapter_bank.open_or_create(root, 10, ttmpl)
    assert tb.row_nbytes == jb.row_nbytes and tb.entries == jb.entries
    got = tb.gather([9, 1, 6, 0])
    want = torch_to_flax({k: torch.from_numpy(v) for k, v in got.items()}, tm)["params"]
    for path, w in zip(jax.tree.leaves(want), jax.tree.leaves(jrows)):
        assert np.array_equal(path[:3], w[[2, 0, 1]])
        assert not path[3].any()
    assert tb.rows_materialized == 3 and tb.lift_column()[6] == np.float32(0.25)
    new = {k: rng.randn(2, *v.shape).astype(np.float32) for k, v in ttmpl.items()}
    tb.scatter([0, 1], new)
    tb.close()
    jb2 = jax_bank.open_or_create(root, 10, jtmpl)
    back = torch_to_flax({k: torch.from_numpy(v[:1]) for k, v in new.items()}, tm)["params"]
    for got_leaf, want_leaf in zip(jax.tree.leaves(jb2.gather([0])), jax.tree.leaves(back)):
        assert np.array_equal(got_leaf, want_leaf)
    assert jb2.rows_materialized == 4
    sides = adapter_bank.read_side_columns(root)
    jsides = jax_bank.read_side_columns(root)
    assert all(np.array_equal(sides[k], jsides[k]) for k in jsides)
    # the same scatters through each package give the same bytes
    roots = (str(tmp_path / "j2"), str(tmp_path / "t2"))
    b1 = jax_bank.create_bank(roots[0], 6, jtmpl, rows_per_shard=4)
    b2 = adapter_bank.create_bank(roots[1], 6, ttmpl, rows_per_shard=4)
    b1.scatter([5, 2], jax.tree.map(lambda a: a[:2], jrows))
    b2.scatter([5, 2], {k: v[:2] for k, v in flax_to_torch(
        {"params": jax.tree.map(lambda a: a[:2], jrows)}, module=tm).items()})
    b1.close()
    b2.close()
    for name in sorted(os.listdir(roots[0])):
        assert (open(os.path.join(roots[0], name), "rb").read()
                == open(os.path.join(roots[1], name), "rb").read()), name


def test_cluster_rows_bitwise():
    ema = np.random.RandomState(0).rand(1000).astype(np.float32) * 5
    for k in (1, 2, 4, 7):
        assert np.array_equal(adapter_bank.cluster_rows(ema, k),
                              jax_bank.cluster_rows(ema, k))
    with pytest.raises(ValueError):
        adapter_bank.cluster_rows(ema, 0)


def test_layout_mismatches_are_rejected(tmp_path):
    _, ttmpl, _ = _templates()
    root = str(tmp_path / "bank")
    adapter_bank.create_bank(root, 5, ttmpl).close()
    wider = {k: torch.zeros(v.shape[0], 2 * RANK) if k.endswith("lora_A")
             else torch.zeros(2 * RANK, v.shape[1]) for k, v in ttmpl.items()}
    with pytest.raises(ValueError, match="different adapter layout"):
        adapter_bank.open_or_create(root, 5, wider)
    with pytest.raises(ValueError, match="holds 5 rows"):
        adapter_bank.open_or_create(root, 6, ttmpl)
    with pytest.raises(IndexError):
        adapter_bank.open_or_create(root, 5, ttmpl).gather([5])


# ------------------------------------------------------ the personal round

CLIENTS, NMAX = 4, 24


def _round_inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(CLIENTS, NMAX, 784).astype(np.float32)
    y = rng.randint(0, 10, size=(CLIENTS, NMAX)).astype(np.int32)
    counts = np.array([24, 17, 9, 24], np.int32)
    return x, y, counts


def _lr_pair(seed=0):
    jt = JaxLoRA(JaxTrainer(jax_create_model("lr", output_dim=10)), rank=RANK)
    jgv = jt.init(jax.random.PRNGKey(seed), jnp.zeros((1, 784)))
    rng = np.random.RandomState(seed)
    jgv = {**jgv, "params": jax.tree.map(
        lambda a: jnp.asarray(a + 0.05 * rng.randn(*a.shape), a.dtype), jgv["params"])}
    tm = create_model("lr", output_dim=10, input_shape=(784,))
    return jt, jgv, LoRATrainer(ClassificationTrainer(tm), rank=RANK), tm


def _kw():
    return dict(batch_size=8, lr=0.1, client_num_per_round=CLIENTS, shuffle=False,
                grad_clip=1.0, lora_rank=RANK, personalize=True)


def test_personal_round_matches_jax():
    """One personalized round with nonzero personal rows and a dropped
    client: the aggregated adapters and the new personal rows match the
    JAX round's; the dropped client's row comes back bit for bit."""
    jt, jgv, tt, tm = _lr_pair()
    x, y, counts = _round_inputs()
    rng = np.random.RandomState(3)
    jpersonal = jax.tree.map(
        lambda a: jnp.asarray(0.02 * rng.randn(CLIENTS, *a.shape), a.dtype), jgv["params"])
    part = np.array([True, False, True, True])
    jcfg = JaxConfig(**_kw())
    jround = jax_personal_round_fn(jt, jcfg, jax_aggregator("fedavg", jcfg))
    jnew, _, jm, jrows = jround(jgv, (), jnp.asarray(x), jnp.asarray(y), jnp.asarray(counts),
                                jax.random.PRNGKey(0), jpersonal, jnp.asarray(part))
    tcfg = FedConfig(**_kw())
    tround = build_personal_round_fn(tt, tcfg, make_aggregator("fedavg", tcfg), device="cpu")
    tgv = flax_to_torch(jgv, module=tm)
    tpersonal = {k: v for k, v in flax_to_torch({"params": jpersonal}, module=tm).items()}
    tnew, _, tmet, trows = tround(tgv, (), torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(counts), torch.Generator(), tpersonal,
                                  torch.from_numpy(part))
    for k in jm:
        np.testing.assert_allclose(float(tmet[k]), float(jm[k]), rtol=2e-5, err_msg=k)
    want_gv = flax_to_torch(jnew, module=tm)
    want_rows = flax_to_torch({"params": jrows}, module=tm)
    for k, w in want_gv.items():
        np.testing.assert_allclose(tnew[k].numpy(), w.numpy(), rtol=2e-5, atol=1e-5,
                                   err_msg=k)
    for k, w in want_rows.items():
        np.testing.assert_allclose(trows[k].numpy(), w.numpy(), rtol=2e-5, atol=1e-5,
                                   err_msg=k)
        assert torch.equal(trows[k][1], tpersonal[k][1])


def test_fresh_bank_round_is_the_shared_round():
    """Every personal row zero (a fresh bank): the personalized round's
    globals are the shared round's bit for bit, and each new row is the
    client's trained adapters minus the globals."""
    _, jgv, tt, tm = _lr_pair(1)
    x, y, counts = _round_inputs(1)
    cfg = FedConfig(**_kw())
    gv = flax_to_torch(jgv, module=tm)
    args = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(counts),
            torch.Generator())
    zero = {k: torch.zeros((CLIENTS,) + v.shape) for k, v in
            split_variables(strip_lora_base(gv))[0].items()}
    pnew, _, pm, rows = build_personal_round_fn(tt, cfg, make_aggregator("fedavg", cfg),
                                                device="cpu")(gv, (), *args, zero)
    snew, _, sm = build_round_fn(tt, cfg.replace(personalize=False),
                                 make_aggregator("fedavg", cfg), device="cpu")(gv, (), *args)
    assert all(torch.equal(pnew[k], snew[k]) for k in snew)
    assert all(torch.equal(pm[k], sm[k]) for k in sm)
    assert all(v.abs().sum() > 0 for v in rows.values())


@pytest.fixture(scope="module")
def ds8():
    return _capped(load_dataset("mnist", client_num_in_total=8, partition_method="homo",
                                seed=0, flatten=True), PackedClients, 48, 256)


def _api(ds, **kw):
    base = dict(dataset="mnist", model="lr", client_num_in_total=8, client_num_per_round=4,
                batch_size=16, lr=0.1, comm_round=4, shuffle=False, seed=0,
                pipeline_depth=0, lora_rank=RANK, personalize=True)
    model = create_model("lr", output_dim=10, input_shape=ds.train.x.shape[2:])
    return FedAvgAPI(ds, FedConfig(**{**base, **kw}), ClassificationTrainer(model),
                     device="cpu")


def _bank(api, root, rows=8):
    return adapter_bank.open_or_create(
        root, rows, split_variables(strip_lora_base(api.global_variables))[0])


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def _bank_bytes(root):
    return {n: open(os.path.join(root, n), "rb").read() for n in sorted(os.listdir(root))}


def test_dead_rows_pass_through_the_drive(ds8, tmp_path):
    """A drive with drops at 0.5: every sampled client's row is written
    back, but a client dropped in every round it was sampled gets its old
    row, the zero row, back; the rows and the lift are finite."""
    api = _api(ds8, comm_round=3)
    bank = _bank(api, str(tmp_path / "bank"))
    plan = FaultPlan(seed=7, drop_rate=0.5)
    hist = api.train(chaos=plan, bank=bank)
    alive, sampled = set(), set()
    for r in range(3):
        ev = plan.events(r, 4)
        idx = api.stage_fn(r).client_idx
        sampled |= {int(c) for c in idx}
        alive |= {int(c) for c, p in zip(idx, ev.participation) if p}
    assert set(np.flatnonzero(bank.materialized_column()).tolist()) == sampled
    rows = bank.gather(np.arange(8))
    dead = sorted(sampled - alive)
    assert dead and all(not rows[k][dead].any() for k in rows)
    assert all(rows[k][sorted(alive)].any() for k in rows)
    assert all(np.isfinite(v).all() for v in rows.values())
    assert np.isfinite(hist[-1]["Personalization/Lift"])


@pytest.mark.parametrize("depth", [0, 2])
def test_each_round_gathers_its_cohort_once(ds8, tmp_path, depth):
    """Eager and pipelined, a round reads its cohort's rows from the bank
    once, when the loop takes the cohort: staging reads none. The other
    reads are the lift probe's, one on each test round."""
    api = _api(ds8, pipeline_depth=depth, frequency_of_the_test=100)
    bank = _bank(api, str(tmp_path / "bank"))
    gather, reads = bank.gather, []

    def counting(rows):
        reads.append(len(rows))
        return gather(rows)

    bank.gather = counting
    api.stage_fn(1)
    assert reads == []
    api.train(bank=bank)
    assert reads == [4, 8, 4, 4, 4, 8], reads


@pytest.mark.parametrize("clusters", [0, 3])
def test_pipelined_equals_eager_and_resumes_bitwise(ds8, tmp_path, clusters):
    """The personalized drive (with a ledger; with cluster rows) at depth 0
    and 2, and one resumed 2 + 2 from a checkpoint and the same bank: the
    globals, the records and the bank's files bit for bit."""
    runs = []
    for name, depth, split in (("eager", 0, False), ("pipe", 2, False),
                               ("resumed", 2, True)):
        led = client_ledger.create_ledger(str(tmp_path / f"{name}_led"), 8)
        root = str(tmp_path / f"{name}_bank")
        ckpt = str(tmp_path / f"{name}_ckpt")
        if split:
            first = _api(ds8, pipeline_depth=depth, comm_round=2, adapter_clusters=clusters)
            first.train(ckpt_dir=ckpt, ledger=led,
                        bank=_bank(first, root, clusters or 8))
        api = _api(ds8, pipeline_depth=depth, adapter_clusters=clusters)
        hist = api.train(ckpt_dir=ckpt if split else None, ledger=led,
                         bank=_bank(api, root, clusters or 8))
        runs.append((api, hist, root))
    (a, ha, ra), *others = runs
    strip = [{k: v for k, v in h.items() if k != "round_time"} for h in ha]
    assert "Personalization/Lift" in ha[-1]
    for api, hist, root in others:
        assert _bitwise(api.global_variables, a.global_variables)
        assert [{k: v for k, v in h.items() if k != "round_time"} for h in hist] == strip
        assert _bank_bytes(root) == _bank_bytes(ra)


def test_personalize_needs_a_bank_and_lora(ds8):
    api = _api(ds8)
    with pytest.raises(ValueError, match="needs an attached adapter bank"):
        api.train()
    with pytest.raises(ValueError, match="requires lora_rank > 0"):
        _api(ds8, lora_rank=0)


def test_cli_adapter_bank(tmp_path):
    """``--adapter_bank_dir`` turns personalization on; the bank covers the
    population and holds the rows the run trained."""
    from fedml_tpu_torch.experiments import main_fedavg

    hist = main_fedavg.main(["--device", "cpu", "--client_num_in_total", "6",
                             "--client_num_per_round", "3", "--comm_round", "2",
                             "--lora_rank", "2", "--run_dir", str(tmp_path / "run"),
                             "--adapter_bank_dir", str(tmp_path / "bank")])
    assert "Personalization/Lift" in hist[-1]
    sides = adapter_bank.read_side_columns(str(tmp_path / "bank"))
    assert sides["mat"].shape == (6,) and 0 < sides["mat"].sum() <= 6
