"""The clients-sharded round over a 2-rank gloo process group
(``fedml_tpu_torch/parallel/sharded.py``), on the CPU, against the port's
single-device round and the JAX package's ``build_sharded_round_fn``.

One group of two worker processes (``tests/torch_dist_worker.py``) is
spawned for the module and runs every case; the tests read their results.
The model is the JAX tests' ``lr`` on the 16-client MNIST surrogate.

- FedAvg, FedOpt (server SGD with momentum), FedNova and robust
  aggregation: the sharded round equals the single-device round at 1e-6
  with shuffle on (the draws are the whole cohort's), and the JAX sharded
  round over 2 of the suite's virtual CPU devices at 2e-5 / 1e-5 with
  shuffle off (the robust noise, a threefry draw there, at stddev 0);
  both ranks hold the same bits, the robust rule's noise included;
- zero-count padding is a no-op; a masked round equals the single-device
  masked round and an all-dead one passes the globals and the state
  through, with its counts; the int8 codec round matches, residuals and
  all; the sharded buffer admit and commit match their single-device
  twins;
- ``FedAvgAPI(backend="shard_map")`` over the group builds the sharded
  round and trains as the single-device API does, chaos included;
- hierarchical and decentralized FL raise over 2 ranks, and so do the
  fused kernel and the silo round with the sharded backend."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as dw
from fedml_tpu.algorithms.aggregators import make_aggregator as jax_aggregator
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.parallel import build_sharded_round_fn as jax_sharded_round_fn
from fedml_tpu.parallel import make_mesh as jax_make_mesh
from fedml_tpu_torch import ClassificationTrainer, FedAvgAPI, FedConfig, create_model
from fedml_tpu_torch import load_dataset
from fedml_tpu_torch.algorithms.aggregators import (build_buffer_admit, build_buffer_commit,
                                                    init_buffer, make_aggregator,
                                                    make_staleness_discount)
from fedml_tpu_torch.algorithms.engine import _batched_update, build_round_fn
from fedml_tpu_torch.algorithms.fedavg import round_generator
from fedml_tpu_torch.codecs import make_codec
from fedml_tpu_torch.core.builder import wrap_codec
from fedml_tpu_torch.robustness.chaos import FaultPlan
from fedml_tpu_torch.utils.convert import flax_to_torch

AGGS = ("fedavg", "fedopt", "fednova", "robust")
CFG = dict(batch_size=8, epochs=2, lr=0.05, client_num_in_total=16, client_num_per_round=16,
           server_optimizer="sgd", server_lr=1.0, server_momentum=0.9, norm_bound=0.5,
           stddev=0.025, seed=3)
DATASET = dict(name="mnist", client_num_in_total=16, partition_method="homo", seed=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trainer(ds):
    return ClassificationTrainer(create_model("lr", output_dim=ds.class_num))


def _close(got: dict, want: dict, tol: float = 1e-6) -> float:
    gap = max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max()) for k in want)
    assert gap < tol, gap
    return gap


def _single_round(ds, cfg, agg_name, gv, x, y, counts, participation=None, codec_slots=0,
                  state=None):
    cfg = FedConfig(**cfg)
    agg = make_aggregator(agg_name, cfg)
    if codec_slots:
        agg = wrap_codec(agg, make_codec(cfg.update_codec, cfg), codec_slots)
    round_fn = build_round_fn(_trainer(ds), cfg, agg, device="cpu")
    state = agg.init_state(gv) if state is None else state
    return round_fn(gv, state, x, y, counts, round_generator(cfg.seed, 0), participation)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The module's data, the JAX init converted, every case's inputs, and
    the 2-rank group's results: (context dict, {job: [rank0, rank1]})."""
    jds = jax_load_dataset(**DATASET)
    ds = load_dataset(**DATASET)
    jtrainer = JaxTrainer(jax_create_model("lr", output_dim=jds.class_num))
    jgv = jtrainer.init(jax.random.PRNGKey(0), jnp.asarray(jds.train.x[:1, 0]))
    gv = flax_to_torch(jgv)
    x, y, counts = (torch.from_numpy(np.ascontiguousarray(a))
                    for a in ds.train.select(np.arange(16)))
    base = {"fn": "round_job", "classes": ds.class_num, "gv": gv, "x": x, "y": y,
            "counts": counts}
    jobs = {}
    for agg in AGGS:
        jobs[agg] = {**base, "aggregator": agg, "cfg": CFG}
        jobs[f"{agg}_jax"] = {**base, "aggregator": agg,
                              "cfg": {**CFG, "shuffle": False, "stddev": 0.0}}
    jobs["padding"] = {**base, "x": x[:10], "y": y[:10], "counts": counts[:10],
                       "aggregator": "fedavg", "cfg": CFG}
    xm = x.clone()
    xm[4] = float("nan")  # client 4's update is not finite: quarantined
    part = torch.ones(16, dtype=torch.bool)
    part[[1, 9, 10]] = False
    fedopt_state = make_aggregator("fedopt", FedConfig(**CFG)).init_state(gv)
    fedopt_state = {"trace": {k: torch.full_like(v, 0.01) for k, v in
                              fedopt_state["trace"].items()}}
    jobs["masked"] = {**base, "x": xm, "aggregator": "fedopt", "cfg": CFG,
                      "participation": part, "state": fedopt_state}
    jobs["all_dead"] = {**base, "aggregator": "fedopt", "cfg": CFG, "state": fedopt_state,
                        "participation": torch.zeros(16, dtype=torch.bool)}
    codec_cfg = {**CFG, "update_codec": "int8"}
    resid = wrap_codec(make_aggregator("fedavg", FedConfig(**codec_cfg)),
                       make_codec("int8", FedConfig(**codec_cfg)), 16).init_state(gv)
    gen = torch.Generator().manual_seed(5)
    resid["codec"] = {k: 1e-3 * torch.randn(v.shape, generator=gen)
                      for k, v in resid["codec"].items()}
    jobs["codec"] = {**base, "aggregator": "fedavg", "cfg": codec_cfg, "state": resid}
    # the buffer: 8 clients' stacked results, 6 rows, 5 admitted
    cfg = FedConfig(**CFG)
    result = _batched_update(_trainer(ds), cfg)(gv, x[:8], y[:8], counts[:8],
                                                round_generator(3, 0))
    stacked = {"vars": result.variables, "steps": result.num_steps,
               "metrics": result.metrics, "counts": counts[:8]}
    jobs["buffer"] = {"fn": "buffer_job", "cfg": CFG, "aggregator": "fedavg", "gv": gv,
                      "stacked": stacked, "k": 6, "srcs": [5, 0, 7, 2, 3],
                      "births": [0, 1, 0, 2, 1], "commit_round": 3, "alpha": 0.5}
    api_cfg = {**CFG, "client_num_per_round": 9, "comm_round": 2, "backend": "shard_map"}
    jobs["api"] = {"fn": "api_job", "classes": ds.class_num, "aggregator": "fedavg",
                   "cfg": api_cfg, "gv": gv, "chaos": {"seed": 2, "drop_rate": 0.2,
                                                       "nan_rate": 0.2},
                   "dataset": DATASET}
    jobs["raises"] = {"fn": "raises_job"}
    results, logs = dw.spawn({"mode": "jobs", "jobs": jobs},
                             str(tmp_path_factory.mktemp("ranks")))
    for name, per_rank in results.items():
        for r, out in enumerate(per_rank):
            assert out is not None, f"{name}: rank {r} wrote nothing:\n{logs[r][-3000:]}"
            assert "error" not in out, f"{name} on rank {r}:\n{out['error']}"
    ctx = {"ds": ds, "jds": jds, "jtrainer": jtrainer, "jgv": jgv, "gv": gv, "x": x, "y": y,
           "counts": counts, "jobs": jobs}
    return ctx, results


def _bitwise_across_ranks(per_rank):
    a, b = per_rank

    def walk(u, v, path):
        if isinstance(u, dict):
            assert u.keys() == v.keys(), path
            for k in u:
                walk(u[k], v[k], f"{path}/{k}")
        elif isinstance(u, (list, tuple)):
            for i, (p, q) in enumerate(zip(u, v)):
                walk(p, q, f"{path}/{i}")
        elif isinstance(u, np.ndarray):
            assert u.tobytes() == v.tobytes(), path

    walk(a, b, "")


@pytest.mark.parametrize("agg", AGGS)
def test_sharded_round_equals_the_single_device_round(world, agg):
    ctx, results = world
    job = ctx["jobs"][agg]
    want_gv, want_state, want_m = _single_round(ctx["ds"], job["cfg"], agg, ctx["gv"],
                                                ctx["x"], ctx["y"], ctx["counts"])
    got_gv, got_state, got_m = results[agg][0]
    _close(got_gv, want_gv)
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k].numpy(), rtol=1e-6, err_msg=k)
    if agg == "fedopt":
        _close(got_state["trace"], want_state["trace"])
    # every rank holds the same bits (the robust rule's noise included)
    _bitwise_across_ranks(results[agg])


@pytest.mark.parametrize("agg", AGGS)
def test_sharded_round_matches_the_jax_sharded_round(world, agg):
    ctx, results = world
    job = ctx["jobs"][f"{agg}_jax"]
    jcfg = JaxConfig(**job["cfg"])
    jagg = jax_aggregator(agg, jcfg)
    jround = jax_sharded_round_fn(ctx["jtrainer"], jcfg, jagg,
                                  jax_make_mesh((2,), ("clients",)))
    jds = ctx["jds"]
    xs, ys, cs = (jnp.asarray(a) for a in jds.train.select(np.arange(16)))
    jgv, _, jm = jround(ctx["jgv"], jagg.init_state(ctx["jgv"]), xs, ys, cs,
                        jax.random.PRNGKey(0))
    want = flax_to_torch(jax.device_get(jgv))
    got_gv, _, got_m = results[f"{agg}_jax"][0]
    for k in want:
        np.testing.assert_allclose(got_gv[k], want[k].numpy(), rtol=2e-5, atol=1e-5,
                                   err_msg=k)
    for k in ("loss_sum", "total"):
        np.testing.assert_allclose(got_m[k], float(jm[k]), rtol=2e-5, atol=1e-5, err_msg=k)


def test_zero_count_padding_is_a_no_op(world):
    """10 clients over 2 ranks of 5; the draws of the 10 real clients are
    the single-device round's."""
    ctx, results = world
    c = slice(0, 10)
    want_gv, _, want_m = _single_round(ctx["ds"], CFG, "fedavg", ctx["gv"], ctx["x"][c],
                                       ctx["y"][c], ctx["counts"][c])
    got_gv, _, got_m = results["padding"][0]
    _close(got_gv, want_gv)
    np.testing.assert_allclose(got_m["total"], want_m["total"].numpy())


def test_padded_block_draws_no_op_rows_after_the_real_ones():
    """shard_key_slice: the real cohort's draws in order, then seed 0 and the
    identity permutation for the pad rows; the generator ends where the
    single-device round's draw leaves it."""
    from fedml_tpu_torch.algorithms.engine import draw_client_randomness
    from fedml_tpu_torch.core.builder import shard_key_slice

    counts = [5, 3, 6]
    gen_a, gen_b = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    perms, seeds = draw_client_randomness(gen_a, counts, 6, 2, True)
    s1, p1, c1 = shard_key_slice(gen_b, counts, 6, 2, True, 1, 2)
    assert torch.equal(s1, torch.stack([seeds[2], torch.tensor(0)]))
    assert torch.equal(p1[0], perms[2]) and torch.equal(p1[1], torch.arange(6).expand(2, 6))
    assert c1 == [6, 0]
    assert torch.equal(torch.randint(0, 9, (4,), generator=gen_a),
                       torch.randint(0, 9, (4,), generator=gen_b))


def test_masked_round_equals_the_single_device_masked_round(world):
    ctx, results = world
    job = ctx["jobs"]["masked"]
    want_gv, want_state, want_m = _single_round(
        ctx["ds"], CFG, "fedopt", ctx["gv"], job["x"], ctx["y"], ctx["counts"],
        job["participation"], state=job["state"])
    got_gv, got_state, got_m = results["masked"][0]
    _close(got_gv, want_gv)
    _close(got_state["trace"], want_state["trace"])
    assert got_m["participated_count"] == want_m["participated_count"] == 12
    assert got_m["quarantined_count"] == want_m["quarantined_count"] == 1


def test_all_dead_round_passes_globals_and_state_through(world):
    ctx, results = world
    got_gv, got_state, got_m = results["all_dead"][0]
    for k, v in ctx["gv"].items():
        assert np.array_equal(got_gv[k], v.numpy()), k
    for k, v in ctx["jobs"]["all_dead"]["state"]["trace"].items():
        assert np.array_equal(got_state["trace"][k], v.numpy()), k
    assert got_m["participated_count"] == 0 and got_m["quarantined_count"] == 0


def test_int8_codec_round_matches(world):
    ctx, results = world
    job = ctx["jobs"]["codec"]
    want_gv, want_state, _ = _single_round(ctx["ds"], job["cfg"], "fedavg", ctx["gv"],
                                           ctx["x"], ctx["y"], ctx["counts"],
                                           codec_slots=16, state=job["state"])
    _close(results["codec"][0][0], want_gv)
    # each rank holds its block's residual rows; together the padded cohort's
    for k, v in want_state["codec"].items():
        got = np.concatenate([results["codec"][r][1]["codec"][k] for r in range(2)])
        assert got.shape == v.shape and np.abs(got - v.numpy()).max() <= 1e-6, k


def test_sharded_buffer_admit_and_commit_match_their_twins(world):
    ctx, results = world
    job = ctx["jobs"]["buffer"]
    cfg = FedConfig(**CFG)
    agg = make_aggregator("fedavg", cfg)
    from fedml_tpu_torch.algorithms.engine import LocalResult

    stacked = job["stacked"]
    result = LocalResult(stacked["vars"], stacked["steps"], stacked["metrics"])
    buf = init_buffer(result, job["k"])
    admit = build_buffer_admit()
    for fill, src in enumerate(job["srcs"]):
        buf = admit(buf, result.variables, result.num_steps, result.metrics,
                    stacked["counts"], src, fill)
    commit = build_buffer_commit(agg, make_staleness_discount(job["alpha"]))
    want_gv, _, want_m = commit(ctx["gv"], (), buf, len(job["srcs"]), job["births"],
                                job["commit_round"], round_generator(3, 3))
    got = [results["buffer"][r] for r in range(2)]
    for k, v in buf["vars"].items():  # the admits move rows bit for bit
        assert np.array_equal(np.concatenate([g["buf"]["vars"][k] for g in got]), v.numpy())
    assert np.array_equal(np.concatenate([g["buf"]["weights"] for g in got]),
                          buf["weights"].numpy())
    got_gv, _, got_m = got[0]["commit"]
    _close(got_gv, want_gv)
    for k, v in want_m.items():
        np.testing.assert_allclose(got_m[k], v.numpy(), rtol=1e-6, err_msg=k)


def test_api_with_shard_map_builds_the_sharded_round_and_trains_as_one_device(world):
    ctx, results = world
    job = ctx["jobs"]["api"]
    got = results["api"]
    assert [g["mesh"] for g in got] == [(2, 0, "gloo"), (2, 1, "gloo")]
    assert got[0]["round"].startswith("build_sharded_round_fn")
    cfg = FedConfig(**{**job["cfg"], "backend": "vmap"})
    api = FedAvgAPI(ctx["ds"], cfg, _trainer(ctx["ds"]), device="cpu")
    api.global_variables = ctx["gv"]
    hist = api.train(chaos=FaultPlan(**job["chaos"]))
    _close(got[0]["gv"], api.global_variables)
    for want, rec in zip(hist, got[0]["hist"]):
        for k, v in want.items():
            if k != "round_time":
                np.testing.assert_allclose(rec[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    assert sum(r["quarantined_count"] for r in hist) >= 1


def test_one_device_apis_refuse_a_group_of_two(world):
    _, results = world
    out = results["raises"][0]
    assert out["hierarchical"][0] == "NotImplementedError" and "item 2.3" in out["hierarchical"][1]
    assert out["decentralized"][0] == "NotImplementedError" and "item 2.4" in out["decentralized"][1]
    assert out["mesh_shape"][0] == "ValueError" and "one process a rank" in out["mesh_shape"][1]
    assert out["fused"][0] == "ValueError" and "no shard_map" in out["fused"][1]
    assert out["silo"][0] == "ValueError" and "mutually exclusive" in out["silo"][1]
    assert out["valid"] == 2
