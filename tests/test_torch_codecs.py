"""The port's update codecs against the JAX package's (``fedml_tpu/codecs``):
int8 and top-k payloads bitwise on the same numpy inputs, the residual
identity bitwise in the port, the per-slot codec stage with a dead and a
NaN row, top-k's ties, the registry, the round without a codec, 3-round
``FedAvgAPI`` runs per codec against the JAX drive, and the residuals
through checkpoint resume and the guard's rollback.

The drives run MNIST logistic regression, 8 homo clients capped at 48
rows, shuffle off (the LR model has no dropout), so that both packages
train from the same weights on the same streams."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fedml_tpu.algorithms.engine import LocalResult as JaxResult
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.codecs import make_codec as jax_make_codec
from fedml_tpu.codecs.transport import CodecAggregator as JaxCodecAggregator
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch import ClassificationTrainer, FedAvgAPI, FedConfig
from fedml_tpu_torch.algorithms.aggregators import FedAvgAggregator, make_aggregator
from fedml_tpu_torch.algorithms.engine import LocalResult, build_round_fn
from fedml_tpu_torch.algorithms.fedavg import client_sampling, round_generator
from fedml_tpu_torch.codecs import CODECS, Int8Codec, TopKCodec, make_codec
from fedml_tpu_torch.codecs.transport import CodecAggregator
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.robustness.guard import GuardVerdict
from fedml_tpu_torch.utils.convert import flax_to_torch
from fedml_tpu_torch.utils.pytree import tree_leaves
from test_torch_fedavg import _capped

CODEC_CASES = {"int8": dict(codec_bits=8), "int4": dict(codec_bits=4),
               "topk": dict(codec_k=5)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _codecs(case):
    name = "topk" if case == "topk" else "int8"
    return jax_make_codec(name, CODEC_CASES[case]), make_codec(name, CODEC_CASES[case])


def _tree(seed, c=4):
    """A client-stacked update tree: leaves [C, 6, 7] and [C, 3], a zero
    row in the second (amax 0, scale 1)."""
    rng = np.random.RandomState(seed)
    tree = {"w": rng.standard_normal((c, 6, 7)).astype(np.float32),
            "b": (rng.standard_normal((c, 3)) * 1e-3).astype(np.float32)}
    tree["b"][1] = 0.0
    return tree


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_encode_decode_match_jax_bitwise(case):
    """Payload leaves (int8 q and scale, top-k values and idx), the new
    residual and the decode, bitwise, with a nonzero carried residual."""
    jc, tc = _codecs(case)
    upd, res = _tree(0), {k: 0.1 * v for k, v in _tree(1).items()}
    jp, jr = jax.vmap(jc.encode)(upd, res)
    jd = jax.vmap(lambda p, like: jc.decode(p, like))(jp, upd)
    tp, tr = tc.encode(_t(upd), _t(res))
    td = tc.decode(tp, _t(upd))
    for part in tp:
        for k in upd:
            got, want = tp[part][k].numpy(), np.asarray(jp[part][k])
            assert got.dtype == want.dtype and np.array_equal(got, want), (part, k)
    for k in upd:
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]), err_msg=k)
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]), err_msg=k)


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_residual_identity_is_bitwise(case):
    """decode(payload) + new residual == update + old residual, bit for bit,
    over three rounds of carried residuals."""
    _, tc = _codecs(case)
    res = {k: torch.zeros((4,) + tuple(v.shape[1:]) if v.dim() else (4,))
           for k, v in _t(_tree(0)).items()}
    for r in range(3):
        upd = _t(_tree(10 + r))
        payload, new = tc.encode(upd, res)
        dec = tc.decode(payload, upd)
        for k in upd:
            assert torch.equal(dec[k] + new[k], upd[k] + res[k]), (r, k)
        res = new


def _stacked(seed, c=5):
    rng = np.random.RandomState(seed)
    gv = {"w": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    rows = {k: (v[None] + 0.05 * rng.standard_normal((c,) + v.shape)).astype(np.float32)
            for k, v in gv.items()}
    rows["w"][3, 1, 2] = np.nan  # a non-finite row
    weights = np.array([3.0, 0.0, 5.0, 2.0, 4.0], np.float32)  # row 1 dead
    resid = {k: (0.01 * rng.standard_normal((c,) + v.shape)).astype(np.float32)
             for k, v in gv.items()}
    return gv, rows, weights, resid


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codec_stage_matches_jax_and_keeps_dead_residuals(case):
    """``CodecAggregator._stage`` on stacked results: the dead row (weight
    0) and the NaN row keep their old residual; the residuals and the alive
    rows' decoded variables equal JAX's bitwise."""
    jc, tc = _codecs(case)
    gv, rows, weights, resid = _stacked(3)
    steps, metrics = np.ones(5, np.int32), {"loss_sum": np.ones(5, np.float32)}
    jres, jr = JaxCodecAggregator(jc, None, 5)._stage(
        gv, JaxResult(rows, steps, metrics), weights, resid)
    tres, tr = CodecAggregator(tc, None, 5)._stage(
        _t(gv), LocalResult(_t(rows), torch.from_numpy(steps), _t(metrics)),
        torch.from_numpy(weights), _t(resid))
    alive = [0, 2, 4]
    for k in gv:
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]), err_msg=k)
        for dead in (1, 3):
            np.testing.assert_array_equal(tr[k][dead].numpy(), resid[k][dead])
        np.testing.assert_array_equal(tres.variables[k].numpy()[alive],
                                      np.asarray(jres.variables[k])[alive], err_msg=k)


def test_topk_ties_go_to_the_lower_index():
    """Equal nonzero magnitudes at the k-th place: lax.top_k keeps the lower
    index, and so does the port, on either sign."""
    t = np.array([[1.0, 3.0, -3.0, 2.0, 3.0, -0.0, 3.0]], np.float32)
    _, idx = jax.lax.top_k(jnp.abs(jnp.asarray(t[0])), 2)
    payload, resid = TopKCodec(k=2).encode({"a": torch.from_numpy(t)},
                                           {"a": torch.zeros(1, 7)})
    assert payload["idx"]["a"].tolist() == [np.asarray(idx).tolist()] == [[1, 2]]
    assert payload["values"]["a"].tolist() == [[3.0, -3.0]]
    assert resid["a"].tolist() == [[1.0, 0.0, 0.0, 2.0, 3.0, 0.0, 3.0]]


def test_make_codec_registry():
    assert sorted(CODECS) == ["int8", "topk"]
    for off in (None, "", "none"):
        assert make_codec(off) is None
    with pytest.raises(ValueError, match="unknown update codec"):
        make_codec("fp4")
    assert make_codec("int8").levels == 127 and make_codec("int8").name == "int8"
    four = make_codec("int8", FedConfig(codec_bits=4))
    assert isinstance(four, Int8Codec) and four.levels == 7 and four.name == "int4"
    assert make_codec("topk", {"codec_k": 9}).k == 9
    assert make_codec("topk", FedConfig()).name == "topk64"
    with pytest.raises(ValueError, match="codec_bits"):
        make_codec("int8", {"codec_bits": 9})
    with pytest.raises(ValueError, match="codec_k"):
        make_codec("topk", {"codec_k": 0})
    tree = {"w": torch.zeros(10, 3), "n": torch.zeros(4, dtype=torch.int32)}
    assert make_codec("int8").wire_bytes(tree) == 30 + 4 + 16
    assert make_codec("topk", {"codec_k": 8}).wire_bytes(tree) == 64 + 16
    with pytest.raises(ValueError, match="^--fused_kernel is mutually exclusive with "
                                         "--update_codec$"):
        FedConfig(update_codec="int8", fused_kernel=True).validate()


# ------------------------------------------------------------------ drives

@pytest.fixture(scope="module")
def ds8():
    return _capped(load_dataset("mnist", client_num_in_total=8, partition_method="homo",
                                seed=0), PackedClients, 48, 256)


@pytest.fixture(scope="module")
def jds8():
    return _capped(jax_load_dataset("mnist", client_num_in_total=8, partition_method="homo",
                                    seed=0), JaxPacked, 48, 256)


def _kw(**kw):
    base = dict(dataset="mnist", model="lr", client_num_in_total=8,
                client_num_per_round=4, batch_size=16, lr=0.1, comm_round=3,
                shuffle=False, seed=0)
    return {**base, **kw}


def _api(ds, rule="fedavg", **kw):
    model = create_model("lr", output_dim=10, input_shape=ds.train.x.shape[2:])
    return FedAvgAPI(ds, FedConfig(**_kw(**kw)), ClassificationTrainer(model),
                     aggregator_name=rule, device="cpu")


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def _strip(history):
    return [{k: v for k, v in r.items() if k != "round_time"} for r in history]


def test_codec_off_build_is_the_round_without_a_codec(ds8):
    """``update_codec="none"`` keeps the aggregator and its state as they
    were (no wrap, state ``()``), and its drive equals rounds of the round
    function built without a codec, fed the same cohorts, bit for bit."""
    api = _api(ds8)
    assert api.codec is None and type(api.aggregator) is FedAvgAggregator
    assert api.agg_state == ()
    api.train()
    cfg = FedConfig(**_kw())
    model = create_model("lr", output_dim=10, input_shape=ds8.train.x.shape[2:])
    trainer = ClassificationTrainer(model)
    round_fn = build_round_fn(trainer, cfg, make_aggregator("fedavg", cfg), device="cpu")
    gv = trainer.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    state = ()
    for r in range(3):
        idx = client_sampling(r, 8, 4)
        x, y, counts = ds8.train.select(idx)
        gv, state, _ = round_fn(gv, state, torch.from_numpy(x), torch.from_numpy(y),
                                torch.from_numpy(counts), round_generator(0, r))
    assert _bitwise(api.global_variables, gv) and state == ()


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_fedavg_api_codec_run_matches_jax(ds8, jds8, codec):
    """3 rounds of FedAvg through each codec from the same weights: the
    per-round train and test metrics, the globals and every slot's residual
    within rtol 2e-5 / atol 1e-5 of the JAX drive's."""
    kw = _kw(update_codec=codec, codec_k=64)
    japi = JaxFedAvgAPI(jds8, JaxConfig(**kw), JaxTrainer(jax_create_model("lr", output_dim=10)))
    tm = create_model("lr", output_dim=10, input_shape=ds8.train.x.shape[2:])
    tapi = FedAvgAPI(ds8, FedConfig(**kw), ClassificationTrainer(tm), device="cpu")
    assert isinstance(tapi.aggregator, CodecAggregator) and tapi.aggregator.slots == 4
    tapi.global_variables = flax_to_torch(japi.global_variables, module=tm)
    tapi.agg_state = tapi.aggregator.init_state(tapi.global_variables)
    jhist, thist = japi.train(), tapi.train()
    for key in ("Train/Acc", "Train/Loss", "Test/Acc", "Test/Loss"):
        np.testing.assert_allclose([h[key] for h in thist], [h[key] for h in jhist],
                                   rtol=2e-5, atol=1e-5, err_msg=key)
    want = flax_to_torch(japi.global_variables, module=tm)
    for k in want:
        np.testing.assert_allclose(tapi.global_variables[k].numpy(), want[k].numpy(),
                                   rtol=2e-5, atol=1e-5, err_msg=k)
    jres = japi.agg_state["codec"]
    for slot in range(4):
        want = flax_to_torch(jax.tree.map(lambda a, s=slot: np.asarray(a)[s], jres), module=tm)
        for k in want:
            np.testing.assert_allclose(tapi.agg_state["codec"][k][slot].numpy(),
                                       want[k].numpy(), rtol=2e-5, atol=1e-5,
                                       err_msg=f"slot {slot} {k}")


class _RejectOnce:
    max_retries = 2

    def __init__(self, bad_round):
        self.bad_round, self.fired = bad_round, False

    def inspect(self, round_idx, loss, global_variables=None):
        if round_idx == self.bad_round and not self.fired:
            self.fired = True
            return GuardVerdict(False, "forced test rejection")
        return GuardVerdict(True, "")


@pytest.mark.parametrize("codec", ["int8", "topk"])
@pytest.mark.parametrize("rule", ["fedavg", "fedopt"])
def test_residuals_survive_resume_and_guard_rollback(ds8, tmp_path, codec, rule):
    """The residuals ride the aggregator state: 2 rounds, a checkpoint and 2
    resumed rounds equal 4 straight rounds bit for bit (globals, FedOpt's
    moments, every slot's residual, history); a guard that rejects round 2
    once restores them, so its run (no dropout and no shuffle: the salted
    retry draws nothing) equals the straight run too."""
    kw = dict(update_codec=codec, codec_k=16, comm_round=4)
    if rule == "fedopt":
        kw.update(server_optimizer="adam", server_lr=0.01)
    straight = _api(ds8, rule, **kw)
    straight.train()
    assert straight.agg_state["codec"]["linear.weight"].abs().sum() > 0
    first = _api(ds8, rule, **{**kw, "comm_round": 2})
    first.train(ckpt_dir=str(tmp_path))
    resumed = _api(ds8, rule, **kw)
    resumed.train(ckpt_dir=str(tmp_path))
    guarded = _api(ds8, rule, **kw)
    guarded.train(guard=_RejectOnce(2))
    assert guarded.history[2]["guard_retries"] == 1
    for other in (resumed, guarded):
        assert _bitwise(other.global_variables, straight.global_variables)
        assert _bitwise(other.agg_state, straight.agg_state)
    assert _strip(resumed.history) == _strip(straight.history)
