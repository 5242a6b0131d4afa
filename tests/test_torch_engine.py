"""The port's round engine (local SGD with clip, FedAvg aggregation,
quarantine) against the JAX package's ``build_round_fn``. Dropout and
shuffle are off on both sides: their random streams differ by design."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.aggregators import make_aggregator as jax_aggregator
from fedml_tpu.algorithms.engine import build_round_fn as jax_round_fn
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.models.cnn import CNN_DropOut as JaxCNN
from fedml_tpu.utils.pytree import tree_weighted_mean as jax_weighted_mean
from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import (_batched_update, build_round_fn,
                                               cohort_stats, draw_client_randomness)
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import ClassificationTrainer
from fedml_tpu_torch.models.cnn import CNN_DropOut
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.utils.pytree import tree_weighted_mean

CLIENTS, NMAX, BS, H, C = 3, 30, 8, 12, 5
# ragged clients: one full, one with a partial last batch, one short
COUNTS = np.array([30, 21, 8], np.int32)


def _setup(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(CLIENTS, NMAX, H, H, 1).astype(np.float32)
    y = rng.randint(0, C, size=(CLIENTS, NMAX)).astype(np.int32)
    kw = dict(batch_size=BS, epochs=2, lr=0.1, client_num_per_round=CLIENTS,
              shuffle=False, grad_clip=1.0)
    jt = JaxTrainer(JaxCNN(output_dim=C, drop1=0.0, drop2=0.0))
    gv = jt.init(jax.random.PRNGKey(seed), jnp.asarray(x[0, :1]))
    tt = ClassificationTrainer(CNN_DropOut(output_dim=C, drop1=0.0, drop2=0.0,
                                           input_hw=H))
    return x, y, JaxConfig(**kw), FedConfig(**kw), jt, tt, gv


def _assert_globals_close(tgv, jgv, rtol=2e-5, atol=1e-5):
    got = torch_to_flax(tgv)["params"]
    for layer, leaves in jgv["params"].items():
        for kind, want in leaves.items():
            np.testing.assert_allclose(got[layer][kind], np.asarray(want),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{layer}.{kind}")


def test_engine_round_matches_jax_over_three_rounds():
    x, y, jcfg, tcfg, jt, tt, gv = _setup()
    jround = jax_round_fn(jt, jcfg, jax_aggregator("fedavg", jcfg))
    tround = build_round_fn(tt, tcfg, make_aggregator("fedavg", tcfg),
                            device="cpu")
    jgv, tgv = gv, flax_to_torch(gv)
    xs, ys, cs = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(COUNTS)
    for r in range(3):
        jgv, _, jm = jround(jgv, (), jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(COUNTS), jax.random.PRNGKey(r))
        tgv, _, tm = tround(tgv, (), xs, ys, cs, torch.Generator().manual_seed(r))
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"round {r} {k}")
    _assert_globals_close(tgv, jgv)


def test_participation_quarantines_non_finite_and_dropped_clients():
    x, y, jcfg, tcfg, jt, tt, gv = _setup(1)
    x_bad = x.copy()
    x_bad[0, 0, 0, 0, 0] = np.nan  # client 0 trains to NaN
    part = np.array([1, 1, 0], bool)  # client 2 dropped
    jround = jax_round_fn(jt, jcfg, jax_aggregator("fedavg", jcfg),
                          collect_stats=True)
    tround = build_round_fn(tt, tcfg, make_aggregator("fedavg", tcfg),
                            device="cpu")
    jgv, _, jm, js = jround(gv, (), jnp.asarray(x_bad), jnp.asarray(y),
                            jnp.asarray(COUNTS), jax.random.PRNGKey(0),
                            jnp.asarray(part))
    args = (flax_to_torch(gv), torch.from_numpy(x_bad), torch.from_numpy(y),
            torch.from_numpy(COUNTS))
    tgv, _, tm = tround(args[0], (), *args[1:], torch.Generator(),
                        torch.from_numpy(part))
    # the per-client health rows of the raw (pre-quarantine) results
    ts = cohort_stats(args[0], _batched_update(tt, tcfg)(*args, torch.Generator()))
    assert float(tm["participated_count"]) == float(jm["participated_count"]) == 1.0
    assert float(tm["quarantined_count"]) == float(jm["quarantined_count"]) == 1.0
    np.testing.assert_array_equal(ts["finite"].numpy(), np.asarray(js["finite"]))
    np.testing.assert_allclose(ts["update_norm"][1:].numpy(),
                               np.asarray(js["update_norm"])[1:], rtol=1e-4)
    _assert_globals_close(tgv, jgv)


def test_all_dead_round_is_a_no_op():
    x, y, _, tcfg, _, tt, gv = _setup(2)
    tround = build_round_fn(tt, tcfg, make_aggregator("fedavg", tcfg),
                            device="cpu")
    tgv = flax_to_torch(gv)
    out, _, m = tround(tgv, (), torch.from_numpy(x), torch.from_numpy(y),
                       torch.from_numpy(COUNTS), torch.Generator(),
                       torch.zeros(CLIENTS, dtype=torch.bool))
    for k in tgv:
        torch.testing.assert_close(out[k], tgv[k], rtol=0, atol=0)
    assert float(m["participated_count"]) == 0.0


def test_weighted_mean_matches_jax():
    rng = np.random.RandomState(3)
    tree = {"a": rng.normal(size=(4, 3, 2)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}
    w = np.array([3.0, 0.0, 1.0, 2.0], np.float32)
    want = jax_weighted_mean({k: jnp.asarray(v) for k, v in tree.items()},
                             jnp.asarray(w))
    got = tree_weighted_mean({k: torch.from_numpy(v) for k, v in tree.items()},
                             torch.from_numpy(w))
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_shuffle_permutes_only_the_valid_prefix():
    perms, seeds = draw_client_randomness(torch.Generator().manual_seed(0),
                                          [5, 3], 6, 2, True)
    assert perms.shape == (2, 2, 6) and seeds.shape == (2,)
    for c, count in enumerate([5, 3]):
        for e in range(2):
            p = perms[c, e].tolist()
            assert sorted(p[:count]) == list(range(count))
            assert p[count:] == list(range(count, 6))


def test_unported_options_raise():
    _, _, _, tcfg, _, tt, _ = _setup()
    for kw in (dict(tensor_shards=2),):
        with pytest.raises(NotImplementedError):
            build_round_fn(tt, tcfg.replace(**kw), make_aggregator("fedavg", tcfg),
                           device="cpu")
    # ported: the Feistel cohort sampler, the update codecs, the superstep,
    # the buffer (drive options), LoRA and the silo threshold (FedAvgAPI's
    # route to the silo round) build the round
    for kw in (dict(fast_sampling=True), dict(update_codec="int8"),
               dict(update_codec="topk"), dict(rounds_per_dispatch=2),
               dict(buffer_size=4), dict(lora_rank=4), dict(silo_threshold=32)):
        build_round_fn(tt, tcfg.replace(**kw), make_aggregator("fedavg", tcfg),
                       device="cpu")
