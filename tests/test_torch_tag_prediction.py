"""StackOverflow tag prediction in the port against the JAX package:
``load_stackoverflow_lr_clients`` and the ``stackoverflow_lr`` loader bit
for bit at the default 200 clients; ``TagPredictionTrainer``'s loss and
metric contract at 2e-5 (an all-zero label row and a row whose every
prediction is below the threshold included); a zero-step client's metric
keys; a 2-round FedAvg drive's records and globals; the CLI's dispatch.

Small shapes where a model trains: logistic regression from a 64-word
bag to 12 tags, or the surrogate's 10,000 -> 500 at 8 clients with the
rows capped at 16. Tolerances: rtol 2e-5, atol 1e-5
(``tests/test_sequence.py:33``) on values, rtol 1e-4 on a round's records
(``tests/test_torch_fedavg.py``)."""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import TagPredictionTrainer as JaxTagTrainer
from fedml_tpu.data import sources as jax_sources
from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch import FedAvgAPI, FedConfig, create_model, load_dataset
from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import build_round_fn
from fedml_tpu_torch.core.trainer import TagPredictionTrainer
from fedml_tpu_torch.data import sources
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.experiments import main_fedavg
from fedml_tpu_torch.models.lora import LoRATrainer
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax

WORDS, TAGS = 64, 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sources_bit_for_bit_at_200_clients():
    got = sources.load_stackoverflow_lr_clients()
    want = jax_sources.load_stackoverflow_lr_clients()
    assert [len(part) for part in got] == [200] * 4
    for g_part, w_part in zip(got, want):
        for g, w in zip(g_part, w_part):
            assert g.dtype == w.dtype == np.float32 and np.array_equal(g, w)
    assert got[0][0].shape[1] == 10000 and got[1][0].shape[1] == 500


def test_loader_bit_for_bit_at_200_clients():
    got = load_dataset("stackoverflow_lr")
    want = jax_load_dataset("stackoverflow_lr")
    assert (got.name, got.class_num, got.meta) == (want.name, want.class_num, want.meta)
    for split in ("train", "test"):
        g, w = getattr(got, split), getattr(want, split)
        for leaf in ("x", "y", "counts"):
            a, b = getattr(g, leaf), getattr(w, leaf)
            assert a.dtype == b.dtype and np.array_equal(a, b), (split, leaf)
    for split in ("train_global", "test_global"):
        for a, b in zip(getattr(got, split), getattr(want, split)):
            assert a.dtype == b.dtype and np.array_equal(a, b), split
    assert got.train.num_clients == 200 and got.train.x.shape[2:] == (10000,)


def _models(seed=0):
    """(JAX trainer, its variables with bias -0.5, port trainer, the same
    variables): lr from a WORDS bag to TAGS tags."""
    jt = JaxTagTrainer(jax_create_model("lr", output_dim=TAGS))
    jv = jt.init(jax.random.PRNGKey(seed), jnp.zeros((1, WORDS), jnp.float32))
    rng = np.random.RandomState(seed)
    jv = jax.tree_util.tree_map_with_path(
        lambda p, a: (jnp.asarray(rng.randn(*a.shape), a.dtype) if p[-1].key == "kernel"
                      else jnp.full(a.shape, -0.5, a.dtype)), jv)
    tt = TagPredictionTrainer(create_model("lr", output_dim=TAGS, input_shape=(WORDS,)))
    return jt, jv, tt, flax_to_torch(jv)


def _batch(rows=8, seed=1):
    """A bag-of-words batch: row 0 has no word (its logits are the bias,
    all below the threshold), row 1 no tag, row 5 is padding."""
    rng = np.random.RandomState(seed)
    x = (rng.rand(rows, WORDS) < 0.2).astype(np.float32)
    y = (rng.rand(rows, TAGS) < 0.3).astype(np.float32)
    x[0] = 0.0
    y[1] = 0.0
    mask = np.ones(rows, np.float32)
    mask[5] = 0.0
    return x, y, mask


def test_loss_and_metric_contract_match_jax():
    jt, jv, tt, tv = _models()
    x, y, mask = _batch()
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y), "mask": jnp.asarray(mask)}
    tbatch = {k: torch.from_numpy(v) for k, v in (("x", x), ("y", y), ("mask", mask))}
    probs = torch.sigmoid(tt.apply(tv, tbatch["x"])[0])
    assert (probs[0] < 0.5).all() and (probs[2:] > 0.5).any()

    def jloss(params):
        return jt.loss_fn({"params": params}, jbatch, None, True)

    (jl, (_, jaux)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jv["params"])
    leaves = {k: v.clone().requires_grad_(True) for k, v in tv.items()}
    tl, (_, taux) = tt.loss_fn(leaves, tbatch, None, True)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5)
    assert set(taux) == set(jaux) == {"loss_sum", "total"}
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=2e-5, err_msg=k)
    got = torch_to_flax({k: v.grad for k, v in leaves.items()})["params"]
    for layer, kinds in jgrads.items():
        for kind, w in kinds.items():
            np.testing.assert_allclose(got[layer][kind], np.asarray(w), rtol=2e-5,
                                       atol=1e-5, err_msg=f"{layer}.{kind}")
    want = jt.eval_fn(jv, jbatch)
    have = tt.eval_fn(tv, tbatch)
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_allclose(float(have[k]), float(want[k]), rtol=2e-5, atol=1e-5,
                                   err_msg=k)


def test_eval_of_client_blocks_matches_jax_per_client():
    """A batch of 2 clients' blocks scales each block's BCE by its own
    count, as the JAX drive's one eval call a client does."""
    jt, jv, tt, tv = _models(seed=3)
    x, y, mask = _batch(rows=8, seed=4)
    mask[6:] = 0.0
    want = {}
    for block in (slice(0, 4), slice(4, 8)):
        m = jt.eval_fn(jv, {"x": jnp.asarray(x[block]), "y": jnp.asarray(y[block]),
                            "mask": jnp.asarray(mask[block])})
        want = {k: want.get(k, 0.0) + float(v) for k, v in m.items()}
    have = tt.eval_fn(tv, {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                           "mask": torch.from_numpy(mask), "clients": 2})
    for k in want:
        np.testing.assert_allclose(float(have[k]), want[k], rtol=2e-5, atol=1e-5, err_msg=k)


def test_zero_step_client_keeps_the_trainers_keys():
    """A client with no row takes no step; the round's metric sums carry
    the tag trainer's keys only (no ``correct``), as the JAX scan's do,
    under LoRA too."""
    cfg = FedConfig(batch_size=4, lr=0.1, client_num_per_round=2, shuffle=False)
    x, y, _ = _batch(rows=8)
    counts = torch.tensor([5, 0], dtype=torch.int32)
    for trainer in (TagPredictionTrainer(create_model("lr", output_dim=TAGS,
                                                      input_shape=(WORDS,))),
                    LoRATrainer(TagPredictionTrainer(create_model(
                        "lr", output_dim=TAGS, input_shape=(WORDS,))), rank=2)):
        rnd = build_round_fn(trainer, cfg, make_aggregator("fedavg", cfg), device="cpu")
        gv = trainer.init(torch.Generator().manual_seed(0), "cpu")
        _, _, metrics = rnd(gv, (), torch.from_numpy(np.stack([x, x])),
                            torch.from_numpy(np.stack([y, y])), counts,
                            torch.Generator().manual_seed(0))
        assert set(metrics) == {"loss_sum", "total"}
        assert float(metrics["total"]) == 5.0


def _capped(ds, packed_cls, cap):
    return dataclasses.replace(
        ds, train=packed_cls(np.ascontiguousarray(ds.train.x[:, :cap]),
                             np.ascontiguousarray(ds.train.y[:, :cap]),
                             np.minimum(ds.train.counts, cap)))


def test_fedavg_drive_matches_jax():
    """2 eager rounds of the surrogate at full width (10,000 -> 500), 8
    clients with their train rows capped at 16, 4 a round, shuffle off,
    the same initial weights: every record's evaluations and the
    final globals match the JAX drive's (``Train/*`` and ``Test/*``)."""
    kw = dict(dataset="stackoverflow_lr", model="lr", client_num_in_total=8,
              client_num_per_round=4, batch_size=8, lr=0.5, epochs=1, comm_round=2,
              shuffle=False, seed=0)
    jds = _capped(jax_load_dataset("stackoverflow_lr", client_num_in_total=8), JaxPacked, 16)
    tds = _capped(load_dataset("stackoverflow_lr", client_num_in_total=8), PackedClients, 16)
    japi = JaxFedAvgAPI(jds, JaxConfig(**kw),
                        JaxTagTrainer(jax_create_model("lr", output_dim=500)))
    tapi = FedAvgAPI(tds, FedConfig(**kw), TagPredictionTrainer(
        create_model("lr", output_dim=500, input_shape=(10000,))), device="cpu")
    tapi.global_variables = flax_to_torch(japi.global_variables)
    jhist, thist = japi.train(), tapi.train()
    assert len(jhist) == len(thist) == 2
    for jr, tr in zip(jhist, thist):
        # the port's records also carry the round's train sums, here
        # loss_sum and total alone
        evals = {k for k in jr if k.startswith(("Train/", "Test/"))}
        assert evals == {k for k in tr if k.startswith(("Train/", "Test/"))}
        assert "correct" not in tr and {"loss_sum", "total"} <= set(tr)
        for key in evals:
            np.testing.assert_allclose(tr[key], jr[key], rtol=1e-4, atol=1e-5,
                                       err_msg=f"round {jr['round']} {key}")
    assert thist[1]["loss_sum"] / thist[1]["total"] < thist[0]["loss_sum"] / thist[0]["total"]
    got = torch_to_flax(tapi.global_variables)["params"]
    for layer, leaves in japi.global_variables["params"].items():
        for kind, want in leaves.items():
            np.testing.assert_allclose(got[layer][kind], np.asarray(want), rtol=2e-5,
                                       atol=1e-5, err_msg=f"{layer}.{kind}")


def test_cli_dispatches_the_tag_trainer_under_lora():
    """``--dataset stackoverflow_lr`` selects TagPredictionTrainer, and
    ``--lora_rank`` wraps it afterwards."""
    parser = main_fedavg.add_args(argparse.ArgumentParser())
    args = parser.parse_args(["--dataset", "stackoverflow_lr", "--model", "lr",
                              "--client_num_in_total", "4", "--device", "cpu"])
    _, ds, trainer = main_fedavg.setup_run(args)
    assert isinstance(trainer, TagPredictionTrainer) and ds.class_num == 500
    args = parser.parse_args(["--dataset", "stackoverflow_lr", "--model", "lr",
                              "--client_num_in_total", "4", "--lora_rank", "4",
                              "--device", "cpu"])
    _, _, trainer = main_fedavg.setup_run(args)
    assert isinstance(trainer, LoRATrainer) and isinstance(trainer.inner, TagPredictionTrainer)
