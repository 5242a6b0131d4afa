"""The port's privacy package against the JAX package's on the CPU:
AdaptiveCNN (``models/ensemble.py``), the joint multi-model client update
(``privacy/multi_model.py``), the block ensemble
(``privacy/blockensemble.py``) and branch-wise FedAvg with its five
ensembles (``privacy/branch_fedavg.py``).

Both packages draw their initial weights, shuffles and dropout masks from
their own random streams (flax's and PyTorch's). So the port starts from
the JAX package's weights (converted), JAX's shuffles are re-derived from
its keys here and injected into the port, and dropout is the identity on
both sides inside each test (flax's ``nn.Dropout.__call__`` and the
port's ``_dropout``, monkeypatched); the engine-based ensembles run with
``shuffle`` off on both sides. Sizes are small: 12x12 images, 10 classes,
3-4 clients of 16-24 rows, batch 8. Tolerance: the engine's float32
contract, rtol 2e-5 / atol 1e-5, unless noted."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.data.registry import FederatedDataset as JaxDataset
from fedml_tpu.models import ensemble as jax_ensemble
from fedml_tpu.privacy import blockensemble as jax_block
from fedml_tpu.privacy import multi_model as jax_multi
from fedml_tpu.privacy.branch_fedavg import BranchFedAvgAPI as JaxBranchAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import ClassificationTrainer, flax_default_init
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.data.registry import FederatedDataset
from fedml_tpu_torch.models import ensemble
from fedml_tpu_torch.privacy import blockensemble, multi_model
from fedml_tpu_torch.privacy.branch_fedavg import BranchFedAvgAPI
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax

HW, CLASSES, BATCH = 12, 10, 8
RTOL, ATOL = 2e-5, 1e-5
HETERO = ensemble.build_hetero_archs(4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side (the suite runs several
    workers on the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout is the identity in both packages for the test."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(ensemble, "_dropout", lambda x, rate, generator: x)


def _images(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(n, HW, HW, 1)).astype(np.float32),
            rng.randint(0, CLASSES, size=n).astype(np.int32))


def _jax_module(arch=None, dtype=None):
    return jax_ensemble.AdaptiveCNN(output_dim=CLASSES, arch=arch or jax_ensemble.ArchSpec(),
                                    dtype=dtype)


def _port_module(arch=None, dtype="float32"):
    return ensemble.AdaptiveCNN(output_dim=CLASSES, arch=arch, dtype=dtype, input_hw=HW)


def _jax_arch(spec):
    return jax_ensemble.ArchSpec(**dataclasses.asdict(spec))


def _jax_init(module, seed, x):
    key = jax.random.PRNGKey(seed)
    return module.init({"params": key, "dropout": key}, jnp.asarray(x[:1]), train=False)


def _close(got: dict, want_tree, module, rtol=RTOL, atol=ATOL, what=""):
    """Port variables ``got`` against a flax variables tree."""
    want = flax_to_torch(jax.device_get(want_tree), module=module)
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k].detach().float().numpy(), want[k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=f"{what} {k}")


# ----------------------------------------------------------------- the model


@pytest.mark.parametrize("b", range(4), ids=[s.describe() for s in HETERO])
def test_adaptive_cnn_forward_and_features_match_flax(b):
    """Logits and the three block features (pre-ReLU, flax's
    ``capture_intermediates``) of each hetero spec, weights converted, and
    the converter's round trip."""
    x, _ = _images(6, b)
    jm, tm = _jax_module(_jax_arch(HETERO[b])), _port_module(HETERO[b])
    v = _jax_init(jm, b, x)
    tv = flax_to_torch(v, module=tm)
    assert [k for k in tv] and {k.split(".")[0] for k in tv} == set(v["params"])
    want_logits, want_feats = jax_multi._forward_with_features(jm, v, jnp.asarray(x), None,
                                                               train=False)
    logits, feats = torch.func.functional_call(tm, tv, (torch.from_numpy(x),),
                                               {"features": True})
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=RTOL, atol=ATOL)
    assert len(feats) == len(want_feats) == 3
    for got, want in zip(feats, want_feats):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    back = torch_to_flax(tv, module=tm)
    for layer, leaves in v["params"].items():
        for leaf, arr in leaves.items():
            np.testing.assert_array_equal(back["params"][layer][leaf], np.asarray(arr))


def test_adaptive_cnn_bfloat16_compute():
    """bf16 compute with f32 parameters, at the port's bf16 model tolerance
    (``tests/test_torch_models.py``: 5e-2 absolute on the logits); the
    logits stay bf16, as the flax module's last Dense leaves them."""
    x, _ = _images(6, 7)
    jm = _jax_module(_jax_arch(HETERO[3]), jnp.bfloat16)
    tm = _port_module(HETERO[3], "bfloat16")
    v = _jax_init(jm, 7, x)
    want = jm.apply(v, jnp.asarray(x))
    got = torch.func.functional_call(tm, flax_to_torch(v, module=tm), (torch.from_numpy(x),))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=5e-2)


def test_hetero_archs_and_blocks_match_jax():
    for n in range(1, 9):
        assert ([dataclasses.astuple(s) for s in ensemble.build_hetero_archs(n)]
                == [dataclasses.astuple(s) for s in jax_ensemble.build_hetero_archs(n)])
        assert ([s.describe() for s in ensemble.build_hetero_archs(n)]
                == [s.describe() for s in jax_ensemble.build_hetero_archs(n)])
    for key in ("conv1_0.weight", "conv1_out.bias", "conv2_1.weight", "linear1_0.bias",
                "linear1_out.weight", "linear2_out.bias"):
        assert blockensemble.block_of(key) == jax_block.block_of(key.split(".")[0])
    with pytest.raises(KeyError):
        blockensemble.block_of("head.weight")


# ------------------------------------------------------- joint local update


def _jax_perms(key, count, n_max, epochs):
    """The permutations the JAX joint update draws from ``key``
    (multi_model.py:175-180)."""
    out = []
    for erng in jax.random.split(key, epochs):
        shuffle_rng, _ = jax.random.split(erng)
        u = jax.random.uniform(shuffle_rng, (n_max,))
        out.append(np.asarray(jnp.argsort(jnp.where(jnp.arange(n_max) < count, u, jnp.inf))))
    return torch.from_numpy(np.stack(out).astype(np.int64))


@pytest.mark.parametrize("num_models,feat_lmda", [(2, 0.0), (3, 0.5)])
def test_joint_local_update_matches_jax(no_dropout, num_models, feat_lmda):
    """A ragged client (13 of 24 rows: a partial batch, then a batch of
    padding alone) for 2 epochs; one clip over the union of the models
    (the step's global norm is well above the clip of 1.0, so a clip per
    model would differ); the feature-matching term with 3 models."""
    n_max, count = 24, 13
    x, y = _images(n_max, 11)
    kw = dict(batch_size=BATCH, epochs=2, lr=0.1, grad_clip=1.0)
    jm, tm = _jax_module(), _port_module()
    paths = [_jax_init(jm, k, x) for k in range(num_models)]
    key = jax.random.PRNGKey(3)
    jlocal = jax_multi.build_joint_local_update(jm, JaxConfig(**kw), num_models, feat_lmda)
    want_paths, want_m = jlocal(tuple(paths), jnp.asarray(x), jnp.asarray(y), count, key)
    trainer = (multi_model.TwoModelTrainer if num_models == 2
               else multi_model.ThreeModelTrainer)(tm, FedConfig(**kw), feat_lmda)
    got_paths, got_m = trainer.train([flax_to_torch(p, module=tm) for p in paths],
                                     torch.from_numpy(x), torch.from_numpy(y), count,
                                     torch.Generator().manual_seed(0),
                                     perms=_jax_perms(key, count, n_max, 2))
    for k, (got, want) in enumerate(zip(got_paths, want_paths)):
        _close(got, want, tm, what=f"path {k}")
        assert not np.allclose(got["linear2_out.weight"].numpy(),
                               flax_to_torch(paths[k])["linear2_out.weight"].numpy())
    assert float(got_m["total"]) == float(want_m["total"]) == 2 * count
    for name in ("loss_sum", "correct"):
        np.testing.assert_allclose(float(got_m[name]), float(want_m[name]), rtol=1e-5,
                                   err_msg=name)


def test_joint_update_draws_its_shuffle_and_refuses_a_wrong_model_count():
    x, y = _images(16, 1)
    tm = _port_module()
    gen = torch.Generator().manual_seed(0)
    paths = [flax_default_init(tm, torch.Generator().manual_seed(k), "cpu") for k in range(2)]
    update = multi_model.build_joint_local_update(tm, FedConfig(batch_size=BATCH, lr=0.1), 2)
    a, ma = update(paths, torch.from_numpy(x), torch.from_numpy(y), 10,
                   torch.Generator().manual_seed(5))
    b, mb = update(paths, torch.from_numpy(x), torch.from_numpy(y), 10,
                   torch.Generator().manual_seed(5))
    for pa, pb in zip(a, b):
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert float(ma["total"]) == 10.0
    with pytest.raises(ValueError, match="expected 3 models"):
        multi_model.ThreeModelTrainer(tm, FedConfig()).train(paths, x, y, 10, gen)


# ------------------------------------------------------------ the datasets


def _datasets(clients=4, n_max=20, test_rows=40, seed=0):
    """The same federated arrays in both packages' dataset types; client 1
    ragged (11 rows) and client 2 short (5)."""
    x, y = _images(clients * n_max, seed)
    x = x.reshape(clients, n_max, HW, HW, 1)
    y = y.reshape(clients, n_max)
    counts = np.full(clients, n_max, np.int32)
    counts[1], counts[2] = 11, 5
    xt, yt = _images(test_rows, seed + 100)
    rows = np.concatenate([x[c, :counts[c]] for c in range(clients)])
    labels = np.concatenate([y[c, :counts[c]] for c in range(clients)])
    args = dict(name="mnist", test=None, train_global=(rows, labels), test_global=(xt, yt),
                class_num=CLASSES)
    return (JaxDataset(train=JaxPacked(x, y, counts), **args),
            FederatedDataset(train=PackedClients(x, y, counts), **args))


# --------------------------------------------------------- block ensemble


def _client_perms(cfg, round_idx, counts, n_max):
    """The JAX block ensemble's per-client permutations of a round
    (blockensemble.py:333-334)."""
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), round_idx)
    return [_jax_perms(k, int(c), n_max, cfg.epochs) for k, c in
            zip(jax.random.split(key, len(counts)), counts)]


def test_block_ensemble_two_rounds_match_jax(no_dropout):
    """prepare_paths bit for bit (the draw and the assembled paths), then
    two rounds of 3 of 4 clients (3 branches, 2 paths): trained blocks
    within the contract, blocks no path trained keep their bits, the
    metrics and the evaluation equal."""
    jds, tds = _datasets()
    kw = dict(batch_size=BATCH, epochs=1, lr=0.1, client_num_in_total=4,
              client_num_per_round=3, comm_round=2, seed=2)
    japi = jax_block.BlockEnsembleAPI(jds, JaxConfig(**kw), branch_num=3, num_paths=2)
    tapi = blockensemble.BlockEnsembleAPI(tds, FedConfig(**kw), branch_num=3, num_paths=2,
                                          device="cpu")
    tm = tapi.module
    tapi.branches = [flax_to_torch(jax.device_get(b), module=tm) for b in japi.branches]
    for r in range(2):
        jpaths, jpick = japi.prepare_paths(r)
        tpaths, tpick = tapi.prepare_paths(r)
        assert {k: v.tolist() for k, v in tpick.items()} == {k: v.tolist()
                                                             for k, v in jpick.items()}
        for k, (got, want) in enumerate(zip(tpaths, jpaths)):
            for name, t in got.items():
                assert t is tapi.branches[tpick[blockensemble.block_of(name)][k]][name]
            if r == 0:  # before training both hold the same bits
                want = flax_to_torch(jax.device_get(want), module=tm)
                assert all(torch.equal(got[n], want[n]) for n in want)
        before = [dict(b) for b in tapi.branches]
        idx = jax_block.client_sampling(r, 4, 3)
        _, _, counts = jds.train.select(idx)
        perms = _client_perms(japi.cfg, r, counts, jds.train.n_max)
        want_m = japi.train_one_round(r)
        got_m = tapi.train_one_round(r, perms=perms)
        for k in want_m:
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-5, err_msg=k)
        for b in range(3):
            _close(tapi.branches[b], japi.branches[b], tm, what=f"round {r} branch {b}")
            for name, t in tapi.branches[b].items():
                blk = blockensemble.block_of(name)
                if b not in {int(v) for v in tpick[blk]}:
                    assert torch.equal(t, before[b][name]), (r, b, name)
                else:
                    assert not torch.equal(t, before[b][name]), (r, b, name)
    got, want = tapi.evaluate(), japi.evaluate()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_block_ensemble_refuses_path_counts():
    _, tds = _datasets()
    for paths in (1, 4):
        with pytest.raises(ValueError, match="num_paths"):
            blockensemble.BlockEnsembleAPI(tds, FedConfig(), branch_num=3, num_paths=paths,
                                           device="cpu")


# ---------------------------------------------------------- branch FedAvg


def _branch_apis(method, branch_num=2, **extra):
    jds, tds = _datasets()
    kw = dict(batch_size=BATCH, epochs=1, lr=0.1, client_num_in_total=4,
              client_num_per_round=4, comm_round=1, shuffle=False, seed=1)
    archs = (ensemble.build_hetero_archs(branch_num) if method == "hetero"
             else [ensemble.ArchSpec()] * branch_num)
    jtrainers = [JaxTrainer(_jax_module(_jax_arch(a))) for a in archs]
    ttrainers = [ClassificationTrainer(_port_module(a)) for a in archs]
    shared = ("conv1_out", "conv2_out") if method == "blockavg" else ()
    japi = JaxBranchAPI(jds, JaxConfig(**kw), jtrainers, ensemble_method=method,
                        shared_blocks=shared, server_data_ratio=0.25, **extra)
    tapi = BranchFedAvgAPI(tds, FedConfig(**kw), ttrainers, ensemble_method=method,
                           shared_blocks=shared, server_data_ratio=0.25, device="cpu")
    tapi.branches = [flax_to_torch(jax.device_get(v), module=t.module)
                     for v, t in zip(japi.branches, ttrainers)]
    return japi, tapi


def test_assign_branches_bitwise():
    japi, tapi = _branch_apis("predavg", branch_num=3)
    for n in (1, 4, 7):
        for r in range(5):
            got, want = tapi.assign_branches(n, r), japi.assign_branches(n, r)
            assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("method", ["predavg", "predvote", "predweight", "blockavg",
                                    "hetero"])
def test_branch_fedavg_round_matches_jax(no_dropout, method):
    """One round of 4 clients over 2 branches (2 clients each, round-robin),
    then the ensemble's predictions on the held-out split equal, the
    evaluation dicts equal, and predweight's fitted weights within the
    contract."""
    japi, tapi = _branch_apis(method)
    want_m = japi.train_one_round(0)
    got_m = tapi.train_one_round(0)
    assert got_m.keys() == want_m.keys() == {"branch0_loss", "branch1_loss"}
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-5, err_msg=k)
    for b, t in enumerate(tapi.trainers):
        _close(tapi.branches[b], japi.branches[b], t.module, what=f"branch {b}")
    if method == "blockavg":
        for k in ("conv1_out.weight", "conv2_out.bias"):
            assert torch.equal(tapi.branches[0][k], tapi.branches[1][k])
    if method == "predweight":
        np.testing.assert_allclose(tapi.branch_weights.numpy(),
                                   np.asarray(japi.branch_weights), rtol=RTOL, atol=ATOL)
        assert not np.allclose(tapi.branch_weights.numpy(), 0.5)
    xe, _ = tapi._eval_data
    assert np.array_equal(tapi.ensemble_predict(xe).numpy(),
                          np.asarray(japi.ensemble_predict(jnp.asarray(xe.numpy()))))
    got, want = tapi.evaluate(), japi.evaluate()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
