"""The port's silo-grouped round (``algorithms/silo_grouped.py``,
``ops/silo_conv.py`` and ``models/resnet.py``'s silo-stacked forward)
against the JAX package's silo round and against the port's own engine
round, after ``tests/test_silo_grouped.py``: a Bottleneck ResNet with one
block a stage at widths (4, 8, 16), 3 silos of 8 rows at 8x8.

Against the JAX package the weights cross through ``utils/convert.py`` and
shuffle is off (the two packages draw their shuffles from different
generators); against the engine both rounds draw the same permutations
and seeds from one round generator. Tolerances are the JAX test's: rtol
1e-4, atol 1e-5 on the globals (metrics rtol 1e-4, atol 1e-4); the
convolution alone rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu.algorithms.aggregators import make_aggregator as jax_make_aggregator
from fedml_tpu.algorithms.silo_grouped import build_silo_round_fn as jax_silo_round_fn
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.models.resnet import Bottleneck as JaxBottleneck
from fedml_tpu.models.resnet import ResNetCifar as JaxResNetCifar
from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import build_round_fn
from fedml_tpu_torch.algorithms.silo_grouped import (build_silo_local_update,
                                                     build_silo_round_fn, silo_trainer)
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import ClassificationTrainer
from fedml_tpu_torch.models.resnet import Bottleneck, ResNetCifar
from fedml_tpu_torch.ops.silo_conv import GroupableConv, silo_conv
from fedml_tpu_torch.utils.convert import flax_to_torch

RTOL, ATOL = 1e-4, 1e-5
KW = dict(layers=(1, 1, 1), widths=(4, 8, 16), output_dim=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the port's other heavy test files: the
    suite's workers would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(s=3, n=8, hw=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(s, n, hw, hw, 3).astype(np.float32)
    y = rng.randint(0, 10, size=(s, n)).astype(np.int32)
    return x, y


def _port(threshold=8):
    tr = ClassificationTrainer(ResNetCifar(Bottleneck, **KW))
    return tr, silo_trainer(tr, threshold)


def _init(tr, seed=0):
    return tr.init(torch.Generator().manual_seed(seed), "cpu")


def _cfg(**kw):
    base = dict(batch_size=4, epochs=2, lr=0.1, client_optimizer="sgd",
                client_num_per_round=3)
    return FedConfig(**{**base, **kw})


def _rounds(round_fn, gv, st, x, y, counts, rounds=1, seed=7):
    x, y, counts = torch.tensor(x), torch.tensor(y).long(), torch.tensor(counts)
    metrics = []
    for r in range(rounds):
        gv, st, m = round_fn(gv, st, x, y, counts, torch.Generator().manual_seed(seed + r))
        metrics.append(m)
    return gv, st, metrics


def _close(got: dict, want: dict, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].detach().numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def _silo_vs_engine(cfg, counts, aggregator="fedavg", rounds=2, threshold=8):
    """The port's silo round and engine round from one init and the same
    round generators: (silo globals, engine globals, their metrics)."""
    tr, st_tr = _port(threshold)
    x, y = _data()
    gv = _init(tr)
    agg = make_aggregator(aggregator, cfg)
    st = agg.init_state(gv)
    eng = _rounds(build_round_fn(tr, cfg, agg, device="cpu"), gv, st, x, y, counts, rounds)
    silo = _rounds(build_silo_round_fn(st_tr, cfg, agg, device="cpu"), gv, st, x, y,
                   counts, rounds)
    return silo, eng


# ---------------------------------------------------------------- silo_conv

@pytest.mark.parametrize("stride,padding,k", [(1, 1, 3), (2, 1, 3), (2, 0, 1)])
def test_silo_conv_unstacked_is_conv2d_bit_for_bit(stride, padding, k):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 6, 9, 9, generator=g)
    w = torch.randn(5, 6, k, k, generator=g)
    want = F.conv2d(x, w, None, stride, padding)
    got = silo_conv(x, w, stride, padding, threshold=32)
    assert torch.equal(got, want)
    layer = GroupableConv(6, 5, k, stride, padding, threshold=32)
    with torch.no_grad():
        layer.weight.copy_(w)
    assert torch.equal(layer(x), want)


@pytest.mark.parametrize("threshold", [0, 8, 64], ids=["per-silo", "mixed", "grouped"])
def test_silo_conv_stacked_equals_the_per_silo_loop(threshold):
    """[S, B, C, H, W] x [S, O, C, kh, kw]: the grouped launch (channels at
    most ``threshold``) and the per-silo one both give each silo's own
    convolution."""
    g = torch.Generator().manual_seed(1)
    for cin, cout in ((4, 8), (16, 16)):
        x = torch.randn(3, 2, cin, 7, 7, generator=g)
        w = torch.randn(3, cout, cin, 3, 3, generator=g)
        got = silo_conv(x, w, 2, 1, threshold)
        want = torch.stack([F.conv2d(x[s], w[s], None, 2, 1) for s in range(3)])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_groupable_conv_keeps_the_plain_models_variables():
    """The silo model's variables are the plain model's: names, shapes and
    flax's initial values, so one converted tree serves both."""
    plain, silo = ResNetCifar(Bottleneck, **KW), ResNetCifar(Bottleneck, silo_threshold=8,
                                                             **KW)
    assert isinstance(silo.Bottleneck_0.Conv_1, GroupableConv)
    a, b = _init(ClassificationTrainer(plain)), _init(ClassificationTrainer(silo))
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("group_norm", [0, 2], ids=["batchnorm", "groupnorm"])
def test_stacked_forward_equals_each_silos_forward(group_norm):
    """One train-mode forward of the silo-stacked model equals each silo's
    own forward: logits and the new running statistics, per silo."""
    tr = ClassificationTrainer(ResNetCifar(Bottleneck, group_norm=group_norm, **KW))
    st_tr = silo_trainer(tr, 8)
    x, _ = _data()
    x = torch.tensor(x)
    variables = [_init(tr, seed) for seed in range(3)]
    stacked = {k: torch.stack([v[k] for v in variables]) for k in variables[0]}
    logits, state = st_tr.apply(stacked, x, None, True)
    for s in range(3):
        want, want_state = tr.apply(variables[s], x[s], None, True)
        np.testing.assert_allclose(logits[s].detach().numpy(), want.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        _close({k: v[s] for k, v in state.items()}, want_state, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- against the JAX round

@pytest.mark.parametrize("full", [True, False], ids=["full", "ragged"])
def test_silo_round_matches_jax_silo_round(full):
    """One round (2 epochs of batch 4) of the port's silo round against the
    JAX package's, from the JAX init converted; ragged counts exercise the
    per-silo no-op steps."""
    x, y = _data()
    counts = [8, 8, 8] if full else [8, 5, 3]
    jcfg = JaxConfig(batch_size=4, epochs=2, lr=0.1, client_optimizer="sgd",
                     client_num_per_round=3, assume_full_clients=full, shuffle=False)
    jagg = jax_make_aggregator("fedavg", jcfg)
    jtr = JaxTrainer(JaxResNetCifar(block=JaxBottleneck, silo_threshold=8, **KW))
    jgv = JaxTrainer(JaxResNetCifar(block=JaxBottleneck, **KW)).init(
        jax.random.PRNGKey(0), jnp.asarray(x[0, :1]))
    jout, _, jm = jax_silo_round_fn(jtr, jcfg, jagg)(
        jgv, jagg.init_state(jgv), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(counts, jnp.int32), jax.random.PRNGKey(7))

    tr, st_tr = _port()
    cfg = _cfg(assume_full_clients=full, shuffle=False)
    agg = make_aggregator("fedavg", cfg)
    gv = flax_to_torch(jax.device_get(jgv), module=tr.module)
    out, _, (m,) = _rounds(build_silo_round_fn(st_tr, cfg, agg, device="cpu"), gv,
                           agg.init_state(gv), x, y, counts)
    _close(out, flax_to_torch(jax.device_get(jout), module=tr.module))
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


# ------------------------------------------------------ against the engine round

@pytest.mark.parametrize("full", [True, False], ids=["full", "ragged"])
def test_silo_round_matches_engine_round(full):
    """Two rounds with shuffle on: the silo round draws the engine's
    permutations and seeds from the same round generators."""
    counts = [8, 8, 8] if full else [8, 5, 3]
    (gs, _, ms), (ge, _, me) = _silo_vs_engine(_cfg(assume_full_clients=full), counts)
    _close(gs, ge)
    for a, b in zip(ms, me):
        for k in b:
            np.testing.assert_allclose(a[k].item(), b[k].item(), rtol=1e-4, atol=1e-4)


def test_silo_momentum_optimizer_exact_per_silo():
    """Momentum and weight decay: each silo's trace is its own."""
    cfg = _cfg(epochs=1, lr=0.05, momentum=0.9, wd=1e-4, assume_full_clients=True)
    (gs, _, _), (ge, _, _) = _silo_vs_engine(cfg, [8, 8, 8])
    _close(gs, ge)


def test_silo_clip_binds_per_silo():
    """A global-norm clip far below the gradients' norms: each silo's
    gradient is clipped by its own norm (a clip over the stack would scale
    every silo by the stack's norm and miss the engine)."""
    tr, st_tr = _port()
    x, y = _data()
    gv = _init(tr)
    b = {"x": torch.tensor(x[0, :4]), "y": torch.tensor(y[0, :4]).long(),
         "mask": torch.ones(4)}
    leaves = {k: v.requires_grad_(True) for k, v in gv.items() if not k.endswith(("mean",
                                                                                  "var"))}
    loss, _ = tr.loss_fn({**gv, **leaves}, b, None, True)
    norm = torch.sqrt(sum((g * g).sum() for g in torch.autograd.grad(loss, list(
        leaves.values()))))
    clip = 0.05
    assert norm.item() > 10 * clip  # the clip binds
    cfg = _cfg(grad_clip=clip, momentum=0.9, assume_full_clients=False)
    (gs, _, _), (ge, _, _) = _silo_vs_engine(cfg, [8, 5, 3])
    _close(gs, ge)


def test_all_padding_silo_keeps_its_variables_and_steps():
    """A silo with no rows takes no step: it returns the globals, its
    step count is 0, and (momentum, so the per-silo selects matter) the
    other silos match the engine."""
    tr, st_tr = _port()
    x, y = _data()
    gv = _init(tr)
    cfg = _cfg(momentum=0.9, assume_full_clients=False)
    update = build_silo_local_update(st_tr, cfg)
    result = update(gv, torch.tensor(x), torch.tensor(y).long(), torch.tensor([8, 5, 0]),
                    torch.Generator().manual_seed(3))
    assert result.num_steps.tolist() == [4, 4, 0]
    for k, v in gv.items():
        assert torch.equal(result.variables[k][2], v), k
    assert result.metrics["total"].tolist() == [8.0, 5.0, 0.0]
    (gs, _, _), (ge, _, _) = _silo_vs_engine(cfg, [8, 5, 0], rounds=1)
    _close(gs, ge)


def test_silo_round_with_fednova_aggregator():
    """FedNova reads the per-silo step counts: ragged counts make its tau
    normalisation load-bearing."""
    cfg = _cfg(assume_full_clients=False)
    (gs, _, _), (ge, _, _) = _silo_vs_engine(cfg, [8, 5, 3], aggregator="fednova")
    _close(gs, ge)


def test_silo_round_with_fedprox_and_amsgrad():
    """FedProx's term and AMSGrad's per-silo step count."""
    cfg = _cfg(fedprox_mu=0.1, client_optimizer="adam", lr=1e-3, assume_full_clients=False)
    (gs, _, _), (ge, _, _) = _silo_vs_engine(cfg, [8, 5, 3], rounds=1)
    _close(gs, ge)


@pytest.mark.parametrize("threshold", [1, 64], ids=["per-silo", "grouped"])
def test_threshold_does_not_change_the_round(threshold):
    """Every convolution per silo (threshold 1 admits none of these
    widths) or grouped (64 admits all): the same round as the engine."""
    cfg = _cfg(assume_full_clients=True)
    (gs, _, _), (ge, _, _) = _silo_vs_engine(cfg, [8, 8, 8], rounds=1, threshold=threshold)
    _close(gs, ge)


def test_silo_trainer_rejects_models_without_a_threshold():
    from fedml_tpu_torch.models.registry import create_model

    with pytest.raises(ValueError, match="ResNetCifar"):
        silo_trainer(ClassificationTrainer(create_model("lr", output_dim=10)), 32)


# ---------------------------------------------------------------- the drive

def _tiny_cifar(clients=3, rows=8, seed=0):
    from fedml_tpu_torch.data.packing import PackedClients
    from fedml_tpu_torch.data.registry import FederatedDataset

    x, y = _data(clients, rows, seed=seed)
    flat = (x.reshape(-1, 8, 8, 3), y.reshape(-1))
    return FederatedDataset(name="tiny", train=PackedClients(x, y, np.full(clients, rows)),
                            test=None, train_global=flat,
                            test_global=(flat[0][:12], flat[1][:12]), class_num=10)


def test_fedavg_api_runs_the_silo_round():
    """``FedConfig(silo_threshold=32)`` validates and ``FedAvgAPI`` routes it
    to the silo round, evaluating with the original trainer: its globals
    after a round are the engine-driven API's (the same round generator)."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI

    ds = _tiny_cifar()
    outs = []
    for threshold in (32, 0):
        cfg = _cfg(client_num_in_total=3, comm_round=2, frequency_of_the_test=1,
                   silo_threshold=threshold, assume_full_clients=True)
        cfg.validate()
        api = FedAvgAPI(ds, cfg, ClassificationTrainer(ResNetCifar(Bottleneck, **KW)),
                        device="cpu")
        assert ("silo" in api.round_fn.__qualname__) == (threshold > 0)
        assert api.trainer.module.silo_threshold == 0  # the evaluations' trainer
        hist = api.train()
        assert len(hist) == 2 and np.isfinite(hist[-1]["Test/Loss"])
        outs.append(api.global_variables)
    _close(outs[0], outs[1])
