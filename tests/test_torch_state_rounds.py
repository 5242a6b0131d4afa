"""Rounds with model state: a small BatchNorm ResNet through the port's
``FedAvgAPI`` and round engine against the JAX package's, under FedAvg and
the server rules, parameters and running statistics compared; the server
rules acting on parameters only; then the Shakespeare LSTM and MNIST
logistic regression through ``FedAvgAPI``, and the CLI's dataset dispatch.

Shuffle and dropout are off on both sides (their random streams differ by
design). Client 0 holds 20 rows, client 1 13 and client 2 8 at batch 8,
so two clients end on a part-padded batch whose zero rows enter the
BatchNorm statistics, and client 2's later batches are all padding (no
step). Tolerances: rtol 2e-5 / atol 1e-5 for whole runs, the reference's
contract."""

import argparse

import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.core.trainer import NWPTrainer as JaxNWPTrainer
from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.data.registry import FederatedDataset as JaxDataset
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.models import resnet as jax_resnet
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch import ClassificationTrainer, FedAvgAPI, FedConfig, NWPTrainer
from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import LocalResult
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.data.registry import FederatedDataset, load_dataset
from fedml_tpu_torch.experiments import main_fedavg
from fedml_tpu_torch.models import resnet
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.utils.convert import flax_to_torch
from fedml_tpu_torch.utils.pytree import split_variables, tree_weighted_mean
from test_torch_fedavg import _capped


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs several
    workers on the machine's cores, and PyTorch's CPU thread pool, sized to
    every core in each worker, oversubscribes them (these tests' many small
    ops then run many times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


COUNTS = np.array([20, 13, 8], np.int32)
SIDE, CLASSES = 8, 5


def _datasets(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(3, 20, SIDE, SIDE, 3)).astype(np.float32)
    y = rng.randint(0, CLASSES, size=(3, 20)).astype(np.int32)
    for c, n in enumerate(COUNTS):
        x[c, n:], y[c, n:] = 0, 0
    xte = rng.normal(size=(8, SIDE, SIDE, 3)).astype(np.float32)
    yte = rng.randint(0, CLASSES, size=8).astype(np.int32)
    flat = (np.concatenate([x[c, :n] for c, n in enumerate(COUNTS)]),
            np.concatenate([y[c, :n] for c, n in enumerate(COUNTS)]))

    def make(dataset_cls, packed_cls):
        return dataset_cls(name="bn", train=packed_cls(x, y, COUNTS.copy()), test=None,
                           train_global=flat, test_global=(xte, yte), class_num=CLASSES)

    return make(JaxDataset, JaxPacked), make(FederatedDataset, PackedClients)


RULES = {
    "fedavg": ("fedavg", {}),
    "fedavgm": ("fedopt", dict(server_optimizer="sgd", server_lr=1e-3, server_momentum=0.9)),
    "fedadam": ("fedopt", dict(server_optimizer="adam", server_lr=1e-3)),
    "fednova": ("fednova", dict(momentum=0.9, wd=1e-4)),
    "robust": ("robust", dict(norm_bound=0.5, stddev=0.0)),
}


@pytest.mark.parametrize("rule", ["fedavg", "fedavgm", "fednova", "robust"])
def test_bn_resnet_two_rounds_match_jax(rule):
    """Two rounds of ResNetCifar (BasicBlock, one block a stage: 7
    BatchNorms) through FedAvgAPI, with the evaluations (running
    statistics) after each: the round metrics, the final parameters and
    the final running statistics, against the JAX package's FedAvgAPI.

    Parameters and statistics at rtol 2e-5 / atol 1e-5: the largest gap
    is 3.0e-7, and a float64 run of the JAX package sits 3.4e-7 from its
    float32 one and at most 3.6e-7 from the port. FedAdam's server step is held
    by ``test_server_rules_act_on_parameters_only`` and PR 8's
    ``tests/test_torch_server_rules.py``: over whole rounds its first step,
    about lr * sign(pseudo-gradient), moves an element that rounds to the
    other side of 0 by up to 2 * lr."""
    name, kw = RULES[rule]
    base = dict(client_num_in_total=3, client_num_per_round=3, batch_size=8, lr=0.05,
                epochs=1, comm_round=2, shuffle=False, seed=0, grad_clip=1.0)
    base.update(kw)
    jds, tds = _datasets()
    jm = jax_resnet.ResNetCifar(block=jax_resnet.BasicBlock, layers=(1, 1, 1),
                                output_dim=CLASSES)
    tm = resnet.ResNetCifar(resnet.BasicBlock, (1, 1, 1), CLASSES)
    japi = JaxFedAvgAPI(jds, JaxConfig(**base), JaxTrainer(jm), aggregator_name=name)
    tapi = FedAvgAPI(tds, FedConfig(**base), ClassificationTrainer(tm), aggregator_name=name,
                     device="cpu")
    tapi.global_variables = flax_to_torch(japi.global_variables, module=tm)
    tapi.agg_state = tapi.aggregator.init_state(tapi.global_variables)
    assert any(k.endswith(".var") for k in tapi.global_variables)
    jhist, thist = japi.train(), tapi.train()
    for jr, tr in zip(jhist, thist):
        for key in ("Train/Acc", "Train/Loss", "Test/Acc", "Test/Loss"):
            np.testing.assert_allclose(tr[key], jr[key], rtol=2e-5, atol=2e-5,
                                       err_msg=f"round {jr['round']} {key}")
    assert thist[0]["total"] == COUNTS.sum()
    want = flax_to_torch(japi.global_variables, module=tm)
    assert set(want) == set(tapi.global_variables)
    for k in want:
        np.testing.assert_allclose(tapi.global_variables[k].numpy(), want[k].numpy(),
                                   rtol=2e-5, atol=1e-5, err_msg=k)
    # the statistics moved from their init
    var = tapi.global_variables["_Norm_0.BatchNorm_0.var"]
    assert not torch.allclose(var, torch.ones_like(var))


def _stacked_result(seed=0):
    """A hand-made client-stacked result: two parameter leaves and a
    BatchNorm's mean and var, three clients far from the globals."""
    g = torch.Generator().manual_seed(seed)
    glob = {"conv.weight": torch.randn(4, 3, generator=g), "norm.weight": torch.ones(4),
            "norm.mean": torch.zeros(4), "norm.var": torch.ones(4)}
    stacked = {k: v[None] + 3.0 * torch.randn((3,) + v.shape, generator=g)
               for k, v in glob.items()}
    stacked["norm.var"] = stacked["norm.var"].abs()
    return glob, LocalResult(stacked, torch.tensor([4, 2, 1]), {})


@pytest.mark.parametrize("rule", ["fedavgm", "fedadam", "fednova", "robust"])
def test_server_rules_act_on_parameters_only(rule):
    """Every server rule but FedAvg steps, normalises, clips or noises the
    parameters only: the running statistics come out as the clients'
    weighted mean, bit for bit, while the parameters do not (a heavy
    clip, noise of 0.5, a server step at lr 0.5); FedOpt's optimizer state
    holds parameters only."""
    name, kw = RULES[rule]
    kw = dict(kw, **({"server_lr": 0.5} if name == "fedopt" else {}),
              **({"stddev": 0.5} if name == "robust" else {}))
    cfg = FedConfig(**kw)
    agg = make_aggregator(name, cfg)
    glob, result = _stacked_result()
    weights = torch.tensor([3.0, 1.0, 2.0])
    state = agg.init_state(glob)
    if name == "fedopt":
        moments = [v for v in state.values() if isinstance(v, dict)]
        assert moments and all(set(m) == {"conv.weight", "norm.weight"} for m in moments)
    new, _ = agg(glob, result, weights, torch.Generator().manual_seed(0), state)
    assert list(new) == list(glob)
    mean = tree_weighted_mean(result.variables, weights)
    params, stats = split_variables(new)
    for k in stats:
        assert torch.equal(new[k], mean[k]), k
    for k in params:
        assert not torch.allclose(new[k], mean[k]), k


def test_fedavg_averages_state_with_the_parameters():
    glob, result = _stacked_result(1)
    weights = torch.tensor([1.0, 1.0, 2.0])
    new, _ = make_aggregator("fedavg", FedConfig())(glob, result, weights, None, ())
    mean = tree_weighted_mean(result.variables, weights)
    assert all(torch.equal(new[k], mean[k]) for k in mean)


@pytest.mark.parametrize("dataset", ["shakespeare", "fed_shakespeare"])
def test_shakespeare_lstm_rounds_match_jax(dataset):
    """The Shakespeare LSTM at its published widths (embed 8, two layers of
    256, vocab 90) for two FedAvg rounds on 3 surrogate clients capped at
    12 windows, batch 5: next-char classification, and per-position NWP
    (fed_shakespeare). Measured: parameters within 2e-7, metrics within
    1e-6; held at rtol 2e-5 / atol 1e-5."""
    kw = dict(dataset=dataset, model="rnn", client_num_in_total=3, client_num_per_round=3,
              batch_size=5, lr=0.8, epochs=1, comm_round=2, shuffle=False, seed=0)
    jds = _capped(jax_load_dataset(dataset, client_num_in_total=3, seed=0), JaxPacked, 12, 16)
    tds = _capped(load_dataset(dataset, client_num_in_total=3, seed=0), PackedClients, 12, 16)
    per_position = dataset == "fed_shakespeare"
    jm = jax_create_model("rnn", output_dim=90, vocab_size=90, per_position=per_position)
    tm = create_model("rnn", output_dim=90, vocab_size=90, per_position=per_position)
    jtr, ttr = ((JaxNWPTrainer(jm), NWPTrainer(tm)) if per_position
                else (JaxTrainer(jm), ClassificationTrainer(tm)))
    japi = JaxFedAvgAPI(jds, JaxConfig(**kw), jtr)
    tapi = FedAvgAPI(tds, FedConfig(**kw), ttr, device="cpu")
    tapi.global_variables = flax_to_torch(japi.global_variables, module=tm)
    jhist, thist = japi.train(), tapi.train()
    for jr, tr in zip(jhist, thist):
        for key in ("Train/Acc", "Train/Loss", "Test/Acc", "Test/Loss"):
            np.testing.assert_allclose(tr[key], jr[key], rtol=2e-5, atol=1e-5,
                                       err_msg=f"round {jr['round']} {key}")
    want = flax_to_torch(japi.global_variables, module=tm)
    for k in want:
        np.testing.assert_allclose(tapi.global_variables[k].numpy(), want[k].numpy(),
                                   rtol=2e-5, atol=1e-5, err_msg=k)


def test_mnist_lr_round_matches_jax():
    """One round of the CLI's default: logistic regression on flat MNIST
    rows, 4 homo clients (the JAX smoke config), batch 32, lr 0.1."""
    kw = dict(dataset="mnist", model="lr", client_num_in_total=4, client_num_per_round=4,
              batch_size=32, lr=0.1, epochs=1, comm_round=1, shuffle=False, seed=0)
    jds = jax_load_dataset("mnist", client_num_in_total=4, partition_method="homo", seed=0)
    tds = load_dataset("mnist", client_num_in_total=4, partition_method="homo", seed=0)
    jm = jax_create_model("lr", output_dim=10)
    tm = create_model("lr", output_dim=10, input_shape=tds.train.x.shape[2:])
    japi = JaxFedAvgAPI(jds, JaxConfig(**kw), JaxTrainer(jm))
    tapi = FedAvgAPI(tds, FedConfig(**kw), ClassificationTrainer(tm), device="cpu")
    tapi.global_variables = flax_to_torch(japi.global_variables, module=tm)
    jr, tr = japi.train()[0], tapi.train()[0]
    for key in ("Train/Acc", "Train/Loss", "Test/Acc", "Test/Loss"):
        np.testing.assert_allclose(tr[key], jr[key], rtol=2e-5, atol=1e-5, err_msg=key)
    want = flax_to_torch(japi.global_variables, module=tm)
    for k in want:
        np.testing.assert_allclose(tapi.global_variables[k].numpy(), want[k].numpy(),
                                   rtol=2e-5, atol=1e-5, err_msg=k)


def test_cli_defaults_run_on_cpu():
    """The CLI with its defaults (MNIST, logistic regression, hetero
    split) and only small counts: finite losses, learning."""
    hist = main_fedavg.main(["--device", "cpu", "--client_num_in_total", "3",
                             "--client_num_per_round", "2", "--comm_round", "2",
                             "--batch_size", "64"])
    assert len(hist) == 2 and all(np.isfinite(h["Test/Loss"]) for h in hist)
    assert hist[-1]["Test/Acc"] > 0.5


@pytest.mark.parametrize("dataset,model,want,kwargs", [
    ("cifar10", "cnn", "cnn_cifar", {}),
    ("har", "cnn", "har_cnn", {}),
    ("femnist", "cnn", "cnn", {}),
    ("mnist", "lr", "lr", {}),
    ("shakespeare", "rnn", "rnn", {"vocab_size": 90, "per_position": False}),
    ("fed_shakespeare", "rnn", "rnn", {"vocab_size": 90, "per_position": True}),
])
def test_cli_contextual_model_dispatch(dataset, model, want, kwargs):
    """Each branch of the JAX CLI's dataset-contextual model choice
    (fedml_tpu/experiments/common.py:316-331)."""
    args = argparse.Namespace(dataset=dataset, model=model)
    assert main_fedavg.contextual_model(args) == (want, kwargs)


@pytest.mark.parametrize("argv,module,trainer", [
    (["--dataset", "cifar10", "--model", "cnn"], "CNNCifar", ClassificationTrainer),
    (["--dataset", "mnist", "--model", "lr"], "LogisticRegression", ClassificationTrainer),
    (["--dataset", "mnist", "--model", "cnn"], "CNN_DropOut", ClassificationTrainer),
    (["--dataset", "fed_shakespeare", "--model", "rnn"], "RNN_OriginalFedAvg", NWPTrainer),
    (["--dataset", "shakespeare", "--model", "rnn"], "RNN_OriginalFedAvg",
     ClassificationTrainer),
], ids=["cifar10-cnn", "mnist-lr", "mnist-cnn", "fed_shakespeare", "shakespeare"])
def test_cli_setup_builds_the_dataset_model_and_trainer(argv, module, trainer):
    """``setup_run``: MNIST flattens for lr only, Shakespeare's per-position
    form trains with NWPTrainer, the model takes the dataset's sample
    shape."""
    args = main_fedavg.add_args(argparse.ArgumentParser()).parse_args(
        argv + ["--client_num_in_total", "3", "--device", "cpu"])
    _, ds, tr = main_fedavg.setup_run(args)
    assert type(tr.module).__name__ == module and type(tr) is trainer
    if argv[1] == "mnist":
        assert ds.train.x.ndim == (3 if argv[3] == "lr" else 5)
    if argv[1] == "fed_shakespeare":
        assert tr.module.per_position and ds.train.y.ndim == 3
