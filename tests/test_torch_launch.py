"""The port's YAML launcher (``experiments/fed_launch.py``) against the JAX
package's, over the repo's 26 configs (``fedml_tpu/experiments/configs/``
and its ``baseline/``): the same dicts from ``_load_yaml`` (PyYAML, or
JSON with PyYAML unimportable), the same argv from
``config_to_argv``, every config resolved through the port to its dataset,
model and trainer (``privacy`` to ``main_privacy``, run for one round),
``main`` of both packages to the
same history, and ``backend: shard_map`` on one device equal to the vmap
round.

History parity: both packages' FedAvgAPI draw their initial weights,
their per-client shuffles and their dropout masks from their own random
streams (flax's and PyTorch's). The history tests therefore start the port
from the JAX package's initial weights (converted) and run both with
``shuffle`` off and the model's dropout at 0 (purchasemlp's 0.5), through a
wrapper of each ``FedAvgAPI.__init__``; everything else (data,
partition, client sampling, the CLI's argv) is the launcher's own. The
tolerance is the float32 contract rtol 2e-5 / atol 1e-5
(``tests/test_fused_sgd.py:76``) on the records both keep: the evaluated
train and test loss and accuracy of the round's globals."""

import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fedavg as jax_fedavg
from fedml_tpu.experiments import fed_launch as jax_launch
from fedml_tpu_torch.algorithms import fedavg
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.experiments import fed_launch, main_fedavg
from fedml_tpu_torch.utils.convert import flax_to_torch

CONFIG_DIR = (pathlib.Path(__file__).resolve().parent.parent / "fedml_tpu" / "experiments"
              / "configs")
CONFIGS = sorted(CONFIG_DIR.glob("*.yaml")) + sorted((CONFIG_DIR / "baseline").glob("*.yaml"))
IDS = [p.name if p.parent == CONFIG_DIR else f"baseline/{p.name}" for p in CONFIGS]
RTOL, ATOL = 2e-5, 1e-5

# the module class the CLI's dataset-contextual dispatch builds
MODEL_CLASSES = {"lr": "LogisticRegression", "cnn": "CNN_DropOut", "cnn_cifar": "CNNCifar",
                 "har_cnn": "HAR_CNN", "resnet20": "ResNetCifar", "resnet56": "ResNetCifar",
                 "resnet18_gn": "ResNetImageNet", "vgg11": "VGG",
                 "purchasemlp": "ReferenceMLP", "texasmlp": "ReferenceMLP",
                 "rnn": "RNN_OriginalFedAvg"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side (the suite runs several
    workers on the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_repo_has_26_configs():
    assert len(CONFIGS) == 26
    assert len(list((CONFIG_DIR / "baseline").glob("*.yaml"))) == 20


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_load_yaml_matches_jax(path):
    """The same dict, scalar types included, and the same argv."""
    want = jax_launch._load_yaml(str(path))
    got = fed_launch._load_yaml(str(path))
    assert got == want
    assert [type(v) for v in got["args"].values()] == [type(v) for v in want["args"].values()]
    assert fed_launch.config_to_argv(got["args"]) == jax_launch.config_to_argv(want["args"])


def test_load_yaml_reads_json_without_pyyaml(tmp_path, monkeypatch):
    """Where PyYAML does not import, both launchers read the config as
    JSON."""
    cfg = tmp_path / "exp.yaml"
    cfg.write_text('{"algorithm": "fedavg", "args": {"dataset": "mnist", "lr": 0.1, '
                   '"mesh_shape": [1], "flag": true}}')
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert fed_launch._load_yaml(str(cfg)) == jax_launch._load_yaml(str(cfg)) == {
        "algorithm": "fedavg", "args": {"dataset": "mnist", "lr": 0.1, "mesh_shape": [1],
                                        "flag": True}}


def test_config_to_argv_matches_jax_on_bools_and_lists():
    args = {"a": True, "b": False, "mesh_shape": [2, 4], "lr": 0.1, "name": "x", "n": 3}
    assert fed_launch.config_to_argv(args) == jax_launch.config_to_argv(args) == [
        "--a", "--mesh_shape", "2", "4", "--lr", "0.1", "--name", "x", "--n", "3"]


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_every_config_resolves_through_the_port(path, tmp_path):
    """The launcher's argv parsed by the port's CLI and set up as ``main``
    does: the dataset loads (its surrogate), the dispatch builds the model
    the JAX CLI would at the dataset's class count, a one-sample forward
    runs, and the config validates on the CPU (``backend: shard_map``
    included: one device). ``privacy`` resolves to ``main_privacy`` and runs
    one round at 2 of 40 MNIST clients with its MI report.
    fedavg_femnist.yaml's 3400 clients are cut to 100 here (its surrogate
    is 5 GB of host memory; the chip run loads 340)."""
    overrides = ["--override", "device=cpu", "--override", f"run_dir={tmp_path}"]
    if path.name == "fedavg_femnist.yaml":
        overrides += ["--override", "client_num_in_total=100"]
    if path.name == "privacy_blockensemble.yaml":
        module, argv = fed_launch.resolve(["--config", str(path), *overrides])
        assert module == "fedml_tpu_torch.experiments.main_privacy"
        cut = ["--override", "comm_round=1", "--override", "client_num_in_total=40",
               "--override", "client_num_per_round=2"]
        hist, final = fed_launch.main(["--config", str(path), *overrides, *cut])
        assert len(hist) == 1 and {"Train/Loss", "Ensemble/Acc", "Branch3/Acc"} <= set(hist[0])
        assert {"MI/NN_attack_acc", "MI/NN_advantage"} <= set(final)
        assert all(np.isfinite(v) for v in [*hist[0].values(), *final.values()])
        return
    module, argv = fed_launch.resolve(["--config", str(path), *overrides])
    assert module == "fedml_tpu_torch.experiments.main_fedavg"
    args = main_fedavg.add_args(__import__("argparse").ArgumentParser()).parse_args(argv)
    cfg, ds, trainer = main_fedavg.setup_run(args)
    conf = jax_launch._load_yaml(str(path))["args"]
    assert ds.name == conf["dataset"] and ds.client_num == args.client_num_in_total
    name = conf["model"]
    if name == "cnn":
        name = {"har": "har_cnn", "har_subject": "har_cnn",
                "cifar10": "cnn_cifar"}.get(conf["dataset"], "cnn")
    assert type(trainer.module).__name__ == MODEL_CLASSES[name]
    assert type(trainer).__name__ == "ClassificationTrainer"
    assert cfg.backend == conf.get("backend", "vmap") and cfg.validate(device="cpu") is cfg
    variables = trainer.init(torch.Generator().manual_seed(0), "cpu")
    out, _ = trainer.apply(variables, torch.from_numpy(ds.train.x[0, :1]))
    assert out.shape == (1, ds.class_num) and torch.isfinite(out.float()).all()


def test_unported_algorithms_and_multihost_raise(tmp_path):
    """Every algorithm name of the JAX launcher is ported; a ``multihost:``
    block starts the process group (with ``fednas`` and ``fedseg`` as with
    ``fedavg``), and a peer that never comes up raises a RuntimeError
    naming the coordinator and this rank within the block's timeout; an
    unknown name exits."""
    import socket

    for algo in ("fedavg", "fednas", "fedseg"):
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        cfg = tmp_path / f"mh_{algo}.yaml"
        cfg.write_text(f"algorithm: {algo}\nargs:\n  dataset: mnist\nmultihost:\n"
                       f"  coordinator: \"localhost:{port}\"\n  num_processes: 2\n"
                       "  process_id: 0\n  timeout: 1\n")
        with pytest.raises(RuntimeError, match=f"coordinator=localhost:{port}.*process_id=0"):
            fed_launch.main(["--config", str(cfg)])
    cfg = tmp_path / "bad.yaml"
    cfg.write_text("algorithm: nope\n")
    with pytest.raises(SystemExit, match="unknown algorithm"):
        fed_launch.main(["--config", str(cfg)])
    assert set(fed_launch.ALGORITHMS) == {"fedavg", "fedopt", "fednova", "fedavg_robust",
                                          "privacy", "hierarchical", "decentralized", "base",
                                          "turboaggregate", "fedgkt", "split_nn", "vfl",
                                          "fednas", "fedseg"}
    assert set(fed_launch.ALGORITHMS) == set(jax_launch.ALGORITHMS)
    assert not hasattr(fed_launch, "UNPORTED_ALGORITHMS")


#: the split-learning family's launcher names, each at a CPU-sized run
SPLIT_FAMILY = {
    "fedgkt": {"dataset": "fmnist", "model": "cnn", "client_num_in_total": 2,
               "client_num_per_round": 2, "comm_round": 1, "batch_size": 16,
               "client_sample_cap": 16, "server_blocks": [1, 1, 1], "epochs_server": 1},
    "split_nn": {"dataset": "fmnist", "model": "cnn", "client_num_in_total": 2,
                 "client_num_per_round": 2, "comm_round": 1, "batch_size": 500,
                 "split_width": 4},
    "vfl": {"dataset": "lending_club", "model": "dense", "epochs": 1},
}


@pytest.mark.parametrize("name", sorted(SPLIT_FAMILY))
def test_split_family_runs_through_the_launcher(name, tmp_path):
    """``fedgkt``, ``split_nn`` and ``vfl`` each run once from a YAML on the
    CPU: finite results, one record a round (``vfl`` returns its final
    metrics)."""
    import math

    args = {**SPLIT_FAMILY[name], "device": "cpu", "run_dir": str(tmp_path / "run")}
    cfg = tmp_path / f"{name}.yaml"
    cfg.write_text(f"algorithm: {name}\nargs:\n" + "".join(
        f"  {k}: {list(v) if isinstance(v, list) else v}\n" for k, v in args.items()))
    module, _ = fed_launch.resolve(["--config", str(cfg)])
    assert module == f"fedml_tpu_torch.experiments.main_{name}"
    out = fed_launch.main(["--config", str(cfg)])
    records = [out] if name == "vfl" else out
    assert len(records) == 1
    assert all(math.isfinite(v) for r in records for k, v in r.items() if k != "round")


#: FedNAS and FedSeg at CPU-sized runs: a one-cell search over two of ten
#: CIFAR-10 surrogate clients; DeepLabV3+ at width 4 on the 16 px pascal_voc
#: surrogate
SEARCH_SEG = {
    "fednas": {"dataset": "cifar10", "partition_method": "homo", "client_num_in_total": 10,
               "client_num_per_round": 2, "comm_round": 1, "batch_size": 64,
               "init_channels": 4, "layers": 1, "steps": 1, "multiplier": 1},
    "fedseg": {"client_num_in_total": 4, "comm_round": 1, "batch_size": 8,
               "image_size": 16, "model_width": 4},
}


@pytest.mark.parametrize("name", sorted(SEARCH_SEG))
def test_fednas_and_fedseg_run_through_the_launcher(name, tmp_path):
    """``fednas`` and ``fedseg`` each run once from a YAML on the CPU: one
    record, every number in it finite (FedSeg's evaluated)."""
    import math

    args = {**SEARCH_SEG[name], "device": "cpu", "run_dir": str(tmp_path / "run")}
    cfg = tmp_path / f"{name}.yaml"
    cfg.write_text(f"algorithm: {name}\nargs:\n" + "".join(
        f"  {k}: {v}\n" for k, v in args.items()))
    module, _ = fed_launch.resolve(["--config", str(cfg)])
    assert module == f"fedml_tpu_torch.experiments.main_{name}"
    records = fed_launch.main(["--config", str(cfg)])
    assert len(records) == 1
    assert all(math.isfinite(v) for k, v in records[0].items() if k != "round")
    if name == "fedseg":
        assert 0.0 <= records[0]["Test/mIoU"] <= 1.0


def test_shard_map_backend_rule():
    """Without a process group a shard_map round spans one rank, the vmap
    round, so it validates; a mesh_shape over more ranks than the group
    has raises, telling to launch one process a rank."""
    cfg = FedConfig(backend="shard_map")
    assert cfg.mesh_size("cpu") == 1 and cfg.validate(device="cpu") is cfg
    assert FedConfig(backend="shard_map", mesh_shape=(1,)).validate() is not None
    for bad in (FedConfig(backend="shard_map", mesh_shape=(2,)),
                FedConfig(backend="shard_map", mesh_shape=(1, 4))):
        with pytest.raises(ValueError, match="one process a rank"):
            bad.validate(device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        FedConfig(backend="pmap").validate()
    assert FedConfig.from_dict({"mesh_shape": [2, 2]}).mesh_shape == (2, 2)


@pytest.fixture
def same_start(monkeypatch):
    """Both packages' FedAvgAPI with ``shuffle`` and dropout off, the
    port's started from the JAX package's initial variables (see the
    module docstring)."""
    start = {}
    jax_init, port_init = jax_fedavg.FedAvgAPI.__init__, fedavg.FedAvgAPI.__init__

    def jax_wrapped(self, dataset, config, trainer, *args, **kwargs):
        if hasattr(trainer.module, "dropout"):
            trainer.module = trainer.module.clone(dropout=0.0)
        jax_init(self, dataset, config.replace(shuffle=False), trainer, *args, **kwargs)
        start["variables"] = jax.device_get(self.global_variables)

    def port_wrapped(self, dataset, config, trainer, *args, **kwargs):
        if hasattr(trainer.module, "dropout"):
            trainer.module.dropout = 0.0
        port_init(self, dataset, config.replace(shuffle=False), trainer, *args, **kwargs)
        self.global_variables = flax_to_torch(start["variables"], device=self.device,
                                              module=self.trainer.module)
        self.agg_state = self.aggregator.init_state(self.global_variables)

    monkeypatch.setattr(jax_fedavg.FedAvgAPI, "__init__", jax_wrapped)
    monkeypatch.setattr(fedavg.FedAvgAPI, "__init__", port_wrapped)
    return start


def _same_history(got, want):
    assert [h["round"] for h in got] == [h["round"] for h in want]
    for g, w in zip(got, want):
        keys = sorted(k for k in w if k in g and k != "round_time" and not k.startswith("time"))
        assert {"Train/Loss", "Train/Acc", "Test/Loss", "Test/Acc"} <= set(keys)
        for k in keys:
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=RTOL, atol=ATOL, err_msg=k)


def _launch_both(path, tmp_path, *overrides):
    flags = [a for o in ("comm_round=1", *overrides) for a in ("--override", o)]
    want = jax_launch.main(["--config", str(path), *flags,
                            "--override", f"run_dir={tmp_path / 'jax'}"])
    got = fed_launch.main(["--config", str(path), *flags, "--override", "device=cpu",
                           "--override", f"run_dir={tmp_path / 'port'}"])
    return got, want


@pytest.mark.parametrize("name", ["smoke.yaml", "baseline/purchase_homo.yaml"])
def test_main_gives_the_jax_history(name, tmp_path, same_start):
    got, want = _launch_both(CONFIG_DIR / name, tmp_path)
    assert len(got) == 1
    _same_history(got, want)


def test_shard_map_on_one_device_equals_vmap_and_jax(tmp_path, same_start):
    """smoke.yaml with ``backend=shard_map`` on a mesh of one device: the
    port's history equals its vmap run's bit for bit (it is the same round)
    and the JAX package's shard_map round on a one-device mesh of its
    8-device CPU platform within the contract."""
    path = CONFIG_DIR / "smoke.yaml"
    got, want = _launch_both(path, tmp_path, "backend=shard_map", "mesh_shape=1")
    _same_history(got, want)
    vmap = fed_launch.main(["--config", str(path), "--override", "comm_round=1",
                            "--override", "device=cpu", "--override",
                            f"run_dir={tmp_path / 'vmap'}"])
    for g, v in zip(got, vmap):
        assert {k: x for k, x in g.items() if k != "round_time"} == {
            k: x for k, x in v.items() if k != "round_time"}
