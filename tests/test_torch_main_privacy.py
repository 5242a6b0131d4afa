"""``experiments/main_privacy.py`` against the JAX package's main on the
CPU, and the launcher's ``privacy`` route.

Both mains run their whole path (flags, API, metrics logger, MI report)
for one round of 4 clients, each loading the same small federation (12x12
images, 10 classes, 4 clients of up to 20 rows) in place of MNIST, so the
check stays CPU-cheap. Their random streams differ (flax's and
PyTorch's), so the metric names are held equal and the values finite."""

import argparse
import json
import pathlib

import numpy as np
import pytest
import torch

from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.data.registry import FederatedDataset as JaxDataset
from fedml_tpu.experiments import main_privacy as jax_main
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.data.registry import FederatedDataset
from fedml_tpu_torch.experiments import fed_launch, main_privacy

HW, CLASSES, BATCH = 12, 10, 8
CONFIG = (pathlib.Path(__file__).resolve().parent.parent / "fedml_tpu" / "experiments"
          / "configs" / "privacy_blockensemble.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _datasets(clients=4, n_max=20, test_rows=40, seed=0):
    """The same federated arrays in both packages' dataset types."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(clients, n_max, HW, HW, 1)).astype(np.float32)
    y = rng.randint(0, CLASSES, size=(clients, n_max)).astype(np.int32)
    counts = np.array([n_max, 11, 5, n_max][:clients], np.int32)
    xt = rng.normal(size=(test_rows, HW, HW, 1)).astype(np.float32)
    yt = rng.randint(0, CLASSES, size=test_rows).astype(np.int32)
    rows = np.concatenate([x[c, :counts[c]] for c in range(clients)])
    labels = np.concatenate([y[c, :counts[c]] for c in range(clients)])
    args = dict(name="mnist", test=None, train_global=(rows, labels), test_global=(xt, yt),
                class_num=CLASSES)
    return (JaxDataset(train=JaxPacked(x, y, counts), **args),
            FederatedDataset(train=PackedClients(x, y, counts), **args))


@pytest.mark.parametrize("method", ["blockensemble", "predweight"])
def test_main_privacy_gives_the_jax_metric_names(method, tmp_path, monkeypatch):
    """One round of 4 clients through both mains, each loading the same
    small 12x12 federation in place of MNIST (the CLI's path otherwise:
    flags, API, metrics logger, MI report): the same history and final
    metric names, among them blockensemble's NN attack and predweight's
    five attacks, finite values, and the run directory's summary."""
    jds, tds = _datasets()
    monkeypatch.setattr("fedml_tpu.data.registry.load_dataset", lambda *a, **k: jds)
    monkeypatch.setattr(main_privacy, "load_dataset", lambda *a, **k: tds)
    argv = ["--dataset", "mnist", "--partition_method", "homo",
            "--client_num_in_total", "4", "--client_num_per_round", "4",
            "--comm_round", "1", "--epochs", "1", "--batch_size", str(BATCH), "--lr", "0.1",
            "--branch_num", "2", "--ensemble_method", method]
    jhist, jfinal = jax_main.main(argv + ["--run_dir", str(tmp_path / "jax")])
    thist, tfinal = main_privacy.main(argv + ["--run_dir", str(tmp_path / "port"),
                                              "--device", "cpu"])
    assert [set(h) for h in thist] == [set(h) for h in jhist]
    assert set(tfinal) == set(jfinal)
    attacks = {k.split("_")[0] for k in tfinal if k.startswith("MI/")}
    assert attacks == ({"MI/NN"} if method == "blockensemble" else
                       {"MI/NN", "MI/Loss", "MI/GradNorm", "MI/GradVec", "MI/MixGrad"})
    assert all(np.isfinite(v) for h in thist for v in h.values())
    assert all(np.isfinite(v) for v in tfinal.values())
    summary = json.loads((tmp_path / "port" / "wandb-summary.json").read_text())
    assert set(tfinal) <= set(summary)


def test_launcher_resolves_privacy_to_main_privacy():
    module, argv = fed_launch.resolve(["--config", str(CONFIG), "--override", "device=cpu"])
    assert module == "fedml_tpu_torch.experiments.main_privacy"
    args = main_privacy.add_privacy_args(main_privacy.add_args(
        argparse.ArgumentParser())).parse_args(argv)
    assert (args.ensemble_method, args.branch_num, args.num_paths, args.comm_round) == (
        "blockensemble", 4, 2, 50)


@pytest.mark.parametrize("flags", [
    ["--ensemble_method", "predavg"], ["--ensemble_method", "predvote"],
    ["--ensemble_method", "blockavg"], ["--ensemble_method", "hetero", "--branch_num", "4"],
    ["--ensemble_method", "blockensemble", "--branch_num", "3", "--num_paths", "3",
     "--feat_lmda", "0.5"]], ids=["predavg", "predvote", "blockavg", "hetero", "three_paths"])
def test_main_privacy_runs_every_method(flags, tmp_path, monkeypatch):
    """The port's main alone for the other methods: two rounds, finite
    metrics, the ensemble and every branch evaluated; blockavg's shared
    blocks equal across branches."""
    _, tds = _datasets()
    monkeypatch.setattr(main_privacy, "load_dataset", lambda *a, **k: tds)
    hist, final = main_privacy.main([
        "--client_num_in_total", "4", "--client_num_per_round", "4", "--comm_round", "2",
        "--batch_size", str(BATCH), "--lr", "0.1", "--branch_num", "2", "--no_mi_attack",
        "--device", "cpu", "--run_dir", str(tmp_path), *flags])
    branches = int(flags[flags.index("--branch_num") + 1]) if "--branch_num" in flags else 2
    assert [h["round"] for h in hist] == [0, 1]
    assert {"Ensemble/Acc", *(f"Branch{b}/Acc" for b in range(branches))} <= set(final)
    assert all(np.isfinite(v) for h in hist for v in h.values())

