"""The port's drive (FedAvgAPI), data, sampling and CLI against the JAX
package, and the port's import and device rules."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import client_sampling as jax_client_sampling
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.data import sources as jax_sources
from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.models.cnn import CNN_DropOut as JaxCNN
from fedml_tpu_torch import (ClassificationTrainer, FedAvgAPI, FedConfig,
                             client_sampling, load_dataset)
from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import build_round_fn
from fedml_tpu_torch.data import sources
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.experiments import main_fedavg
from fedml_tpu_torch.models.cnn import CNN_DropOut
from fedml_tpu_torch.robustness.chaos import FaultPlan
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.utils.device import resolve_device

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("round_idx,total,per_round", [
    (0, 100, 10), (7, 3400, 10), (3, 10, 10), (12, 5, 8), (99, 1000, 1)])
def test_client_sampling_bitwise(round_idx, total, per_round):
    np.testing.assert_array_equal(client_sampling(round_idx, total, per_round),
                                  jax_client_sampling(round_idx, total, per_round))


def test_femnist_surrogate_byte_identical():
    got = sources.load_femnist_arrays("./no-such-dir", client_num=6, seed=3)
    want = jax_sources.load_femnist_arrays("./no-such-dir", client_num=6, seed=3)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) == 6
        for g, w in zip(g_list, w_list):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()


def _capped(ds, packed_cls, cap, test_cap):
    """bench.py::_capped: every client's train rows capped at ``cap``."""
    return dataclasses.replace(
        ds,
        train=packed_cls(np.ascontiguousarray(ds.train.x[:, :cap]),
                         np.ascontiguousarray(ds.train.y[:, :cap]),
                         np.minimum(ds.train.counts, cap)),
        test_global=(ds.test_global[0][:test_cap], ds.test_global[1][:test_cap]))


def test_fedavg_api_three_rounds_match_jax_drive():
    """A 3-round eager drive, engine path, dropout and shuffle off, the same
    flax-initialised weights: per-round train/test metrics and the final
    globals match the JAX drive."""
    kw = dict(dataset="femnist", model="cnn", client_num_in_total=5,
              client_num_per_round=2, batch_size=16, lr=0.1, epochs=1,
              comm_round=3, shuffle=False, seed=0)
    jds = _capped(jax_load_dataset("femnist", client_num_in_total=5, seed=0),
                  JaxPacked, 16, 32)
    tds = _capped(load_dataset("femnist", client_num_in_total=5, seed=0),
                  PackedClients, 16, 32)
    japi = JaxFedAvgAPI(jds, JaxConfig(**kw),
                        JaxTrainer(JaxCNN(output_dim=62, drop1=0.0, drop2=0.0)))
    tapi = FedAvgAPI(tds, FedConfig(**kw),
                     ClassificationTrainer(CNN_DropOut(output_dim=62, drop1=0.0,
                                                       drop2=0.0)),
                     device="cpu")
    tapi.global_variables = flax_to_torch(japi.global_variables)
    jhist, thist = japi.train(), tapi.train()
    assert len(jhist) == len(thist) == 3
    for jr, tr in zip(jhist, thist):
        for key in ("Train/Acc", "Train/Loss", "Test/Acc", "Test/Loss"):
            np.testing.assert_allclose(tr[key], jr[key], rtol=1e-4, atol=1e-5,
                                       err_msg=f"round {jr['round']} {key}")
    got = torch_to_flax(tapi.global_variables)["params"]
    for layer, leaves in japi.global_variables["params"].items():
        for kind, want in leaves.items():
            np.testing.assert_allclose(got[layer][kind], np.asarray(want),
                                       rtol=2e-5, atol=1e-5,
                                       err_msg=f"{layer}.{kind}")


def test_fedavg_api_fused_drive_trains_on_cpu():
    """The fused path through FedAvgAPI (plain version on the CPU): finite
    globals and train metrics in every round's record."""
    ds = _capped(load_dataset("femnist", client_num_in_total=4, seed=1),
                 PackedClients, 20, 32)
    cfg = FedConfig(dataset="femnist", model="cnn", client_num_in_total=4,
                    client_num_per_round=2, batch_size=20, lr=0.1,
                    comm_round=2, fused_kernel=True)
    api = FedAvgAPI(ds, cfg, ClassificationTrainer(CNN_DropOut(output_dim=62)),
                    device="cpu")
    hist = api.train()
    assert [h["round"] for h in hist] == [0, 1]
    assert all(h["total"] == 40.0 and np.isfinite(h["loss_sum"]) for h in hist)
    assert all(torch.isfinite(v).all() for v in api.global_variables.values())


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fedml_tpu")


def test_port_imports_no_jax_or_reference_package():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import fedml_tpu_torch, fedml_tpu_torch.ops.fused_sgd, "
        "fedml_tpu_torch.ops._build, fedml_tpu_torch.experiments.main_fedavg, "
        "fedml_tpu_torch.ops.attention, fedml_tpu_torch.models.transformer, "
        "fedml_tpu_torch.experiments.profile_nwp, fedml_tpu_torch.telemetry.records, "
        "fedml_tpu_torch.robustness.guard, fedml_tpu_torch.utils.checkpoint, "
        "fedml_tpu_torch.utils.logging, fedml_tpu_torch.data.prefetch\n"
        "new = [m for m in set(sys.modules) - before "
        f"if m.split('.')[0] in {_FORBIDDEN!r}]\n"
        "print(sorted(new)); sys.exit(1 if new else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_static_import_of_jax_or_reference_package():
    files = sorted((REPO / "fedml_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in _FORBIDDEN, f"{path}: imports {name}"


def test_cuda_without_a_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    ds = _capped(load_dataset("femnist", client_num_in_total=2, seed=0),
                 PackedClients, 20, 32)
    cfg = FedConfig(client_num_in_total=2, client_num_per_round=2,
                    batch_size=20, comm_round=1)
    trainer = ClassificationTrainer(CNN_DropOut(output_dim=62))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedAvgAPI(ds, cfg, trainer)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_round_fn(trainer, cfg, make_aggregator("fedavg", cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_fedavg.main(["--dataset", "femnist", "--model", "cnn",
                          "--client_num_in_total", "2", "--run_dir", str(tmp_path)])


def test_cli_runs_a_round_on_cpu(tmp_path):
    hist = main_fedavg.main([
        "--dataset", "femnist", "--model", "cnn", "--client_num_in_total", "3",
        "--client_num_per_round", "2", "--comm_round", "1", "--batch_size", "32",
        "--lr", "0.1", "--device", "cpu", "--run_dir", str(tmp_path)])
    assert len(hist) == 1 and np.isfinite(hist[0]["Test/Loss"])


def test_unported_drive_options_raise():
    """The drive's unported options raise NotImplementedError (the client
    ledger, the adapter bank, the superstep and buffered drives); the
    fused kernel under chaos and a negative pipeline depth raise
    ValueError."""
    ds = _capped(load_dataset("femnist", client_num_in_total=2, seed=0),
                 PackedClients, 20, 32)
    trainer = ClassificationTrainer(CNN_DropOut(output_dim=62))
    for kw in (dict(rounds_per_dispatch=2), dict(buffer_size=4)):
        with pytest.raises(NotImplementedError):
            FedAvgAPI(ds, FedConfig(**kw), trainer, device="cpu")
    api = FedAvgAPI(ds, FedConfig(client_num_in_total=2), trainer, device="cpu")
    for kw in (dict(ledger=object()), dict(bank=object())):
        with pytest.raises(NotImplementedError):
            api.train(**kw)
    with pytest.raises(ValueError, match="pipeline_depth"):
        FedAvgAPI(ds, FedConfig(pipeline_depth=-1), trainer, device="cpu")
    fused = FedAvgAPI(ds, FedConfig(client_num_in_total=2, batch_size=20, fused_kernel=True),
                      trainer, device="cpu")
    with pytest.raises(ValueError, match="no participation/quarantine stage"):
        fused.train(chaos=FaultPlan(seed=0, drop_rate=0.5))
