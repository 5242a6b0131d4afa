"""The port's hierarchical FL (``algorithms/hierarchical.py``), centralized
trainer (``algorithms/centralized.py``) and base framework
(``algorithms/base_framework.py``) against the JAX package, their CI
oracles inside the port, and their mains through ``fed_launch``.

MNIST logistic regression (no dropout) on 12 homo clients at full batch
with shuffle off, both packages from the same flax-initialised weights:
the globals after 2 rounds within 1e-5. The default group assignment is
bitwise the JAX package's."""

import json

import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.base_framework import FedML_Base_simulated as jax_base_simulated
from fedml_tpu.algorithms.centralized import CentralizedTrainer as JaxCentralized
from fedml_tpu.algorithms.hierarchical import HierarchicalFLAPI as JaxHierarchical
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch import (CentralizedTrainer, ClassificationTrainer, FedAvgAPI,
                             FedConfig, FedML_Base_simulated, HierarchicalFLAPI,
                             create_model, load_dataset)
from fedml_tpu_torch.algorithms.base_framework import BaseCentralWorker
from fedml_tpu_torch.algorithms.engine import build_local_update
from fedml_tpu_torch.algorithms.hierarchical import default_group_assignment
from fedml_tpu_torch.experiments import fed_launch
from fedml_tpu_torch.utils.convert import flax_to_torch

# full batch, E = 1, no clip, shuffle off: the JAX oracles' configuration
KW = dict(dataset="mnist", model="lr", batch_size=-1, epochs=1, lr=0.05, comm_round=2,
          grad_clip=None, client_num_in_total=12, client_num_per_round=12, shuffle=False,
          seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mnist12():
    return load_dataset("mnist", client_num_in_total=12, partition_method="homo", seed=3)


@pytest.fixture(scope="module")
def jax_mnist12():
    return jax_load_dataset("mnist", client_num_in_total=12, partition_method="homo", seed=3)


def _module(ds):
    return create_model("lr", output_dim=10, input_shape=ds.train.x.shape[2:])


def _trainer(ds):
    return ClassificationTrainer(_module(ds))


def _jax_trainer():
    return JaxTrainer(jax_create_model("lr", output_dim=10))


def _close(got: dict, want: dict, atol: float):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("group_num,seed", [(2, 0), (3, 7), (5, 11)])
def test_default_group_assignment_is_bitwise_jax(mnist12, jax_mnist12, group_num, seed):
    japi = JaxHierarchical(jax_mnist12, JaxConfig(**{**KW, "seed": seed}), _jax_trainer(),
                           group_num=group_num)
    got = default_group_assignment(mnist12.client_num, group_num, seed)
    assert len(got) == len(japi.groups) == group_num
    for g, w in zip(got, japi.groups):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("group_num,group_comm_round", [(3, 2), (2, 1)])
def test_hierarchical_matches_jax(mnist12, jax_mnist12, group_num, group_comm_round):
    """2 global rounds of G groups x K inner rounds: the globals within
    1e-5 of the JAX package's, the metrics (the last inner round's, summed
    over clients and groups) within float32 noise."""
    japi = JaxHierarchical(jax_mnist12, JaxConfig(**KW), _jax_trainer(), group_num=group_num,
                           group_comm_round=group_comm_round)
    module = _module(mnist12)
    tapi = HierarchicalFLAPI(mnist12, FedConfig(**KW), ClassificationTrainer(module),
                             group_num=group_num, group_comm_round=group_comm_round,
                             device="cpu")
    tapi.global_variables = flax_to_torch(japi.global_variables, module=module)
    for r in range(2):
        jm, tm = japi.train_one_round(r), tapi.train_one_round(r)
        assert set(jm) == set(tm) and tm["total"] == jm["total"] == 6000.0
        np.testing.assert_allclose(tm["loss_sum"], jm["loss_sum"], rtol=1e-5)
        assert abs(tm["correct"] - jm["correct"]) <= 1.0
    _close(tapi.global_variables, flax_to_torch(japi.global_variables, module=module), 1e-5)
    je, te = japi.eval_global(), tapi.eval_global()
    for key in ("Test/Acc", "Test/Loss"):
        np.testing.assert_allclose(te[key], je[key], rtol=1e-5, atol=1e-5, err_msg=key)


def test_ragged_groups_match_jax(mnist12, jax_mnist12):
    """A ragged 3 + 2 split pads the second group with a zero-count client,
    a weight-0 no-op at both levels: the globals within 1e-5 of the JAX
    package's, and the padded counts sum to the real clients' rows."""
    groups = [np.arange(3), np.arange(3, 5)]
    japi = JaxHierarchical(jax_mnist12, JaxConfig(**KW), _jax_trainer(),
                           group_assignment=groups, group_comm_round=2)
    module = _module(mnist12)
    tapi = HierarchicalFLAPI(mnist12, FedConfig(**KW), ClassificationTrainer(module),
                             group_assignment=groups, group_comm_round=2, device="cpu")
    assert tapi._counts.shape == (2, 3) and int(tapi._counts[1, 2]) == 0
    assert int(tapi._counts.sum()) == int(mnist12.train.counts[:5].sum())
    tapi.global_variables = flax_to_torch(japi.global_variables, module=module)
    for r in range(2):
        japi.train_one_round(r)
        tapi.train_one_round(r)
    _close(tapi.global_variables, flax_to_torch(japi.global_variables, module=module), 1e-5)


def test_zero_count_client_takes_no_step(mnist12):
    """count 0 (a ragged group's padding): no step, the globals back bit for
    bit, zero steps and zero metric sums under the trainer's keys."""
    trainer = _trainer(mnist12)
    cfg = FedConfig(**{**KW, "batch_size": 16})
    gv = trainer.init(torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(mnist12.train.x[0])
    y = torch.from_numpy(mnist12.train.y[0])
    out = build_local_update(trainer, cfg)(gv, x, y, 0, torch.Generator().manual_seed(1))
    assert out.num_steps == 0
    assert all(torch.equal(out.variables[k], gv[k]) for k in gv)
    assert set(out.metrics) == {"loss_sum", "correct", "total"}
    assert all(float(v) == 0.0 for v in out.metrics.values())


def test_one_group_one_inner_round_is_the_fedavg_round(mnist12):
    """CI oracle (reference CI-script-fedavg.sh:52-62), strict form: 1 group
    and K = 1 is the port's FedAvg engine round, within 1e-5."""
    cfg = FedConfig(**KW)
    flat = FedAvgAPI(mnist12, cfg, _trainer(mnist12), device="cpu")
    hier = HierarchicalFLAPI(mnist12, cfg, _trainer(mnist12), group_num=1,
                             group_comm_round=1, group_assignment=[np.arange(12)],
                             device="cpu")
    hier.global_variables = dict(flat.global_variables)
    for r in range(2):
        flat.train_one_round(r)
        hier.train_one_round(r)
    _close(hier.global_variables, flat.global_variables, 1e-5)


def test_three_groups_equal_centralized(mnist12):
    """Full batch: 3 groups x 1 inner round == centralized GD (gradient
    linearity across the two averaging levels): Test/Acc and Test/Loss
    within 2e-3 after 3 rounds."""
    cfg = FedConfig(**{**KW, "comm_round": 3})
    hier = HierarchicalFLAPI(mnist12, cfg, _trainer(mnist12), group_num=3, device="cpu")
    cen = CentralizedTrainer(mnist12, cfg, _trainer(mnist12), device="cpu")
    cen.global_variables = dict(hier.global_variables)
    for r in range(3):
        hier.train_one_round(r)
    cen.train(3)
    h, c = hier.eval_global(), cen.eval_global()
    assert abs(h["Test/Acc"] - c["Test/Acc"]) < 2e-3
    assert abs(h["Test/Loss"] - c["Test/Loss"]) < 2e-3


def test_centralized_matches_jax(mnist12, jax_mnist12):
    """The union as one client, full batch, 2 rounds: the globals within
    1e-5 and each round's test metrics within float32 noise of the JAX
    package's."""
    japi = JaxCentralized(jax_mnist12, JaxConfig(**KW), _jax_trainer())
    module = _module(mnist12)
    tapi = CentralizedTrainer(mnist12, FedConfig(**KW), ClassificationTrainer(module),
                              device="cpu")
    assert tapi.count == len(mnist12.train_global[0]) == 6000
    tapi.global_variables = flax_to_torch(japi.global_variables, module=module)
    jhist, thist = japi.train(2), tapi.train(2)
    for jr, tr in zip(jhist, thist):
        for key in ("Test/Acc", "Test/Loss"):
            np.testing.assert_allclose(tr[key], jr[key], rtol=1e-5, atol=1e-5, err_msg=key)
    _close(tapi.global_variables, flax_to_torch(japi.global_variables, module=module), 1e-5)


def test_fused_kernel_flag_has_no_effect(mnist12):
    """Only engine.build_round_fn routes a round through the fused kernel;
    hierarchical and centralized runs with fused_kernel set are the same
    bits as without."""
    kw = {**KW, "batch_size": 100, "grad_clip": 1.0, "shuffle": True}
    runs = []
    for fused in (False, True):
        cfg = FedConfig(**kw, fused_kernel=fused)
        hier = HierarchicalFLAPI(mnist12, cfg, _trainer(mnist12), group_num=2, device="cpu")
        hier.train_one_round(0)
        cen = CentralizedTrainer(mnist12, cfg, _trainer(mnist12), device="cpu")
        cen.train_one_round(0)
        runs.append((hier.global_variables, cen.global_variables))
    for a, b in zip(*runs):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_shard_map_on_one_device_is_the_vmap_round(mnist12):
    """backend='shard_map' on one device is the vmap round bit for bit; a
    mesh over more devices raises, naming ROADMAP's multi-device item."""
    runs = []
    for backend in ("vmap", "shard_map"):
        api = HierarchicalFLAPI(mnist12, FedConfig(**KW, backend=backend), _trainer(mnist12),
                                group_num=3, group_comm_round=2, device="cpu")
        api.train_one_round(0)
        runs.append(api.global_variables)
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    for api_cls, extra in ((HierarchicalFLAPI, {"group_num": 2}), (CentralizedTrainer, {})):
        with pytest.raises(NotImplementedError, match="item 5"):
            api_cls(mnist12, FedConfig(**KW, backend="shard_map", mesh_shape=(2,)),
                    _trainer(mnist12), device="cpu", **extra)


def test_empty_group_is_refused(mnist12):
    with pytest.raises(ValueError, match="at least one client"):
        HierarchicalFLAPI(mnist12, FedConfig(**KW), _trainer(mnist12),
                          group_assignment=[np.arange(3), np.array([], np.int64)],
                          device="cpu")


@pytest.mark.parametrize("client_num,comm_round", [(4, 3), (4, 2), (7, 1)])
def test_base_framework_matches_jax(client_num, comm_round):
    def value(i, r):
        return float(i + r) * 0.5 + 0.1

    assert FedML_Base_simulated(client_num, value, comm_round, device="cpu") == (
        jax_base_simulated(client_num, value, comm_round))


def test_base_central_worker():
    worker = BaseCentralWorker(3)
    for i in range(3):
        assert not worker.check_whether_all_receive()
        worker.add_client_local_result(i, i + 0.5)
    assert worker.check_whether_all_receive()
    assert worker.aggregate() == 4.5 and not worker.check_whether_all_receive()


def _launch(tmp_path, algorithm: str, args: dict):
    cfg = tmp_path / f"{algorithm}.yaml"
    lines = [f"algorithm: {algorithm}", "args:"] + [f"  {k}: {v}" for k, v in args.items()]
    cfg.write_text("\n".join(lines) + "\n")
    return fed_launch.main(["--config", str(cfg), "--override", "device=cpu"])


def test_main_base_through_fed_launch(tmp_path):
    assert _launch(tmp_path, "base", {}) == [6.0, 10.0, 14.0]
    assert _launch(tmp_path, "base", {"client_num": 4, "comm_round": 2}) == [6.0, 10.0]


def test_main_hierarchical_through_fed_launch(tmp_path):
    run = tmp_path / "run"
    hist = _launch(tmp_path, "hierarchical", {
        "dataset": "mnist", "model": "lr", "partition_method": "homo",
        "client_num_in_total": 4, "client_num_per_round": 4, "comm_round": 2,
        "batch_size": 16, "lr": 0.1, "group_num": 2, "group_comm_round": 2,
        "run_dir": str(run)})
    assert [h["round"] for h in hist] == [0, 1]
    summary = json.loads((run / "wandb-summary.json").read_text())
    assert 0.0 <= summary["Test/Acc"] <= 1.0 and np.isfinite(summary["Test/Loss"])
    assert summary["total"] == 6000.0  # the surrogate's 6,000 train rows
