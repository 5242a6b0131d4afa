"""The port's backdoor tooling against the JAX package's, and the FedOpt,
FedNova and robust entry points run on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import backdoor as jax_backdoor
from fedml_tpu_torch.algorithms import backdoor
from fedml_tpu_torch.experiments import main_fedavg_robust, main_fednova, main_fedopt
from fedml_tpu_torch.utils.convert import flax_to_torch
from test_torch_engine import _setup


@pytest.mark.parametrize("shape,value", [((6, 12, 12, 1), None), ((4, 8, 8, 3), 2.5),
                                         ((5, 49), None)],
                         ids=["nhwc", "nhwc_value", "flat"])
def test_apply_trigger_matches_jax(shape, value):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    got = backdoor.apply_trigger(x, 3, value)
    np.testing.assert_array_equal(got, jax_backdoor.apply_trigger(x, 3, value))
    assert not np.array_equal(got, x)
    np.testing.assert_array_equal(x, np.random.RandomState(0).rand(*shape).astype(np.float32))


def test_apply_trigger_rejects_non_square_flat():
    with pytest.raises(ValueError, match="not a square image"):
        backdoor.apply_trigger(np.zeros((2, 10), np.float32))


@pytest.mark.parametrize("count,frac", [(20, 0.5), (20, 0.01)], ids=["half", "none"])
def test_poison_client_data_matches_jax(count, frac):
    rng = np.random.RandomState(1)
    x = rng.rand(30, 12, 12, 1).astype(np.float32)
    y = rng.randint(0, 5, size=30).astype(np.int32)
    got = backdoor.poison_client_data(x, y, count, 4, frac, 3, np.random.RandomState(9))
    want = jax_backdoor.poison_client_data(x, y, count, 4, frac, 3, np.random.RandomState(9))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_backdoor_metrics_match_jax():
    x, y, _, _, jt, tt, gv = _setup()
    xc, yc = x.reshape(-1, *x.shape[2:])[:40], y.reshape(-1)[:40]
    tv = flax_to_torch(gv)

    def jpredict(a):
        return jt.apply(gv, jnp.asarray(a), train=False)[0]

    def tpredict(a):
        return tt.apply(tv, torch.from_numpy(np.ascontiguousarray(a)))[0]

    want = jax_backdoor.backdoor_metrics(jpredict, xc, yc, target_label=2)
    got = backdoor.backdoor_metrics(tpredict, xc, yc, target_label=2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_load_edge_case_sets(tmp_path):
    """Absent: None (the pixel trigger); present: the southwest pickles,
    normalised by CIFAR-10's statistics, as the JAX package reads them
    (``test_torch_readers.py`` holds the other normalisations)."""
    import pickle

    assert backdoor.load_edge_case_sets(str(tmp_path)) is None
    base = tmp_path / "edge_case_examples" / "southwest_cifar10"
    base.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for name in ("southwest_images_new_train.pkl", "southwest_images_new_test.pkl"):
        with open(base / name, "wb") as f:
            pickle.dump(rng.randint(0, 255, (4, 32, 32, 3), dtype=np.uint8), f)
    got = backdoor.load_edge_case_sets(str(tmp_path))
    want = jax_backdoor.load_edge_case_sets(str(tmp_path))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2] == 9


ARGS = ["--dataset", "femnist", "--model", "cnn", "--client_num_in_total", "3",
        "--client_num_per_round", "2", "--comm_round", "2", "--batch_size", "32",
        "--lr", "0.1", "--device", "cpu"]


@pytest.mark.parametrize("main,extra", [
    (main_fedopt.main, ["--server_optimizer", "yogi", "--server_lr", "0.01"]),
    (main_fednova.main, ["--fedprox_mu", "0.01", "--momentum", "0.9", "--wd", "1e-4"]),
    (main_fedavg_robust.main, ["--attacker_num", "1", "--stddev", "0.01"]),
], ids=["fedopt", "fednova", "robust"])
def test_entry_point_runs_two_rounds_on_cpu(main, extra, tmp_path):
    hist = main(ARGS + extra + ["--run_dir", str(tmp_path)])
    assert [h["round"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["Test/Loss"]) and np.isfinite(h["loss_sum"]) for h in hist)
    if main is main_fedavg_robust.main:
        assert 0.0 <= hist[-1]["MainTask/Acc"] <= 1.0
        assert 0.0 <= hist[-1]["Backdoor/SuccessRate"] <= 1.0
        # the backdoor metrics reach wandb-summary.json, as in the JAX CLI
        summary = json.loads((tmp_path / "wandb-summary.json").read_text())
        assert summary["MainTask/Acc"] == hist[-1]["MainTask/Acc"]
        assert summary["Backdoor/SuccessRate"] == hist[-1]["Backdoor/SuccessRate"]


def test_entry_points_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (main_fedopt.main, main_fednova.main, main_fedavg_robust.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(ARGS[:-2] + ["--run_dir", str(tmp_path)])
