"""The resident federation eval (``FedAvgAPI._resident_eval_data`` and
``engine.build_federation_eval_fn``) and the registry API of the port,
against the port's chunked eval and the JAX package:

- resident sums equal the chunked path's, over several chunks with a
  padded last one, and the JAX drive's ``local_test_on_all_clients`` at
  2e-5 / 1e-5; the splits are staged once a run, not once an eval;
- each fallback to the chunked path, with its log line: CI mode, a
  streaming split, a split over ``resident_eval_budget``; an in-budget mmap
  store is read once through ``materialize``;
- ``FedConfig`` maps the JAX config's ``resident_eval`` keys to fields;
- ``available_models()`` and ``available_datasets()`` equal the JAX
  package's lists."""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxTrainer
from fedml_tpu.data.packing import PackedClients as JaxPacked
from fedml_tpu.data.registry import available_datasets as jax_available_datasets
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.models.cnn import CNN_DropOut as JaxCNN
from fedml_tpu.models.registry import available_models as jax_available_models
from fedml_tpu_torch import ClassificationTrainer, FedAvgAPI, FedConfig, load_dataset
from fedml_tpu_torch.algorithms import fedavg
from fedml_tpu_torch.data import packed_store
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.data.registry import FederatedDataset, available_datasets
from fedml_tpu_torch.data.streaming import StreamingPackedClients
from fedml_tpu_torch.models.cnn import CNN_DropOut
from fedml_tpu_torch.models.registry import available_models, create_model
from fedml_tpu_torch.utils.convert import flax_to_torch

KEYS = ("Train/Acc", "Train/Loss", "Test/Acc", "Test/Loss")
KW = dict(dataset="femnist", model="cnn", client_num_in_total=9, client_num_per_round=3,
          batch_size=8, lr=0.1, epochs=1, comm_round=1, shuffle=False, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def small_chunks(monkeypatch):
    """40 rows a forward pass: the splits' 9 clients of 12 (train) and 4
    (test) rows make several chunks, the last one padded."""
    monkeypatch.setattr(fedavg, "_EVAL_ROWS", 40)


def _capped(ds, packed_cls, cap=12, test_cap=4):
    return dataclasses.replace(
        ds,
        train=packed_cls(np.ascontiguousarray(ds.train.x[:, :cap]),
                         np.ascontiguousarray(ds.train.y[:, :cap]),
                         np.minimum(ds.train.counts, cap)),
        test=packed_cls(np.ascontiguousarray(ds.test.x[:, :test_cap]),
                        np.ascontiguousarray(ds.test.y[:, :test_cap]),
                        np.minimum(ds.test.counts, test_cap)),
        test_global=(ds.test_global[0][:16], ds.test_global[1][:16]))


def _api(ds=None, **kw):
    ds = ds if ds is not None else _capped(load_dataset("femnist", client_num_in_total=9,
                                                        seed=0), PackedClients)
    return FedAvgAPI(ds, FedConfig(**{**KW, **kw}),
                     ClassificationTrainer(CNN_DropOut(output_dim=62, drop1=0.0, drop2=0.0)),
                     device="cpu")


def _count_staging(monkeypatch, api) -> list:
    calls = []
    stage = api._stage_split

    def counted(packed, k):
        calls.append(k)
        return stage(packed, k)

    monkeypatch.setattr(api, "_stage_split", counted)
    return calls


def test_resident_equals_chunked_and_stages_once_a_run(small_chunks, monkeypatch):
    resident, chunked = _api(), _api(resident_eval=False)
    chunked.global_variables = resident.global_variables
    calls = _count_staging(monkeypatch, resident)
    got = resident.local_test_on_all_clients(0)
    assert calls == [3, 9]  # train: 3 clients a chunk (3 chunks); test: 9 (1 chunk)
    xs, _, counts = resident._resident_cache["Train"]
    assert xs.shape[:2] == (3, 3 * 12) and counts.shape == (3, 3)
    want = chunked.local_test_on_all_clients(0)
    assert chunked._resident_cache is None
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=2e-5, atol=1e-5, err_msg=key)
    # a second eval after a round: only the globals changed, nothing is staged
    resident.train_one_round(0)
    chunked.global_variables = resident.global_variables
    got, want = resident.local_test_on_all_clients(1), chunked.local_test_on_all_clients(1)
    assert len(calls) == 2
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=2e-5, atol=1e-5, err_msg=key)
    assert resident.resident_eval_bytes > 0


def test_resident_eval_matches_the_jax_drive(small_chunks):
    jds = _capped(jax_load_dataset("femnist", client_num_in_total=9, seed=0), JaxPacked)
    japi = JaxFedAvgAPI(jds, JaxConfig(**KW),
                        JaxTrainer(JaxCNN(output_dim=62, drop1=0.0, drop2=0.0)))
    api = _api()
    api.global_variables = flax_to_torch(japi.global_variables)
    want, got = japi.local_test_on_all_clients(0), api.local_test_on_all_clients(0)
    assert api._resident_cache  # the resident path ran
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=2e-5, atol=1e-5, err_msg=key)


def test_ci_mode_evaluates_one_client_chunked(monkeypatch):
    api = _api(ci=1)
    calls = _count_staging(monkeypatch, api)
    got = api.local_test_on_all_clients(0)
    assert calls == [] and api._resident_cache is None
    want = _api(ci=1, resident_eval=False)
    want.global_variables = api.global_variables
    assert got == want.local_test_on_all_clients(0)


def test_over_budget_splits_fall_back_with_a_warning(small_chunks, monkeypatch, caplog):
    api = _api(resident_eval_budget=1024)
    calls = _count_staging(monkeypatch, api)
    with caplog.at_level(logging.WARNING, logger="fedml_tpu_torch.algorithms.fedavg"):
        got = api.local_test_on_all_clients(0)
        api.local_test_on_all_clients(0)
    assert "resident_eval disabled: packed splits are" in caplog.text
    assert caplog.text.count("resident_eval disabled") == 1  # decided once a run
    assert calls == [] and api._resident_cache == {}
    want = _api(resident_eval=False)
    want.global_variables = api.global_variables
    assert got == want.local_test_on_all_clients(0)


def _streaming_ds():
    rng = np.random.RandomState(0)
    pixels = {f"c{c}_{i}": rng.rand(28, 28, 1).astype(np.float32)
              for c in range(4) for i in range(3 + c)}
    files = [[f"c{c}_{i}" for i in range(3 + c)] for c in range(4)]
    labels = [rng.randint(0, 62, size=len(f)) for f in files]
    train = StreamingPackedClients(files, labels, pixels.__getitem__, byte_budget=1 << 20)
    return FederatedDataset(name="stream", train=train, test=None,
                            train_global=(np.zeros((0, 28, 28, 1), np.float32),
                                          np.zeros(0, np.int32)),
                            test_global=(np.stack(list(pixels.values()))[:8],
                                         np.zeros(8, np.int32)), class_num=62)


def test_streaming_split_falls_back_with_its_log_line(monkeypatch, caplog):
    api = _api(_streaming_ds(), client_num_in_total=4)
    calls = _count_staging(monkeypatch, api)
    with caplog.at_level(logging.INFO, logger="fedml_tpu_torch.algorithms.fedavg"):
        got = api.local_test_on_all_clients(0)
    assert "resident_eval disabled: streaming (lazy-decode) split" in caplog.text
    assert calls == [] and api._resident_cache == {}
    want = _api(_streaming_ds(), client_num_in_total=4, resident_eval=False)
    want.global_variables = api.global_variables
    assert got == want.local_test_on_all_clients(0)


def test_mmap_store_is_materialized_once(small_chunks, monkeypatch, tmp_path):
    ds = _capped(load_dataset("femnist", client_num_in_total=9, seed=0), PackedClients)
    mm = dataclasses.replace(
        ds, train=packed_store.MmapPackedStore(
            packed_store.write_packed_shards(str(tmp_path / "train"), ds.train,
                                             clients_per_shard=4)),
        test=packed_store.MmapPackedStore(
            packed_store.write_packed_shards(str(tmp_path / "test"), ds.test)))
    reads = []

    def counted(store, budget):
        reads.append(budget)
        return packed_store.materialize(store, budget=budget)

    monkeypatch.setattr(fedavg, "materialize", counted)
    api, ram = _api(mm), _api(ds)
    ram.global_variables = api.global_variables
    got = api.local_test_on_all_clients(0)
    api.local_test_on_all_clients(0)
    assert reads == [8 << 30, 8 << 30]  # each split once, under the budget
    assert got == ram.local_test_on_all_clients(0)


def test_config_maps_the_resident_eval_keys():
    cfg = FedConfig.from_dict({"resident_eval": False, "resident_eval_budget": 123,
                               "other": 1})
    assert (cfg.resident_eval, cfg.resident_eval_budget) == (False, 123)
    assert cfg.extra == {"other": 1}
    jax_cfg = JaxConfig()
    assert (FedConfig().resident_eval, FedConfig().resident_eval_budget) == (
        jax_cfg.resident_eval, jax_cfg.resident_eval_budget)


def test_registries_list_the_jax_packages_names():
    assert available_models() == jax_available_models()
    assert available_datasets() == jax_available_datasets()
    with pytest.raises(NotImplementedError, match="nope"):
        create_model("nope", output_dim=2)
