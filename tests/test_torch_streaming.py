"""The streaming image path in the port (``fedml_tpu_torch/data/streaming.py``,
the ILSVRC2012 and Google Landmarks loaders and their readers) against the
JAX package's, on tiny PNG and JPEG trees that the tests write from a seed:

- the readers' scans, ``load_image``, the eager readers and the csvs;
- ``StreamingPackedClients``: the decoded ``select`` rows, the LRU's
  resident sets and bytes over one select sequence under one budget, the
  over-budget error, ``materialize`` (and its refusal), decoding outside
  the lock;
- the loaders' file lists, labels, class-blocked and homo partitions,
  ``samples_per_client`` cap, ``*_global`` subsets and surrogates; the
  train/val class-mismatch error and the missing-image error;
- the drive on a streaming split: a 2-round run against the JAX drive
  (rtol 1e-4 on the records, 2e-5 / 1e-5 on the globals), the pipelined
  and the superstep loops equal to the eager one bit for bit, chunked eval
  inside the store's budget, the tracer's ``store_resident_bytes``, and the
  robust CLI's materialized split.

Everything the two packages decode goes through the same PIL build, so
every decoded array is compared bit for bit."""

import logging

import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxConfig
from fedml_tpu.core.trainer import ClassificationTrainer as JaxClassifier
from fedml_tpu.data import packed_store as jax_packed_store
from fedml_tpu.data import readers as jax_readers
from fedml_tpu.data import streaming as jax_streaming
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch import ClassificationTrainer, FedAvgAPI, FedConfig, create_model
from fedml_tpu_torch import load_dataset, telemetry
from fedml_tpu_torch.data import packed_store, readers, streaming
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.utils.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.utils.pytree import tree_leaves

SIZE = 8  # decoded side
CLASSES = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_image(path, rng, side=12):
    from PIL import Image

    Image.fromarray((rng.rand(side, side, 3) * 255).astype(np.uint8)).save(path)


def _imagenet_tree(root, train_per=4, val_per=2, extra_val_class=False):
    """<root>/{train,val}/<wnid>/*: JPEG train images, PNG val images."""
    rng = np.random.RandomState(0)
    for split, per, ext in (("train", train_per, ".JPEG"), ("val", val_per, ".png")):
        classes = CLASSES + (1 if split == "val" and extra_val_class else 0)
        for c in range(classes):
            d = root / split / f"n{c:08d}"
            d.mkdir(parents=True)
            for i in range(per):
                _write_image(d / f"img_{i}{ext}", rng)
    return str(root)


def _landmarks_tree(root, variant="gld23k", missing=None):
    """data_user_dict/<variant>_user_dict_{train,test}.csv and the images
    they name, at <root>/<image_id>.jpg or <root>/images/<image_id>.jpg;
    users out of order, 5 users, 7 classes. ``missing`` names an image
    left unwritten."""
    rng = np.random.RandomState(1)
    (root / "data_user_dict").mkdir(parents=True)
    (root / "images").mkdir()
    users = [(9, 3), (2, 1), (5, 4), (11, 2), (0, 5)]
    train, j = [], 0
    for uid, n in users:
        for _ in range(n):
            train.append((uid, f"im{j:03d}", int(rng.randint(0, 7))))
            j += 1
    test = [(0, f"te{i:02d}", int(rng.randint(0, 7))) for i in range(6)]
    for name, rows in (("train", train), ("test", test)):
        with open(root / "data_user_dict" / f"{variant}_user_dict_{name}.csv", "w") as f:
            f.write("user_id,image_id,class\n")
            for uid, image_id, cls in rows:
                f.write(f"{uid},{image_id},{cls}\n")
        for i, (_, image_id, _) in enumerate(rows):
            if image_id != missing:
                where = root / "images" if i % 3 == 0 else root
                _write_image(where / f"{image_id}.jpg", rng)
    return str(root)


def _same_arrays(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _same_store(got, want):
    assert got._files == want._files
    assert (got.n_max, got.byte_budget, got.sample_shape) == \
        (want.n_max, want.byte_budget, want.sample_shape)
    _same_arrays(got.y, want.y)
    _same_arrays(got.counts, want.counts)


def _same_dataset(got, want):
    assert (got.name, got.class_num, got.meta) == (want.name, want.class_num, want.meta)
    for split in ("train", "test"):
        g, w = getattr(got, split), getattr(want, split)
        if isinstance(w, jax_streaming.StreamingPackedClients):
            assert isinstance(g, streaming.StreamingPackedClients)
            _same_store(g, w)
        else:
            for leaf in ("x", "y", "counts"):
                _same_arrays(getattr(g, leaf), getattr(w, leaf))
    for split in ("train_global", "test_global"):
        for a, b in zip(getattr(got, split), getattr(want, split)):
            _same_arrays(a, b)


# ------------------------------------------------------------------ readers


def test_readers_match_jax(tmp_path):
    root = _imagenet_tree(tmp_path / "inet")
    lm = _landmarks_tree(tmp_path / "lm")
    got = readers.list_image_folder_files(f"{root}/train")
    assert got == jax_readers.list_image_folder_files(f"{root}/train")
    assert len(got[0]) == CLASSES and all(len(f) == 4 for f in got[0])
    for path in (got[0][0][0], f"{root}/val/n00000001/img_1.png"):
        for size in (None, SIZE, 16):
            _same_arrays(readers.load_image(path, size), jax_readers.load_image(path, size))
    for a, b in zip(readers.read_imagenet_folder(root, SIZE, cap_per_class=3),
                    jax_readers.read_imagenet_folder(root, SIZE, cap_per_class=3)):
        if isinstance(a, list):
            assert a == b
        else:
            _same_arrays(a, b)
    csv = f"{lm}/data_user_dict/gld23k_user_dict_train.csv"
    assert readers.read_landmarks_csv(csv) == jax_readers.read_landmarks_csv(csv)
    g, w = readers.read_landmarks(lm, "gld23k", SIZE), jax_readers.read_landmarks(lm, "gld23k",
                                                                                  SIZE)
    for a, b in zip(g[0] + g[1], w[0] + w[1]):
        _same_arrays(a, b)
    _same_arrays(g[2], w[2])
    _same_arrays(g[3], w[3])
    assert g[4] == w[4]
    g, w = readers.list_landmarks_files(lm, "gld23k"), jax_readers.list_landmarks_files(
        lm, "gld23k")
    assert g[0] == w[0] and g[2] == w[2] and g[4] == w[4]
    for a, b in zip(g[1] + [g[3]], w[1] + [w[3]]):
        _same_arrays(a, b)
    assert [len(f) for f in g[0]] == [5, 1, 4, 3, 2]  # users in ascending id order
    assert readers.list_landmarks_files(str(tmp_path), "gld23k") is None
    assert readers.list_image_folder_files(str(tmp_path / "lm" / "data_user_dict")) is None


def test_missing_image_error_matches_jax(tmp_path):
    """An image the csvs name is absent: the reader raises up front with
    the JAX message; the loader then warns and loads the surrogate, in
    both packages the same bytes."""
    lm = _landmarks_tree(tmp_path, missing="im004")
    with pytest.raises(FileNotFoundError) as got:
        readers.list_landmarks_files(lm, "gld23k")
    with pytest.raises(FileNotFoundError) as want:
        jax_readers.list_landmarks_files(lm, "gld23k")
    assert str(got.value) == str(want.value) and "im004" in str(got.value)
    kw = dict(data_dir=lm, client_num_in_total=4, image_size=SIZE)
    ds = load_dataset("gld23k", **kw)
    assert isinstance(ds.train, PackedClients) and ds.train.num_clients == 4
    _same_dataset(ds, jax_load_dataset("gld23k", **kw))


# ------------------------------------------------------------------ the store


def _stores(tmp_path, budget, clients=5, per_client=(3, 2, 3, 1, 3)):
    """The same files and budget behind a port and a JAX store."""
    rng = np.random.RandomState(2)
    files, labels = [], []
    for k in range(clients):
        fl = []
        for i in range(per_client[k]):
            p = tmp_path / f"c{k}_{i}.png"
            _write_image(p, rng)
            fl.append(str(p))
        files.append(fl)
        labels.append(np.arange(per_client[k], dtype=np.int32) + k)
    return (streaming.StreamingPackedClients(files, labels, streaming.make_image_decoder(SIZE),
                                             byte_budget=budget),
            jax_streaming.StreamingPackedClients(files, labels,
                                                 jax_streaming.make_image_decoder(SIZE),
                                                 byte_budget=budget))


def test_select_rows_and_lru_match_jax(tmp_path):
    """One select sequence under a budget of 2.5 client rows: the decoded
    rows, the resident clients (LRU order) and bytes after every select
    are the JAX store's; the budget holds after every select; evictions
    happen; the tracer reads the store's resident bytes."""
    row = 3 * SIZE * SIZE * 3 * 4
    got, want = _stores(tmp_path, budget=int(2.5 * row))
    assert got.x.shape == (5, 3, SIZE, SIZE, 3) and got.resident_clients() == []
    tracer = telemetry.Tracer()
    telemetry.install(tracer)
    evicted = False
    try:
        for idx in ([0, 1], [2], [1, 3], [0], [4, 2], [3, 4], [1]):
            before = set(got.resident_clients())
            g, w = got.select(idx), want.select(idx)
            for a, b in zip(g, w):
                _same_arrays(a, b)
            assert got.resident_clients() == want.resident_clients()
            assert got.resident_bytes == want.resident_bytes <= got.byte_budget
            assert set(idx) <= set(got.resident_clients())
            evicted |= bool(before - set(got.resident_clients()))
            last = tracer.gauge_summary()["store_resident_bytes"]["last"]
            assert last == {"store": "streaming", "bytes": got.resident_bytes}
    finally:
        telemetry.uninstall(tracer)
    assert evicted
    # the lazy facade: one client's row, a slice of two
    _same_arrays(got.x[3], want.x[3])
    _same_arrays(got.x[:2, 0], want.x[:2, 0])


def test_over_budget_round_raises_the_jax_error(tmp_path):
    got, want = _stores(tmp_path, budget=3 * SIZE * SIZE * 3 * 4 * 2)
    with pytest.raises(MemoryError) as g:
        got.select([0, 1, 2])
    with pytest.raises(MemoryError) as w:
        want.select([0, 1, 2])
    assert str(g.value) == str(w.value) and "FEDML_TPU_STREAM_BUDGET" in str(g.value)
    assert got.resident_clients() == []


def test_materialize_matches_jax_and_refuses_over_budget(tmp_path):
    got, want = _stores(tmp_path, budget=1 << 20)
    for mine, theirs in ((streaming.materialize(got), jax_streaming.materialize(want)),
                         (packed_store.materialize(got), jax_packed_store.materialize(want))):
        assert isinstance(mine, PackedClients)
        for leaf in ("x", "y", "counts"):
            _same_arrays(getattr(mine, leaf), getattr(theirs, leaf))
    small, small_jax = _stores(tmp_path / "..", budget=4 * 3 * SIZE * SIZE * 3 * 4)
    with pytest.raises(ValueError) as g:
        packed_store.materialize(small)
    with pytest.raises(ValueError) as w:
        jax_streaming.materialize(small_jax)
    assert str(g.value) == str(w.value)


def test_select_decodes_outside_the_lock():
    """Two threads selecting disjoint clients through a slow decoder
    overlap their decodes (the lock guards the cache's bookkeeping only),
    and the rows are right."""
    import threading
    import time

    gate = threading.Lock()
    live = {"now": 0, "max": 0}

    def dec(path):
        with gate:
            live["now"] += 1
            live["max"] = max(live["max"], live["now"])
        time.sleep(0.1)
        k, i = (int(s) for s in path.split("_")[1:])
        with gate:
            live["now"] -= 1
        return np.random.RandomState(k * 100 + i).rand(6).astype(np.float32)

    files = [[f"f_{k}_{i}" for i in range(2)] for k in range(8)]
    st = streaming.StreamingPackedClients(files, [np.arange(2) % 2] * 8, dec)
    out = {}
    threads = [threading.Thread(target=lambda n=n, i=i: out.update({n: st.select(i)}))
               for n, i in (("a", [0, 1, 2, 3]), ("b", [4, 5, 6, 7]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert live["max"] >= 2
    for name, idx in (("a", [0, 1, 2, 3]), ("b", [4, 5, 6, 7])):
        want = np.stack([np.stack([dec(f"f_{k}_{i}") for i in range(2)]) for k in idx])
        assert np.array_equal(out[name][0], want)


# ------------------------------------------------------------------ loaders


def test_imagenet_loader_matches_jax(tmp_path, monkeypatch, caplog):
    """Class blocks over 3 clients (2 classes each, 8 files) capped to
    samples_per_client=5 with a seeded subsample and a warning; the budget
    from FEDML_TPU_STREAM_BUDGET; homo test clients; seeded global
    subsets."""
    root = _imagenet_tree(tmp_path)
    monkeypatch.setenv("FEDML_TPU_STREAM_BUDGET", str(3 << 20))
    kw = dict(data_dir=root, client_num_in_total=3, image_size=SIZE, samples_per_client=5,
              global_cap=7, seed=3)
    with caplog.at_level(logging.WARNING):
        got = load_dataset("ILSVRC2012", **kw)
    assert "subsampled 3/3 clients to samples_per_client=5" in caplog.text
    _same_dataset(got, jax_load_dataset("ILSVRC2012", **kw))
    assert got.train.byte_budget == 3 << 20 and got.train.counts.tolist() == [5, 5, 5]
    assert sorted(set(got.train.y[1].tolist())) == [2, 3]
    assert len(got.train_global[1]) == len(got.test_global[1]) == 7
    # uncapped, with an explicit budget and a class cap
    kw = dict(data_dir=root, client_num_in_total=4, image_size=SIZE, samples_per_client=None,
              byte_budget=1 << 20, cap_per_class=3)
    got = load_dataset("ILSVRC2012", **kw)
    _same_dataset(got, jax_load_dataset("ILSVRC2012", **kw))
    assert got.train.counts.tolist() == [6, 6, 3, 3] and got.train.byte_budget == 1 << 20


def test_imagenet_class_mismatch_error_matches_jax(tmp_path):
    root = _imagenet_tree(tmp_path, extra_val_class=True)
    with pytest.raises(ValueError) as got:
        load_dataset("ILSVRC2012", data_dir=root, client_num_in_total=3, image_size=SIZE)
    with pytest.raises(ValueError) as want:
        jax_load_dataset("ILSVRC2012", data_dir=root, client_num_in_total=3, image_size=SIZE)
    assert str(got.value) == str(want.value) and "disagree" in str(got.value)


@pytest.mark.parametrize("variant", ["gld23k", "gld160k"])
def test_landmarks_loader_matches_jax(tmp_path, variant):
    lm = _landmarks_tree(tmp_path / "lm", variant)
    kw = dict(data_dir=lm, image_size=SIZE, global_cap=9, seed=1)
    got = load_dataset(variant, **kw)
    _same_dataset(got, jax_load_dataset(variant, **kw))
    assert got.train.num_clients == got.test.num_clients == 5
    assert got.train.byte_budget == 4 << 30 and got.class_num <= 7


@pytest.mark.parametrize("name,kw", [
    ("ILSVRC2012", dict(client_num_in_total=4, image_size=16)),
    ("gld23k", dict(client_num_in_total=3, image_size=SIZE)),
    ("gld160k", dict(client_num_in_total=2, image_size=4)),
])
def test_surrogates_match_jax(tmp_path, name, kw):
    got = load_dataset(name, data_dir=str(tmp_path), **kw)
    _same_dataset(got, jax_load_dataset(name, data_dir=str(tmp_path), **kw))
    assert isinstance(got.train, PackedClients)


# ------------------------------------------------------------------ the drive


def _api(ds, **kw):
    base = dict(client_num_in_total=3, client_num_per_round=2, batch_size=4, lr=0.1,
                comm_round=2, shuffle=False, seed=0, pipeline_depth=0)
    model = create_model("lr", output_dim=ds.class_num, input_shape=ds.train.x.shape[2:])
    return FedAvgAPI(ds, FedConfig(**{**base, **kw}), ClassificationTrainer(model),
                     device="cpu")


def _streaming_ds(root, budget=3 << 20):
    return load_dataset("ILSVRC2012", data_dir=root, client_num_in_total=3, image_size=SIZE,
                        samples_per_client=5, byte_budget=budget)


def test_streaming_drive_matches_jax(tmp_path):
    """2 eager rounds over the streaming split, the same initial weights:
    the records' evaluations and the globals match the JAX drive's."""
    root = _imagenet_tree(tmp_path)
    kw = dict(client_num_in_total=3, client_num_per_round=2, batch_size=4, lr=0.1,
              comm_round=2, shuffle=False, seed=0)
    jds = jax_load_dataset("ILSVRC2012", data_dir=root, client_num_in_total=3,
                           image_size=SIZE, samples_per_client=5, byte_budget=3 << 20)
    japi = JaxFedAvgAPI(jds, JaxConfig(**kw),
                        JaxClassifier(jax_create_model("lr", output_dim=CLASSES)))
    tapi = _api(_streaming_ds(root))
    tapi.global_variables = flax_to_torch(japi.global_variables)
    jhist, thist = japi.train(), tapi.train()
    for jr, tr in zip(jhist, thist):
        for key in ("Train/Acc", "Train/Loss", "Test/Acc", "Test/Loss"):
            np.testing.assert_allclose(tr[key], jr[key], rtol=1e-4, atol=1e-5,
                                       err_msg=f"round {jr['round']} {key}")
    got = torch_to_flax(tapi.global_variables)["params"]
    for layer, leaves in japi.global_variables["params"].items():
        for kind, want in leaves.items():
            np.testing.assert_allclose(got[layer][kind], np.asarray(want), rtol=2e-5,
                                       atol=1e-5, err_msg=f"{layer}.{kind}")


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def _evals(hist):
    return [{k: v for k, v in h.items() if k != "round_time"} for h in hist]


def test_pipelined_and_superstep_loops_equal_the_eager_one(tmp_path, caplog):
    """Over a streaming split whose budget holds 2 of the 3 client rows
    (one round's cohort), the pipelined loop (its stager thread selecting
    while the main thread evaluates) and the superstep loop (which falls
    back to the eager one, saying why) give the eager run's globals and
    records bit for bit. Eval runs chunked, one client a chunk, inside the
    budget, and the tracer records the store's resident bytes."""
    root = _imagenet_tree(tmp_path)
    row = 5 * SIZE * SIZE * 3 * 4
    runs = {}
    for name, kw in (("eager", {}), ("pipelined", dict(pipeline_depth=2)),
                     ("superstep", dict(rounds_per_dispatch=2, frequency_of_the_test=5,
                                        comm_round=3))):
        ds = _streaming_ds(root, budget=2 * row)
        api = _api(ds, **{"comm_round": 3, "frequency_of_the_test": 5, **kw})
        tracer = telemetry.Tracer()
        with caplog.at_level(logging.INFO):
            hist = api.train(tracer=tracer)
        assert ds.train.resident_bytes <= ds.train.byte_budget
        assert ds.test.resident_bytes <= ds.test.byte_budget
        gauges = tracer.gauge_summary()["store_resident_bytes"]
        assert gauges["last"]["store"] == "streaming" and gauges["count"] >= 3
        runs[name] = (api.global_variables, _evals(hist))
    assert "superstep (rounds_per_dispatch=2) unavailable: train store is streaming" in \
        caplog.text
    assert "eval of a streaming (lazy-decode) split: chunked, 2 clients a chunk" in caplog.text
    for name in ("pipelined", "superstep"):
        assert _bitwise(runs[name][0], runs["eager"][0]), name
        assert runs[name][1] == runs["eager"][1], name


def test_robust_cli_materializes_a_streaming_split(tmp_path):
    """``main_fedavg_robust`` poisons an attacker's rows: on a streaming
    split it decodes the split first, within the stream's budget."""
    from fedml_tpu_torch.experiments import main_fedavg_robust

    root = _imagenet_tree(tmp_path / "inet")
    hist = main_fedavg_robust.main([
        "--dataset", "ILSVRC2012", "--data_dir", root, "--model", "lr",
        "--client_num_in_total", "3", "--client_num_per_round", "2", "--comm_round", "1",
        "--batch_size", "4", "--attacker_num", "1", "--target_label", "1",
        "--device", "cpu", "--run_dir", str(tmp_path / "run")])
    assert len(hist) == 1 and np.isfinite(hist[0]["Train/Loss"])


def test_eval_chunks_fit_the_budget_where_the_jax_drive_raises(tmp_path):
    """A streaming split whose budget holds 2 of its 3 client rows: the JAX
    drive's chunked eval selects min(clients, 64) = 3 at once and raises
    ``MemoryError``; the port cuts its chunks to the budget and evaluates
    (a kept divergence, ROADMAP Queue 3)."""
    root = _imagenet_tree(tmp_path)
    budget = 2 * 5 * SIZE * SIZE * 3 * 4
    jds = jax_load_dataset("ILSVRC2012", data_dir=root, client_num_in_total=3,
                           image_size=SIZE, samples_per_client=5, byte_budget=budget)
    japi = JaxFedAvgAPI(jds, JaxConfig(client_num_in_total=3, client_num_per_round=2),
                        JaxClassifier(jax_create_model("lr", output_dim=CLASSES)))
    with pytest.raises(MemoryError, match="stream budget"):
        japi.local_test_on_all_clients(0)
    api = _api(_streaming_ds(root, budget=budget))
    metrics = api.local_test_on_all_clients(0)
    assert all(np.isfinite(v) for v in metrics.values())
    assert api.dataset.train.resident_bytes <= budget
