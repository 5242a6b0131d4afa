"""The port's data beyond FEMNIST and StackOverflow against the JAX
package's: the seeded surrogates byte for byte (MNIST, CIFAR-10/100,
fed_CIFAR-100, Shakespeare in both forms, FedProx synthetic), the partition
maps bit for bit (homo, hetero, p-hetero), whole loaders, and the plain
readers (IDX, the CIFAR pickles, LEAF json) on tiny files the tests
write."""

import gzip
import json
import pickle
import struct
import sys

import numpy as np
import torch
import pytest

from fedml_tpu.core import partition as jax_partition
from fedml_tpu.data import sources as jax_sources
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu_torch.core import partition
from fedml_tpu_torch.data import readers, sources
from fedml_tpu_torch.data.registry import load_dataset


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



def _same(got, want):
    """Equal dtype, shape and bytes, through nested lists and tuples."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("flatten", [False, True])
def test_mnist_surrogate_byte_identical(flatten):
    _same(sources.load_mnist_arrays("./no-such-dir", flatten=flatten, seed=2),
          jax_sources.load_mnist_arrays("./no-such-dir", flatten=flatten, seed=2))


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
def test_cifar_surrogate_byte_identical(name):
    _same(sources.load_cifar_arrays(name, "./no-such-dir", seed=1),
          jax_sources.load_cifar_arrays(name, "./no-such-dir", seed=1))


def test_fed_cifar100_surrogate_byte_identical():
    _same(sources.load_fed_cifar100_clients("./no-such-dir", client_num=4, seed=3),
          jax_sources.load_fed_cifar100_clients("./no-such-dir", client_num=4, seed=3))


@pytest.mark.parametrize("per_position", [False, True])
def test_shakespeare_surrogate_byte_identical(per_position):
    _same(sources.load_shakespeare_clients("./no-such-dir", 5, seed=4,
                                           per_position=per_position),
          jax_sources.load_shakespeare_clients("./no-such-dir", 5, seed=4,
                                               per_position=per_position))


def test_fedprox_synthetic_byte_identical():
    _same(sources.fedprox_synthetic(0.5, 0.5, client_num=5, seed=6),
          jax_sources.fedprox_synthetic(0.5, 0.5, client_num=5, seed=6))


def test_partition_maps_bitwise():
    labels = np.random.RandomState(0).randint(0, 10, size=600)
    cases = [
        ("homo_partition", (600, 7)),
        ("non_iid_partition_with_dirichlet_distribution", (labels, 8, 10, 0.5)),
        ("p_hetero_partition", (20, labels, 0.8)),
        ("p_hetero_partition", (6, labels, 0.8)),
    ]
    for name, args in cases:
        got = getattr(partition, name)(*args, rng=np.random.RandomState(9))
        want = getattr(jax_partition, name)(*args, rng=np.random.RandomState(9))
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
        assert (partition.record_net_data_stats(labels, got)
                == jax_partition.record_net_data_stats(labels, want))


@pytest.mark.parametrize("name,kw", [
    ("mnist", dict(partition_method="homo", client_num_in_total=6)),
    ("mnist", dict(partition_method="p-hetero", client_num_in_total=20, flatten=False)),
    ("cifar10", dict(partition_method="hetero", client_num_in_total=10, partition_alpha=0.5)),
    ("cifar100", dict(partition_method="homo", client_num_in_total=4)),
    ("fed_cifar100", dict(client_num_in_total=3)),
    ("synthetic", dict(client_num_in_total=4)),
    ("shakespeare", dict(client_num_in_total=4)),
    ("fed_shakespeare", dict(client_num_in_total=4)),
], ids=["mnist-homo", "mnist-p-hetero", "cifar10-hetero", "cifar100-homo", "fed_cifar100",
        "synthetic", "shakespeare", "fed_shakespeare"])
def test_loaders_match_jax(name, kw):
    """Whole datasets through ``load_dataset``: the packed client rows,
    counts, global splits, class count and task."""
    got = load_dataset(name, data_dir="./no-such-dir", seed=1, **kw)
    want = jax_load_dataset(name, data_dir="./no-such-dir", seed=1, **kw)
    for split in ("train", "test"):
        g, w = getattr(got, split), getattr(want, split)
        _same((g.x, g.y, g.counts), (w.x, w.y, w.counts))
    _same(got.train_global, want.train_global)
    _same(got.test_global, want.test_global)
    assert got.class_num == want.class_num
    assert got.meta.get("task") == want.meta.get("task")


def _write_idx(path, array, code):
    head = struct.pack(">HBB", 0, code, array.ndim) + struct.pack(
        ">" + "I" * array.ndim, *array.shape)
    data = head + array.astype(array.dtype.newbyteorder(">")).tobytes()
    with (gzip.open if path.suffix == ".gz" else open)(path, "wb") as f:
        f.write(data)


def test_idx_reader_matches_jax(tmp_path):
    """MNIST's four IDX files (train gzipped, test raw, under MNIST/raw):
    normalised images and labels as the JAX package reads them."""
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.RandomState(0)
    _write_idx(raw / "train-images-idx3-ubyte.gz",
               rng.randint(0, 256, (5, 28, 28)).astype(np.uint8), 8)
    _write_idx(raw / "train-labels-idx1-ubyte.gz", rng.randint(0, 10, 5).astype(np.uint8), 8)
    _write_idx(raw / "t10k-images-idx3-ubyte", rng.randint(0, 256, (3, 28, 28)).astype(np.uint8),
               8)
    _write_idx(raw / "t10k-labels-idx1-ubyte", rng.randint(0, 10, 3).astype(np.uint8), 8)
    got = sources.load_mnist_arrays(str(tmp_path))
    _same(got, jax_sources.load_mnist_arrays(str(tmp_path)))
    assert got[0].shape == (5, 28, 28, 1)
    ints = rng.randint(-5, 5, (2, 3)).astype(np.int32)
    _write_idx(tmp_path / "ints", ints, 12)
    _same(readers.read_idx(str(tmp_path / "ints")), ints.astype(">i4"))


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
def test_cifar_pickle_reader_matches_jax(tmp_path, name):
    rng = np.random.RandomState(1)

    def dump(path, n, label_key):
        with open(path, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                         label_key: list(rng.randint(0, 10, n))}, f)

    if name == "cifar10":
        base = tmp_path / "cifar-10-batches-py"
        base.mkdir()
        for i in range(1, 6):
            dump(base / f"data_batch_{i}", 2, b"labels")
        dump(base / "test_batch", 3, b"labels")
    else:
        base = tmp_path / "cifar-100-python"
        base.mkdir()
        dump(base / "train", 4, b"fine_labels")
        dump(base / "test", 3, b"fine_labels")
    got = sources.load_cifar_arrays(name, str(tmp_path))
    _same(got, jax_sources.load_cifar_arrays(name, str(tmp_path)))
    assert got[0].shape == ((10 if name == "cifar10" else 4), 32, 32, 3)


@pytest.mark.parametrize("per_position", [False, True])
def test_leaf_json_reader_matches_jax(tmp_path, per_position):
    """LEAF Shakespeare: two json files a split, a user with no test rows,
    characters outside the 80-letter table (mapped to id 89)."""
    rng = np.random.RandomState(2)
    letters = sources.ALL_LETTERS + "é~"

    def text(n):
        return "".join(letters[i] for i in rng.randint(0, len(letters), n))

    for split, users in (("train", ["a", "b", "c"]), ("test", ["a", "c"])):
        d = tmp_path / "shakespeare" / split
        d.mkdir(parents=True)
        for part, chunk in enumerate((users[:1], users[1:])):
            data = {u: {"x": [text(80) for _ in range(2 + i)], "y": [text(1) for _ in range(2 + i)]}
                    for i, u in enumerate(chunk)}
            (d / f"part{part}.json").write_text(json.dumps({"users": chunk, "user_data": data}))
    got = sources.load_shakespeare_clients(str(tmp_path), per_position=per_position)
    _same(got, jax_sources.load_shakespeare_clients(str(tmp_path), per_position=per_position))
    assert len(got[0]) == 3 and len(got[2][1]) == 0
    assert sources.letter_to_index("é") == 89 and sources.letter_to_index("a") == 53


def test_h5_files_present_raise(tmp_path, monkeypatch):
    """With the TFF h5 exports present and h5py unimportable, the loaders
    raise, naming h5py and the files, and never fall back to the surrogate
    (the JAX package's fallback there is a kept divergence; the readers
    themselves are held in ``test_torch_readers.py``)."""
    for stem in ("fed_cifar100_train", "fed_cifar100_test"):
        (tmp_path / f"{stem}.h5").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="fed_cifar100_train.h5.*h5py"):
        load_dataset("fed_cifar100", data_dir=str(tmp_path), client_num_in_total=2)


def test_unported_partition_and_dataset_raise():
    """A dataset the registry does not know raises NotImplementedError
    naming it; every loader of the JAX package's registry is ported
    (pascal_voc, the last: ``test_torch_fedseg.py``; hetero-fix and
    cinic10: ``test_torch_readers.py``; ILSVRC2012, gld23k, gld160k and
    stackoverflow_lr: ``test_torch_streaming.py``,
    ``test_torch_tag_prediction.py``); an unknown partition method is a
    ValueError."""
    import fedml_tpu.data.loaders  # noqa: F401  (registers the JAX loaders)
    import fedml_tpu_torch.data.loaders  # noqa: F401
    from fedml_tpu.data import registry as jax_registry
    from fedml_tpu_torch.data import registry

    assert set(jax_registry._LOADERS) <= set(registry._LOADERS)
    for name in ("no_such_dataset",):
        with pytest.raises(NotImplementedError, match=name):
            load_dataset(name)
    with pytest.raises(ValueError, match="unknown partition method"):
        load_dataset("cifar10", data_dir="./no-such-dir", partition_method="lda")
