"""The port's on-disk readers and the loaders over them against the JAX
package's: tiny files in the reference's formats, written by each test
(gz IDX, HAR's Inertial Signals txt, the UCIAdult npy quartet,
purchase/texas pickles, a net_dataidx_map.txt, the southwest pickles, a PNG
ImageFolder, LEAF json and the TFF h5 exports of FEMNIST, fed_CIFAR-100
and StackOverflow), go through both packages' ``load_dataset``; the packed
x, y and counts of train and test and the global arrays must be equal bit
for bit, and no surrogate warning may fire. Each loader on its seeded
surrogate, bit for bit too. Where h5 files exist and ``h5py`` cannot
import, the JAX package trains on the surrogate; the port must raise."""

import gzip
import json
import logging
import pickle
import struct
import sys

import numpy as np
import pytest

from fedml_tpu.algorithms import backdoor as jax_backdoor
from fedml_tpu.data import readers as jax_readers
from fedml_tpu.data.registry import load_dataset as jax_load_dataset
from fedml_tpu_torch.algorithms import backdoor
from fedml_tpu_torch.data import readers
from fedml_tpu_torch.data.registry import load_dataset


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


def _same_dataset(got, want):
    assert (got.name, got.class_num, got.meta) == (want.name, want.class_num, want.meta)
    for split in ("train", "test"):
        g, w = getattr(got, split), getattr(want, split)
        _same((g.x, g.y, g.counts), (w.x, w.y, w.counts))
    _same(got.train_global, want.train_global)
    _same(got.test_global, want.test_global)


@pytest.fixture
def no_surrogate(caplog):
    """Fails the test if either package logged a surrogate fallback."""
    caplog.set_level(logging.WARNING)
    yield
    said = [r.getMessage() for r in caplog.records]
    assert not [m for m in said if "surrogate" in m or "not found" in m], said


def _write_idx(path, arr, gz=True):
    header = struct.pack(">HBB", 0, 8, arr.ndim)
    header += struct.pack(">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


def _emnist(root, rng):
    raw = root / "EMNIST" / "raw"
    raw.mkdir(parents=True)
    for split, n in (("train", 40), ("test", 12)):
        _write_idx(raw / f"emnist-balanced-{split}-images-idx3-ubyte.gz",
                   rng.randint(0, 255, (n, 28, 28)))
        _write_idx(raw / f"emnist-balanced-{split}-labels-idx1-ubyte.gz",
                   rng.randint(0, 47, (n,)))
    return "emnist", {"client_num_in_total": 4, "partition_method": "p-hetero",
                      "partition_alpha": 1.0}


def _fmnist(root, rng):
    d = root / "fmnist"
    d.mkdir()
    for stem, n in (("train", 30), ("t10k", 10)):  # raw IDX, not gzipped
        _write_idx(d / f"{stem}-images-idx3-ubyte", rng.randint(0, 255, (n, 28, 28)), gz=False)
        _write_idx(d / f"{stem}-labels-idx1-ubyte", rng.randint(0, 10, (n,)), gz=False)
    return "fmnist", {"client_num_in_total": 3}


def _cinic10(root, rng):
    from PIL import Image

    for split, per in (("train", 3), ("test", 1)):
        for c in range(10):
            d = root / "cinic10" / split / f"class{c}"
            d.mkdir(parents=True)
            for i in range(per):
                size = 32 if i else 36  # one image resized to 32x32
                Image.fromarray(rng.randint(0, 255, (size, size, 3), dtype=np.uint8)).save(
                    d / f"im{i}.png")
    return "cinic10", {"client_num_in_total": 3, "partition_method": "homo"}


def _har_files(root, rng, subjects=False):
    base = root / "UCI HAR Dataset"
    for group, n in (("train", 12), ("test", 6)):
        sig = base / group / "Inertial Signals"
        sig.mkdir(parents=True)
        for s in jax_readers._HAR_SIGNALS:
            np.savetxt(sig / f"{s}_{group}.txt", rng.randn(n, 128))
        np.savetxt(base / group / f"y_{group}.txt", rng.randint(1, 7, n), fmt="%d")
        if subjects:
            ids = (1, 3, 5) if group == "train" else (2, 9)
            np.savetxt(base / group / f"subject_{group}.txt", rng.choice(ids, n), fmt="%d")


def _har(root, rng):
    _har_files(root, rng)
    return "har", {"client_num_in_total": 2, "partition_method": "p-hetero"}


def _har_subject(root, rng):
    _har_files(root, rng, subjects=True)
    return "har_subject", {"client_num_in_total": 3, "partition_method": "p-hetero",
                           "partition_alpha": 0.5}


def _adult(root, rng):
    d = root / "income_proc"
    d.mkdir()
    np.save(d / "train_val_feat.npy", rng.randn(20, 104).astype(np.float32))
    np.save(d / "train_val_label.npy", rng.randint(0, 2, (20, 1)))
    np.save(d / "test_feat.npy", rng.randn(8, 104).astype(np.float32))
    np.save(d / "test_label.npy", rng.randint(0, 2, 8))
    return "adult", {"client_num_in_total": 2}


def _purchase_texas(name, width, first_label):
    def write(root, rng):
        stem = {"purchase100": "purchase_100", "texas100": "texas_100"}[name]
        with open(root / f"{stem}_not_normalized_features.p", "wb") as f:
            pickle.dump(rng.randint(0, 2, (30, width)).astype(np.float32), f)
        with open(root / f"{stem}_not_normalized_labels.p", "wb") as f:
            pickle.dump(rng.randint(first_label, first_label + 100, 30), f)
        return name, {"client_num_in_total": 2, "partition_method": "p-hetero"}

    return write


def _chmnist_npz(root, rng):
    np.savez(root / "chmnist.npz", x_train=rng.rand(16, 64, 64, 1),
             y_train=rng.randint(0, 8, 16), x_test=rng.rand(4, 64, 64, 1),
             y_test=rng.randint(0, 8, 4))
    return "chmnist", {"client_num_in_total": 2}


def _cifar_pickles(root, rng):
    base = root / "cifar-10-batches-py"
    base.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (4, 3072), dtype=np.uint8),
                         b"labels": rng.randint(0, 10, 4).tolist()}, f)


def _hetero_fix(root, rng):
    """A recorded map with non-contiguous client ids, over CIFAR-10's
    pickles."""
    _cifar_pickles(root, rng)
    d = root / "non-iid-distribution" / "CIFAR10"
    d.mkdir(parents=True)
    (d / "net_dataidx_map.txt").write_text(
        "{\n3: [\n0, 1, 2, 17,\n3, 4]\n7: [\n5, 6, 7, 8, 9, 10, 11,\n12]\n"
        "9: [\n13, 14, 15, 16, 18, 19]\n}\n")
    return "cifar10", {"client_num_in_total": 3, "partition_method": "hetero-fix"}


def _raw_mnist(root, rng):
    (root / "train").mkdir()
    (root / "test").mkdir()

    def blob(sizes):
        return {"users": sorted(sizes),
                "user_data": {u: {"x": rng.rand(n, 784).astype(np.float32).tolist(),
                                  "y": rng.randint(0, 10, n).tolist()}
                              for u, n in sizes.items()}}

    (root / "train" / "a.json").write_text(json.dumps(blob({"u0": 8, "u1": 5})))
    (root / "train" / "b.json").write_text(json.dumps(blob({"u2": 6})))
    (root / "test" / "a.json").write_text(json.dumps(blob({"u0": 2, "u2": 3})))
    return "raw_mnist", {}


def _h5(path, clients, write_client):
    import h5py

    with h5py.File(path, "w") as f:
        ex = f.create_group("examples")
        for cid, n in clients.items():
            write_client(ex.create_group(cid), n)


def _femnist_h5(root, rng):
    def client(g, n):
        g.create_dataset("pixels", data=rng.rand(n, 28, 28).astype(np.float32))
        g.create_dataset("label", data=rng.randint(0, 62, n).astype(np.int64))

    _h5(root / "fed_emnist_train.h5", {"f0": 9, "f1": 6, "f2": 12}, client)
    _h5(root / "fed_emnist_test.h5", {"f0": 3, "f1": 2, "f2": 4}, client)
    return "femnist", {"client_num_in_total": 3}


def _fed_cifar100_h5(root, rng):
    def client(g, n):
        g.create_dataset("image", data=rng.randint(0, 256, (n, 32, 32, 3), dtype=np.uint8))
        g.create_dataset("label", data=rng.randint(0, 100, n).astype(np.int64))

    _h5(root / "fed_cifar100_train.h5", {"c1": 5, "c0": 4}, client)
    _h5(root / "fed_cifar100_test.h5", {"c1": 2, "c0": 3}, client)
    return "fed_cifar100", {"client_num_in_total": 2}


def _stackoverflow_h5(root, rng):
    words = ["the", "a", "python", "list", "error", "how", "to", "sort", "dict", "é"]

    def client(g, n):
        rows = [" ".join(rng.choice(words, rng.randint(1, 30))).encode() for _ in range(n)]
        g.create_dataset("tokens", data=np.array(rows, dtype=object),
                         dtype=__import__("h5py").string_dtype())

    _h5(root / "stackoverflow_train.h5", {"u2": 3, "u0": 5, "u1": 2}, client)
    _h5(root / "stackoverflow_test.h5", {"u2": 1, "u0": 2, "u1": 2}, client)
    return "stackoverflow_nwp", {"client_num_in_total": 2}


FILE_CASES = {"emnist": _emnist, "fmnist": _fmnist, "cinic10": _cinic10, "har": _har,
              "har_subject": _har_subject, "adult": _adult,
              "purchase100": _purchase_texas("purchase100", 600, 1),
              "texas100": _purchase_texas("texas100", 6169, 0),
              "chmnist_npz": _chmnist_npz, "hetero_fix": _hetero_fix,
              "raw_mnist": _raw_mnist, "femnist_h5": _femnist_h5,
              "fed_cifar100_h5": _fed_cifar100_h5, "stackoverflow_h5": _stackoverflow_h5}


@pytest.mark.parametrize("case", list(FILE_CASES))
def test_loader_reads_reference_files_as_jax_does(case, tmp_path, no_surrogate):
    name, kwargs = FILE_CASES[case](tmp_path, np.random.RandomState(0))
    got = load_dataset(name, data_dir=str(tmp_path), **kwargs)
    _same_dataset(got, jax_load_dataset(name, data_dir=str(tmp_path), **kwargs))
    assert got.train.total_samples > 0


SURROGATE_CASES = [
    ("emnist", {"partition_method": "p-hetero", "partition_alpha": 1.0}),
    ("fmnist", {}),
    ("cinic10", {"partition_method": "hetero"}),
    ("adult", {"partition_method": "p-hetero", "partition_alpha": 1.0}),
    ("purchase100", {}),
    ("texas100", {"partition_method": "p-hetero"}),
    ("har", {"client_num_in_total": 6, "partition_method": "p-hetero"}),
    ("chmnist", {"client_num_in_total": 8}),
    ("har_subject", {"partition_method": "p-hetero"}),
    ("har_subject", {"partition_method": "homo", "partition_alpha": 1.0}),
    ("raw_mnist", {"client_num_in_total": 30}),
    # a missing recorded map falls back to a fresh LDA partition
    ("cifar10", {"partition_method": "hetero-fix"}),
]


@pytest.mark.parametrize("name,kwargs", SURROGATE_CASES,
                         ids=[f"{n}-{k.get('partition_method', 'default')}"
                              for n, k in SURROGATE_CASES])
def test_loader_surrogate_bitwise(name, kwargs, tmp_path):
    kwargs = {"client_num_in_total": 10, "seed": 3, **kwargs}
    got = load_dataset(name, data_dir=str(tmp_path), **kwargs)
    _same_dataset(got, jax_load_dataset(name, data_dir=str(tmp_path), **kwargs))


def test_hetero_fix_map_must_match_the_client_count(tmp_path):
    name, kwargs = _hetero_fix(tmp_path, np.random.RandomState(0))
    with pytest.raises(ValueError, match="records 3 clients"):
        load_dataset(name, data_dir=str(tmp_path), **{**kwargs, "client_num_in_total": 4})


def test_partition_text_readers_match(tmp_path):
    _hetero_fix(tmp_path, np.random.RandomState(0))
    path = readers.find_hetero_fix_map(str(tmp_path), "cifar10")
    assert path == jax_readers.find_hetero_fix_map(str(tmp_path), "cifar10")
    assert readers.read_net_dataidx_map(path) == jax_readers.read_net_dataidx_map(path)
    d = tmp_path / "distribution.txt"
    d.write_text("{\n0: {\n0: 250,\n1: 250\n}\n1: {\n0: 100\n}\n}\n")
    assert readers.read_data_distribution(str(d)) == {0: {0: 250, 1: 250}, 1: {0: 100}}
    assert readers.read_data_distribution(str(d)) == jax_readers.read_data_distribution(str(d))
    assert readers.find_hetero_fix_map(str(tmp_path), "cifar100") is None


@pytest.mark.parametrize("normalize", [True, False, "stats"])
def test_edge_case_sets_read_as_jax_does(normalize, tmp_path):
    rng = np.random.RandomState(0)
    base = tmp_path / "edge_case_examples" / "southwest_cifar10"
    base.mkdir(parents=True)
    for name, n in (("southwest_images_new_train.pkl", 7),
                    ("southwest_images_new_test.pkl", 3)):
        with open(base / name, "wb") as f:
            pickle.dump(rng.randint(0, 255, (n, 32, 32, 3), dtype=np.uint8), f)
    if normalize == "stats":
        normalize = (np.float32(0.5), np.float32(0.25))
    got = backdoor.load_edge_case_sets(str(tmp_path), normalize=normalize)
    want = jax_backdoor.load_edge_case_sets(str(tmp_path), normalize=normalize)
    _same(got[:2], want[:2])
    assert got[2] == want[2] == 9
    assert backdoor.load_edge_case_sets(str(tmp_path / "absent")) is None


@pytest.mark.parametrize("case", ["femnist_h5", "fed_cifar100_h5", "stackoverflow_h5"])
def test_h5_files_without_h5py_raise(case, tmp_path, monkeypatch):
    """The kept divergence: the JAX package trains on the surrogate when
    h5py does not import (for fed_CIFAR-100 and StackOverflow after a
    warning, for FEMNIST with none); the port raises, naming h5py and the
    file, and never replaces the files in silence."""
    name, kwargs = FILE_CASES[case](tmp_path, np.random.RandomState(0))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match=r"h5py.*|.*\.h5"):
        load_dataset(name, data_dir=str(tmp_path), **kwargs)
    with pytest.raises(ImportError) as err:
        load_dataset(name, data_dir=str(tmp_path), **kwargs)
    assert "h5py" in str(err.value) and f"{tmp_path}" in str(err.value)


@pytest.mark.parametrize("case", ["fed_cifar100_h5"])
def test_corrupt_h5_falls_back_as_jax_does(case, tmp_path, caplog):
    """A file h5py cannot read: the JAX package's warning and its seeded
    surrogate, bit for bit (StackOverflow's branch is the same code; its
    surrogate alone takes seconds to draw)."""
    name, kwargs = FILE_CASES[case](tmp_path, np.random.RandomState(0))
    for p in tmp_path.glob("*_test.h5"):
        p.write_bytes(b"not an h5 file")
    caplog.set_level(logging.WARNING)
    got = load_dataset(name, data_dir=str(tmp_path), **kwargs)
    assert any("failed reading" in r.getMessage() for r in caplog.records)
    _same_dataset(got, jax_load_dataset(name, data_dir=str(tmp_path), **kwargs))
