"""The port's vertical FL (``algorithms/vfl.py``), its party data
(``data/loaders.py::load_vfl_parties``, ``data/readers.py``'s NUS-WIDE and
lending club readers) and ``experiments/main_vfl.py`` against the JAX
package.

Both packages draw the initial weights from ``np.random.RandomState`` and
the minibatches from ``_minibatch_indices``, so the fits start from the
same bits and take the same batches: the loss histories and the predicted
probabilities agree within 1e-6. The readers parse without pandas and must
give the JAX package's pandas readers' arrays bit for bit."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import vfl as jax_vfl
from fedml_tpu.data import loaders as jax_loaders
from fedml_tpu.data import readers as jax_readers
from fedml_tpu.experiments import main_vfl as jax_main_vfl
from fedml_tpu_torch.algorithms import vfl
from fedml_tpu_torch.data import loaders, readers
from fedml_tpu_torch.experiments import main_vfl

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _design(seed: int = 0, n: int = 300, d: int = 14):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x @ rng.normal(size=d) > 0).astype(np.int32)
    return x, y


SPLITS = [np.arange(0, 5), np.arange(5, 9), np.arange(9, 14)]  # guest + 2 hosts


@pytest.mark.parametrize("n,epochs,batch,seed", [(300, 3, 64, 0), (128, 2, 128, 5),
                                                 (50, 2, 64, 1)])
def test_minibatch_indices_bit_for_bit(n, epochs, batch, seed):
    got = list(vfl._minibatch_indices(n, epochs, batch, seed))
    want = list(jax_vfl._minibatch_indices(n, epochs, batch, seed))
    assert len(got) == len(want) == epochs * (n // batch)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_initial_weights_bit_for_bit():
    t = vfl.VerticalFederatedLearningAPI(SPLITS, seed=7, device="cpu")
    j = jax_vfl.VerticalFederatedLearningAPI(SPLITS, seed=7)
    tn = vfl.NeuralVFLAPI([5, 4, 5], hidden_dim=8, seed=7, device="cpu")
    jn = jax_vfl.NeuralVFLAPI([5, 4, 5], hidden_dim=8, seed=7)
    for tp, jp in list(zip(t.params, j.params)) + list(zip(tn.params, jn.params)):
        assert set(tp) == set(jp)
        for k in jp:
            assert tp[k].dtype == torch.float32
            assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k
    assert "b" in t.params[0] and "b" not in t.params[1]
    assert "dense_b" in tn.params[0] and "dense_b" not in tn.params[2]


def test_linear_fit_matches_jax():
    """3 epochs of the linear parties: every step's loss and the predicted
    probabilities within 1e-6, the weights within 1e-6."""
    x, y = _design()
    t = vfl.VerticalFederatedLearningAPI(SPLITS, lr=0.2, seed=3, device="cpu")
    j = jax_vfl.VerticalFederatedLearningAPI(SPLITS, lr=0.2, seed=3)
    t.fit(x, y, epochs=3, batch_size=64, seed=4)
    j.fit(x, y, epochs=3, batch_size=64, seed=4)
    assert len(t.loss_history) == len(j.loss_history) == 12
    np.testing.assert_allclose(t.loss_history, j.loss_history, rtol=0, atol=TOL)
    np.testing.assert_allclose(t.predict_proba(x), j.predict_proba(x), rtol=0, atol=TOL)
    for tp, jp in zip(t.params, j.params):
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=TOL)
    assert t.score(x, y) == j.score(x, y)


def test_neural_fit_matches_jax():
    """3 epochs of the neural party stack (LocalModel + DenseModel, weight
    decay and momentum over every party): the losses and the predicted
    probabilities within 1e-6."""
    ptr, ytr, pte, yte = readers.synthetic_vfl_parties((12, 20), n_train=320, n_test=100)
    t = vfl.NeuralVFLAPI([12, 20], hidden_dim=16, lr=0.05, seed=0, device="cpu")
    j = jax_vfl.NeuralVFLAPI([12, 20], hidden_dim=16, lr=0.05, seed=0)
    t.fit(ptr, ytr, epochs=3, batch_size=64, seed=2)
    j.fit(ptr, ytr, epochs=3, batch_size=64, seed=2)
    np.testing.assert_allclose(t.loss_history, j.loss_history, rtol=0, atol=TOL)
    np.testing.assert_allclose(t.predict_proba(pte), j.predict_proba(pte), rtol=0, atol=TOL)
    assert t.score(pte, yte) == j.score(pte, yte)


def test_vfl_equals_centralized_logistic():
    """Feature-split training of the linear model is centralized logistic
    regression (the sum of the party components is one linear map), the
    JAX package's property, held in the port."""
    rng = np.random.RandomState(1)
    x = rng.normal(size=(200, 10)).astype(np.float32)
    y = (x[:, 0] - x[:, 3] > 0).astype(np.int32)
    two = vfl.VerticalFederatedLearningAPI([np.arange(5), np.arange(5, 10)], lr=0.2, seed=7,
                                           device="cpu")
    one = vfl.VerticalFederatedLearningAPI([np.arange(10)], lr=0.2, seed=7, device="cpu")
    one.params[0]["w"] = torch.cat([two.params[0]["w"], two.params[1]["w"]])
    one.params[0]["b"] = two.params[0]["b"].clone()
    two.fit(x, y, epochs=5, batch_size=50, seed=3)
    one.fit(x, y, epochs=5, batch_size=50, seed=3)
    np.testing.assert_allclose(two.predict_proba(x), one.predict_proba(x), atol=1e-5)
    np.testing.assert_allclose(two.loss_history, one.loss_history, atol=1e-5)


@pytest.mark.parametrize("name,three", [("lending_club", False), ("nus_wide", False),
                                        ("nus_wide", True)])
def test_vfl_surrogates_bit_for_bit(name, three, tmp_path):
    got = loaders.load_vfl_parties(name, data_dir=str(tmp_path), seed=2, three_party=three)
    want = jax_loaders.load_vfl_parties(name, data_dir=str(tmp_path), seed=2,
                                        three_party=three)
    _same_parties(got, want)
    assert len(got[0]) == (3 if three else 2)


def _same_parties(got, want):
    assert len(got) == len(want) == 4
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    for g, w in ((got[1], want[1]), (got[3], want[3])):
        assert g.dtype == w.dtype == np.int32 and np.array_equal(g, w)


def test_main_vfl_dense_lending_club_matches_jax(tmp_path):
    """``main_vfl --dataset lending_club --model dense``: the accuracies
    equal the JAX main's, the last loss within 1e-6, and Test/Acc > 0.7 (the
    JAX package's own bar)."""
    argv = ["--dataset", "lending_club", "--model", "dense", "--epochs", "4",
            "--batch_size", "64", "--lr", "0.05", "--data_dir", str(tmp_path / "data")]
    got = main_vfl.main(argv + ["--run_dir", str(tmp_path / "t"), "--device", "cpu"])
    want = jax_main_vfl.main(argv + ["--run_dir", str(tmp_path / "j")])
    assert got["Train/Acc"] == want["Train/Acc"] and got["Test/Acc"] == want["Test/Acc"]
    np.testing.assert_allclose(got["Train/Loss"], want["Train/Loss"], rtol=0, atol=TOL)
    assert got["Test/Acc"] > 0.7


@pytest.mark.parametrize("argv", [["--dataset", "nus_wide", "--party_num", "3"],
                                  ["--dataset", "adult", "--party_num", "3"]])
def test_main_vfl_lr_matches_jax(argv, tmp_path):
    """``main_vfl --model lr`` on a natively split dataset and on a 9-tuple
    one split by columns: the same accuracies and last loss (1e-6)."""
    argv = argv + ["--epochs", "2", "--data_dir", str(tmp_path / "data")]
    got = main_vfl.main(argv + ["--run_dir", str(tmp_path / "t"), "--device", "cpu"])
    want = jax_main_vfl.main(argv + ["--run_dir", str(tmp_path / "j")])
    assert got["Train/Acc"] == want["Train/Acc"] and got["Test/Acc"] == want["Test/Acc"]
    np.testing.assert_allclose(got["Train/Loss"], want["Train/Loss"], rtol=0, atol=TOL)


# ---- the readers, without pandas


def _write_nus_wide(root, rng, rows, labels=("sky", "clouds", "person", "water", "animal")):
    """NUS-WIDE's layout at a small size: per split, two normalized feature
    files (space-separated, a trailing space on every line, one column with
    an empty field and one with a ``NaN``), the tag file (tab-separated,
    a trailing tab) and one label file per label."""
    for split, n in rows.items():
        feat = root / "Low_Level_Features"
        feat.mkdir(exist_ok=True)
        for name, width in (("CH", 5), ("EDH", 4)):
            a = rng.rand(n, width)
            lines = []
            for i, row in enumerate(a):
                fields = [f"{v:.6f}" for v in row]
                if name == "CH" and i == 3:
                    fields[1] = ""  # column 1 has an empty field: dropped
                if name == "EDH" and i == n - 2:
                    fields[2] = "NaN"  # column 2 holds a NaN: dropped
                lines.append(" ".join(fields) + " \n")
            (feat / f"{split}_Normalized_{name}.dat").write_text("".join(lines))
        tags = root / "NUS_WID_Tags"
        tags.mkdir(exist_ok=True)
        t = rng.randint(0, 2, (n, 6))
        (tags / f"{split}_Tags1k.dat").write_text(
            "".join("\t".join(str(v) for v in row) + "\t\n" for row in t))
        gt = root / "Groundtruth" / "TrainTestLabels"
        gt.mkdir(parents=True, exist_ok=True)
        onehot = rng.rand(n, len(labels)) < 0.3
        for k, label in enumerate(labels):
            (gt / f"Labels_{label}_{split}.txt").write_text(
                "".join(f"{int(v)}\n" for v in onehot[:, k]))


@pytest.mark.parametrize("three", [False, True])
def test_read_nus_wide_equals_pandas(tmp_path, three):
    """The port's reader against the JAX package's pandas reader on files
    with trailing separators and NaN columns: the same float32 parties and
    int32 labels, bit for bit."""
    _write_nus_wide(tmp_path, np.random.RandomState(0), {"Train": 40, "Test": 25})
    got = readers.read_nus_wide(str(tmp_path), three_party=three)
    want = jax_readers.read_nus_wide(str(tmp_path), three_party=three)
    _same_parties(got, want)
    assert got[0][0].shape[1] == 4 + 3  # CH less its empty column, EDH less its NaN one
    assert readers.read_nus_wide(str(tmp_path / "absent")) is None


def test_read_lending_club_equals_pandas(tmp_path):
    """``processed_loan.csv`` (a header, mixed integer and float columns,
    ``target`` among them) through both readers: the same shuffled 80/20
    parties, bit for bit."""
    rng = np.random.RandomState(1)
    n, names = 53, [f"f{i}" for i in range(7)]
    cols = names[:3] + ["target"] + names[3:]
    lines = [",".join(cols)]
    for _ in range(n):
        row = [f"{v:.7g}" for v in rng.randn(3)] + [str(rng.randint(0, 2))]
        row += [str(rng.randint(0, 9)), repr(float(np.float32(rng.rand()))),
                f"{rng.rand():.4f}", f"{rng.randn() * 1e3:.3f}"]
        lines.append(",".join(row))
    (tmp_path / "processed_loan.csv").write_text("\n".join(lines) + "\n")
    for seed in (0, 3):
        got = readers.read_lending_club(str(tmp_path), seed=seed)
        want = jax_readers.read_lending_club(str(tmp_path), seed=seed)
        _same_parties(got, want)
        assert got[0][0].shape == (42, 3) and got[0][1].shape == (42, 4)
    assert readers.read_lending_club(str(tmp_path / "absent")) is None


def test_vfl_modules_load_no_pandas():
    """Importing the port's readers, loaders, VFL algorithms and main loads
    no pandas (the card's machine has none)."""
    code = ("import sys\n"
            "import fedml_tpu_torch.data.readers, fedml_tpu_torch.data.loaders\n"
            "import fedml_tpu_torch.algorithms.vfl, fedml_tpu_torch.experiments.main_vfl\n"
            "assert 'pandas' not in sys.modules, 'pandas was imported'\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
