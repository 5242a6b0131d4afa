"""Raw data sources (the MNIST, EMNIST, CIFAR, fed_CIFAR-100, FEMNIST,
FedProx synthetic, Shakespeare, StackOverflow NWP and tag prediction and
tabular parts of
``fedml_tpu/data/sources.py``).

Each ``load_*`` reads the real files from ``data_dir`` when they are there
and otherwise makes a seeded surrogate of the same shape. Both are
byte-identical to the JAX package's: the readers parse the same formats
(``readers.py``; MNIST's IDX files, the CIFAR python pickles, LEAF
Shakespeare's json, the TFF h5 exports of FEMNIST, fed_CIFAR-100 and
StackOverflow), and the surrogates come from the same numpy
``RandomState`` draws in the same order.

One divergence is kept on purpose: where the TFF h5 files are present but
``h5py`` does not import, the JAX package trains on the surrogate (after a
warning, or none for FEMNIST); the port raises, naming ``h5py`` and the
file, because a user's real data must never be replaced in silence. A file
that ``h5py`` fails to read gives the JAX package's warning and surrogate
(or, for FEMNIST, its error)."""

from __future__ import annotations

import json
import logging
import os
import pickle
import zlib

import numpy as np

from fedml_tpu_torch.data import readers

log = logging.getLogger(__name__)


def _h5py(*paths):
    """The ``h5py`` module when every file of ``paths`` exists, None when one
    is absent; raises ``ImportError`` naming the files when they exist and
    ``h5py`` does not import."""
    if not all(os.path.exists(p) for p in paths):
        return None
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{', '.join(paths)} exist, but reading them needs h5py, which "
            f"does not import ({e}); install h5py or move the files away to "
            f"train on the seeded surrogate") from e
    return h5py


def _find(data_dir: str, names: list[str]) -> str | None:
    for name in names:
        for root in (data_dir, os.path.join(data_dir, "MNIST", "raw"),
                     os.path.join(data_dir, "raw")):
            p = os.path.join(root, name)
            if os.path.exists(p):
                return p
    return None


def synthetic_image_classes(n: int, class_num: int, shape: tuple[int, ...], seed: int,
                            noise: float = 0.35, proto_seed: int | None = None):
    """Seeded surrogate image dataset: each class a random prototype plus
    gaussian noise. ``proto_seed`` fixes the prototypes apart from the
    sample draw, so train and test splits share a distribution."""
    proto_rng = np.random.RandomState(seed if proto_seed is None else proto_seed)
    protos = proto_rng.normal(0.0, 1.0, size=(class_num,) + shape).astype(np.float32)
    rng = np.random.RandomState(seed)
    y = rng.randint(0, class_num, size=n).astype(np.int32)
    x = protos[y] * 0.6 + rng.normal(0.0, noise, size=(n,) + shape).astype(np.float32)
    return x.astype(np.float32), y


def load_mnist_arrays(data_dir: str = "./data", flatten: bool = False, seed: int = 0):
    """(x_train, y_train, x_test, y_test), normalised as torchvision's MNIST
    (mean 0.1307, std 0.3081), NHWC [n, 28, 28, 1] or flat [n, 784]."""
    paths = [_find(data_dir, [f"{stem}.gz", stem]) for stem in (
        "train-images-idx3-ubyte", "train-labels-idx1-ubyte",
        "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")]
    if all(p is not None for p in paths):
        tr_img, tr_lab, te_img, te_lab = paths
        xtr = (readers.read_idx(tr_img).astype(np.float32) / 255.0 - 0.1307) / 0.3081
        xte = (readers.read_idx(te_img).astype(np.float32) / 255.0 - 0.1307) / 0.3081
        ytr = readers.read_idx(tr_lab).astype(np.int32)
        yte = readers.read_idx(te_lab).astype(np.int32)
        xtr, xte = xtr[..., None], xte[..., None]
    else:
        log.warning("MNIST files not found under %s — using seeded surrogate", data_dir)
        xtr, ytr = synthetic_image_classes(6000, 10, (28, 28, 1), seed, proto_seed=seed + 9999)
        xte, yte = synthetic_image_classes(1000, 10, (28, 28, 1), seed + 1,
                                           proto_seed=seed + 9999)
    if flatten:
        xtr = xtr.reshape(len(xtr), -1)
        xte = xte.reshape(len(xte), -1)
    return xtr, ytr, xte, yte


def load_emnist_arrays(data_dir: str = "./data", seed: int = 0, split: str = "balanced"):
    """EMNIST balanced, 47 classes (reference MNIST/data_loader.py:55-60 via
    torchvision's EMNIST split='balanced'), normalised as MNIST, from the
    NIST gzip-IDX files when present, else a seeded surrogate (4,700 train
    and 940 test rows)."""
    ref = readers.read_emnist(data_dir, split)
    if ref is not None:
        xtr, ytr, xte, yte = ref
        return ((xtr - 0.1307) / 0.3081, ytr, (xte - 0.1307) / 0.3081, yte)
    log.warning("EMNIST IDX files not found under %s — using seeded surrogate", data_dir)
    xtr, ytr = synthetic_image_classes(4700, 47, (28, 28, 1), seed, proto_seed=seed + 4747)
    xte, yte = synthetic_image_classes(940, 47, (28, 28, 1), seed + 1, proto_seed=seed + 4747)
    return xtr, ytr, xte, yte


def fedprox_synthetic(alpha: float = 1.0, beta: float = 1.0, client_num: int = 30,
                      dim: int = 60, class_num: int = 10, seed: int = 0):
    """FedProx's synthetic(alpha, beta) generator (reference
    data_preprocessing/synthetic_1_1): per-client softmax-regression tasks,
    W_k ~ N(u_k, 1), u_k ~ N(0, alpha); x_k ~ N(v_k, Sigma),
    v_k ~ N(B_k, 1), B_k ~ N(0, beta); lognormal sizes."""
    rng = np.random.RandomState(seed)
    sizes = (rng.lognormal(4, 2, client_num).astype(int) + 50).clip(50, 2000)
    sigma = np.diag(np.arange(1, dim + 1) ** -1.2)
    xs, ys = [], []
    for k in range(client_num):
        u_k = rng.normal(0, alpha)
        b_k = rng.normal(0, beta)
        w = rng.normal(u_k, 1, size=(dim, class_num))
        b = rng.normal(u_k, 1, size=class_num)
        v_k = rng.normal(b_k, 1, size=dim)
        x = rng.multivariate_normal(v_k, sigma, size=int(sizes[k])).astype(np.float32)
        xs.append(x)
        ys.append(np.argmax(x @ w + b, axis=1).astype(np.int32))
    return xs, ys


def _read_cifar_pickles(name: str, data_dir: str):
    """The CIFAR python pickles as (xtr, ytr, xte, yte) of raw rows, or None
    when the directory is absent."""
    if name == "cifar10":
        base = os.path.join(data_dir, "cifar-10-batches-py")
        train, test, label = [f"data_batch_{i}" for i in range(1, 6)], "test_batch", b"labels"
    else:
        base = os.path.join(data_dir, "cifar-100-python")
        train, test, label = ["train"], "test", b"fine_labels"
    if not os.path.isdir(base):
        return None

    def read(fn):
        with open(os.path.join(base, fn), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        return np.asarray(d[b"data"]), np.asarray(d[label])

    parts = [read(fn) for fn in train]
    xte, yte = read(test)
    return (np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]),
            xte, yte)


def load_cifar_arrays(name: str = "cifar10", data_dir: str = "./data", seed: int = 0):
    """CIFAR-10/100 as NHWC float32 [n, 32, 32, 3], normalised by the
    reference's per-channel mean and std (cifar10/data_loader.py), from the
    python pickles when present, else a seeded surrogate (5,000 train and
    1,000 test rows)."""
    class_num = 100 if name == "cifar100" else 10
    loaded = None
    try:
        loaded = _read_cifar_pickles(name, data_dir)
    except Exception as e:  # corrupt files -> surrogate
        log.warning("failed reading %s from %s (%s) — using surrogate", name, data_dir, e)
    if loaded is not None:
        xtr, ytr, xte, yte = loaded
        xtr = xtr.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
        xte = xte.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
        mean = np.array([0.4914, 0.4822, 0.4465], np.float32)
        std = np.array([0.247, 0.243, 0.262], np.float32)
        return ((xtr - mean) / std, ytr.astype(np.int32),
                (xte - mean) / std, yte.astype(np.int32))
    log.warning("%s files not found under %s — using seeded surrogate", name, data_dir)
    xtr, ytr = synthetic_image_classes(5000, class_num, (32, 32, 3), seed, proto_seed=seed + 777)
    xte, yte = synthetic_image_classes(1000, class_num, (32, 32, 3), seed + 1,
                                       proto_seed=seed + 777)
    return xtr, ytr, xte, yte


def load_fed_cifar100_clients(data_dir: str = "./data", client_num: int = 500, seed: int = 0):
    """fed_CIFAR-100: TFF's natural split, 500 clients of 100 train and 20
    test images, 24x24 center crops (reference fed_cifar100/data_loader.py),
    from TFF's ``fed_cifar100_{train,test}.h5`` (pixels / 255) when present.
    Returns (xtr, ytr, xte, yte), lists of per-client arrays."""
    paths = (os.path.join(data_dir, "fed_cifar100_train.h5"),
             os.path.join(data_dir, "fed_cifar100_test.h5"))
    h5py = _h5py(*paths)
    if h5py is not None:
        def read(path):
            xs, ys = [], []
            with h5py.File(path, "r") as f:
                ex = f["examples"]
                for cid in sorted(ex.keys()):
                    g = ex[cid]
                    img = np.asarray(g["image"], np.float32) / 255.0
                    xs.append(img[:, 4:28, 4:28, :])  # 32 -> 24 center crop
                    ys.append(np.asarray(g["label"], np.int32))
            return xs, ys

        try:
            return (*read(paths[0]), *read(paths[1]))
        except Exception as e:  # a corrupt file -> the surrogate
            log.warning("failed reading fed_cifar100 (%s) — using surrogate", e)
    log.warning("fed_cifar100 h5 not found under %s — using seeded surrogate", data_dir)
    rng = np.random.RandomState(seed)
    protos = rng.normal(0.0, 1.0, size=(100, 24, 24, 3)).astype(np.float32)
    xtr, ytr, xte, yte = [], [], [], []
    for _ in range(client_num):
        y_i = rng.randint(0, 100, size=120).astype(np.int32)
        x_i = protos[y_i] * 0.6 + rng.normal(0, 0.35, size=(120, 24, 24, 3)).astype(np.float32)
        xtr.append(x_i[:100]); ytr.append(y_i[:100])
        xte.append(x_i[100:]); yte.append(y_i[100:])
    return xtr, ytr, xte, yte


def load_femnist_arrays(data_dir: str = "./data", client_num: int = 3400, seed: int = 0):
    """FederatedEMNIST: per-writer natural split, 62 classes, 28x28
    (reference FederatedEMNIST/data_loader.py:16-77); TFF's
    ``fed_emnist_{train,test}.h5`` when present, every writer in them.

    Returns (xtr, ytr, xte, yte), lists of per-client arrays
    [n_i, 28, 28, 1] float32 / [n_i] int32."""
    paths = (os.path.join(data_dir, "fed_emnist_train.h5"),
             os.path.join(data_dir, "fed_emnist_test.h5"))
    h5py = _h5py(*paths)
    if h5py is not None:
        # TFF's export: examples/<writer>/{pixels [n, 28, 28], label [n]}
        def read(path):
            xs, ys = [], []
            with h5py.File(path, "r") as f:
                examples = f["examples"]
                for cid in sorted(examples.keys()):
                    g = examples[cid]
                    xs.append(np.asarray(g["pixels"], dtype=np.float32)[..., None])
                    ys.append(np.asarray(g["label"], dtype=np.int32))
            return xs, ys

        return (*read(paths[0]), *read(paths[1]))
    log.warning("FEMNIST h5 not found under %s — using seeded surrogate", data_dir)
    xtr, ytr, xte, yte = [], [], [], []
    for x_i, y_i, tx_i, ty_i in femnist_surrogate_clients(client_num, seed):
        xtr.append(x_i)
        ytr.append(y_i)
        xte.append(tx_i)
        yte.append(ty_i)
    return xtr, ytr, xte, yte


#: the surrogate's largest client: its train split is clipped to this many
#: samples, its test split to FEMNIST_MAX_SAMPLES // 9
FEMNIST_MAX_SAMPLES = 480


def femnist_surrogate_clients(client_num: int, seed: int = 0):
    """The FEMNIST surrogate one client at a time: yields (x_train,
    y_train, x_test, y_test) per client, the arrays ``load_femnist_arrays``
    collects, from the same draws. A caller that writes clients out as
    they come (``data/packed_store.py::ShardWriter``) never holds the
    federation."""
    rng = np.random.RandomState(seed)
    protos = rng.normal(0.0, 1.0, size=(62, 28, 28, 1)).astype(np.float32)
    for _ in range(client_num):
        # unbalanced natural splits: lognormal-ish sizes around the TFF
        # per-writer mean (~227 train / ~26 test samples)
        n_i = int(np.clip(rng.lognormal(4.6, 0.45), 16, FEMNIST_MAX_SAMPLES))
        t_i = max(2, n_i // 9)
        y_i = rng.randint(0, 62, size=n_i + t_i).astype(np.int32)
        x_i = protos[y_i] * 0.6 + rng.normal(0, 0.35, size=(n_i + t_i, 28, 28, 1)).astype(np.float32)
        yield (x_i[:n_i].astype(np.float32), y_i[:n_i], x_i[n_i:].astype(np.float32),
               y_i[n_i:])


# StackOverflow NWP: 10,000 words + pad/bos/eos/oov, 20-token windows
STACKOVERFLOW_VOCAB, STACKOVERFLOW_SEQ = 10004, 20


def _markov_text_clients(client_num, vocab, seq_len, per_client, test_frac, seed,
                         per_position=True):
    """Surrogate language data: a shared seeded 2-gram transition table (so
    next-token structure is learnable) with per-client start states;
    per-position next-token targets, or the window's next token alone."""
    rng = np.random.RandomState(seed)
    # sparse transition table: each token has 4 likely successors, stored as
    # [vocab, 4] successor ids + cumulative probabilities
    succ = np.stack([rng.choice(vocab, 4, replace=False) for _ in range(vocab)])
    cum = np.cumsum(rng.dirichlet(np.ones(4) * 2.0, size=vocab), axis=1)
    xtr, ytr, xte, yte = [], [], [], []
    for _ in range(client_num):
        n_i = max(4, int(per_client * rng.lognormal(0, 0.4)))
        toks = np.zeros(n_i + seq_len + 1, np.int32)
        toks[0] = rng.randint(vocab)
        draws = rng.rand(len(toks))
        for i in range(1, len(toks)):
            t = toks[i - 1]
            toks[i] = succ[t, np.searchsorted(cum[t], draws[i])]
        windows = np.lib.stride_tricks.sliding_window_view(toks, seq_len + 1)[:n_i]
        x = windows[:, :seq_len].astype(np.int32)
        y = windows[:, 1:].astype(np.int32) if per_position else windows[:, -1].astype(np.int32)
        k = max(1, int(n_i * (1 - test_frac)))
        xtr.append(x[:k]); ytr.append(y[:k]); xte.append(x[k:]); yte.append(y[k:])
    return xtr, ytr, xte, yte


def load_stackoverflow_nwp_clients(data_dir: str = "./data", client_num: int = 200,
                                   seed: int = 0):
    """StackOverflow next-word prediction (reference stackoverflow_nwp/):
    20-token windows over the extended vocab, per-position targets. Reads
    TFF's ``stackoverflow_{train,test}.h5`` (examples/<client>/tokens, rows
    of whitespace-joined sentences; the first ``client_num`` clients, 256
    rows each) when present.

    Returns (xtr, ytr, xte, yte), lists of per-client [n_i, seq_len] int32."""
    paths = (os.path.join(data_dir, "stackoverflow_train.h5"),
             os.path.join(data_dir, "stackoverflow_test.h5"))
    h5py = _h5py(*paths)
    if h5py is not None:
        vocab, seq = STACKOVERFLOW_VOCAB, STACKOVERFLOW_SEQ

        def tok_ids(sentence):
            words = sentence.decode() if isinstance(sentence, bytes) else str(sentence)
            # 0 pad, 1 bos, 2 eos; words hashed into [4, vocab) by crc32,
            # the same in every process (unlike hash())
            ids = ([1] + [4 + (zlib.crc32(w.encode()) % (vocab - 4))
                          for w in words.split()][: seq - 2] + [2])
            ids = ids + [0] * (seq + 1 - len(ids))
            return np.array(ids[: seq + 1], np.int32)

        def read(path):
            xs, ys = [], []
            with h5py.File(path, "r") as f:
                ex = f["examples"]
                for cid in sorted(ex.keys())[:client_num]:
                    rows = np.stack([tok_ids(s) for s in ex[cid]["tokens"][:256]])
                    xs.append(rows[:, :seq])
                    ys.append(rows[:, 1:])
            return xs, ys

        try:
            return (*read(paths[0]), *read(paths[1]))
        except Exception as e:  # a corrupt file -> the surrogate
            log.warning("failed reading stackoverflow h5 (%s) — using surrogate", e)
    log.warning("stackoverflow h5 not found under %s — using seeded surrogate", data_dir)
    return _markov_text_clients(client_num, STACKOVERFLOW_VOCAB, STACKOVERFLOW_SEQ,
                                per_client=64, test_frac=0.15, seed=seed)


def load_stackoverflow_lr_clients(data_dir: str = "./data", client_num: int = 200,
                                  seed: int = 0, vocab_size: int = 10000, tag_num: int = 500):
    """StackOverflow tag prediction (reference stackoverflow_lr/): x is a
    bag of words over the 10,000-word vocab, y a multi-hot row over 500
    tags. The surrogate (the only data either package reads: no file)
    couples tags to words through a sparse seeded map so that logistic
    regression can learn; one ``RandomState(seed)`` draws the map, then
    each client's size, words and split, in that order."""
    rng = np.random.RandomState(seed)
    word_tag = np.zeros((vocab_size, tag_num), np.float32)
    for t in range(tag_num):
        word_tag[rng.choice(vocab_size, 20, replace=False), t] = 1.0
    xtr, ytr, xte, yte = [], [], [], []
    for _ in range(client_num):
        n_i = max(4, int(40 * rng.lognormal(0, 0.4)))
        x = (rng.rand(n_i, vocab_size) < 0.002).astype(np.float32)
        scores = x @ word_tag
        y = (scores >= np.maximum(1.0, np.partition(scores, -3, axis=1)[:, -3:-2])
             ).astype(np.float32)
        k = max(1, int(n_i * 0.85))
        xtr.append(x[:k]); ytr.append(y[:k]); xte.append(x[k:]); yte.append(y[k:])
    return xtr, ytr, xte, yte


SHAKESPEARE_VOCAB = 90  # reference shakespeare/language_utils.py ALL_LETTERS
SHAKESPEARE_SEQ = 80  # McMahan et al. (fed_shakespeare/utils.py:15)
ALL_LETTERS = ("\n !\"&'(),-.0123456789:;>?ABCDEFGHIJKLMNOPQRSTUVWXYZ[]"
               "abcdefghijklmnopqrstuvwxyz}")


def letter_to_index(letter: str) -> int:
    """A character's id (reference language_utils.letter_to_index); a
    character outside ALL_LETTERS maps to the last id, 89."""
    return ALL_LETTERS.find(letter) % SHAKESPEARE_VOCAB


def _read_leaf_json(directory: str):
    """A LEAF split: (users in file order, {user: {"x": [...], "y": [...]}})."""
    users, data = [], {}
    for fn in sorted(os.listdir(directory)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(directory, fn)) as f:
            j = json.load(f)
        users += j["users"]
        data.update(j["user_data"])
    return users, data


def load_shakespeare_clients(data_dir: str = "./data", client_num: int = 715,
                             seed: int = 0, per_position: bool = False):
    """LEAF Shakespeare (reference shakespeare/data_loader.py:11-50): one
    client per role, 80-character windows; the target is the next
    character, or with ``per_position`` the window shifted by one with the
    next character last (fed_shakespeare). Reads LEAF's train/test json
    when present. Returns (xtr, ytr, xte, yte), lists of per-client int32
    arrays."""
    tr_dir = os.path.join(data_dir, "shakespeare", "train")
    te_dir = os.path.join(data_dir, "shakespeare", "test")
    if not (os.path.isdir(tr_dir) and os.path.isdir(te_dir)):
        log.warning("shakespeare LEAF json not found under %s — using seeded surrogate",
                    data_dir)
        return _markov_text_clients(client_num, SHAKESPEARE_VOCAB, SHAKESPEARE_SEQ,
                                    per_client=48, test_frac=0.15, seed=seed,
                                    per_position=per_position)

    def to_ids(s):
        return np.array([letter_to_index(ch) for ch in s], np.int32)

    users, tr = _read_leaf_json(tr_dir)
    _, te = _read_leaf_json(te_dir)
    xtr, ytr, xte, yte = [], [], [], []
    for u in users:
        for data, xs, ys in ((tr[u], xtr, ytr), (te.get(u, {"x": [], "y": []}), xte, yte)):
            if data["x"]:
                x = np.stack([to_ids(s)[:SHAKESPEARE_SEQ] for s in data["x"]])
                nxt = np.array([to_ids(s)[0] for s in data["y"]], np.int32)
                y = np.concatenate([x[:, 1:], nxt[:, None]], axis=1) if per_position else nxt
            else:
                x = np.zeros((0, SHAKESPEARE_SEQ), np.int32)
                y = np.zeros((0, SHAKESPEARE_SEQ) if per_position else (0,), np.int32)
            xs.append(x); ys.append(y)
    return xtr, ytr, xte, yte


# ---------------------------------------------------------------------------
# the fork's tabular extras (UCIAdult / purchase100 / texas100 / UCI-HAR /
# CHMNIST)

#: one sample's shape and the class count of each tabular dataset
TABULAR = {
    "adult": ((104,), 2),          # one-hot encoded UCI Adult
    "purchase100": ((600,), 100),  # acquire-valued-shoppers binary basket
    "texas100": ((6169,), 100),    # hospital discharge features
    "har": ((128, 9), 6),          # UCI-HAR 128-step 9-channel windows
    "chmnist": ((64, 64, 1), 8),   # colorectal-histology MNIST
}


def load_tabular_arrays(name: str, data_dir: str = "./data", seed: int = 0):
    """The fork's datasets of its privacy / membership-inference experiments
    (reference fedml_api/data_preprocessing/{UCIAdult,purchase,texas,UCI_HAR,
    CHMNIST}): the reference's own files first (HAR Inertial Signals txt,
    UCIAdult income_proc npy, purchase/texas not_normalized pickles), then
    ``<name>.npz`` with x_train/y_train/x_test/y_test, else a seeded
    surrogate of the dataset's true dimensionality (6,000 train rows for
    flat features, 3,000 for images and windows; a sixth of that for test)."""
    shape, class_num = TABULAR[name]
    ref = None
    if name == "har":
        ref = readers.read_har(data_dir)
    elif name == "adult":
        ref = readers.read_adult(data_dir)
    elif name in ("purchase100", "texas100"):
        ref = readers.read_purchase_texas(name, data_dir)
    if ref is not None:
        xtr, ytr, xte, yte = ref
        return (xtr.astype(np.float32), ytr.astype(np.int32),
                xte.astype(np.float32), yte.astype(np.int32))
    p = os.path.join(data_dir, f"{name}.npz")
    if os.path.exists(p):
        try:
            d = np.load(p)
            out = (d["x_train"].astype(np.float32), d["y_train"].astype(np.int32),
                   d["x_test"].astype(np.float32), d["y_test"].astype(np.int32))
            if out[0].shape[1:] != shape:
                raise ValueError(f"{name} features {out[0].shape[1:]} != expected {shape}")
            return out
        except Exception as e:  # a corrupt or misshapen file -> the surrogate
            log.warning("failed reading %s (%s) — using surrogate", p, e)
    else:
        log.warning("%s npz not found under %s — using seeded surrogate", name, data_dir)
    ntr = 6000 if len(shape) == 1 else 3000
    xtr, ytr = synthetic_image_classes(ntr, class_num, shape, seed, proto_seed=seed + 31)
    xte, yte = synthetic_image_classes(ntr // 6, class_num, shape, seed + 1,
                                       proto_seed=seed + 31)
    return xtr, ytr, xte, yte
