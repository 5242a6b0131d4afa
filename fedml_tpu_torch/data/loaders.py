"""Dataset loaders (the mnist, emnist, fmnist, raw_mnist, synthetic,
cifar10, cifar100, cinic10, fed_cifar100, femnist, shakespeare,
fed_shakespeare, stackoverflow_nwp, adult, purchase100, texas100, har,
chmnist and har_subject parts of ``fedml_tpu/data/loaders.py``).

A globally pooled dataset is split across clients by ``homo``, ``hetero``
(LDA), ``p-hetero`` or ``hetero-fix`` (a recorded ``net_dataidx_map.txt``,
``readers.find_hetero_fix_map``), the train split by the method asked for
and the test split homo unless the method is homo or p-hetero, both from
one ``RandomState(seed)``; a naturally split one keeps its clients.
"""

from __future__ import annotations

import os

import numpy as np

from fedml_tpu_torch.core.partition import (homo_partition,
                                            non_iid_partition_with_dirichlet_distribution,
                                            p_hetero_partition, record_net_data_stats)
from fedml_tpu_torch.data import readers, sources
from fedml_tpu_torch.data.packing import pack_client_data, pack_client_lists
from fedml_tpu_torch.data.registry import FederatedDataset, register_loader


def _partition(method: str, y: np.ndarray, client_num: int, alpha: float, class_num: int,
               rng, data_dir: str = "./data", dataset: str = "",
               partition_file: str | None = None):
    if method == "homo":
        return homo_partition(len(y), client_num, rng)
    if method == "hetero":
        return non_iid_partition_with_dirichlet_distribution(y, client_num, class_num, alpha,
                                                             rng=rng)
    if method == "p-hetero":
        return p_hetero_partition(client_num, y, alpha, rng)
    if method == "hetero-fix":
        # a recorded partition (reference cifar10/data_loader.py:33-46 and
        # :163-170 read the net_dataidx_map.txt of an earlier hetero run)
        path = partition_file or readers.find_hetero_fix_map(data_dir, dataset)
        if path is None:
            sources.log.warning(
                "hetero-fix map not found under %s for %s — falling back to "
                "a fresh LDA (hetero) partition", data_dir, dataset)
            return non_iid_partition_with_dirichlet_distribution(y, client_num, class_num,
                                                                 alpha, rng=rng)
        m = readers.read_net_dataidx_map(path)
        if len(m) != client_num:
            raise ValueError(
                f"hetero-fix map at {path} records {len(m)} clients but "
                f"--client_num_in_total is {client_num}; pass the matching "
                "client count (the map is a fixed pre-recorded partition)")
        # recorded ids, possibly not contiguous, become 0..C-1 in sorted order
        return {i: np.asarray(m[k], np.int64) for i, k in enumerate(sorted(m))}
    raise ValueError(f"unknown partition method {method!r}")


def _from_global(name, xtr, ytr, xte, yte, class_num, client_num, partition_method,
                 partition_alpha, seed, data_dir="./data", partition_file=None):
    rng = np.random.RandomState(seed)
    tr_map = _partition(partition_method, ytr, client_num, partition_alpha, class_num, rng,
                        data_dir=data_dir, dataset=name, partition_file=partition_file)
    te_map = _partition(partition_method if partition_method in ("homo", "p-hetero") else "homo",
                        yte, client_num, partition_alpha, class_num, rng)
    record_net_data_stats(ytr, tr_map, name)
    return FederatedDataset(name=name, train=pack_client_data(xtr, ytr, tr_map),
                            test=pack_client_data(xte, yte, te_map),
                            train_global=(xtr, ytr), test_global=(xte, yte),
                            class_num=class_num)


@register_loader("mnist")
def load_mnist(data_dir="./data", client_num_in_total=10, partition_method="homo",
               partition_alpha=0.5, flatten=True, seed=0, **_):
    """MNIST split by homo / hetero / p-hetero (reference
    MNIST/data_loader.py:101-190); flat 784-wide rows unless ``flatten`` is
    False."""
    xtr, ytr, xte, yte = sources.load_mnist_arrays(data_dir, flatten=flatten, seed=seed)
    return _from_global("mnist", xtr, ytr, xte, yte, 10, client_num_in_total,
                        partition_method, partition_alpha, seed)


@register_loader("synthetic")
def load_synthetic(alpha=1.0, beta=1.0, client_num_in_total=30, dim=60, class_num=10,
                   seed=0, test_frac=0.2, **_):
    """FedProx synthetic(alpha, beta) (reference
    data_preprocessing/synthetic_1_1), each client's first 80% for train."""
    xs, ys = sources.fedprox_synthetic(alpha, beta, client_num_in_total, dim, class_num, seed)
    xtr, ytr, xte, yte = [], [], [], []
    for x, y in zip(xs, ys):
        k = max(1, int(len(x) * (1 - test_frac)))
        xtr.append(x[:k]); ytr.append(y[:k]); xte.append(x[k:]); yte.append(y[k:])
    train, test = pack_client_lists(xtr, ytr), pack_client_lists(xte, yte)
    return FederatedDataset(name="synthetic", train=train, test=test,
                            train_global=(np.concatenate(xtr), np.concatenate(ytr)),
                            test_global=(np.concatenate(xte), np.concatenate(yte)),
                            class_num=class_num)


def _register_cifar(name, class_num):
    @register_loader(name)
    def _load(data_dir="./data", client_num_in_total=10, partition_method="hetero",
              partition_alpha=0.5, seed=0, partition_file=None, **_):
        """CIFAR split by homo / hetero / p-hetero / hetero-fix (reference
        cifar10/data_loader.py:284)."""
        xtr, ytr, xte, yte = sources.load_cifar_arrays(name, data_dir, seed)
        return _from_global(name, xtr, ytr, xte, yte, class_num, client_num_in_total,
                            partition_method, partition_alpha, seed, data_dir=data_dir,
                            partition_file=partition_file)

    return _load


load_cifar10 = _register_cifar("cifar10", 10)
load_cifar100 = _register_cifar("cifar100", 100)


@register_loader("cinic10")
def load_cinic10(data_dir="./data", client_num_in_total=10, partition_method="hetero",
                 partition_alpha=0.5, seed=0, partition_file=None, **_):
    """CINIC-10 (CIFAR-shaped ImageNet + CIFAR): the reference's folder tree
    <root>/{train,test}/<class>/*.png first (reference
    cinic10/data_loader.py:222-239, ImageFolder), then ``cinic10.npz``,
    then a seeded surrogate; never CIFAR-10's files."""
    ref = None
    try:
        ref = readers.read_cinic10(data_dir)
    except Exception as e:  # an unreadable tree -> the npz or the surrogate
        sources.log.warning("failed reading cinic10 folder tree (%s)", e)
    if ref is not None:
        xtr, ytr, xte, yte = ref
    else:
        p = os.path.join(data_dir, "cinic10.npz")
        if os.path.exists(p):
            try:
                d = np.load(p)
                xtr, ytr = d["x_train"].astype(np.float32), d["y_train"].astype(np.int32)
                xte, yte = d["x_test"].astype(np.float32), d["y_test"].astype(np.int32)
            except Exception as e:  # a corrupt file -> the surrogate
                sources.log.warning("failed reading %s (%s) — using surrogate", p, e)
                ref = False
        else:
            sources.log.warning("cinic10 folder tree / npz not found under %s — "
                                "using seeded surrogate", data_dir)
            ref = False
        if ref is False:
            xtr, ytr = sources.synthetic_image_classes(5000, 10, (32, 32, 3), seed,
                                                       proto_seed=seed + 778)
            xte, yte = sources.synthetic_image_classes(1000, 10, (32, 32, 3), seed + 1,
                                                       proto_seed=seed + 778)
    return _from_global("cinic10", xtr, ytr, xte, yte, 10, client_num_in_total,
                        partition_method, partition_alpha, seed, data_dir=data_dir,
                        partition_file=partition_file)


@register_loader("emnist")
def load_emnist(data_dir="./data", client_num_in_total=10, partition_method="homo",
                partition_alpha=0.5, seed=0, partition_file=None, **_):
    """EMNIST balanced, 47 classes (reference MNIST/data_loader.py:55-60;
    the mnist/fmnist/emnist trio shares homo / p-hetero partitioning)."""
    xtr, ytr, xte, yte = sources.load_emnist_arrays(data_dir, seed=seed)
    return _from_global("emnist", xtr, ytr, xte, yte, 47, client_num_in_total,
                        partition_method, partition_alpha, seed, data_dir=data_dir,
                        partition_file=partition_file)


@register_loader("fmnist")
def load_fmnist(data_dir="./data", client_num_in_total=10, partition_method="homo",
                partition_alpha=0.5, seed=0, **_):
    """Fashion-MNIST: MNIST's IDX layout under <data_dir>/fmnist (the fork's
    MNIST/data_loader.py serves mnist, fmnist and emnist); its surrogate is
    MNIST's at seed + 5, as 28x28 images."""
    xtr, ytr, xte, yte = sources.load_mnist_arrays(os.path.join(data_dir, "fmnist"),
                                                   seed=seed + 5)
    return _from_global("fmnist", xtr, ytr, xte, yte, 10, client_num_in_total,
                        partition_method, partition_alpha, seed)


@register_loader("raw_mnist")
def load_raw_mnist(data_dir="./data", client_num_in_total=1000, seed=0, **_):
    """LEAF-json MNIST with natural per-device clients (reference
    raw_MNIST/data_loader.py:80-124, load_partition_data_mnist_1000fix):
    <data_dir>/{train,test}/*.json, else a surrogate of
    ``client_num_in_total`` small natural clients."""
    ref = None
    failed = False
    try:
        ref = readers.read_leaf_json_clients(data_dir)
    except Exception as e:  # unreadable json -> the surrogate
        sources.log.warning("failed reading raw_mnist LEAF json (%s) — using "
                            "seeded surrogate", e)
        failed = True
    if ref is not None:
        xtr, ytr, xte, yte = ref
    else:
        if not failed:
            sources.log.warning("raw_mnist LEAF json not found under %s — "
                                "using seeded surrogate", data_dir)
        rng = np.random.RandomState(seed)
        protos = rng.normal(0.0, 1.0, (10, 28, 28, 1)).astype(np.float32)
        xtr, ytr, xte, yte = [], [], [], []
        for _ in range(client_num_in_total):
            n_i = int(np.clip(rng.lognormal(3.2, 0.4), 8, 96))
            t_i = max(1, n_i // 6)
            y_i = rng.randint(0, 10, n_i + t_i).astype(np.int32)
            x_i = (protos[y_i] * 0.6
                   + rng.normal(0, 0.35, (n_i + t_i, 28, 28, 1)).astype(np.float32))
            xtr.append(x_i[:n_i]); ytr.append(y_i[:n_i])
            xte.append(x_i[n_i:]); yte.append(y_i[n_i:])
    return _from_client_lists("raw_mnist", xtr, ytr, xte, yte, 10)


@register_loader("fed_cifar100")
def load_fed_cifar100(data_dir="./data", client_num_in_total=500, seed=0, **_):
    """TFF fed_CIFAR-100's natural split (reference fed_cifar100/data_loader.py)."""
    xtr, ytr, xte, yte = sources.load_fed_cifar100_clients(data_dir, client_num_in_total, seed)
    return _from_client_lists("fed_cifar100", xtr, ytr, xte, yte, 100)


@register_loader("shakespeare")
def load_shakespeare(data_dir="./data", client_num_in_total=715, seed=0, **_):
    """LEAF Shakespeare: an 80-character window -> the next character
    (reference shakespeare/data_loader.py:11-50)."""
    xtr, ytr, xte, yte = sources.load_shakespeare_clients(data_dir, client_num_in_total, seed,
                                                          per_position=False)
    return _from_client_lists("shakespeare", xtr, ytr, xte, yte, sources.SHAKESPEARE_VOCAB,
                              task="next_char")


@register_loader("fed_shakespeare")
def load_fed_shakespeare(data_dir="./data", client_num_in_total=715, seed=0, **_):
    """TFF fed_shakespeare: per-position next-character targets, trained
    with the NWP loss (reference fed_shakespeare/data_loader.py)."""
    xtr, ytr, xte, yte = sources.load_shakespeare_clients(data_dir, client_num_in_total, seed,
                                                          per_position=True)
    return _from_client_lists("fed_shakespeare", xtr, ytr, xte, yte,
                              sources.SHAKESPEARE_VOCAB, task="nwp")


@register_loader("femnist")
def load_femnist(data_dir="./data", client_num_in_total=3400, seed=0, **_):
    """FederatedEMNIST natural per-writer split, 62 classes
    (reference FederatedEMNIST/data_loader.py:16-77)."""
    xtr, ytr, xte, yte = sources.load_femnist_arrays(
        data_dir, client_num=client_num_in_total, seed=seed)
    return _from_client_lists("femnist", xtr, ytr, xte, yte, 62)


@register_loader("stackoverflow_nwp")
def load_stackoverflow_nwp(data_dir="./data", client_num_in_total=200, seed=0, **_):
    """StackOverflow next-word prediction: per-position targets over the
    10,004-token vocab (reference stackoverflow_nwp/)."""
    xtr, ytr, xte, yte = sources.load_stackoverflow_nwp_clients(
        data_dir, client_num_in_total, seed)
    return _from_client_lists("stackoverflow_nwp", xtr, ytr, xte, yte,
                              sources.STACKOVERFLOW_VOCAB, task="nwp")


def _register_tabular(name, default_partition="homo"):
    class_num = sources.TABULAR[name][1]

    @register_loader(name)
    def _load(data_dir="./data", client_num_in_total=10, partition_method=None,
              partition_alpha=0.5, seed=0, **_):
        """A tabular dataset of the fork, pooled and then split (homo by
        default)."""
        xtr, ytr, xte, yte = sources.load_tabular_arrays(name, data_dir, seed)
        return _from_global(name, xtr, ytr, xte, yte, class_num, client_num_in_total,
                            partition_method or default_partition, partition_alpha, seed)

    return _load


# the fork's extras (reference fedml_api/data_preprocessing/{UCIAdult,purchase,
# texas,UCI_HAR,CHMNIST}), its membership-inference experiments' datasets
for _name in sources.TABULAR:
    _register_tabular(_name)


@register_loader("har_subject")
def load_har_subject(data_dir="./data", client_num_in_total=10, partition_method="p-hetero",
                     partition_alpha=0.5, seed=0, **_):
    """UCI-HAR split by volunteer (reference HAR/subject_dataloader.py:262-330):
    p-hetero with the subject id as the grouping label in place of the
    class, so a fraction alpha of each volunteer's windows stays with their
    group and the rest spreads evenly; ``homo`` splits evenly. The
    surrogate draws 21 train and 9 test volunteers."""
    ref = None
    try:
        ref = readers.read_har_subjects(data_dir)
    except Exception as e:  # unreadable files -> the surrogate
        sources.log.warning("failed reading har subjects (%s) — surrogate", e)
    if ref is not None:
        xtr, ytr, s_tr, xte, yte, s_te = ref
    else:
        sources.log.warning("HAR subject files not found under %s — using seeded surrogate",
                            data_dir)
        xtr, ytr, xte, yte = sources.load_tabular_arrays("har", data_dir, seed)
        srng = np.random.RandomState(seed + 71)
        s_tr = srng.randint(0, 21, size=len(ytr)).astype(np.int32)
        s_te = srng.randint(0, 9, size=len(yte)).astype(np.int32)
    rng = np.random.RandomState(seed)
    if partition_method == "homo":
        tr_map = homo_partition(len(ytr), client_num_in_total, rng)
        te_map = homo_partition(len(yte), client_num_in_total, rng)
    else:
        tr_map = p_hetero_partition(client_num_in_total, s_tr, partition_alpha, rng)
        te_map = p_hetero_partition(client_num_in_total, s_te, partition_alpha, rng)
    return FederatedDataset(name="har_subject", train=pack_client_data(xtr, ytr, tr_map),
                            test=pack_client_data(xte, yte, te_map),
                            train_global=(xtr, ytr), test_global=(xte, yte), class_num=6)


def _from_client_lists(name, xtr, ytr, xte, yte, class_num, **meta):
    """Build a FederatedDataset from naturally split per-client arrays."""
    train = pack_client_lists(xtr, ytr)
    test = pack_client_lists(xte, yte)

    def flat(packed):
        return (np.concatenate([a[:c] for a, c in zip(packed.x, packed.counts)]),
                np.concatenate([a[:c] for a, c in zip(packed.y, packed.counts)]))

    return FederatedDataset(name=name, train=train, test=test,
                            train_global=flat(train), test_global=flat(test),
                            class_num=class_num, meta=meta)
