"""Dataset loaders (the mnist, synthetic, cifar10, cifar100, fed_cifar100,
femnist, shakespeare, fed_shakespeare and stackoverflow_nwp parts of
``fedml_tpu/data/loaders.py``).

A globally pooled dataset (mnist, cifar10, cifar100) is split across
clients by ``homo``, ``hetero`` (LDA) or ``p-hetero``, the train split by
the method asked for and the test split homo unless the method is homo or
p-hetero, both from one ``RandomState(seed)``; a naturally split one keeps
its clients. ``hetero-fix`` (a recorded map) is not ported yet.
"""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.core.partition import (homo_partition,
                                            non_iid_partition_with_dirichlet_distribution,
                                            p_hetero_partition, record_net_data_stats)
from fedml_tpu_torch.data import sources
from fedml_tpu_torch.data.packing import pack_client_data, pack_client_lists
from fedml_tpu_torch.data.registry import FederatedDataset, register_loader


def _partition(method: str, y: np.ndarray, client_num: int, alpha: float, class_num: int,
               rng):
    if method == "homo":
        return homo_partition(len(y), client_num, rng)
    if method == "hetero":
        return non_iid_partition_with_dirichlet_distribution(y, client_num, class_num, alpha,
                                                             rng=rng)
    if method == "p-hetero":
        return p_hetero_partition(client_num, y, alpha, rng)
    if method == "hetero-fix":
        raise NotImplementedError(
            "partition_method 'hetero-fix' (a recorded net_dataidx_map) is not "
            "ported to fedml_tpu_torch yet")
    raise ValueError(f"unknown partition method {method!r}")


def _from_global(name, xtr, ytr, xte, yte, class_num, client_num, partition_method,
                 partition_alpha, seed):
    rng = np.random.RandomState(seed)
    tr_map = _partition(partition_method, ytr, client_num, partition_alpha, class_num, rng)
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
              partition_alpha=0.5, seed=0, **_):
        """CIFAR split by homo / hetero / p-hetero (reference
        cifar10/data_loader.py:284)."""
        xtr, ytr, xte, yte = sources.load_cifar_arrays(name, data_dir, seed)
        return _from_global(name, xtr, ytr, xte, yte, class_num, client_num_in_total,
                            partition_method, partition_alpha, seed)

    return _load


load_cifar10 = _register_cifar("cifar10", 10)
load_cifar100 = _register_cifar("cifar100", 100)


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
