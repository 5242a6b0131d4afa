"""Dataset loaders (the FEMNIST and StackOverflow NWP parts of
``fedml_tpu/data/loaders.py``)."""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.data import sources
from fedml_tpu_torch.data.packing import pack_client_lists
from fedml_tpu_torch.data.registry import FederatedDataset, register_loader


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
