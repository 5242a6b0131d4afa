"""Federated data partitioners (host-side numpy), a copy of
``fedml_tpu/core/partition.py``:

  - ``homo_partition``: a uniform random split (reference
    data_preprocessing/utils.py:9);
  - ``non_iid_partition_with_dirichlet_distribution``: the LDA split of
    Hsu et al. 2019 with the min-10-samples retry loop (reference
    fedml_core/non_iid_partition/noniid_partition.py:6-92);
  - ``p_hetero_partition``: the fork's pathological split (reference
    utils.py:15-58);
  - ``record_net_data_stats``: per-client class histograms (utils.py:60).

They draw from the numpy ``RandomState`` they are given in the JAX
package's order, so the same seed gives the same maps, bit for bit.
"""

from __future__ import annotations

import logging

import numpy as np


def homo_partition(total_num: int, client_num: int, rng: np.random.RandomState | None = None):
    """Uniform random split of `total_num` samples into `client_num` shards."""
    rng = rng or np.random
    idxs = rng.permutation(total_num)
    shards = np.array_split(idxs, client_num)
    return {i: shards[i] for i in range(client_num)}


def _dirichlet_split_one_class(idx_k, alpha, client_num, idx_batch, total_n, rng):
    """Distribute one class's sample indices across clients by Dirichlet draw,
    zeroing the share of any client already at/above the fair quota
    (reference noniid_partition.py:76-92)."""
    rng.shuffle(idx_k)
    props = rng.dirichlet(np.full(client_num, alpha))
    # clients that already hold >= N/client_num samples get nothing this class
    props = np.array(
        [p * (len(held) < total_n / client_num) for p, held in zip(props, idx_batch)]
    )
    props = props / props.sum()
    cuts = (np.cumsum(props) * len(idx_k)).astype(int)[:-1]
    parts = np.split(idx_k, cuts)
    idx_batch = [held + part.tolist() for held, part in zip(idx_batch, parts)]
    return idx_batch, min(len(held) for held in idx_batch)


def non_iid_partition_with_dirichlet_distribution(
    label_list: np.ndarray,
    client_num: int,
    classes: int,
    alpha: float,
    min_samples: int = 10,
    rng: np.random.RandomState | None = None,
):
    """LDA partition (Hsu et al. 2019): per-class Dirichlet(alpha) proportions
    across clients, retried until every client has >= `min_samples`.

    Same contract as reference noniid_partition.py:6-73 (classification task).
    """
    rng = rng or np.random
    label_list = np.asarray(label_list)
    n = label_list.shape[0]
    min_size = 0
    while min_size < min_samples:
        idx_batch = [[] for _ in range(client_num)]
        for k in range(classes):
            idx_k = np.where(label_list == k)[0]
            idx_batch, min_size = _dirichlet_split_one_class(
                idx_k, alpha, client_num, idx_batch, n, rng
            )
    out = {}
    for i in range(client_num):
        arr = np.asarray(idx_batch[i])
        rng.shuffle(arr)
        out[i] = arr
    return out


# alias matching the reference name used by cifar loaders ("hetero" method)
hetero_partition = non_iid_partition_with_dirichlet_distribution


def p_hetero_partition(
    client_num: int,
    y_train: np.ndarray,
    alpha: float,
    rng: np.random.RandomState | None = None,
):
    """The fork's pathological-hetero split (reference utils.py:15-58).

    One "group" per class; a fraction `alpha` of each class k goes densely to
    group k, the remainder is split evenly across the other groups; each
    group's pool is then split across its `client_num / num_class` clients.
    """
    rng = rng or np.random
    y_train = np.asarray(y_train)
    num_class = len(np.unique(y_train))
    num_group = num_class
    client_per_group = client_num // num_group

    group_pools = [[] for _ in range(num_group)]
    for k in range(num_class):
        idx_k = np.where(y_train == k)[0]
        rng.shuffle(idx_k)
        split = int(alpha * len(idx_k))
        group_pools[k].append(idx_k[:split])
        sparse = np.array_split(idx_k[split:], num_group - 1)
        j = 0
        for g in range(num_group):
            if g == k:
                continue
            group_pools[g].append(sparse[j])
            j += 1
    pools = []
    for g in range(num_group):
        pool = np.concatenate(group_pools[g])
        rng.shuffle(pool)
        pools.append(pool)

    # pre-create every client so client_num not divisible by num_class still
    # yields client_num shards (the remainder clients hold no samples, matching
    # the reference's pre-allocated idx_batch)
    net_dataidx_map = {i: np.array([], dtype=int) for i in range(client_num)}
    if client_num >= num_class:
        for g in range(num_group):
            for b, shard in enumerate(np.array_split(pools[g], client_per_group)):
                net_dataidx_map[g * client_per_group + b] = shard
    else:
        merged = np.array_split(np.asarray(pools, dtype=object), client_num)
        for i in range(client_num):
            net_dataidx_map[i] = np.concatenate(list(merged[i]))
    for i in net_dataidx_map:
        arr = np.asarray(net_dataidx_map[i])
        rng.shuffle(arr)
        net_dataidx_map[i] = arr
    return net_dataidx_map


def record_net_data_stats(y_train, net_dataidx_map, tag=""):
    """Per-client class histogram (reference utils.py:60-77)."""
    stats = {}
    y_train = np.asarray(y_train)
    for cid, idxs in net_dataidx_map.items():
        unq, cnt = np.unique(y_train[np.asarray(idxs, dtype=int)], return_counts=True)
        stats[cid] = {int(u): int(c) for u, c in zip(unq, cnt)}
    logging.debug("%s data statistics: %s", tag, stats)
    return stats
