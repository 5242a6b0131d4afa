"""Dataset loaders (every part of ``fedml_tpu/data/loaders.py``: mnist,
emnist, fmnist, raw_mnist, synthetic, cifar10, cifar100, cinic10,
fed_cifar100, femnist, shakespeare, fed_shakespeare, stackoverflow_nwp,
stackoverflow_lr, adult, purchase100, texas100, har, chmnist,
har_subject, pascal_voc, and the streaming ILSVRC2012, gld23k and
gld160k).

A globally pooled dataset is split across clients by ``homo``, ``hetero``
(LDA), ``p-hetero`` or ``hetero-fix`` (a recorded ``net_dataidx_map.txt``,
``readers.find_hetero_fix_map``), the train split by the method asked for
and the test split homo unless the method is homo or p-hetero, both from
one ``RandomState(seed)``; a naturally split one keeps its clients.

ILSVRC2012 and Google Landmarks stream when their files are present
(``data/streaming.py``): only file paths are scanned at load, a round
decodes its sampled clients under an LRU byte budget
(``FEDML_TPU_STREAM_BUDGET``, 8 GiB for ILSVRC2012 and 4 GiB for
Landmarks by default), and ``train_global``/``test_global`` hold seeded
decoded subsets of ``global_cap`` images. Without the files each loads a
small seeded surrogate in RAM, as in the JAX package.
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


@register_loader("ILSVRC2012")
def load_imagenet(data_dir="./data", client_num_in_total=100, seed=0, image_size=224,
                  cap_per_class=None, byte_budget=None, global_cap=512,
                  samples_per_client=1024, **_):
    """ImageNet split into class blocks: with 100 clients each owns 10
    consecutive classes, with 1000 each owns one (reference
    ImageNet/data_loader.py:190-240, datasets.py:81-129 net_dataidx_map).

    With the ILSVRC2012 tree (<data_dir>/{train,val}/<wnid>/*) present the
    dataset streams: a round's ``select()`` decodes only its sampled
    clients (the full train split at 224 px would be about 700 GB of
    float32). ``samples_per_client`` caps each client's list with a seeded
    subsample, and says so in a warning. Surrogate when the tree is
    absent."""
    from fedml_tpu_torch.data.streaming import (StreamingPackedClients,
                                                decode_global_subset, make_image_decoder)

    tr_root = os.path.join(data_dir, "train")
    te_root = os.path.join(data_dir, "val")
    scan = None
    if os.path.isdir(tr_root) and os.path.isdir(te_root):
        try:
            scan = (readers.list_image_folder_files(tr_root),
                    readers.list_image_folder_files(te_root))
        except Exception as e:  # an unreadable tree -> the surrogate
            sources.log.warning("failed scanning ImageNet tree (%s)", e)
    if scan is not None and scan[0] is not None and scan[1] is not None:
        (tr_pc, classes), (te_pc, te_classes) = scan
        if te_classes != classes:
            raise ValueError(
                f"ImageNet train/val class dirs disagree ({len(classes)} vs "
                f"{len(te_classes)}; first diff: "
                f"{sorted(set(classes) ^ set(te_classes))[:3]}) — val labels "
                "would be silently wrong. Complete the download or remove "
                "the extra dirs.")
        if cap_per_class is not None:
            tr_pc = [f[:cap_per_class] for f in tr_pc]
            te_pc = [f[:cap_per_class] for f in te_pc]
        class_num = len(classes)
        dec = make_image_decoder(image_size, readers.IMAGENET_MEAN, readers.IMAGENET_STD)
        # 10 sampled clients x 1024 rows at 224 px float32 is about 6.2 GB
        budget = int(byte_budget or os.environ.get("FEDML_TPU_STREAM_BUDGET", 8 << 30))
        # array_split puts every class on exactly one client even when
        # class_num % client_num != 0 (the reference's per-class map)
        class_blocks = np.array_split(np.arange(class_num), client_num_in_total)
        cf, cl = [], []
        for block in class_blocks:
            files, labels = [], []
            for ci in block:
                files.extend(tr_pc[ci])
                labels.extend([ci] * len(tr_pc[ci]))
            cf.append(files)
            cl.append(np.asarray(labels, np.int32))
        if samples_per_client is not None:
            # a class-blocked client owns 1.3k-13k images, and one padded row
            # at 224 px is n_max x 600 KB: a seeded subsample keeps a round
            # inside the budget
            srng = np.random.RandomState(seed + 7)
            capped = dropped = 0
            for k in range(len(cf)):
                if len(cf[k]) > samples_per_client:
                    capped += 1
                    dropped += len(cf[k]) - samples_per_client
                    keep = np.sort(srng.choice(len(cf[k]), samples_per_client,
                                               replace=False))
                    cf[k] = [cf[k][i] for i in keep]
                    cl[k] = cl[k][keep]
            if capped:
                # the reference trains on each client's whole class block
                sources.log.warning(
                    "ILSVRC streaming loader subsampled %d/%d clients to "
                    "samples_per_client=%d (dropped %d images total); pass "
                    "samples_per_client=None for reference-faithful full "
                    "class blocks", capped, len(cf), samples_per_client, dropped)
        train = StreamingPackedClients(cf, cl, dec, byte_budget=budget)
        # a homo split of the val files as the per-client test split
        te_files = [f for ci in range(class_num) for f in te_pc[ci]]
        te_labels = np.asarray([ci for ci in range(class_num) for _ in te_pc[ci]], np.int32)
        te_map = homo_partition(len(te_files), client_num_in_total,
                                np.random.RandomState(seed))
        tef = [[te_files[i] for i in te_map[k]] for k in sorted(te_map)]
        tel = [te_labels[te_map[k]] for k in sorted(te_map)]
        test = StreamingPackedClients(tef, tel, dec, byte_budget=budget)
        # seeded random subsets, not the class-sorted prefix (which would
        # cover only the lowest classes)
        tr_flat = [(f, ci) for ci in range(class_num) for f in tr_pc[ci]]
        xgt, ygt = decode_global_subset(
            [f for f, _ in tr_flat], np.asarray([c for _, c in tr_flat], np.int32),
            dec, global_cap, seed, (image_size, image_size, 3))
        xg, yg = decode_global_subset(te_files, te_labels, dec, global_cap, seed + 1,
                                      (image_size, image_size, 3))
        return FederatedDataset(name="ILSVRC2012", train=train, test=test,
                                train_global=(xgt, ygt), test_global=(xg, yg),
                                class_num=class_num,
                                meta={"streaming": True, "global_cap": int(global_cap)})

    sources.log.warning("ImageNet folder tree not found under %s — using "
                        "tiny seeded surrogate", data_dir)
    class_num = max(10, client_num_in_total)
    sz = min(image_size, 32)
    xtr, ytr = sources.synthetic_image_classes(class_num * 12, class_num, (sz, sz, 3), seed,
                                               proto_seed=seed + 1012)
    xte, yte = sources.synthetic_image_classes(class_num * 3, class_num, (sz, sz, 3),
                                               seed + 1, proto_seed=seed + 1012)
    class_blocks = np.array_split(np.arange(class_num), client_num_in_total)
    order = np.argsort(ytr, kind="stable")
    xtr_l, ytr_l = [], []
    for block in class_blocks:
        if len(block):
            sel = order[(ytr[order] >= block[0]) & (ytr[order] <= block[-1])]
        else:
            sel = np.array([], np.int64)
        xtr_l.append(xtr[sel])
        ytr_l.append(ytr[sel])
    te_map = homo_partition(len(yte), client_num_in_total, np.random.RandomState(seed))
    return FederatedDataset(name="ILSVRC2012", train=pack_client_lists(xtr_l, ytr_l),
                            test=pack_client_data(xte, yte, te_map),
                            train_global=(xtr, ytr), test_global=(xte, yte),
                            class_num=class_num)


def _register_landmarks(variant, default_clients):
    @register_loader(variant)
    def _load(data_dir="./data", client_num_in_total=None, seed=0, image_size=64,
              global_cap=512, **_):
        """Google Landmarks' user split (reference Landmarks/data_loader.py:202
        load_partition_data_landmarks; gld23k: 233 users and 203 classes,
        gld160k: 1,262 users and 2,028 classes), streamed when the csvs and
        images are present; a surrogate of ``client_num_in_total`` users
        (default the variant's) when they are not."""
        from fedml_tpu_torch.data.streaming import (StreamingPackedClients,
                                                    decode_global_subset,
                                                    make_image_decoder)

        client_num = client_num_in_total or default_clients
        scan = None
        try:
            scan = readers.list_landmarks_files(data_dir, variant)
        except Exception as e:  # unreadable csvs or missing images -> the surrogate
            sources.log.warning("failed reading %s (%s)", variant, e)
        if scan is not None:
            files, labels, te_files, te_labels, class_num = scan
            dec = make_image_decoder(image_size)
            budget = int(os.environ.get("FEDML_TPU_STREAM_BUDGET", 4 << 30))
            train = StreamingPackedClients(files, labels, dec, byte_budget=budget)
            te_map = homo_partition(len(te_files), len(files), np.random.RandomState(seed))
            tef = [[te_files[i] for i in te_map[k]] for k in sorted(te_map)]
            tel = [te_labels[te_map[k]] for k in sorted(te_map)]
            test = StreamingPackedClients(tef, tel, dec, byte_budget=budget)
            shp = (image_size, image_size, 3)
            xg, yg = decode_global_subset(te_files, te_labels, dec, global_cap, seed + 1,
                                          shp)
            gt_files = [f for fl in files for f in fl]
            xgt, ygt = decode_global_subset(gt_files, np.concatenate(labels), dec,
                                            global_cap, seed, shp)
            return FederatedDataset(name=variant, train=train, test=test,
                                    train_global=(xgt, ygt), test_global=(xg, yg),
                                    class_num=int(class_num),
                                    meta={"streaming": True, "global_cap": int(global_cap)})
        sources.log.warning("%s csv/images not found under %s — using tiny "
                            "seeded surrogate", variant, data_dir)
        class_num = 203 if variant == "gld23k" else 2028
        rng = np.random.RandomState(seed)
        protos = rng.normal(0, 1, (class_num, image_size, image_size, 3)).astype(np.float32)
        xtr_l, ytr_l = [], []
        for _c in range(client_num):
            n_i = int(np.clip(rng.lognormal(3.0, 0.6), 4, 128))
            y_i = rng.randint(0, class_num, n_i).astype(np.int32)
            xtr_l.append(protos[y_i] * 0.6 + rng.normal(
                0, 0.35, (n_i, image_size, image_size, 3)).astype(np.float32))
            ytr_l.append(y_i)
        yte = rng.randint(0, class_num, 64).astype(np.int32)
        xte = protos[yte] * 0.6 + rng.normal(
            0, 0.35, (64, image_size, image_size, 3)).astype(np.float32)
        train = pack_client_lists(xtr_l, ytr_l)
        te_map = homo_partition(len(yte), len(xtr_l), np.random.RandomState(seed))
        return FederatedDataset(
            name=variant, train=train, test=pack_client_data(xte, yte, te_map),
            train_global=(np.concatenate([a[:c] for a, c in zip(train.x, train.counts)]),
                          np.concatenate([a[:c] for a, c in zip(train.y, train.counts)])),
            test_global=(xte, yte), class_num=int(class_num))

    return _load


load_gld23k = _register_landmarks("gld23k", 233)
load_gld160k = _register_landmarks("gld160k", 1262)


@register_loader("emnist")
def load_emnist(data_dir="./data", client_num_in_total=10, partition_method="homo",
                partition_alpha=0.5, seed=0, partition_file=None, **_):
    """EMNIST balanced, 47 classes (reference MNIST/data_loader.py:55-60;
    the mnist/fmnist/emnist trio shares homo / p-hetero partitioning)."""
    xtr, ytr, xte, yte = sources.load_emnist_arrays(data_dir, seed=seed)
    return _from_global("emnist", xtr, ytr, xte, yte, 47, client_num_in_total,
                        partition_method, partition_alpha, seed, data_dir=data_dir,
                        partition_file=partition_file)


@register_loader("pascal_voc")
def load_pascal_voc(data_dir="./data", client_num_in_total=4, partition_method="homo",
                    partition_alpha=0.5, seed=0, image_size=64, **_):
    """Pascal VOC semantic segmentation for FedSeg (21 classes, 255 = the
    ignored border): the VOCdevkit tree when present, else a seeded
    surrogate of blob masks (40 training and 10 test images), so that the
    losses and mIoU mean something; equal to the JAX loader's arrays."""
    ref = None
    try:
        ref = readers.read_pascal_voc(data_dir, image_size)
    except Exception as e:  # a broken tree falls back, as in the JAX loader
        sources.log.warning("failed reading VOC tree (%s)", e)
    if ref is not None:
        xtr, ytr, xte, yte = ref
    else:
        sources.log.warning("VOCdevkit not found under %s — using seeded "
                            "segmentation surrogate", data_dir)
        rng = np.random.RandomState(seed)

        def synth(n):
            h = image_size
            x = rng.rand(n, h, h, 3).astype(np.float32) * 0.2
            y = np.zeros((n, h, h), np.int32)
            for i in range(n):
                # 1-3 class blobs on background 0, each in a 255 ring
                for _b in range(rng.randint(1, 4)):
                    c = rng.randint(1, 21)
                    cy, cx = rng.randint(4, h - 4), rng.randint(4, h - 4)
                    r = rng.randint(3, max(4, h // 4))
                    yy, xx = np.ogrid[:h, :h]
                    blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
                    ring = ((yy - cy) ** 2 + (xx - cx) ** 2 <= (r + 1) ** 2) & ~blob
                    y[i][blob] = c
                    y[i][ring] = 255
                    x[i][blob] += np.array([c / 21.0, (c % 5) / 5.0, (c % 3) / 3.0], np.float32)
            return x, y

        xtr, ytr = synth(40)
        xte, yte = synth(10)
    return _from_global("pascal_voc", xtr, ytr, xte, yte, 21, client_num_in_total,
                        partition_method, partition_alpha, seed, data_dir=data_dir)


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


@register_loader("stackoverflow_lr")
def load_stackoverflow_lr(data_dir="./data", client_num_in_total=200, seed=0, **_):
    """StackOverflow tag prediction: bag-of-words rows, multi-hot over 500
    tags, trained by ``TagPredictionTrainer`` (the task in ``meta``)."""
    xtr, ytr, xte, yte = sources.load_stackoverflow_lr_clients(
        data_dir, client_num_in_total, seed)
    return _from_client_lists("stackoverflow_lr", xtr, ytr, xte, yte, 500,
                              task="tag_prediction")


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


def load_vfl_parties(name: str, data_dir: str = "./data", seed: int = 0,
                     three_party: bool = False):
    """Vertical-FL party data (outside the 9-tuple contract: features are
    split across parties, not rows across clients). ``name``: "nus_wide"
    (reference NUS_WIDE/nus_wide_dataset.py) or "lending_club"
    (lending_club_loan/lending_club_dataset.py). Returns (parties_train,
    y_train, parties_test, y_test); the seeded surrogate when the files are
    absent or unreadable (the JAX package's dimensions: NUS-WIDE's 634
    image features and 1,000 tags, in two or three parties; lending club's
    18 + 18 columns)."""
    if name not in ("nus_wide", "lending_club"):
        raise ValueError(f"unknown VFL dataset {name!r}")
    ref = None
    failed = False
    try:
        if name == "nus_wide":
            ref = readers.read_nus_wide(data_dir, three_party=three_party)
        else:
            ref = readers.read_lending_club(data_dir, seed=seed)
    except Exception as e:  # corrupt files -> surrogate, like every loader here
        sources.log.warning("failed reading %s (%s) — using seeded VFL surrogate", name, e)
        failed = True
    if ref is not None:
        return ref
    if not failed:
        sources.log.warning("%s files not found under %s — using seeded VFL surrogate",
                            name, data_dir)
    dims = {"nus_wide": (634, 500, 500) if three_party else (634, 1000),
            "lending_club": (18, 18)}[name]
    return readers.synthetic_vfl_parties(dims, seed=seed)
