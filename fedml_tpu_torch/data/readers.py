"""Readers for the reference's on-disk dataset formats (the parts of
``fedml_tpu/data/readers.py`` that the ported loaders reach).

Each function reads the file layout the reference's preprocessing
consumes, so a data directory prepared for the reference works unchanged,
and returns what the JAX package's reader returns, bit for bit:

- EMNIST balanced gzip-IDX (reference MNIST/data_loader.py:55-60 via
  torchvision EMNIST split="balanced")
- ImageFolder trees: CINIC-10 train/test/<class>/*.png (reference
  cinic10/data_loader.py:218-239) and ILSVRC2012 train/val/<wnid>/*
  (reference ImageNet/datasets.py:81-129), read eagerly or only scanned
  for the streaming loaders (``list_image_folder_files``)
- Google Landmarks' user-split csvs and <image_id>.jpg files (reference
  Landmarks/data_loader.py), read eagerly or scanned
  (``list_landmarks_files``)
- UCI-HAR Inertial Signals txt matrices (reference HAR/data_loader.py:56-154)
- UCIAdult income_proc npy quartet (reference UCIAdult/dataloader.py:38-50)
- purchase100/texas100 not_normalized pickles (reference
  purchase/dataloader.py:21-45)
- hetero-fix pre-recorded partition text files (reference
  cifar10/data_loader.py:18-47)
- LEAF-json per-client MNIST (reference raw_MNIST/data_loader.py:9-50)
- Pascal VOC 2012's segmentation split (the upstream FedSeg layout)
- southwest-airline edge-case backdoor pickles (reference
  edge_case_examples/data_loader.py:329-385)
- NUS-WIDE's and lending club's vertical-FL party files (reference
  NUS_WIDE/nus_wide_dataset.py:23-71, lending_club_dataset.py:126-155),
  parsed with ``csv`` and numpy (``read_table``) where the JAX package
  uses pandas, into the same float32 and int32 arrays

A reader returns None when its files are absent; the loaders
(``sources``, ``loaders``) then fall back to seeded surrogates. ``PIL`` is
imported only by the image readers, when they run.
"""

from __future__ import annotations

import csv
import gzip
import json
import logging
import os
import pickle
import struct

import numpy as np

log = logging.getLogger(__name__)

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".ppm", ".bmp", ".webp")

# per-channel normalisation of the reference's transforms
# (cifar10/data_loader.py, cinic10/data_loader.py, ImageNet/datasets.py)
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.247, 0.243, 0.262], np.float32)
CINIC10_MEAN = np.array([0.47889522, 0.47227842, 0.43047404], np.float32)
CINIC10_STD = np.array([0.24205776, 0.23828046, 0.25874835], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


# ---------------------------------------------------------------------------
# EMNIST balanced (gzip IDX)


def read_idx(path: str) -> np.ndarray:
    """Parse an IDX (MNIST-format) file, gzipped or raw."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtype = {8: np.uint8, 9: np.int8, 11: np.int16, 12: np.int32,
                 13: np.float32, 14: np.float64}[dtype_code]
        data = np.frombuffer(f.read(), dtype=np.dtype(dtype).newbyteorder(">"))
        return data.reshape(dims)


def find_emnist_files(data_dir: str, split: str = "balanced"):
    """The four emnist-<split> IDX files under the roots torchvision uses
    (EMNIST/raw, the NIST zip's gzip/, raw/ or data_dir itself), or None."""
    names = {
        "train_images": f"emnist-{split}-train-images-idx3-ubyte",
        "train_labels": f"emnist-{split}-train-labels-idx1-ubyte",
        "test_images": f"emnist-{split}-test-images-idx3-ubyte",
        "test_labels": f"emnist-{split}-test-labels-idx1-ubyte",
    }
    roots = (data_dir, os.path.join(data_dir, "EMNIST", "raw"),
             os.path.join(data_dir, "gzip"), os.path.join(data_dir, "raw"))
    out = {}
    for key, base in names.items():
        for root in roots:
            for name in (base + ".gz", base):
                p = os.path.join(root, name)
                if os.path.exists(p):
                    out[key] = p
                    break
            if key in out:
                break
        if key not in out:
            return None
    return out


def read_emnist(data_dir: str, split: str = "balanced"):
    """(x_train, y_train, x_test, y_test) in [0, 1], or None. Raw EMNIST
    images are stored transposed against MNIST; torchvision transposes them
    on import, and so does this reader."""
    files = find_emnist_files(data_dir, split)
    if files is None:
        return None
    xtr = read_idx(files["train_images"]).astype(np.float32) / 255.0
    xte = read_idx(files["test_images"]).astype(np.float32) / 255.0
    xtr = xtr.transpose(0, 2, 1)[..., None]
    xte = xte.transpose(0, 2, 1)[..., None]
    ytr = read_idx(files["train_labels"]).astype(np.int32)
    yte = read_idx(files["test_labels"]).astype(np.int32)
    return xtr, ytr, xte, yte


# ---------------------------------------------------------------------------
# ImageFolder trees


def load_image(path: str, size: int | None = None) -> np.ndarray:
    """One image as RGB float32 [h, w, 3] in [0, 1], bilinearly resized to
    ``size`` x ``size`` when given."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None and img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def read_image_folder(root: str, size: int | None = None,
                      cap_per_class: int | None = None):
    """torchvision ImageFolder semantics: each subdirectory of ``root`` is a
    class (sorted name order -> class id), every image file inside belongs
    to it. Returns (x [n, h, w, 3] float32 in [0, 1], y [n] int32,
    class_names) or None."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        return None
    if cap_per_class is None:
        n_files = sum(
            sum(1 for f in os.listdir(os.path.join(root, d))
                if f.lower().endswith(_IMG_EXTS)) for d in classes)
        if n_files > 200_000:  # ~30+ GB at 224px float32
            log.warning(
                "read_image_folder(%s): %d images would be materialized as "
                "host float32 (this reader is for fixture/subset-scale trees; "
                "set cap_per_class)", root, n_files)
    xs, ys = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        files = sorted(f for f in os.listdir(cdir)
                       if f.lower().endswith(_IMG_EXTS))
        if cap_per_class is not None:
            files = files[:cap_per_class]
        for f in files:
            xs.append(load_image(os.path.join(cdir, f), size))
            ys.append(ci)
    if not xs:
        return None
    return np.stack(xs), np.asarray(ys, np.int32), classes


def read_cinic10(data_dir: str, size: int = 32):
    """CINIC-10's folder tree <root>/{train,test}/<class>/*.png (reference
    cinic10/data_loader.py:222-239), with data_dir itself, cinic10/ or
    CINIC-10/ as the root. Returns (xtr, ytr, xte, yte) normalised by
    CINIC-10's channel statistics, or None."""
    for root in (data_dir, os.path.join(data_dir, "cinic10"),
                 os.path.join(data_dir, "CINIC-10")):
        tr, te = os.path.join(root, "train"), os.path.join(root, "test")
        if os.path.isdir(tr) and os.path.isdir(te):
            train = read_image_folder(tr, size)
            test = read_image_folder(te, size)
            if train is None or test is None:
                return None
            mean, std = CINIC10_MEAN, CINIC10_STD
            xtr, ytr, _ = train
            xte, yte, _ = test
            return ((xtr - mean) / std, ytr, (xte - mean) / std, yte)
    return None


def read_imagenet_folder(data_dir: str, size: int = 224,
                         cap_per_class: int | None = None):
    """ILSVRC2012's layout <root>/train/<wnid>/*, <root>/val/<wnid>/*
    (reference ImageNet/datasets.py:81-129). Returns (xtr, ytr, xte, yte,
    class_names) normalised with the ImageNet statistics, or None."""
    tr = os.path.join(data_dir, "train")
    te = os.path.join(data_dir, "val")
    if not (os.path.isdir(tr) and os.path.isdir(te)):
        return None
    train = read_image_folder(tr, size, cap_per_class)
    test = read_image_folder(te, size, cap_per_class)
    if train is None or test is None:
        return None
    mean, std = IMAGENET_MEAN, IMAGENET_STD
    xtr, ytr, classes = train
    xte, yte, _ = test
    return (xtr - mean) / std, ytr, (xte - mean) / std, yte, classes


def list_image_folder_files(root: str):
    """An ImageFolder tree scanned without decoding: (per_class_files,
    class_names), or None. The streaming loaders' entry point: the eager
    ``read_image_folder`` cannot hold an ILSVRC2012-sized tree."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        return None
    per_class = []
    for cname in classes:
        cdir = os.path.join(root, cname)
        per_class.append(sorted(
            os.path.join(cdir, f) for f in os.listdir(cdir)
            if f.lower().endswith(_IMG_EXTS)))
    if not any(per_class):
        return None
    return per_class, classes


# ---------------------------------------------------------------------------
# Google Landmarks (gld23k / gld160k)


def read_landmarks_csv(path: str):
    """user_id,image_id,class rows -> a list of dicts (reference _read_csv,
    Landmarks/data_loader.py:20-29)."""
    import csv

    with open(path) as f:
        rows = list(csv.DictReader(f))
    if rows and not all(c in rows[0] for c in ("user_id", "image_id", "class")):
        raise ValueError(
            "landmarks mapping csv must have user_id,image_id,class columns, "
            f"got {list(rows[0].keys())}")
    return rows


def _landmarks_csvs(data_dir: str, variant: str):
    map_dir = os.path.join(data_dir, "data_user_dict")
    tr_csv = os.path.join(map_dir, f"{variant}_user_dict_train.csv")
    te_csv = os.path.join(map_dir, f"{variant}_user_dict_test.csv")
    if not (os.path.exists(tr_csv) and os.path.exists(te_csv)):
        return None
    return read_landmarks_csv(tr_csv), read_landmarks_csv(te_csv)


def _landmarks_image(data_dir: str, image_id) -> str:
    """<data_dir>/<image_id>.jpg, else <data_dir>/images/<image_id>.jpg."""
    p = os.path.join(data_dir, str(image_id) + ".jpg")
    if not os.path.exists(p):
        p = os.path.join(data_dir, "images", str(image_id) + ".jpg")
    return p


def _by_user(rows) -> list:
    """The train rows grouped by user, users in ascending id order."""
    by_user: dict[int, list] = {}
    for r in rows:
        by_user.setdefault(int(r["user_id"]), []).append(r)
    return [by_user[uid] for uid in sorted(by_user)]


def read_landmarks(data_dir: str, variant: str = "gld23k", size: int = 64):
    """Google Landmarks' user split: csv maps under data_user_dict/, images
    at <data_dir>/<image_id>.jpg (reference datasets.py:49). Returns
    (xtr_list, ytr_list, xte, yte, class_num), one train client a user and a
    pooled test set, or None when the csvs are absent."""
    csvs = _landmarks_csvs(data_dir, variant)
    if csvs is None:
        return None
    tr_rows, te_rows = csvs

    def img(image_id):
        return load_image(_landmarks_image(data_dir, image_id), size)

    xtr, ytr = [], []
    for rows in _by_user(tr_rows):
        xtr.append(np.stack([img(r["image_id"]) for r in rows]))
        ytr.append(np.asarray([int(r["class"]) for r in rows], np.int32))
    xte = np.stack([img(r["image_id"]) for r in te_rows])
    yte = np.asarray([int(r["class"]) for r in te_rows], np.int32)
    class_num = int(max(max(y.max() for y in ytr), yte.max())) + 1
    return xtr, ytr, xte, yte, class_num


def list_landmarks_files(data_dir: str, variant: str = "gld23k"):
    """The Landmarks csvs scanned without decoding: (per_user_files,
    per_user_labels, test_files, test_labels, class_num), or None. Raises
    FileNotFoundError up front when an image the csvs name is absent: a
    lazy decode would otherwise fail mid-run."""
    csvs = _landmarks_csvs(data_dir, variant)
    if csvs is None:
        return None
    tr_rows, te_rows = csvs
    missing = []

    def path_of(image_id):
        p = _landmarks_image(data_dir, image_id)
        if not os.path.exists(p):
            missing.append(str(image_id))
        return p

    files, labels = [], []
    for rows in _by_user(tr_rows):
        files.append([path_of(r["image_id"]) for r in rows])
        labels.append(np.asarray([int(r["class"]) for r in rows], np.int32))
    te_files = [path_of(r["image_id"]) for r in te_rows]
    if missing:
        raise FileNotFoundError(
            f"{variant}: {len(missing)} images named in the csvs are absent "
            f"under {data_dir} (first: {missing[:3]}) — complete the download "
            "before training (a lazy decode would fail mid-run instead)")
    te_labels = np.asarray([int(r["class"]) for r in te_rows], np.int32)
    class_num = int(max(max(int(la.max()) for la in labels), te_labels.max())) + 1
    return files, labels, te_files, te_labels, class_num


# ---------------------------------------------------------------------------
# UCI-HAR Inertial Signals


_HAR_SIGNALS = ("total_acc_x", "total_acc_y", "total_acc_z",
                "body_acc_x", "body_acc_y", "body_acc_z",
                "body_gyro_x", "body_gyro_y", "body_gyro_z")
_HAR_ROOTS = ("", "UCI HAR Dataset", "har")


def _har_root(data_dir: str) -> str | None:
    for sub in _HAR_ROOTS:
        root = os.path.join(data_dir, sub) if sub else data_dir
        if os.path.isdir(os.path.join(root, "train", "Inertial Signals")):
            return root
    return None


def read_har(data_dir: str):
    """UCI HAR Dataset/{train,test}/Inertial Signals/<signal>_<group>.txt,
    whitespace matrices [n, 128] stacked to [n, 128, 9]; labels 1-indexed
    in y_<group>.txt (reference HAR/data_loader.py:132-154). Returns
    (xtr, ytr, xte, yte) or None."""
    root = _har_root(data_dir)
    if root is None:
        return None
    out = []
    for group in ("train", "test"):
        sig_dir = os.path.join(root, group, "Inertial Signals")
        chans = [np.loadtxt(os.path.join(sig_dir, f"{s}_{group}.txt"), dtype=np.float32)
                 for s in _HAR_SIGNALS]
        chans = [c[None, :] if c.ndim == 1 else c for c in chans]
        x = np.stack(chans, axis=-1)  # [n, 128, 9]
        y = np.loadtxt(os.path.join(root, group, f"y_{group}.txt"),
                       dtype=np.int64).reshape(-1).astype(np.int32) - 1
        out += [x, y]
    return tuple(out)


def read_har_subjects(data_dir: str):
    """``read_har`` plus each window's volunteer (subject_{train,test}.txt,
    1-indexed ids made contiguous 0-based per split; reference
    HAR/subject_dataloader.py load_har_data), the grouping variable of the
    har_subject partition. Returns (xtr, ytr, str_, xte, yte, ste) or
    None."""
    base = read_har(data_dir)
    if base is None:
        return None
    xtr, ytr, xte, yte = base
    root = _har_root(data_dir)
    subj = []
    for group in ("train", "test"):
        s = np.loadtxt(os.path.join(root, group, f"subject_{group}.txt"),
                       dtype=np.int64).reshape(-1)
        # train and test hold disjoint volunteer sets; p-hetero groups by
        # unique label, so each split's ids become 0..k-1
        _, s = np.unique(s, return_inverse=True)
        subj.append(s.astype(np.int32))
    return xtr, ytr, subj[0], xte, yte, subj[1]


# ---------------------------------------------------------------------------
# UCIAdult / purchase100 / texas100


def read_adult(data_dir: str):
    """income_proc/{train_val_feat,train_val_label,test_feat,test_label}.npy
    (reference UCIAdult/dataloader.py:38-50), or None."""
    d = os.path.join(data_dir, "income_proc")
    names = ("train_val_feat.npy", "train_val_label.npy",
             "test_feat.npy", "test_label.npy")
    if not all(os.path.exists(os.path.join(d, n)) for n in names):
        return None
    xtr, ytr, xte, yte = (np.load(os.path.join(d, n)) for n in names)
    return (xtr.astype(np.float32), ytr.reshape(-1).astype(np.int32),
            xte.astype(np.float32), yte.reshape(-1).astype(np.int32))


def read_purchase_texas(name: str, data_dir: str, seed: int = 1):
    """<name>_100_not_normalized_{features,labels}.p pickles split 80/20
    (the reference uses sklearn's train_test_split with random_state=1,
    purchase/dataloader.py:21-45; this split is a seeded permutation, the
    JAX package's: the same distribution, not the same index sequence)."""
    stem = {"purchase100": "purchase_100", "texas100": "texas_100"}[name]
    fp = os.path.join(data_dir, f"{stem}_not_normalized_features.p")
    lp = os.path.join(data_dir, f"{stem}_not_normalized_labels.p")
    if not (os.path.exists(fp) and os.path.exists(lp)):
        return None
    with open(fp, "rb") as f:
        x = np.asarray(pickle.load(f), np.float32)
    with open(lp, "rb") as f:
        y = np.asarray(pickle.load(f)).reshape(-1)
    y = y.astype(np.int32)
    if y.min() == 1:  # texas labels are 1-indexed in the published pickles
        y = y - 1
    perm = np.random.RandomState(seed).permutation(len(x))
    k = int(len(x) * 0.8)
    tr, te = perm[:k], perm[k:]
    return x[tr], y[tr], x[te], y[te]


# ---------------------------------------------------------------------------
# hetero-fix pre-recorded partitions


def read_net_dataidx_map(path: str) -> dict[int, list[int]]:
    """The reference's net_dataidx_map.txt: ``<client>: [`` opens a client,
    the comma-separated lines after it list its sample indices, ``]`` ends
    it (reference cifar10/data_loader.py:33-46)."""
    out: dict[int, list[int]] = {}
    key = None
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s[0] in "{}":
                continue
            if s.endswith("["):
                key = int(s.split(":")[0])
                out[key] = []
            elif s[0] != "]":
                out[key] += [int(t) for t in s.replace("]", "").split(",") if t.strip()]
    return out


def read_data_distribution(path: str) -> dict[int, dict[int, int]]:
    """distribution.txt: nested ``<client>: {`` / ``<class>: <count>,``
    blocks (reference cifar10/data_loader.py:18-30)."""
    out: dict[int, dict[int, int]] = {}
    first = None
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s[0] in "{}":
                continue
            k, v = s.split(":", 1)
            if v.strip() == "{":
                first = int(k)
                out[first] = {}
            else:
                out[first][int(k)] = int(v.strip().rstrip(","))
    return out


def find_hetero_fix_map(data_dir: str, dataset: str) -> str | None:
    """The recorded map the reference reads from
    ./data_preprocessing/non-iid-distribution/<DATASET>/net_dataidx_map.txt,
    under data_dir or data_dir/non-iid-distribution, or None."""
    for root in (data_dir, os.path.join(data_dir, "non-iid-distribution")):
        p = os.path.join(root, dataset.upper(), "net_dataidx_map.txt")
        if os.path.exists(p):
            return p
    return None


# ---------------------------------------------------------------------------
# raw_MNIST (LEAF json)


def read_leaf_json_clients(data_dir: str, x_shape=(28, 28, 1)):
    """LEAF-json per-client data: <root>/{train,test}/*.json with 'users' and
    'user_data' {uid: {x: [[784 floats]], y: [ints]}} (reference
    raw_MNIST/data_loader.py:9-50). Returns (xtr_list, ytr_list, xte_list,
    yte_list) in sorted user order, or None."""
    tr_dir = os.path.join(data_dir, "train")
    te_dir = os.path.join(data_dir, "test")
    if not (os.path.isdir(tr_dir) and os.path.isdir(te_dir)):
        return None

    def read(d):
        users, data = [], {}
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".json"):
                with open(os.path.join(d, fn)) as f:
                    j = json.load(f)
                users += j["users"]
                data.update(j["user_data"])
        return users, data

    users, tr = read(tr_dir)
    _, te = read(te_dir)
    if not users:
        return None
    empty = {"x": [], "y": []}
    xtr, ytr, xte, yte = [], [], [], []
    for u in sorted(set(users)):
        for d, xs, ys in ((tr.get(u, empty), xtr, ytr), (te.get(u, empty), xte, yte)):
            xs.append(np.asarray(d["x"], np.float32).reshape((-1,) + x_shape))
            ys.append(np.asarray(d["y"], np.int32))
    return xtr, ytr, xte, yte


# ---------------------------------------------------------------------------
# Pascal VOC segmentation


def read_pascal_voc(data_dir: str, size: int = 64):
    """A VOCdevkit segmentation split: JPEGImages/<id>.jpg with palette-PNG
    masks in SegmentationClass/<id>.png, the split lists under
    ImageSets/Segmentation/{train,val}.txt (the upstream FedSeg layout),
    found at ``data_dir``, ``data_dir/VOCdevkit/VOC2012`` or
    ``data_dir/VOC2012``. Images are resized bilinearly and masks nearest to
    ``size`` x ``size``; masks keep their class ids (255 = the ignored
    border). Returns (xtr, ytr, xte, yte), images ImageNet-normalised, or
    None."""
    from PIL import Image

    root = None
    for cand in (data_dir, os.path.join(data_dir, "VOCdevkit", "VOC2012"),
                 os.path.join(data_dir, "VOC2012")):
        if os.path.isdir(os.path.join(cand, "SegmentationClass")):
            root = cand
            break
    if root is None:
        return None

    def read_split(name):
        with open(os.path.join(root, "ImageSets", "Segmentation", f"{name}.txt")) as f:
            ids = [s.strip() for s in f if s.strip()]
        xs, ys = [], []
        for i in ids:
            img = Image.open(os.path.join(root, "JPEGImages", i + ".jpg")).convert("RGB")
            msk = Image.open(os.path.join(root, "SegmentationClass", i + ".png"))
            img = img.resize((size, size), Image.BILINEAR)
            msk = msk.resize((size, size), Image.NEAREST)
            xs.append(np.asarray(img, np.float32) / 255.0)
            ys.append(np.asarray(msk, np.int32))
        return np.stack(xs), np.stack(ys)

    xtr, ytr = read_split("train")
    xte, yte = read_split("val")
    mean, std = IMAGENET_MEAN, IMAGENET_STD
    return (xtr - mean) / std, ytr, (xte - mean) / std, yte


# ---------------------------------------------------------------------------
# edge-case backdoor sets


def read_southwest(data_dir: str):
    """The southwest-airline poisoned CIFAR images (reference
    edge_case_examples/data_loader.py:346-377: uint8 [n, 32, 32, 3]
    pickles, labelled 9 = truck). Returns (x_train, x_test, target_label)
    with pixels in [0, 1], or None."""
    base = os.path.join(data_dir, "edge_case_examples", "southwest_cifar10")
    tr = os.path.join(base, "southwest_images_new_train.pkl")
    te = os.path.join(base, "southwest_images_new_test.pkl")
    if not (os.path.exists(tr) and os.path.exists(te)):
        return None
    with open(tr, "rb") as f:
        xtr = np.asarray(pickle.load(f))
    with open(te, "rb") as f:
        xte = np.asarray(pickle.load(f))
    return xtr.astype(np.float32) / 255.0, xte.astype(np.float32) / 255.0, 9


# ---------------------------------------------------------------------------
# vertical-FL party datasets (NUS-WIDE / lending club), parsed without pandas

# pandas.read_csv's default NA strings: a field equal to one of them is NaN
_NA_STRINGS = ("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
               "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
               "nan", "null")
# the booleans pandas parses, as the numbers astype(float32) makes of them
_BOOL_STRINGS = {"True": "1", "TRUE": "1", "true": "1", "False": "0", "FALSE": "0",
                 "false": "0"}
_ROWS_A_BLOCK = 4096


def _float_block(rows: list, ncols: int, path: str, first: int) -> np.ndarray:
    """[len(rows), ncols] float64 of text fields: the NA strings NaN, a row
    short of fields NaN-filled, a row with more fields an error (pandas'
    C parser's rules)."""
    for i, r in enumerate(rows):
        if len(r) > ncols:
            raise ValueError(f"{path}: expected {ncols} fields in row {first + i}, "
                             f"saw {len(r)}")
    a = np.array([r + [""] * (ncols - len(r)) for r in rows], dtype=str).reshape(-1, ncols)
    a = np.where(np.isin(a, _NA_STRINGS), "nan", a)
    for text, number in _BOOL_STRINGS.items():
        a = np.where(a == text, number, a)
    return a.astype(np.float64)


def read_table(path: str, sep: str = ",", header: bool = False):
    """(column names or None, float64 [rows, columns]) of a delimited text
    file, as ``pandas.read_csv(path, sep=sep, header=0 if header else
    None)`` then ``.values.astype(np.float64)`` would give them for numeric
    columns: blank lines skipped, each ``sep`` a field boundary (a trailing
    one makes an empty last field), the NA strings and missing fields NaN.
    The width is the header's, or the first row's. Read a block of rows at
    a time, so the text of a large file is never held whole."""
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter=sep)
        names = next(reader) if header else None
        ncols = len(names) if header else None
        blocks, rows, first = [], [], 0
        for row in reader:
            if not row:
                continue  # a blank line
            if ncols is None:
                ncols = len(row)
            rows.append(row)
            if len(rows) == _ROWS_A_BLOCK:
                blocks.append(_float_block(rows, ncols, path, first))
                first += len(rows)
                rows = []
        if rows:
            blocks.append(_float_block(rows, ncols, path, first))
    width = ncols or 0
    return names, (np.concatenate(blocks) if blocks else np.zeros((0, width)))


def _dropna_columns(a: np.ndarray) -> np.ndarray:
    """pandas' ``dropna(axis=1)``: every column holding a NaN goes."""
    return a[:, ~np.isnan(a).any(0)]


def read_nus_wide(data_dir: str, selected_labels=("sky", "clouds", "person", "water",
                                                  "animal"),
                  n_samples: int = -1, three_party: bool = False):
    """NUS-WIDE two- or three-party vertical split (reference
    NUS_WIDE/nus_wide_dataset.py:23-71), the JAX package's pandas reader
    without pandas: party A = the 634 normalized low-level image features
    (Low_Level_Features/<dtype>_Normalized_*.dat, space-separated, the
    files in sorted order), party B = the 1k tag vector
    (NUS_WID_Tags/<dtype>_Tags1k.dat, tab-separated), each file's columns
    that hold any NaN dropped (the empty column a trailing separator makes
    among them); the labels from
    Groundtruth/TrainTestLabels/Labels_<label>_<dtype>.txt, keeping the
    rows with exactly one positive among the selected labels; y = 1 iff the
    first selected label fires. Three parties split the tags in half.
    Returns (parties_train, y_train, parties_test, y_test), or None."""
    if not os.path.isdir(os.path.join(data_dir, "Low_Level_Features")):
        return None

    def load(dtype):
        columns = []
        for label in selected_labels:
            path = os.path.join(data_dir, "Groundtruth", "TrainTestLabels",
                                f"Labels_{label}_{dtype}.txt")
            a = read_table(path)[1]
            if a.shape[1] != 1:
                raise ValueError(f"{path}: {a.shape[1]} columns, one label column expected")
            columns.append(a)
        labels = np.concatenate(columns, axis=1)
        # pandas' row sum skips NaN
        rows = (np.flatnonzero(np.nansum(labels, 1) == 1) if len(selected_labels) > 1
                else np.arange(len(labels)))
        feat_dir = os.path.join(data_dir, "Low_Level_Features")
        xa = np.concatenate([
            _dropna_columns(read_table(os.path.join(feat_dir, f), sep=" ")[1])
            for f in sorted(os.listdir(feat_dir)) if f.startswith(f"{dtype}_Normalized")],
            axis=1)[rows].astype(np.float32)
        tags = _dropna_columns(read_table(
            os.path.join(data_dir, "NUS_WID_Tags", f"{dtype}_Tags1k.dat"), sep="\t")[1])
        xb = tags[rows].astype(np.float32)
        y = (labels[rows, 0] > 0).astype(np.int32)
        if n_samples != -1:
            xa, xb, y = xa[:n_samples], xb[:n_samples], y[:n_samples]
        if three_party:
            half = xb.shape[1] // 2
            return [xa, xb[:, :half], xb[:, half:]], y
        return [xa, xb], y

    ptr, ytr = load("Train")
    pte, yte = load("Test")
    return ptr, ytr, pte, yte


def read_lending_club(data_dir: str, seed: int = 0):
    """Lending-club two-party vertical split (reference
    lending_club_dataset.py:126-155), the JAX package's pandas reader
    without pandas: processed_loan.csv, a header row, the normalized
    feature columns and ``target``; party A = the first half of the
    non-target columns, party B = the rest, shuffled by
    ``RandomState(seed)`` before the 80/20 train/test cut. Returns
    (parties_train, y_train, parties_test, y_test), or None."""
    fp = os.path.join(data_dir, "processed_loan.csv")
    if not os.path.exists(fp):
        return None
    names, a = read_table(fp, header=True)
    y = a[:, names.index("target")].astype(np.int32)
    feat = [i for i, c in enumerate(names) if c != "target"]
    half = len(feat) // 2
    xa = a[:, feat[:half]].astype(np.float32)
    xb = a[:, feat[half:]].astype(np.float32)
    perm = np.random.RandomState(seed).permutation(len(y))
    xa, xb, y = xa[perm], xb[perm], y[perm]
    k = int(0.8 * len(y))
    return [xa[:k], xb[:k]], y[:k], [xa[k:], xb[k:]], y[k:]


def synthetic_vfl_parties(party_dims=(24, 40), n_train: int = 800, n_test: int = 200,
                          seed: int = 0):
    """Seeded surrogate vertical data, the JAX package's bit for bit: a
    shared latent drives every party's features and the label, so VFL
    training is learnable."""
    rng = np.random.RandomState(seed)
    z = rng.normal(size=(n_train + n_test, 8)).astype(np.float32)
    w_y = rng.normal(size=8).astype(np.float32)
    y = (z @ w_y + 0.3 * rng.normal(size=len(z)) > 0).astype(np.int32)
    parties = []
    for d in party_dims:
        proj = rng.normal(size=(8, d)).astype(np.float32)
        x = z @ proj + 0.3 * rng.normal(size=(len(z), d)).astype(np.float32)
        parties.append(x.astype(np.float32))
    tr = [x[:n_train] for x in parties]
    te = [x[n_train:] for x in parties]
    return tr, y[:n_train], te, y[n_train:]
