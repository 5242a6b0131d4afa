"""Raw data sources (the FEMNIST part of ``fedml_tpu/data/sources.py``).

Only the seeded surrogate is ported: with the same seed it produces arrays
byte-identical to the JAX package's, from the same numpy ``RandomState``
draws in the same order."""

from __future__ import annotations

import logging
import os

import numpy as np

log = logging.getLogger(__name__)


def load_femnist_arrays(data_dir: str = "./data", client_num: int = 3400, seed: int = 0):
    """FederatedEMNIST: per-writer natural split, 62 classes, 28x28.

    Returns (xtr, ytr, xte, yte), lists of per-client arrays
    [n_i, 28, 28, 1] float32 / [n_i] int32."""
    if (os.path.exists(os.path.join(data_dir, "fed_emnist_train.h5"))
            and os.path.exists(os.path.join(data_dir, "fed_emnist_test.h5"))):
        raise NotImplementedError(
            "reading the TFF FEMNIST h5 files is not ported to "
            "fedml_tpu_torch yet; only the seeded surrogate is")
    log.warning("FEMNIST h5 not found under %s — using seeded surrogate", data_dir)
    rng = np.random.RandomState(seed)
    protos = rng.normal(0.0, 1.0, size=(62, 28, 28, 1)).astype(np.float32)
    xtr, ytr, xte, yte = [], [], [], []
    for _ in range(client_num):
        # unbalanced natural splits: lognormal-ish sizes around the TFF
        # per-writer mean (~227 train / ~26 test samples)
        n_i = int(np.clip(rng.lognormal(4.6, 0.45), 16, 480))
        t_i = max(2, n_i // 9)
        y_i = rng.randint(0, 62, size=n_i + t_i).astype(np.int32)
        x_i = protos[y_i] * 0.6 + rng.normal(0, 0.35, size=(n_i + t_i, 28, 28, 1)).astype(np.float32)
        xtr.append(x_i[:n_i].astype(np.float32))
        ytr.append(y_i[:n_i])
        xte.append(x_i[n_i:].astype(np.float32))
        yte.append(y_i[n_i:])
    return xtr, ytr, xte, yte
