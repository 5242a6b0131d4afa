"""Raw data sources (the FEMNIST and StackOverflow NWP parts of
``fedml_tpu/data/sources.py``).

Only the seeded surrogates are ported: with the same seed they produce
arrays byte-identical to the JAX package's, from the same numpy
``RandomState`` draws in the same order."""

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


# StackOverflow NWP: 10,000 words + pad/bos/eos/oov, 20-token windows
STACKOVERFLOW_VOCAB, STACKOVERFLOW_SEQ = 10004, 20


def _markov_text_clients(client_num, vocab, seq_len, per_client, test_frac, seed):
    """Surrogate language data: a shared seeded 2-gram transition table (so
    next-token structure is learnable) with per-client start states, and
    per-position next-token targets."""
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
        y = windows[:, 1:].astype(np.int32)
        k = max(1, int(n_i * (1 - test_frac)))
        xtr.append(x[:k]); ytr.append(y[:k]); xte.append(x[k:]); yte.append(y[k:])
    return xtr, ytr, xte, yte


def load_stackoverflow_nwp_clients(data_dir: str = "./data", client_num: int = 200,
                                   seed: int = 0):
    """StackOverflow next-word prediction (reference stackoverflow_nwp/):
    20-token windows over the extended vocab, per-position targets.

    Returns (xtr, ytr, xte, yte), lists of per-client [n_i, seq_len] int32."""
    if (os.path.exists(os.path.join(data_dir, "stackoverflow_train.h5"))
            and os.path.exists(os.path.join(data_dir, "stackoverflow_test.h5"))):
        raise NotImplementedError(
            "reading the TFF StackOverflow h5 files is not ported to "
            "fedml_tpu_torch yet; only the seeded surrogate is")
    log.warning("stackoverflow h5 not found under %s — using seeded surrogate", data_dir)
    return _markov_text_clients(client_num, STACKOVERFLOW_VOCAB, STACKOVERFLOW_SEQ,
                                per_client=64, test_frac=0.15, seed=seed)
