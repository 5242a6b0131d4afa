"""Vertical FL experiment main (mirror of ``fedml_tpu/experiments/main_vfl.py``;
reference fedml_experiments/distributed/classical_vertical_fl/main_vfl.py:
a guest and hosts hold disjoint feature columns of the same rows).

A 9-tuple dataset (``adult``, ``mnist``, ...) is column-split across
``--party_num`` parties, its label made binary (class > 0); ``nus_wide``
and ``lending_club`` come split by party (``data/loaders.py::
load_vfl_parties``). ``--model lr`` trains the classical linear parties,
``--model dense`` the reference's LocalModel + DenseModel stack.

Usage:
  python -m fedml_tpu_torch.experiments.main_vfl --dataset lending_club \
      --model dense --epochs 4 --batch_size 64 --lr 0.05 [--device cpu]
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from fedml_tpu_torch.algorithms.vfl import NeuralVFLAPI, VerticalFederatedLearningAPI
from fedml_tpu_torch.data.loaders import load_vfl_parties
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.utils.logging import MetricsLogger


def add_vfl_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--dataset", type=str, default="adult",
                        help="9-tuple datasets are column-split across --party_num "
                             "parties; 'nus_wide' / 'lending_club' are natively "
                             "party-split")
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--party_num", type=int, default=3)
    parser.add_argument("--model", type=str, default="lr", choices=["lr", "dense"],
                        help="lr = classical linear parties; dense = the reference's "
                             "LocalModel+DenseModel neural stack")
    parser.add_argument("--hidden_dim", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    parser.add_argument("--run_dir", type=str, default="./wandb/latest-run/files")
    return parser


def load_parties(args):
    """(parties_train, y_train, parties_test, y_test) of the run's dataset;
    ``args.party_num`` is set to the parties a natively split dataset has."""
    if args.dataset in ("nus_wide", "lending_club"):
        ptr, ytr, pte, yte = load_vfl_parties(args.dataset, data_dir=args.data_dir,
                                              seed=args.seed,
                                              three_party=args.party_num >= 3)
        if len(ptr) != args.party_num:
            # these datasets fix the party structure (nus_wide: 2 or 3,
            # lending_club: 2): record what ran
            logging.getLogger(__name__).warning(
                "%s provides %d parties; requested --party_num %d ignored",
                args.dataset, len(ptr), args.party_num)
            args.party_num = len(ptr)
        return list(ptr), ytr, list(pte), yte
    ds = load_dataset(args.dataset, data_dir=args.data_dir, client_num_in_total=2,
                      seed=args.seed)
    xtr, ytr = ds.train_global
    xte, yte = ds.test_global
    xtr = xtr.reshape(len(xtr), -1)
    xte = xte.reshape(len(xte), -1)
    ytr = (np.asarray(ytr) > 0).astype(np.int32)  # the guest's binary label
    yte = (np.asarray(yte) > 0).astype(np.int32)
    # party k owns a contiguous column slice (the reference's vfl_fixture
    # splits the design matrix across the guest and the hosts)
    cols = np.array_split(np.arange(xtr.shape[1]), args.party_num)
    return [xtr[:, c] for c in cols], ytr, [xte[:, c] for c in cols], yte


def main(argv=None):
    args = add_vfl_args(argparse.ArgumentParser()).parse_args(argv)
    parties_tr, ytr, parties_te, yte = load_parties(args)
    logger = MetricsLogger(run_dir=args.run_dir, config=vars(args))
    if args.model == "dense":
        api = NeuralVFLAPI([x.shape[1] for x in parties_tr], hidden_dim=args.hidden_dim,
                           lr=args.lr, seed=args.seed, device=args.device)
        api.fit(parties_tr, ytr, epochs=args.epochs, batch_size=args.batch_size,
                seed=args.seed)
        out = {"Train/Acc": api.score(parties_tr, ytr), "Test/Acc": api.score(parties_te, yte)}
    else:
        xtr = np.concatenate(parties_tr, axis=1)
        xte = np.concatenate(parties_te, axis=1)
        offs = np.cumsum([0] + [x.shape[1] for x in parties_tr])
        splits = [np.arange(offs[i], offs[i + 1]) for i in range(len(parties_tr))]
        api = VerticalFederatedLearningAPI(splits, lr=args.lr, seed=args.seed,
                                           device=args.device)
        api.fit(xtr, ytr, epochs=args.epochs, batch_size=args.batch_size, seed=args.seed)
        out = {"Train/Acc": api.score(xtr, ytr), "Test/Acc": api.score(xte, yte)}
    out["Train/Loss"] = api.loss_history[-1] if api.loss_history else float("nan")
    logger.log(out, step=args.epochs)
    logger.finish()
    print(out)
    return out


if __name__ == "__main__":
    main()
