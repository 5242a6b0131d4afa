"""FedGKT experiment main (mirror of ``fedml_tpu/experiments/main_fedgkt.py``;
reference fedml_experiments/distributed/fedgkt/main_fedgkt.py: the edge
ResNet-8 and server ResNet-55 group knowledge transfer). Takes
``main_fedavg``'s flags and the reference's ``--epochs_server``,
``--temperature`` and ``--alpha``; the history records go to ``--run_dir``
in wandb's file layout.

Usage:
  python -m fedml_tpu_torch.experiments.main_fedgkt --dataset cifar10 \
      --client_num_in_total 8 --comm_round 10 --epochs 1 --epochs_server 2 \
      [--client_sample_cap 256] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI
from fedml_tpu_torch.data.packing import PackedClients
from fedml_tpu_torch.experiments.main_fedavg import add_args, setup_run
from fedml_tpu_torch.models.resnet_gkt import GKTClientResNet, GKTServerResNet
from fedml_tpu_torch.utils.logging import MetricsLogger


def add_gkt_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    # the reference main_fedgkt's flags (--epochs_server, --temperature, --alpha)
    parser.add_argument("--epochs_server", type=int, default=2)
    parser.add_argument("--temperature", type=float, default=3.0)
    parser.add_argument("--alpha", type=float, default=1.0)
    parser.add_argument("--client_blocks", type=int, default=1)
    parser.add_argument("--server_blocks", type=int, nargs=3, default=None)
    parser.add_argument("--client_sample_cap", type=int, default=None,
                        help="truncate each client's local data to N samples "
                             "(quick experiments / CI; GKT trains the FULL "
                             "federation every round, so work scales with "
                             "total samples, not clients-per-round)")
    return parser


def cap_clients(ds, cap: int):
    """``ds`` with every client's rows cut to ``cap`` and the test set to
    512 rows, as the JAX main's ``--client_sample_cap`` cuts them."""
    return dataclasses.replace(
        ds, train=PackedClients(ds.train.x[:, :cap], ds.train.y[:, :cap],
                                np.minimum(ds.train.counts, cap)),
        test_global=(ds.test_global[0][:512], ds.test_global[1][:512]))


def build_api(args) -> FedGKTAPI:
    """The run's FedGKTAPI from parsed flags (data, models, config)."""
    cfg, ds, _trainer = setup_run(args)
    if args.client_sample_cap:
        ds = cap_clients(ds, args.client_sample_cap)
    in_channels = ds.train.x.shape[-1]
    client = GKTClientResNet(output_dim=ds.class_num, num_blocks=args.client_blocks,
                             in_channels=in_channels)
    server_kw = {"output_dim": ds.class_num}
    if args.server_blocks:
        server_kw["layers"] = tuple(args.server_blocks)
    return FedGKTAPI(ds, cfg, client, GKTServerResNet(**server_kw), alpha=args.alpha,
                     temperature=args.temperature, server_epochs=args.epochs_server,
                     device=args.device)


def main(argv=None):
    args = add_gkt_args(add_args(argparse.ArgumentParser())).parse_args(argv)
    api = build_api(args)
    logger = MetricsLogger(run_dir=args.run_dir, config=vars(args))
    history = api.train(ckpt_dir=args.ckpt_dir)
    final = api.evaluate()
    for r, rec in enumerate(history):
        logger.log({k: v for k, v in rec.items() if k != "round"}, step=r)
    logger.log(final, step=len(history))
    logger.finish()
    return history


if __name__ == "__main__":
    main()
