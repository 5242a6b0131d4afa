"""SplitNN experiment main (mirror of
``fedml_tpu/experiments/main_split_nn.py``; reference
fedml_experiments/distributed/split_nn/main_split_nn.py: round-robin split
learning over a client pool). Takes ``main_fedavg``'s flags and
``--split_width``; the history records go to ``--run_dir`` in wandb's file
layout.

Usage:
  python -m fedml_tpu_torch.experiments.main_split_nn --dataset cifar10 \
      --client_num_in_total 4 --comm_round 5 --epochs 1 --batch_size 32 \
      [--device cpu]
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.algorithms.splitnn import SplitLowerCNN, SplitNNAPI, SplitUpperCNN
from fedml_tpu_torch.experiments.main_fedavg import add_args, setup_run
from fedml_tpu_torch.utils.logging import MetricsLogger


def build_api(args) -> SplitNNAPI:
    """The run's SplitNNAPI from parsed flags: the lower half at
    ``--split_width`` over the dataset's images, the upper half over its
    activations (two 2x2 pools: a quarter of each side, 2 * width
    channels)."""
    cfg, ds, _trainer = setup_run(args)
    h, w, c = ds.train.x.shape[2:]
    lower = SplitLowerCNN(width=args.split_width, in_channels=c)
    upper = SplitUpperCNN((h // 4) * (w // 4) * 2 * args.split_width, output_dim=ds.class_num)
    return SplitNNAPI(ds, cfg, lower, upper, device=args.device)


def main(argv=None):
    parser = add_args(argparse.ArgumentParser())
    parser.add_argument("--split_width", type=int, default=16)
    args = parser.parse_args(argv)
    api = build_api(args)
    logger = MetricsLogger(run_dir=args.run_dir, config=vars(args))
    history = api.train()
    final = api.evaluate()
    for r, rec in enumerate(history):
        logger.log({k: v for k, v in rec.items() if k != "round"}, step=r)
    logger.log(final, step=len(history))
    logger.finish()
    return history


if __name__ == "__main__":
    main()
