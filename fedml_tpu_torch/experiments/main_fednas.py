"""FedNAS experiment main (mirror of ``fedml_tpu/experiments/main_fednas.py``;
reference fedml_experiments/distributed/fednas/). Takes ``main_fedavg``'s
flags (``--model`` is not read: the model is the DARTS search network) and
the search's own; the history and the last genotype go to ``--run_dir`` in
wandb's file layout, and ``--ckpt_dir`` resumes.

Usage:
  python -m fedml_tpu_torch.experiments.main_fednas --dataset cifar10 \
      --client_num_in_total 4 --client_num_per_round 4 --comm_round 2 \
      --batch_size 64 --lr 0.025 --momentum 0.9 --wd 3e-4 \
      [--init_channels 16 --layers 8] [--unrolled 1 | --gdas 1] [--device cpu]
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.algorithms.fednas import FedNASAPI
from fedml_tpu_torch.experiments.main_fedavg import add_args, setup_run
from fedml_tpu_torch.utils.logging import MetricsLogger


def add_nas_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--init_channels", type=int, default=8)
    parser.add_argument("--layers", type=int, default=4)
    # the cell's size (reference model_search.py Network(steps, multiplier))
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--multiplier", type=int, default=4)
    parser.add_argument("--arch_lr", type=float, default=3e-4)
    parser.add_argument("--unrolled", type=int, default=0)
    # GDAS (reference model_search_gdas.py): hard gumbel-softmax sampling
    # of the architecture at temperature tau
    parser.add_argument("--gdas", type=int, default=0)
    parser.add_argument("--tau", type=float, default=5.0)
    return parser


def main(argv=None):
    args = add_nas_args(add_args(argparse.ArgumentParser())).parse_args(argv)
    cfg, ds, _ = setup_run(args)
    logger = MetricsLogger(run_dir=args.run_dir, config=vars(args))
    api = FedNASAPI(ds, cfg, channels=args.init_channels, layers=args.layers,
                    arch_lr=args.arch_lr, unrolled=bool(args.unrolled),
                    gdas=bool(args.gdas), tau=args.tau, steps=args.steps,
                    multiplier=args.multiplier, device=args.device)
    history = api.train(ckpt_dir=args.ckpt_dir)
    for rec in history:
        logger.log({"search_loss": rec["search_loss"],
                    "search_acc": rec["search_acc"]}, step=rec["round"])
    # the reference records the genotype every round (FedNASAggregator.py:173)
    logger.log({"genotype": str(api.genotype_history[-1])})
    logger.finish()
    return history


if __name__ == "__main__":
    main()
