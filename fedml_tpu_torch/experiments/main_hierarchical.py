"""Hierarchical FL experiment main (mirror of
``fedml_tpu/experiments/main_hierarchical.py``; reference
fedml_experiments/standalone/hierarchical_fl/: ``--group_num`` /
``--group_comm_round``). Takes ``main_fedavg``'s flags; the history records
go to ``--run_dir`` in wandb's file layout.

Usage:
  python -m fedml_tpu_torch.experiments.main_hierarchical --dataset mnist \
      --model lr --client_num_in_total 4 --comm_round 2 --batch_size 16 \
      --lr 0.1 --group_num 2 --group_comm_round 2 [--device cpu]
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.algorithms.hierarchical import HierarchicalFLAPI
from fedml_tpu_torch.experiments.main_fedavg import add_args, setup_run
from fedml_tpu_torch.utils.logging import MetricsLogger


def main(argv=None):
    parser = add_args(argparse.ArgumentParser())
    parser.add_argument("--group_num", type=int, default=2)
    parser.add_argument("--group_comm_round", type=int, default=1)
    args = parser.parse_args(argv)
    cfg, ds, trainer = setup_run(args)
    logger = MetricsLogger(run_dir=args.run_dir, config=vars(args))
    api = HierarchicalFLAPI(ds, cfg, trainer, group_num=args.group_num,
                            group_comm_round=args.group_comm_round, device=args.device)
    history = api.train()
    for rec in history:
        logger.log({k: v for k, v in rec.items() if k != "round"}, step=rec["round"])
    logger.finish()
    return history


if __name__ == "__main__":
    main()
