"""Robust FedAvg experiment main (mirror of
``fedml_tpu/experiments/main_fedavg_robust.py``; reference
fedml_experiments/distributed/fedavg_robust/ + FedAvgRobustAggregator.py:
14-112): norm-clipping and weak-DP noise in the aggregation, under an
active backdoor attacker, with the poisoned task scored beside the main
task.

The attackers, the first ``--attacker_num`` clients, poison
``--poison_frac`` of their samples with the pixel trigger (the reference's
edge-case pickles apply to CIFAR-shaped data, which no loader of the port
serves yet). After training, the final model's main-task accuracy and
backdoor success rate go through the metrics logger into the run
directory's ``wandb-summary.json`` (as in the JAX CLI) and are merged into
the last history record.

Usage (the FEMNIST flagship through the fused kernel):
  python -m fedml_tpu_torch.experiments.main_fedavg_robust --dataset femnist \
      --model cnn --client_num_in_total 30 --client_num_per_round 10 \
      --batch_size 20 --lr 0.1 --comm_round 10 --fused_kernel 1
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from fedml_tpu_torch.algorithms.backdoor import backdoor_metrics, poison_client_data
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.experiments.main_fedavg import add_args, setup_run
from fedml_tpu_torch.utils.logging import MetricsLogger

log = logging.getLogger(__name__)


def _extra(parser: argparse.ArgumentParser):
    parser.add_argument("--norm_bound", type=float, default=5.0)
    parser.add_argument("--stddev", type=float, default=0.025)
    parser.add_argument("--attacker_num", type=int, default=1)
    parser.add_argument("--poison_frac", type=float, default=0.5)
    parser.add_argument("--target_label", type=int, default=9)
    parser.add_argument("--trigger_size", type=int, default=3)


def main(argv=None):
    parser = add_args(argparse.ArgumentParser())
    _extra(parser)
    args = parser.parse_args(argv)
    cfg, ds, trainer = setup_run(args)
    logger = MetricsLogger(run_dir=args.run_dir, config=vars(args))

    # poison the attackers' packed rows (reference load_poisoned_dataset)
    rng = np.random.RandomState(cfg.seed)
    for k in range(min(args.attacker_num, ds.train.num_clients)):
        ds.train.x[k], ds.train.y[k] = poison_client_data(
            ds.train.x[k], ds.train.y[k], int(ds.train.counts[k]),
            args.target_label, args.poison_frac, args.trigger_size, rng)

    api = FedAvgAPI(ds, cfg, trainer, aggregator_name="robust", device=args.device)
    history = api.train(ckpt_dir=args.ckpt_dir, metrics_logger=logger)

    # the poisoned-task eval (reference test(..., mode="targetted-task"))
    def predict(x):
        return trainer.apply(api.global_variables,
                             torch.from_numpy(np.ascontiguousarray(x)).to(api.device))[0]

    xte, yte = ds.test_global
    n = min(len(yte), 2048)
    metrics = backdoor_metrics(predict, xte[:n], yte[:n], args.target_label,
                               args.trigger_size)
    log.info("backdoor eval after round %d: %s", cfg.comm_round - 1, metrics)
    logger.log(metrics, step=cfg.comm_round)
    logger.finish()
    history[-1].update(metrics)
    return history


if __name__ == "__main__":
    main()
