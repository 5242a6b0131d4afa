"""TurboAggregate experiment main (mirror of
``fedml_tpu/experiments/main_turboaggregate.py``; reference fedml_experiments
distributed turboaggregate launch: FedAvg training under secure multi-group
circular aggregation, the server reconstructing only the group-ring share
sum). Takes ``main_fedavg``'s flags.

Usage:
  python -m fedml_tpu_torch.experiments.main_turboaggregate --dataset mnist \
      --model lr --client_num_in_total 8 --client_num_per_round 8 \
      --num_groups 2 --comm_round 3 [--device cpu]
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregateAPI
from fedml_tpu_torch.experiments.main_fedavg import add_args, setup_run
from fedml_tpu_torch.utils.logging import MetricsLogger


def main(argv=None):
    parser = add_args(argparse.ArgumentParser())
    parser.add_argument("--num_groups", type=int, default=2)
    parser.add_argument("--privacy_threshold", type=int, default=None)
    parser.add_argument("--frac_bits", type=int, default=16)
    args = parser.parse_args(argv)
    cfg, ds, trainer = setup_run(args)
    logger = MetricsLogger(run_dir=args.run_dir, config=vars(args))
    api = TurboAggregateAPI(ds, cfg, trainer, num_groups=args.num_groups,
                            threshold=args.privacy_threshold, frac_bits=args.frac_bits,
                            device=args.device)
    history = api.train(metrics_logger=logger)
    logger.finish()
    return history


if __name__ == "__main__":
    main()
