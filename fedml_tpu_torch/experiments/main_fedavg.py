"""FedAvg experiment main of the PyTorch port (mirror of
``fedml_tpu/experiments/main_fedavg.py`` with the subset of
``experiments/common.py``'s flags that the port runs).

Usage (the flagship, through the fused CUDA kernel):
  python -m fedml_tpu_torch.experiments.main_fedavg --dataset femnist \
      --model cnn --client_num_in_total 3400 --client_num_per_round 10 \
      --batch_size 20 --lr 0.1 --comm_round 100 --fused_kernel 1

Next-word prediction with the transformer LM (through the flash-attention
kernels):
  python -m fedml_tpu_torch.experiments.main_fedavg --dataset stackoverflow_nwp \
      --model transformer_nwp --client_num_in_total 200 \
      --client_num_per_round 50 --batch_size 16 --lr 0.3 --comm_round 100
"""

from __future__ import annotations

import argparse
import logging
import random

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import ClassificationTrainer, NWPTrainer
from fedml_tpu_torch.data.registry import load_dataset
from fedml_tpu_torch.models.registry import create_model


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The reference's add_args (main_fedavg.py:46-112), ported subset."""
    parser.add_argument("--model", type=str, default="lr")
    parser.add_argument("--dataset", type=str, default="mnist")
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--partition_method", type=str, default="hetero")
    parser.add_argument("--partition_alpha", type=float, default=0.5)
    parser.add_argument("--client_num_in_total", type=int, default=10)
    parser.add_argument("--client_num_per_round", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=10)
    parser.add_argument("--client_optimizer", type=str, default="sgd")
    parser.add_argument("--lr", type=float, default=0.03)
    parser.add_argument("--wd", type=float, default=0.0)
    parser.add_argument("--momentum", type=float, default=0.0)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--comm_round", type=int, default=10)
    parser.add_argument("--frequency_of_the_test", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ci", type=int, default=0)
    parser.add_argument("--fedprox_mu", type=float, default=0.0)
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--fused_kernel", type=int, default=0,
                        help="1 = run the local epoch through the fused CUDA "
                             "kernel (femnist CNN_DropOut only)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    return parser


def setup_run(args):
    """Seeds + logging + data + model + trainer."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    d = {k: v for k, v in vars(args).items()
         if k not in ("data_dir", "device") and v is not None}
    d["fused_kernel"] = bool(d.get("fused_kernel", 0))
    cfg = FedConfig.from_dict(d)
    ds = load_dataset(args.dataset, data_dir=args.data_dir,
                      client_num_in_total=args.client_num_in_total,
                      partition_method=args.partition_method,
                      partition_alpha=args.partition_alpha, seed=args.seed)
    module = create_model(args.model, output_dim=ds.class_num, dtype=cfg.dtype)
    # task trainer by dataset (reference FedAvgAPI.py:33-39)
    if ds.meta.get("task") == "nwp":
        return cfg, ds, NWPTrainer(module, pad_id=0)
    return cfg, ds, ClassificationTrainer(module)


def main(argv=None, aggregator_name: str = "fedavg", extra_args=None):
    """Parse ``argv`` (with the flags ``extra_args(parser)`` adds), train
    with ``aggregator_name`` and return the history."""
    parser = add_args(argparse.ArgumentParser())
    if extra_args:
        extra_args(parser)
    args = parser.parse_args(argv)
    cfg, ds, trainer = setup_run(args)
    api = FedAvgAPI(ds, cfg, trainer, aggregator_name=aggregator_name,
                    device=args.device)
    return api.train()


if __name__ == "__main__":
    main()
