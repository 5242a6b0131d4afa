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

FedML's benchmark rows beyond FEMNIST (``fedml_tpu/experiments/configs/``):
  cross-silo CIFAR-10 ResNet-56 (BatchNorm state carried and averaged):
      --dataset cifar10 --model resnet56 --partition_method hetero \
      --client_num_in_total 10 --client_num_per_round 10 --comm_round 100 \
      --epochs 20 --batch_size 64 --lr 0.001 --momentum 0.9 --wd 0.0001
  fed_CIFAR-100 ResNet-18-GN: --dataset fed_cifar100 --model resnet18_gn \
      --client_num_in_total 500 --client_num_per_round 10 --batch_size 20 --lr 0.1
  Shakespeare LSTM: --dataset shakespeare --model rnn --client_num_in_total 715 \
      --client_num_per_round 10 --batch_size 10 --lr 0.8
  (``--dataset fed_shakespeare`` trains it per position with NWPTrainer)
With no flags but ``--device cpu`` it runs MNIST logistic regression.
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
    extra_load = {}
    if args.dataset == "mnist":
        # the reference feeds lr a flat 784 vector and the CNNs 28x28
        # images (standalone main_fedavg.py:318-325)
        extra_load["flatten"] = args.model in ("lr", "mlp")
    ds = load_dataset(args.dataset, data_dir=args.data_dir,
                      client_num_in_total=args.client_num_in_total,
                      partition_method=args.partition_method,
                      partition_alpha=args.partition_alpha, seed=args.seed, **extra_load)
    name, model_kwargs = contextual_model(args)
    module = create_model(name, output_dim=ds.class_num, dtype=cfg.dtype,
                          input_shape=ds.train.x.shape[2:], **model_kwargs)
    # task trainer by dataset (reference FedAvgAPI.py:33-39)
    if ds.meta.get("task") == "nwp" or args.dataset in ("fed_shakespeare",
                                                       "stackoverflow_nwp"):
        return cfg, ds, NWPTrainer(module, pad_id=0)
    return cfg, ds, ClassificationTrainer(module)


def contextual_model(args) -> tuple[str, dict]:
    """(model name, model kwargs) by dataset, as the JAX CLI dispatches
    (``fedml_tpu/experiments/common.py:316-331``; reference standalone
    main_fedavg.py:315-340): Shakespeare gets the 90-character vocab and
    per-position logits for fed_shakespeare; ``cnn`` on har is HAR_CNN and
    on cifar10 CNNCifar."""
    kwargs = {}
    if args.dataset in ("shakespeare", "fed_shakespeare"):
        kwargs = {"vocab_size": 90, "per_position": args.dataset == "fed_shakespeare"}
    name = args.model
    if name == "cnn":
        if args.dataset in ("har", "har_subject"):
            name = "har_cnn"
        elif args.dataset == "cifar10":
            name = "cnn_cifar"
    return name, kwargs


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
