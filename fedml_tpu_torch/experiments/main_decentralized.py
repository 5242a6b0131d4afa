"""Decentralized online-learning experiment main (mirror of
``fedml_tpu/experiments/main_decentralized.py``; reference
fedml_experiments/standalone/decentralized/: DSGD or push-sum over ring
topologies on streaming data). The stream is generated from ``--seed``: a
random linear 2-class task over ``--dim`` features, ``--iterations`` samples
a node. Logs ``regret`` and ``final_loss`` to ``--run_dir``.

Usage:
  python -m fedml_tpu_torch.experiments.main_decentralized --client_number 8 \
      --iterations 100 --mode pushsum --b_symmetric 0 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from fedml_tpu_torch.algorithms.decentralized import DecentralizedFLAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.topology import AsymmetricTopologyManager, SymmetricTopologyManager
from fedml_tpu_torch.core.trainer import ClassificationTrainer
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.utils.logging import MetricsLogger


def make_stream(client_number: int, iterations: int, dim: int, seed: int) -> tuple:
    """(x [N, T, dim] float32, y [N, T] int32): the JAX main's draws."""
    rng = np.random.RandomState(seed)
    w = rng.normal(size=(dim, 2)).astype(np.float32)
    x = rng.normal(size=(client_number, iterations, dim)).astype(np.float32)
    return x, np.argmax(x @ w, axis=-1).astype(np.int32)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--client_number", type=int, default=8)
    parser.add_argument("--iterations", type=int, default=100)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--neighbor_num", type=int, default=4)
    parser.add_argument("--mode", type=str, default="dsgd", choices=["dsgd", "pushsum"])
    parser.add_argument("--b_symmetric", type=int, default=1)
    parser.add_argument("--dim", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--backend", type=str, default="vmap", choices=["vmap", "shard_map"])
    parser.add_argument("--run_dir", type=str, default="./wandb/latest-run/files")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)

    x, y = make_stream(args.client_number, args.iterations, args.dim, args.seed)
    cfg = FedConfig(lr=args.lr, seed=args.seed, backend=args.backend)
    if args.b_symmetric:
        topo = SymmetricTopologyManager(args.client_number, args.neighbor_num)
    else:
        topo = AsymmetricTopologyManager(args.client_number, args.neighbor_num,
                                         args.neighbor_num, np.random.RandomState(args.seed))
    trainer = ClassificationTrainer(create_model("lr", output_dim=2, input_shape=(args.dim,)))
    api = DecentralizedFLAPI(trainer, cfg, topo, push_sum=(args.mode == "pushsum"),
                             device=args.device)
    api.run(x, y)
    logger = MetricsLogger(run_dir=args.run_dir, config=vars(args))
    logger.log({"regret": api.regret(), "final_loss": api.loss_history[-1]})
    logger.finish()
    return api.loss_history


if __name__ == "__main__":
    main()
