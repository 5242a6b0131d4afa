"""FedOpt experiment main (mirror of ``fedml_tpu/experiments/main_fedopt.py``;
reference fedml_experiments/distributed/fedopt/main_fedopt.py:54-60): the
FedAvg flags plus the server optimizer.

Usage (FedAdam on StackOverflow next-word prediction):
  python -m fedml_tpu_torch.experiments.main_fedopt --dataset stackoverflow_nwp \
      --model transformer_nwp --client_num_in_total 200 \
      --client_num_per_round 50 --batch_size 16 --lr 0.3 --comm_round 100 \
      --server_optimizer adam --server_lr 0.01
"""

from __future__ import annotations

from fedml_tpu_torch.experiments.main_fedavg import main as fedavg_main


def _extra(parser):
    parser.add_argument("--server_optimizer", type=str, default="adam")
    parser.add_argument("--server_lr", type=float, default=0.001)
    parser.add_argument("--server_momentum", type=float, default=0.0)


def main(argv=None):
    return fedavg_main(argv, aggregator_name="fedopt", extra_args=_extra)


if __name__ == "__main__":
    main()
