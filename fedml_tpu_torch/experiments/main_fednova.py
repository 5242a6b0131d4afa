"""FedNova experiment main (mirror of ``fedml_tpu/experiments/main_fednova.py``;
reference fedml_experiments/standalone/fednova/). FedProx is its
``--fedprox_mu`` flag (reference fednova.py:124-126).

Usage:
  python -m fedml_tpu_torch.experiments.main_fednova --dataset femnist \
      --model cnn --client_num_in_total 3400 --client_num_per_round 10 \
      --batch_size 20 --lr 0.1 --comm_round 100 --fedprox_mu 0.01
"""

from __future__ import annotations

from fedml_tpu_torch.experiments.main_fedavg import main as fedavg_main


def main(argv=None):
    return fedavg_main(argv, aggregator_name="fednova")


if __name__ == "__main__":
    main()
