"""Base-framework smoke main (mirror of ``fedml_tpu/experiments/main_base.py``;
reference fedml_experiments/distributed/base/, the CI framework smoke test
target, CI-script-framework.sh:16-23). Client i's value in round r is
i + r, so the defaults print ``[6.0, 10.0, 14.0]``.

Usage:
  python -m fedml_tpu_torch.experiments.main_base [--client_num 4] \
      [--comm_round 3] [--device cpu]
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.algorithms.base_framework import FedML_Base_simulated


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--client_num", type=int, default=4)
    parser.add_argument("--comm_round", type=int, default=3)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)
    out = FedML_Base_simulated(args.client_num, lambda i, r: float(i + r),
                               args.comm_round, device=args.device)
    print("aggregated:", out)
    return out


if __name__ == "__main__":
    main()
