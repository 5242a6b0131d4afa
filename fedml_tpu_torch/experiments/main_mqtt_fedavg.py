"""FedAvg over MQTT, the mobile deployment mode as a CLI: the port's form
of ``fedml_tpu/experiments/main_mqtt_fedavg.py``.

A single-host simulation of the reference's is_mobile path (reference
FedAvgClientManager.py:148-156 + mqtt_comm_manager.py:14-125): an
in-process broker, a server actor and one worker actor per sampled client
exchange real MQTT frames with list-encoded model payloads; each worker's
local SGD is the port's engine step on ``--device`` (``cuda`` by default).
Point --broker_host/--broker_port at an external broker to span processes
or machines instead.

Usage:
  python -m fedml_tpu_torch.experiments.main_mqtt_fedavg --dataset mnist --model lr \\
      --client_num_in_total 4 --client_num_per_round 2 --comm_round 3 [--device cpu]
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.comm.mqtt_fedavg import run_mqtt_fedavg
from fedml_tpu_torch.experiments.main_fedavg import add_args, setup_run
from fedml_tpu_torch.utils.logging import MetricsLogger


def main(argv=None):
    parser = add_args(argparse.ArgumentParser())
    parser.add_argument("--broker_host", type=str, default=None,
                        help="external MQTT broker (default: in-process)")
    parser.add_argument("--broker_port", type=int, default=1883)
    args = parser.parse_args(argv)
    cfg, ds, trainer = setup_run(args)
    logger = MetricsLogger(run_dir=args.run_dir, config=vars(args))
    _, history = run_mqtt_fedavg(
        ds, trainer, cfg, host=args.broker_host,
        port=args.broker_port if args.broker_host else None, device=args.device)
    for rec in history:
        out = {"round": rec["round"]}
        if "test_acc" in rec:
            out["Test/Acc"] = rec["test_acc"]
            out["Test/Loss"] = rec["test_loss"]
        logger.log(out, step=rec["round"])
    logger.finish()
    return history


if __name__ == "__main__":
    main()
