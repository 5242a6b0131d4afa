"""Where the time of an NWP FedAvg round goes on the card.

    python -m fedml_tpu_torch.experiments.profile_nwp [--rounds 2] [--dtype float32]

The StackOverflow NWP surrogate (200 clients), the transformer LM at full
width (vocab 10,004, d_model 128, 4 heads, 2 layers), NWPTrainer, 50
clients a round, batch 16, lr 0.3, clip 1.0: one warm-up round of
``FedAvgAPI.train_one_round`` (sampling, host-to-device copy, the engine's
local SGD, aggregation, the metrics fetch), then ``--rounds`` rounds under
``torch.profiler``. Prints the card's name and power limit, each kernel's
device time per round and the device's busy share of the wall time.
Needs a GPU.
"""

from __future__ import annotations

import argparse
import subprocess

from fedml_tpu_torch import FedAvgAPI, FedConfig, NWPTrainer, create_model, load_dataset
from fedml_tpu_torch.experiments.profile_fused import profile_rounds
from fedml_tpu_torch.ops import _build


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    args = parser.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    _build.build(["flash_attention"])
    ds = load_dataset("stackoverflow_nwp", client_num_in_total=200, seed=0)
    cfg = FedConfig(client_num_in_total=200, client_num_per_round=50, batch_size=16,
                    lr=0.3, grad_clip=1.0, epochs=1, dtype=args.dtype, seed=0)
    api = FedAvgAPI(ds, cfg, NWPTrainer(create_model("transformer_nwp", ds.class_num,
                                                     dtype=args.dtype)), device="cuda")
    api.train_one_round(0)
    profile_rounds(lambda r: api.train_one_round(r + 1), args.rounds, args.dtype)


if __name__ == "__main__":
    main()
