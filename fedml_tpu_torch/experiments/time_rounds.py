"""Time the fused FEMNIST flagship's rounds through ``FedAvgAPI.train`` on
the card, at one pipeline depth and several evaluation cadences.

    python fedml_tpu_torch/experiments/time_rounds.py --tag change \
        [--freqs 1,10,1] [--rounds 12] [--depth 0]

The flagship (100 surrogate clients capped at 200 samples, 10 a round,
batch 20, lr 0.1, float32 with TF32 off), one run of ``--rounds`` rounds
per entry of ``--freqs`` (``frequency_of_the_test``: 1 evaluates every
round, as ``chip_smoke.py`` phase 3 does). Prints the card's name and
power limit, then a line a run: the median ``round_time`` of rounds
1..R-1, every round's, and, where the tree has the drive's tracer, the
median per-round total of each phase span. Run with ``PYTHONPATH=<another
checkout>`` to time that tree (the script uses only the package's public
names, and runs a tree without the tracer at depth 0 only), so that two
trees compare in one call on one card: parent, change, change, parent.
Needs a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess

import numpy as np
import torch

from fedml_tpu_torch import ClassificationTrainer, FedAvgAPI, FedConfig, create_model, load_dataset
from fedml_tpu_torch.data.packing import PackedClients


def flagship():
    ds = load_dataset("femnist", client_num_in_total=100, seed=0)
    return dataclasses.replace(
        ds,
        train=PackedClients(np.ascontiguousarray(ds.train.x[:, :200]),
                            np.ascontiguousarray(ds.train.y[:, :200]),
                            np.minimum(ds.train.counts, 200)),
        test_global=(ds.test_global[0][:256], ds.test_global[1][:256]))


def phase_medians(tracer) -> dict:
    """{phase: median over rounds 1.. of its per-round total ms}."""
    per: dict = {}
    for s in tracer.spans:
        if s["round"] is not None and s["name"] != "round":
            rounds = per.setdefault(s["name"], {})
            rounds[s["round"]] = rounds.get(s["round"], 0.0) + s["dur_s"] * 1e3
    return {k: round(statistics.median([v for r, v in rounds.items() if r > 0] or [0.0]), 3)
            for k, rounds in per.items()}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--tag", default="tree")
    parser.add_argument("--freqs", default="1,10,1")
    parser.add_argument("--rounds", type=int, default=12)
    parser.add_argument("--depth", type=int, default=0)
    args = parser.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        from fedml_tpu_torch.telemetry import Tracer
    except ImportError:  # a tree from before the drive was ported
        Tracer = None
    ds = flagship()
    for freq in (int(f) for f in args.freqs.split(",")):
        cfg = FedConfig(dataset="femnist", model="cnn", client_num_in_total=100,
                        client_num_per_round=10, batch_size=20, lr=0.1, grad_clip=1.0,
                        epochs=1, comm_round=args.rounds, seed=0, fused_kernel=True,
                        frequency_of_the_test=freq, pipeline_depth=args.depth)
        api = FedAvgAPI(ds, cfg, ClassificationTrainer(create_model("cnn", output_dim=62)),
                        device="cuda")
        phases = {}
        if Tracer is None:
            hist = api.train()
        else:
            tracer = Tracer()
            hist = api.train(tracer=tracer)
            phases = phase_medians(tracer)
        times = [h["round_time"] * 1e3 for h in hist]
        print(f"{args.tag} depth {args.depth} freq {freq}: median round "
              f"{statistics.median(times[1:]):.3f} ms, rounds {[round(t, 2) for t in times]}, "
              f"phase medians ms {phases}", flush=True)


if __name__ == "__main__":
    main()
