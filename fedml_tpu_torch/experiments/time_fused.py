"""Time the fused local-SGD epoch at the FEMNIST flagship shape on the card.

    python fedml_tpu_torch/experiments/time_fused.py [--reps 20]

One epoch of 10 clients x 200 samples, 28x28, 62 classes, batch 20, dropout
on, in float32 and in bfloat16, on seeded data and weights: the median of
``--reps`` calls between CUDA events after two warm-up calls, wrapper
included. Prints the card's name and power limit, one line a type, and one
JSON object. Run with ``PYTHONPATH=<another checkout>`` to time that tree's
kernel (the script uses only the package's public names), so that two trees
compare in one call on one card. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from fedml_tpu_torch.ops import fused_sgd
from fedml_tpu_torch.utils.convert import flax_to_torch

CLIENTS, SAMPLES, SIDE, CLASSES, BATCH = 10, 200, 28, 62, 20


def inputs(device, seed=0):
    """Seeded data, dropout seeds and flax-shaped weights on ``device``."""
    rng = np.random.RandomState(seed)
    x = rng.rand(CLIENTS, SAMPLES, SIDE, SIDE, 1).astype(np.float32)
    y = rng.randint(0, CLASSES, size=(CLIENTS, SAMPLES)).astype(np.int32)
    seeds = rng.randint(0, 2 ** 31 - 1, size=CLIENTS).astype(np.int32)
    pooled = ((SIDE - 4) // 2) ** 2 * 64
    shapes = {"conv2d_1": (3, 3, 1, 32), "conv2d_2": (3, 3, 32, 64),
              "linear_1": (pooled, 128), "linear_2": (128, CLASSES)}
    tree = {name: {"kernel": (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1])))
                   .astype(np.float32),
                   "bias": (0.01 * rng.normal(size=shape[-1])).astype(np.float32)}
            for name, shape in shapes.items()}
    return (flax_to_torch({"params": tree}, device=device), torch.from_numpy(x).to(device),
            torch.from_numpy(y).to(device), torch.from_numpy(seeds).to(device))


def time_epoch(dtype, device, reps) -> float:
    spec = fused_sgd.FusedEpochSpec(height=SIDE, width=SIDE, n_classes=CLASSES,
                                    samples=SAMPLES, batch=BATCH, lr=0.1, grad_clip=1.0,
                                    drop1=0.25, drop2=0.5, compute_dtype=dtype)
    args = inputs(device)
    for _ in range(2):
        fused_sgd.fused_epoch(spec, *args)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fused_sgd.fused_epoch(spec, *args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_fused: needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}; package {fused_sgd.__file__}", flush=True)
    device = torch.device("cuda", 0)
    out = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        out[name] = time_epoch(dtype, device, args.reps)
        print(f"fused_epoch[{name}] flagship: median {out[name]:.4f} ms of {args.reps} calls",
              flush=True)
    print(json.dumps({"card": card, "fused_epoch_ms": out}))


if __name__ == "__main__":
    main()
