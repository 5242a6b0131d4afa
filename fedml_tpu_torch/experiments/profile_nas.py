"""One FedNAS search step at the DARTS paper's CIFAR-10 search widths on
the card, timed and profiled.

    python -m fedml_tpu_torch.experiments.profile_nas [--modes first_order,unrolled,gdas]
        [--deterministic 1,0] [--dtype float32] [--steps 2]

The network is ``chip_smoke.py`` phase 15's cell 35 (16 channels, 8 cells,
steps 4, multiplier 4, 10 classes), the batch 64 seeded 32x32x3 rows for
the train half and 64 for the val half. For each mode and each setting of
``torch.backends.cudnn.deterministic``: one warm-up step, ``--steps``
timed steps (wall per step, the card synchronised) with the peak
allocated bytes, then one step under the profiler (the device's activity
alone): its busy time, launches and the kernels by device time. Prints
the card's name and power limit first and one JSON line a (mode,
setting). TF32 is off, as in ``chip_smoke.py``. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fednas import (NASState, build_search_step,
                                               draw_gdas_uniforms)
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import flax_default_init
from fedml_tpu_torch.experiments.profile_fused import measure_rounds
from fedml_tpu_torch.models.darts import DARTSNetwork, init_alphas
from fedml_tpu_torch.utils.device import resolve_device

WIDTHS = {"channels": 16, "layers": 8, "steps": 4, "multiplier": 4}
BATCH, SIDE, CLASSES = 64, 32, 10
MODES = {"first_order": {}, "unrolled": {"unrolled": True}, "gdas": {"gdas": True}}


def step_runner(mode: str, dtype: str, device):
    """A function running one search step of ``mode`` from a fixed state
    (so that every call does the same work); returns it and the step's
    metric tensors of a first call."""
    net = DARTSNetwork(CLASSES, dtype=dtype, **WIDTHS).to(device)
    gen = torch.Generator().manual_seed(0)
    params = flax_default_init(net, gen, device)
    alphas = dict(zip(("normal", "reduce"), init_alphas(gen, WIDTHS["steps"], device=device)))
    cfg = FedConfig(lr=0.025, momentum=0.9, wd=3e-4, dtype=dtype)
    step, w_opt, a_opt = build_search_step(net, cfg, **MODES[mode])
    state = NASState(params, alphas, w_opt.init(params), a_opt.init(alphas))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.normal(size=(2 * BATCH, SIDE, SIDE, 3)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.randint(0, CLASSES, 2 * BATCH).astype(np.int64)).to(device)
    train = (x[:BATCH], y[:BATCH], torch.ones(BATCH, device=device))
    val = (x[BATCH:], y[BATCH:])
    uniforms = None
    if mode == "gdas":
        uniforms = draw_gdas_uniforms(gen, 1, net.layers, net.num_edges)[0].to(device)

    def run(_=None):
        return step(state, train, val, 0.025, True, uniforms)[1]

    return run


def measure(mode: str, dtype: str, steps: int, device) -> dict:
    run = step_runner(mode, dtype, device)
    loss_n, _, n = run()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    peak = torch.cuda.max_memory_allocated()
    prof = measure_rounds(run, 1, host_events=False)
    top = [{"ms": round(us / 1e3, 3), "launches": count, "kernel": key[:90]}
           for us, count, key in prof["rows"][:12]]
    return {"mode": mode, "dtype": dtype,
            "deterministic": torch.backends.cudnn.deterministic,
            "step_ms": round(wall * 1e3, 2), "loss": float(loss_n / n), "peak_bytes": peak,
            "profiled_wall_ms": round(prof["wall_ms"], 2),
            "busy_ms": round(prof["busy_ms"], 2), "launches": prof["launches"],
            "kinds": {k: [round(us / 1e3, 3), c] for k, (us, c) in prof["kinds"].items()},
            "top": top}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--modes", default=",".join(MODES))
    parser.add_argument("--deterministic", default="1,0")
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--steps", type=int, default=2)
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for det in (bool(int(v)) for v in args.deterministic.split(",")):
        torch.backends.cudnn.deterministic = det
        for mode in args.modes.split(","):
            print(json.dumps(measure(mode, args.dtype, args.steps, device)), flush=True)


if __name__ == "__main__":
    main()
