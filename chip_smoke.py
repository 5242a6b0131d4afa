#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     build every CUDA kernel of the path from the checkout's sources, all
     ``nvcc`` processes started together, and time the build;
  2. every kernel against its plain PyTorch version, in float32 with TF32
     off and in bfloat16, on seeded data and flax-shaped weights with
     dropout on and no shuffle: at a small shape (3 clients x 40 samples,
     12x12, 5 classes), where every element must be within the tolerance
     (see TOL), and at the flagship shape (10 clients x 200 samples, 28x28,
     62 classes, batch 20); then the kernel's and the plain version's time
     at the flagship shape (median of 7 timed calls after 2 warm-up calls,
     CUDA events) and the least time the card could take (the bound);
  3. the main path through the user's entry points: the FEMNIST surrogate
     (100 clients, a cut from the reference's 3400 to keep the surrogate's
     host memory small; every client capped at 200 samples, as bench.py's
     _capped does, because the surrogate is ragged and the fused path needs
     a padded width that is a multiple of the batch), FedAvgAPI with the
     fused kernel for 5 rounds, then the same with the engine path: finite
     parameters, a falling training loss, and every kernel of the path
     launched (counts set to 0 just before the run, read just after).

The last three lines: the card's name and power limit, a JSON object of
per-kernel numbers, and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --calibrate 5

prints instead the readings of the kernel against its plain version at the
flagship shape for seeds 0-4, one JSON line each, from which the limits in
TOL are set.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SEED = 0
CLIENTS, SAMPLES, BATCH, SIDE, CLASSES = 10, 200, 20, 28, 62
FEMNIST_CLIENTS, CAP, ROUNDS = 100, 200, 5
# H100 SXM peaks (NVIDIA data sheet, dense): float32 outside the tensor
# cores, bf16 tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# Kernel vs plain version, both float32-accumulating in different orders.
# Elementwise (rtol, atol): float32 is the JAX kernel's own contract
# (tests/test_fused_sgd.py:76-81); bfloat16 rounds at the same points on both
# sides, but a float32 sum taken in another order can land on the other side
# of a bf16 rounding step (2**-8 relative). At the small shape every element
# must pass. At the flagship shape an epoch makes ~10**8 ReLU and max-pool
# decisions, and a few sit within rounding of their threshold: there the two
# sides route a whole gradient element differently and that client's later
# steps drift apart. So at the flagship shape
#   - a fraction ``outliers`` of the elements may miss (rtol, atol), but no
#     element may differ by more than ``max_abs``;
#   - per leaf, the median over clients of ||kernel - plain|| / ||plain -
#     global|| (the difference over the client's own update) stays within
#     ``rel_median``, and every client's within ``rel_max``: a leaf the
#     kernel left un-updated reads 1 there;
#   - the loss sums agree to ``loss`` relative.
# The limits are about 10x the largest reading of sound runs over seeds 0-4
# (``--calibrate 5`` on an H100 80GB HBM3: float32 max_abs 4.1e-5, outliers
# 1.4e-5, rel_median 9.0e-6, rel_max 3.2e-3; bfloat16 max_abs 2.5e-3,
# outliers 1.1e-3, rel_median 4.8e-4, rel_max 0.24), except bfloat16's
# rel_max, held below the 1 of a skipped leaf. ``check_controls`` shows that
# a kernel that skips the update, or one leaf's update, fails them.
TOL = {"float32": {"rtol": 2e-5, "atol": 1e-5, "outliers": 1e-4, "max_abs": 4e-4,
                   "rel_median": 1e-4, "rel_max": 0.03, "loss": 1e-4},
       "bfloat16": {"rtol": 1e-3, "atol": 2e-4, "outliers": 1e-2, "max_abs": 2.5e-2,
                    "rel_median": 5e-3, "rel_max": 0.6, "loss": 5e-3}}


class Disagreement(RuntimeError):
    """The kernel's result is not its plain version's."""


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=2, reps=7) -> float:
    """Median milliseconds of ``fn()`` between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_inputs(device, clients, samples, side, classes, seed):
    """Seeded data, dropout seeds and flax-shaped weights (numpy), on
    ``device``."""
    import numpy as np
    import torch

    from fedml_tpu_torch.utils.convert import flax_to_torch

    rng = np.random.RandomState(seed)
    x = rng.rand(clients, samples, side, side, 1).astype(np.float32)
    y = rng.randint(0, classes, size=(clients, samples)).astype(np.int32)
    seeds = rng.randint(0, 2 ** 31 - 1, size=clients).astype(np.int32)
    pooled = ((side - 4) // 2) ** 2 * 64
    shapes = {"conv2d_1": (3, 3, 1, 32), "conv2d_2": (3, 3, 32, 64),
              "linear_1": (pooled, 128), "linear_2": (128, classes)}
    tree = {}
    for name, shape in shapes.items():
        fan_in = int(np.prod(shape[:-1]))
        tree[name] = {
            "kernel": (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32),
            "bias": (0.01 * rng.normal(size=shape[-1])).astype(np.float32)}
    params = flax_to_torch({"params": tree}, device=device)
    return (params, torch.from_numpy(x).to(device), torch.from_numpy(y).to(device),
            torch.from_numpy(seeds).to(device))


def agreement(kernel: dict, plain: dict, global_params: dict, tol: dict) -> dict:
    """Readings of the kernel's stacked per-client params against the plain
    version's: the largest elementwise difference, the count of elements
    outside (rtol, atol), and per leaf the median and the largest over
    clients of ||kernel - plain|| / ||plain - global||."""
    import torch

    out = {"max_abs": 0.0, "outside": 0, "count": 0, "rel_median": {}, "rel_max": {}}
    for key, p in plain.items():
        k = kernel[key]
        if not torch.isfinite(k).all():
            raise Disagreement(f"kernel output {key} is not finite")
        diff = (k - p).abs()
        out["max_abs"] = max(out["max_abs"], diff.max().item())
        out["outside"] += int((diff > tol["atol"] + tol["rtol"] * p.abs()).sum())
        out["count"] += diff.numel()
        clients = p.shape[0]
        update = (p - global_params[key][None]).reshape(clients, -1).norm(dim=1)
        rel = (k - p).reshape(clients, -1).norm(dim=1) / update.clamp_min(1e-30)
        out["rel_median"][key] = rel.median().item()
        out["rel_max"][key] = rel.max().item()
    return out


def check_agreement(tag: str, kernel: dict, plain: dict, global_params: dict,
                    tol: dict, outliers: float) -> dict:
    """``agreement`` held to ``tol``, with at most a fraction ``outliers`` of
    the elements outside (rtol, atol); raises Disagreement."""
    r = agreement(kernel, plain, global_params, tol)
    median, worst = max(r["rel_median"].values()), max(r["rel_max"].values())
    if r["outside"] > outliers * r["count"]:
        raise Disagreement(f"{tag}: {r['outside']} of {r['count']} elements outside "
                           f"rtol {tol['rtol']} atol {tol['atol']}")
    if r["max_abs"] > tol["max_abs"]:
        raise Disagreement(f"{tag}: an element differs by {r['max_abs']:.3e}")
    if median > tol["rel_median"] or worst > tol["rel_max"]:
        raise Disagreement(f"{tag}: difference over update per leaf: median "
                           f"{r['rel_median']}, max {r['rel_max']}")
    return r


def check_controls(tag: str, plain: dict, global_params: dict, tol: dict,
                   outliers: float) -> int:
    """``check_agreement`` must reject a kernel that skips the update, skips
    one leaf's update, or skips one leaf's update in one client. Returns the
    number of faults it rejected; raises if it passes one."""
    faults = {"no update": {k: global_params[k][None].expand_as(p)
                            for k, p in plain.items()}}
    for key, p in plain.items():
        faults[f"no {key} update"] = {**plain, key: global_params[key][None].expand_as(p)}
        one = p.clone()
        one[-1] = global_params[key]
        faults[f"no {key} update in the last client"] = {**plain, key: one}
    for name, fault in faults.items():
        try:
            check_agreement(tag, fault, plain, global_params, tol, outliers)
        except Disagreement:
            continue
        raise RuntimeError(f"{tag}: the agreement check passed a kernel with {name}")
    return len(faults)


def compare_fused_epoch(dtype_name, device, clients, samples, side, classes, seed,
                        outliers, strict=True):
    """fused_epoch (kernel) vs fused_epoch_reference (plain) on the same
    inputs. Raises on a mismatch unless ``strict`` is false. Returns
    (inputs, spec, readings)."""
    import torch

    from fedml_tpu_torch.ops import fused_sgd

    cdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    spec = fused_sgd.FusedEpochSpec(height=side, width=side, n_classes=classes,
                                    samples=samples, batch=BATCH, lr=0.1,
                                    grad_clip=1.0, drop1=0.25, drop2=0.5,
                                    compute_dtype=cdtype)
    inputs = make_inputs(device, clients, samples, side, classes, seed)
    kp, km = fused_sgd.fused_epoch(spec, *inputs)
    pp, pm = fused_sgd.fused_epoch_reference(spec, *inputs)
    torch.cuda.synchronize()
    tag = (f"fused_epoch[{dtype_name}] {clients}x{samples} {side}x{side} C={classes} "
           f"seed {seed}")
    tol = TOL[dtype_name]
    r = agreement(kp, pp, inputs[0], tol)
    r["loss_rel"] = ((km["loss_sum"] - pm["loss_sum"]).abs()
                     / pm["loss_sum"].abs()).max().item()
    r["correct_diff"] = (km["correct"] - pm["correct"]).abs().max().item()
    log(f"{tag}: params max_abs {r['max_abs']:.3e}, {r['outside']}/{r['count']} outside "
        f"rtol {tol['rtol']} atol {tol['atol']} (allowed fraction {outliers}); "
        f"difference over update per leaf: median "
        f"{max(r['rel_median'].values()):.3e}, max {max(r['rel_max'].values()):.3e}; "
        f"loss_sum max_rel {r['loss_rel']:.3e}; correct max diff {r['correct_diff']:.0f}")
    if strict:
        check_agreement(tag, kp, pp, inputs[0], tol, outliers)
        if (r["loss_rel"] > tol["loss"] or r["correct_diff"] > 2
                or not torch.equal(km["total"], pm["total"])):
            raise Disagreement(f"{tag}: metrics differ: kernel {km} plain {pm}")
        controls = check_controls(tag, pp, inputs[0], tol, outliers)
        log(f"{tag}: the check rejected all {controls} faulted copies of the result")
    return inputs, spec, r


def check_fused_epoch(dtype_name: str, device) -> dict:
    """The kernel against its plain version at a small shape (every element
    within tolerance) and at the flagship shape; times both at the flagship
    shape and computes the bound."""
    from fedml_tpu_torch.ops import fused_sgd

    tol = TOL[dtype_name]
    compare_fused_epoch(dtype_name, device, 3, 40, 12, 5, SEED, 0.0)
    inputs, spec, readings = compare_fused_epoch(
        dtype_name, device, CLIENTS, SAMPLES, SIDE, CLASSES, SEED, tol["outliers"])
    max_abs = readings["max_abs"]
    ms = cuda_ms(lambda: fused_sgd.fused_epoch(spec, *inputs))
    plain_ms = cuda_ms(lambda: fused_sgd.fused_epoch_reference(spec, *inputs),
                       warmup=1, reps=5)
    params, x, y, seeds = inputs
    flops = spec.flops_per_round(CLIENTS)
    nbytes = (x.numel() * 4 + y.numel() * 4 + seeds.numel() * 4   # inputs read once
              + spec.NP * 4                                        # global weights
              + CLIENTS * spec.NP * 4 + CLIENTS * 3 * 4)           # outputs
    flop_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    bound_by = "operations" if flop_ms >= byte_ms else "bytes"
    log(f"fused_epoch[{dtype_name}] flagship: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
        f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB -> bound "
        f"{max(flop_ms, byte_ms):.3f} ms ({bound_by}); "
        f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s achieved")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(flop_ms, byte_ms), "bound_by": bound_by}


def capped(ds, cap, test_cap=256):
    import dataclasses

    import numpy as np

    from fedml_tpu_torch.data.packing import PackedClients

    return dataclasses.replace(
        ds,
        train=PackedClients(np.ascontiguousarray(ds.train.x[:, :cap]),
                            np.ascontiguousarray(ds.train.y[:, :cap]),
                            np.minimum(ds.train.counts, cap)),
        test_global=(ds.test_global[0][:test_cap], ds.test_global[1][:test_cap]))


def run_main_path(ds, fused: bool) -> list:
    import math

    import torch

    from fedml_tpu_torch import ClassificationTrainer, FedAvgAPI, FedConfig, create_model

    cfg = FedConfig(dataset="femnist", model="cnn", client_num_in_total=FEMNIST_CLIENTS,
                    client_num_per_round=10, batch_size=BATCH, lr=0.1, grad_clip=1.0,
                    epochs=1, comm_round=ROUNDS, seed=SEED, fused_kernel=fused)
    trainer = ClassificationTrainer(create_model("cnn", output_dim=ds.class_num))
    api = FedAvgAPI(ds, cfg, trainer, device="cuda")
    hist = api.train()
    for name, t in api.global_variables.items():
        if not torch.isfinite(t).all():
            raise RuntimeError(f"fused={fused}: global {name} is not finite")
    losses = [h["loss_sum"] / h["total"] for h in hist]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise RuntimeError(f"fused={fused}: training loss did not fall: {losses}")
    for h, loss in zip(hist, losses):
        log(f"  {'fused ' if fused else 'engine'} round {h['round']}: "
            f"{h['round_time'] * 1e3:.2f} ms, train loss {loss:.4f}, "
            f"Test/Acc {h['Test/Acc']:.4f}")
    return hist


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--calibrate", type=int, default=0, metavar="N",
                        help="only print the kernel's agreement readings at the "
                        "flagship shape for seeds 0..N-1, checking nothing")
    calibrate = parser.parse_args(argv).calibrate

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    try:
        from fedml_tpu_torch.ops import _build, fused_sgd
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = _build.build(["fused_sgd"])
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(reports) or 'already built'})")
    for name, rep in reports.items():
        regs = [int(w) for line in rep.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        spills = sum(int(w) for line in rep.splitlines() if "spill" in line
                     for w, nxt in zip(line.split(), line.split()[1:])
                     if nxt == "bytes" and "spill" in line)
        log(f"  ptxas {name}: {len(regs)} kernels, max {max(regs, default=0)} "
            f"registers/thread, {spills} bytes of stack/spill")

    # ---- phase 2: kernels vs plain versions, TF32 off for the plain float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if calibrate:
        for seed in range(calibrate):
            for d in ("float32", "bfloat16"):
                _, _, r = compare_fused_epoch(d, dev, CLIENTS, SAMPLES, SIDE, CLASSES,
                                              seed, TOL[d]["outliers"], strict=False)
                log(json.dumps({"dtype": d, "seed": seed, **r}))
        return 0
    numbers = {d: check_fused_epoch(d, dev) for d in ("float32", "bfloat16")}

    # ---- phase 3: the main path through FedAvgAPI
    from fedml_tpu_torch import load_dataset

    t0 = time.perf_counter()
    ds = capped(load_dataset("femnist", client_num_in_total=FEMNIST_CLIENTS, seed=SEED), CAP)
    log(f"femnist surrogate: {FEMNIST_CLIENTS} clients (cut from 3400), capped at "
        f"{CAP} samples, padded width {ds.train.n_max}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    fused_sgd.launches = 0
    fused_hist = run_main_path(ds, fused=True)
    launches = fused_sgd.launches
    if launches <= 0:
        raise RuntimeError("the fused main path launched the fused_sgd kernel no time")
    engine_hist = run_main_path(ds, fused=False)
    for name, hist in (("fused", fused_hist), ("engine", engine_hist)):
        steady = [h["round_time"] * 1e3 for h in hist[1:]]
        log(f"{name} path: median round {statistics.median(steady):.2f} ms over rounds "
            f"1-{len(hist) - 1}, final Test/Acc {hist[-1]['Test/Acc']:.4f}")

    f32 = numbers["float32"]
    kernels = [{
        "name": "fused_epoch",
        "route": "cuda",
        "source": "fedml_tpu_torch/csrc/fused_sgd.cu",
        "replaces": "fedml_tpu/ops/fused_sgd.py:461",
        "launches": launches,
        "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": None,
    }]
    log(f"bfloat16 fused_epoch: {json.dumps(numbers['bfloat16'])}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
