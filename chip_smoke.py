#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     build every CUDA kernel of the paths from the checkout's sources (the
     fused epoch and flash attention), all ``nvcc`` processes started
     together, and time the build;
  2. every kernel against its plain PyTorch version, in float32 with TF32
     off and in bfloat16:
     - the fused epoch, on seeded data and flax-shaped weights with dropout
       on and no shuffle: at a small shape (3 clients x 40 samples, 12x12, 5
       classes), where every element must be within the tolerance (see
       TOL), and at the flagship shape (10 clients x 200 samples, 28x28, 62
       classes, batch 20), where two runs must also agree bit for bit (a
       copy one bit off must fail); then the kernel's and the plain
       version's time at the flagship shape (median of 7 timed calls after
       2 warm-up calls, CUDA events) and the least time the card could take
       (the bound); the ptxas report must show no spill in its conv2
       tensor-core kernels;
     - the three flash-attention kernels (forward, dQ, dK/dV), causal and
       not, at the NWP slice's shape (B 16, T 20, H 4, D 32), a ragged
       multi-tile shape (2, 333, 2, 64), a long causal shape (8, 2048, 4,
       32), a ragged narrow shape (2, 100, 3, 20: D no multiple of 8,
       40-byte bf16 rows, so the forward stages with 8-byte copies) and a
       wide odd one (2, 70, 2, 127: the D <= 128 instantiations, float32
       reloading Q's fragments per tile, bf16 rows of odd length copied
       element by element), every element within ATTN_TOL; the three
       kernels again on q, k, v cut from one [B, T, 3H, D] tensor as the
       model cuts them (dO contiguous), which must give the same bits;
       faulted results (O without the causal mask, dQ with one key tile
       dropped, dK and dV swapped, O and dK one bit off) must fail the same
       checks; under the profiler, the forward on such views must run one
       kernel and no copy, and the backward (``flash_bwd``) the delta op's
       kernels, one dQ and one dK/dV kernel, and no layout copy; at shapes
       (a) and (c) each kernel's time, its plain version's, its bound and
       the time of PyTorch's ``scaled_dot_product_attention`` forward or
       backward; the ptxas report must show no spill in any flash
       instantiation with D <= 64 (a spill at D = 128 is printed);
  3. the main paths through the user's entry points:
     - FEMNIST: the surrogate (100 clients, a cut from the reference's 3400
       to keep the surrogate's host memory small; every client capped at
       200 samples, as bench.py's _capped does, because the surrogate is
       ragged and the fused path needs a padded width that is a multiple
       of the batch), FedAvgAPI with the fused kernel for 5 rounds, then
       the same with the engine path;
     - StackOverflow NWP: the surrogate (200 clients), the transformer LM
       at full width (vocab 10,004, d_model 128, 4 heads, 2 layers),
       NWPTrainer, 50 clients a round, batch 16, lr 0.3, 5 rounds;
     each checked for finite parameters, a falling training loss, and every
     kernel of the path launched (counts set to 0 just before the run, read
     just after);
  4. the server rules and client optimizers, each run through FedAvgAPI or
     its CLI with the launch counts read as in phase 3:
     - NWP with FedAdam (server Adam, lr 1e-2) at the widths of phase 3 for
       5 rounds: the loss falls, all three flash kernels launch; the median
       round, the aggregator call's device time (CUDA events around it) and
       the server step's alone beside its bound;
     - fused FEMNIST: FedOpt with server SGD at lr 1 against FedAvg (max
       difference under 1e-6) and FedNova against FedAvg (equal taus; under
       1e-4), 2 rounds, each started from the same globals; 5 rounds of
       FedYogi (the loss falls; the server step timed as for NWP), and the
       robust CLI (``main_fedavg_robust``) with one attacker: finite losses
       and the backdoor metrics printed;
     - engine FEMNIST: client momentum 0.9, wd 1e-4 and FedProx mu 0.01
       under FedNova, then client Adam (AMSGrad, lr 1e-3), 2 rounds each:
       finite parameters and a falling loss;
  5. FedML's benchmark rows beyond FEMNIST through FedAvgAPI or the CLI
     (``experiments/profile_zoo.py`` builds them through the CLI's
     ``setup_run`` from their configs' flags, on the seeded surrogates), each with the four kernels' launches
     counted (none of them is on these paths: each must read 0):
     - cross-silo CIFAR-10 ResNet-56 (``cross_silo_cifar10_resnet56.yaml``:
       10 silos, hetero alpha 0.5, batch 64, SGD lr 0.001, momentum 0.9, wd
       1e-4, float32): first under FedAvgM (server SGD, lr 1, momentum 0.9)
       beside FedAvg, 2 rounds of 1 local epoch, each round from the same
       globals with cuDNN deterministic: the BatchNorm statistics equal
       FedAvg's weighted mean within 1e-6 (the aggregator acts on
       parameters only); then 2 FedAvg rounds of 3 local epochs (the
       config's 20 cut to fit a 30 s round; a longer round is reported):
       the loss falls, every global BatchNorm statistic moved from its init
       and is finite, and the evaluation reads the running statistics (an
       eval-mode call returns no new state, and resetting the statistics
       changes Test/Loss); 2 bf16 rounds of 3 epochs from the float32
       globals, whose loss falls from the first to the second; and a
       1-epoch round under the profiler;
     - fed_CIFAR-100 ResNet-18-GN (``fed_cifar100_resnet18_gn.yaml`` under
       ``backend vmap``): 500 clients, 10 a round, batch 20, lr 0.1, 3
       rounds: finite, every global moved (its loss need not fall: this
       config barely learns in a run, see ``run_zoo_paths``);
     - Shakespeare (``shakespeare_rnn.yaml``): the LSTM, 715 clients, 10 a
       round, batch 10, lr 0.8, 3 rounds; then fed_shakespeare per
       position through NWPTrainer, 2 rounds;
     - the CLI with its defaults, ``main_fedavg.main([])`` on the card
       (MNIST logistic regression, 10 clients, 10 rounds);
     each with its median round, its training loss per round and, for one
     more round under ``torch.profiler``, the device's busy share and its
     largest kinds of kernel;
  6. the drive (``FedAvgAPI.train`` as the CLI drives it), each run's
     launches counted as in phase 3, with the tracer's phase spans
     (``stage``, ``h2d``, ``dispatch``, ``device_wait``, ``metrics_fetch``)
     printed as medians beside the median round and the wall per round:
     - fused FEMNIST, 5 rounds at depth 0 (the eager loop) and at
       PIPE_DEPTH (2, the CLI's default): the globals and server state bit
       for bit equal and the kernel launched once a round in each; 3 rounds
       with a checkpoint, then a new ``FedAvgAPI`` restored from it for 2
       more: bit for bit the 5 straight rounds; a pipelined run with one
       staged byte flipped must differ;
     - engine FEMNIST through the CLI with ``--chaos 1 --chaos_drop_rate
       0.3 --chaos_nan_rate 0.3 --guard 1`` (the chaos seed the first that
       NaN-faults a client in the last round): ``quarantined_count >= 1``
       in ``wandb-summary.json``, a ``guard_verdict`` event a round in
       ``TRACE.jsonl``, finite globals in the final checkpoint;
     - NWP at full width, 3 rounds at depth 0 and at PIPE_DEPTH, round 1
       NaN-faulting one client (out-of-range token ids): that client is
       quarantined and no other, no device assert, the loss falls and the
       three flash kernels launch.

The script's wall time, then the last three lines: the card's name and
power limit, a JSON object of per-kernel numbers, and ``{"ok": true,
"device": {...}}``.

    python3 chip_smoke.py --calibrate 5

prints instead the readings of the fused epoch against its plain version
at the flagship shape for seeds 0-4, one JSON line each, from which the
limits in TOL are set.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
CLIENTS, SAMPLES, BATCH, SIDE, CLASSES = 10, 200, 20, 28, 62
FEMNIST_CLIENTS, CAP, ROUNDS = 100, 200, 5
# H100 SXM peaks (NVIDIA data sheet, dense), one table for every kernel:
# float32 at the card's fastest route to float32 accuracy, 3xTF32 (three
# TF32 products per float32 product at 495 TFLOP/s, which the flash kernels
# and the fused epoch's conv2 products run); bf16 on the tensor cores; HBM3
# bandwidth
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
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
# The limits were set at about 10x the largest reading of sound runs over
# seeds 0-4 with the kernel's earlier SIMT conv2 (``--calibrate 5`` on an H100
# 80GB HBM3: float32 max_abs 4.1e-5, outliers 1.4e-5, rel_median 9.0e-6,
# rel_max 3.2e-3; bfloat16 max_abs 2.5e-3, outliers 1.1e-3, rel_median
# 4.8e-4, rel_max 0.24), except bfloat16's rel_max, held below the 1 of a
# skipped leaf. With conv2 on the tensor cores ``--calibrate 5`` reads (H100
# 80GB HBM3 at 700 W): float32 max_abs 1.3e-4, outliers 3.7e-5,
# rel_median 8.0e-6, rel_max 9.4e-3, loss 9.4e-7; bfloat16 max_abs 2.5e-3,
# outliers 1.1e-3, rel_median 3.6e-4, rel_max 0.24, loss 6.1e-4.
# ``check_controls`` shows that a kernel that skips the update, or one leaf's
# update, fails them.
TOL = {"float32": {"rtol": 2e-5, "atol": 1e-5, "outliers": 1e-4, "max_abs": 4e-4,
                   "rel_median": 1e-4, "rel_max": 0.03, "loss": 1e-4},
       "bfloat16": {"rtol": 1e-3, "atol": 2e-4, "outliers": 1e-2, "max_abs": 2.5e-2,
                    "rel_median": 5e-3, "rel_max": 0.6, "loss": 5e-3}}


# Flash attention: check shapes (B, T, H, D) and elementwise (rtol, atol)
# of kernel vs plain version. float32 is the JAX package's own contract
# (tests/test_sequence.py:51 for O, :153 for the gradients), lse included.
# bfloat16: both sides compute in float32 from the same bf16 inputs and
# round the outputs once, so an element may differ by one bf16 step (2**-7
# relative at most) where the two float32 values straddle a rounding
# point; lse stays float32 on both sides.
ATTN_SHAPES = {"a": (16, 20, 4, 32), "b": (2, 333, 2, 64), "c": (8, 2048, 4, 32),
               "d": (2, 100, 3, 20), "e": (2, 70, 2, 127)}
ATTN_TOL = {"float32": {"o": (2e-5, 2e-5), "lse": (2e-5, 2e-5), "grad": (2e-4, 2e-4)},
            "bfloat16": {"o": (1e-2, 1e-4), "lse": (2e-5, 2e-5), "grad": (1e-2, 2e-4)}}
NWP_CLIENTS, NWP_PER_ROUND, NWP_BATCH, NWP_LR = 200, 50, 16, 0.3
# Phase 6: the CLI's default pipeline depth, and the tracer's phase spans
PIPE_DEPTH = 2
DRIVE_SPANS = ("stage_wait", "stage", "h2d", "dispatch", "device_wait", "metrics_fetch",
               "eval")
# the fused timing pair runs longer than ROUNDS, so that the pipeline
# reaches its steady state between the evaluations of its first and last
# round
TIME_ROUNDS = 20
# Cross-silo ResNet-56: the config's 20 local epochs cut to XS_EPOCHS, the
# most whose round stayed within XS_ROUND_S on the H100 hosts measured (E = 3:
# 28.6-29.9 s on the slowest); a longer round is reported, not re-cut. The
# FedAvgM/FedAvg pair checks the aggregator, not local depth: 1 epoch.
XS_EPOCHS, XS_ROUND_S, XS_PAIR_EPOCHS = 3, 30.0, 1


class Disagreement(RuntimeError):
    """The kernel's result is not its plain version's."""


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_kernels(report: str) -> dict:
    """{mangled kernel name: {"registers", "spill_bytes"}} from the
    ``nvcc -Xptxas -v`` report; spill bytes are stores plus loads."""
    import re

    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {"registers": 0, "spill_bytes": 0})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if cur is not None and m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if cur is not None and m:
            cur["registers"] = int(m.group(1))
    return out


def flash_label(mangled: str):
    """(``flash_bwd_dq_kernel<float32, 64>``, 64) for a flash-attention
    instantiation's mangled name, else None."""
    import re

    m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I(f|13__nv_bfloat16)Li(\d+)E",
                  mangled)
    if m is None:
        return None
    dtype = "float32" if m.group(2) == "f" else "bfloat16"
    return f"{m.group(1)}<{dtype}, {m.group(3)}>", int(m.group(3))


#: the fused epoch's tensor-core kernels (csrc/fused_sgd.cu)
CONV2_KERNELS = ("conv2_fwd_kernel", "conv2_wgrad_kernel", "conv2_dgrad_kernel")


def conv2_label(mangled: str):
    """``conv2_wgrad_kernel<bfloat16>`` for a conv2 tensor-core
    instantiation's mangled name, else None."""
    import re

    m = re.search(r"\d(conv2_(?:fwd|wgrad|dgrad)_kernel)I(f|13__nv_bfloat16)E", mangled)
    if m is None:
        return None
    return f"{m.group(1)}<{'float32' if m.group(2) == 'f' else 'bfloat16'}>"


def check_spills(kernels: dict) -> list:
    """One line per flash or conv2 tensor-core instantiation of a
    ``ptxas_kernels`` report: its registers and bytes of spill. Raises
    RuntimeError on a spill in any conv2 kernel or in a flash kernel with
    D <= 64; a flash spill at D = 128 is only marked."""
    lines, spills = [], []
    for name, x in sorted(kernels.items()):
        flash, conv2 = flash_label(name), conv2_label(name)
        if flash is None and conv2 is None:
            continue
        label = conv2 or flash[0]
        mark = " (SPILL)" if x["spill_bytes"] else ""
        lines.append(f"{label}: {x['registers']} registers, {x['spill_bytes']} bytes of "
                     f"spill{mark}")
        if x["spill_bytes"] and (conv2 or flash[1] <= 64):
            spills.append(f"{label} spills {x['spill_bytes']} bytes")
    if spills:
        raise RuntimeError("; ".join(spills))
    return lines


def device_events(fn) -> list:
    """The profiler's events of the kernels that ``fn()`` runs on the card
    (after one untraced call; a trace with no device event at all is
    retried)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        if events:
            break
    return events


def device_kernels(fn) -> list:
    """The names of the kernels that ``fn()`` runs on the card."""
    return [e.name for e in device_events(fn)]


def check_one_launch(device) -> list:
    """The forward on the model's split q, k, v views runs exactly one
    kernel on the card, its own, and no layout copy (torch.profiler).
    Returns the device events' names."""
    import torch

    from fedml_tpu_torch.ops import attention as A

    q, k, v = qkv_views(*attention_inputs(ATTN_SHAPES["a"], torch.float32, device)[:3])
    names = device_kernels(lambda: A.flash_fwd(q, k, v, True))
    if len(names) != 1 or "flash_fwd_kernel" not in names[0]:
        raise RuntimeError(f"flash_fwd on split views ran {names} on the card, not one "
                           f"flash_fwd_kernel")
    return names


def backward_kernels_ok(names: list, delta_names: list) -> bool:
    """``names`` (a backward's kernels) are the delta op's kernels
    ``delta_names``, one flash_bwd_dq_kernel and one flash_bwd_dkv_kernel,
    in any order, and nothing else: no layout copy."""
    flash = sorted("dkv" if "flash_bwd_dkv_kernel" in n else "dq"
                   for n in names if "flash_bwd_" in n)
    rest = sorted(n for n in names if "flash_bwd_" not in n)
    return flash == ["dkv", "dq"] and rest == sorted(delta_names)


def check_backward_launches(device) -> list:
    """``flash_bwd`` on the model's split q, k, v views (dO contiguous)
    runs the delta op's kernels, one dQ and one dK/dV kernel on the card,
    and no layout copy of q, k, v or dO (torch.profiler). Returns the
    device events' names."""
    import torch

    from fedml_tpu_torch.ops import attention as A

    q, k, v, do = attention_inputs(ATTN_SHAPES["a"], torch.float32, device)
    views = qkv_views(q, k, v)
    o, lse = A.flash_fwd(*views, True)
    delta_names = device_kernels(lambda: A.attention_delta(o, do))
    names = device_kernels(lambda: A.flash_bwd(*views, o, lse, do, True))
    if not backward_kernels_ok(names, delta_names):
        raise RuntimeError(f"flash_bwd on split views ran {names} on the card, not the delta "
                           f"op's {delta_names} and one kernel each of dQ and dK/dV")
    return names


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


def check_determinism(dtype_name: str, spec, inputs) -> None:
    """Two epochs on the same inputs give the same bits (no atomics, split
    sums reduced in a fixed order); a copy with one bit flipped must fail."""
    from fedml_tpu_torch.ops import fused_sgd

    (p1, m1), (p2, m2) = [fused_sgd.fused_epoch(spec, *inputs) for _ in range(2)]
    tag = f"fused_epoch[{dtype_name}] flagship, two runs"
    for key in p1:
        bitwise(f"{tag}: {key}", p2[key], p1[key])
    for key in m1:
        bitwise(f"{tag}: metric {key}", m2[key], m1[key])
    key = "conv2d_2.weight"
    faulted = bits(p2[key]).clone()
    faulted.view(-1)[0] ^= 1
    must_fail(f"{tag}: {key} one bit off",
              lambda: bitwise("control", faulted.view(p2[key].dtype), p1[key]))
    log(f"{tag}: bitwise equal; a copy one bit off fails")


def check_fused_epoch(dtype_name: str, device) -> dict:
    """The kernel against its plain version at a small shape (every element
    within tolerance) and at the flagship shape, where two runs must agree
    bit for bit; times both at the flagship shape and computes the bound."""
    from fedml_tpu_torch.ops import fused_sgd

    tol = TOL[dtype_name]
    compare_fused_epoch(dtype_name, device, 3, 40, 12, 5, SEED, 0.0)
    inputs, spec, readings = compare_fused_epoch(
        dtype_name, device, CLIENTS, SAMPLES, SIDE, CLASSES, SEED, tol["outliers"])
    check_determinism(dtype_name, spec, inputs)
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


def close(tag: str, got, want, rtol: float, atol: float) -> dict:
    """Every element of ``got`` within (rtol, atol) of ``want``; raises
    Disagreement. Returns the largest difference and the largest share of
    the allowance used."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise Disagreement(f"{tag}: shape {tuple(got.shape)} vs {tuple(want.shape)}, "
                           f"finite {bool(torch.isfinite(got).all())}")
    diff = (got - want).abs()
    share = (diff / (atol + rtol * want.abs())).max().item()
    if share > 1.0:
        raise Disagreement(f"{tag}: {int((diff > atol + rtol * want.abs()).sum())} elements "
                           f"outside rtol {rtol} atol {atol}, max diff {diff.max().item():.3e}")
    return {"max_abs": diff.max().item(), "share": share}


def bits(t):
    """The bits of a float32 or bf16 tensor, as a contiguous int tensor."""
    import torch

    return t.contiguous().view({4: torch.int32, 2: torch.int16}[t.element_size()])


def bitwise(tag: str, got, want) -> None:
    """``got`` holds the same bits as ``want``; raises Disagreement."""
    if (got.shape != want.shape or got.dtype != want.dtype
            or not bits(got).equal(bits(want))):
        raise Disagreement(f"{tag}: not bitwise equal")


def qkv_views(q, k, v):
    """q, k, v as views of one [B, T, 3H, D] tensor, cut as
    models/transformer.py cuts the qkv projection."""
    import torch

    return torch.cat((q, k, v), dim=2).split(q.shape[2], dim=2)


def must_fail(tag: str, fn) -> None:
    try:
        fn()
    except Disagreement:
        return
    raise RuntimeError(f"{tag}: the check passed a faulted result")


def attention_inputs(shape, dtype, device, seed=SEED):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(device, dtype)
            for _ in range(4)]


def attention_work(shape, causal, elem):
    """(flops of the forward, dq, dkv; bytes of each): 2 products for the
    forward, 3 for dq, 4 for dkv, each 2 D FLOP per live (query, key) pair;
    each input read once, each output written once."""
    b, t, h, d = shape
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    x, row = b * t * h * d * elem, b * h * t * 4
    flops = {n: products * pairs * 2 * d
             for n, products in (("flash_fwd", 2), ("flash_bwd_dq", 3), ("flash_bwd_dkv", 4))}
    nbytes = {"flash_fwd": 3 * x + x + row,
              "flash_bwd_dq": 4 * x + 2 * row + x,
              "flash_bwd_dkv": 4 * x + 2 * row + 2 * x}
    return flops, nbytes


def check_attention_case(dtype_name, device, key, causal):
    """The three flash kernels against their plain versions at shape ``key``;
    faulted results must fail. Returns the inputs and {kernel: max_abs}."""
    import torch

    from fedml_tpu_torch.ops import attention as A

    dt = getattr(torch, dtype_name)
    shape = ATTN_SHAPES[key]
    q, k, v, do = attention_inputs(shape, dt, device)
    tol = ATTN_TOL[dtype_name]
    tag = f"flash[{dtype_name}] {key}={shape} causal={causal}"
    o, lse = A.flash_fwd(q, k, v, causal)
    po, plse = A.flash_fwd_reference(q, k, v, causal)
    views = qkv_views(q, k, v)
    so, slse = A.flash_fwd(*views, causal)
    delta = A.attention_delta(o, do)
    dq = A.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = A.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    split_grads = (A.flash_bwd_dq(*views, do, lse, delta, causal),
                   *A.flash_bwd_dkv(*views, do, lse, delta, causal))
    pdq = A.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
    pdk, pdv = A.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    r = {"o": close(f"{tag} O", o, po, *tol["o"]),
         "lse": close(f"{tag} lse", lse, plse, *tol["lse"]),
         "dq": close(f"{tag} dQ", dq, pdq, *tol["grad"]),
         "dk": close(f"{tag} dK", dk, pdk, *tol["grad"]),
         "dv": close(f"{tag} dV", dv, pdv, *tol["grad"])}
    bitwise(f"{tag} O from split views", so, o)
    bitwise(f"{tag} lse from split views", slse, lse)
    for name, got, want in zip(("dQ", "dK", "dV"), split_grads, (dq, dk, dv)):
        bitwise(f"{tag} {name} from split views", got, want)
    # faulted results: O without the causal mask, dQ with the last key tile
    # dropped (its keys zeroed: their ds . k terms vanish, nothing else
    # moves), dK and dV swapped
    if causal:
        must_fail(f"{tag} O without the causal mask", lambda: close(
            "control", A.flash_fwd_reference(q, k, v, False)[0], po, *tol["o"]))
    t0 = (shape[1] - 1) // 64 * 64
    k_cut = k.clone()
    k_cut[:, t0:] = 0
    must_fail(f"{tag} dQ with one key tile dropped", lambda: close(
        "control", A.flash_bwd_dq_reference(q, k_cut, v, do, lse, delta, causal), pdq,
        *tol["grad"]))
    must_fail(f"{tag} dK and dV swapped", lambda: (
        close("control", pdv, pdk, *tol["grad"]), close("control", pdk, pdv, *tol["grad"])))
    one_bit = bits(so).clone()
    one_bit.view(-1)[-1] ^= 1
    must_fail(f"{tag} O from split views one bit off",
              lambda: bitwise("control", one_bit.view(o.dtype), o))
    one_bit_dk = bits(split_grads[1]).clone()
    one_bit_dk.view(-1)[0] ^= 1
    must_fail(f"{tag} dK from split views one bit off",
              lambda: bitwise("control", one_bit_dk.view(dk.dtype), dk))
    log(f"{tag}: max diff O {r['o']['max_abs']:.3e}, lse {r['lse']['max_abs']:.3e}, "
        f"dQ {r['dq']['max_abs']:.3e}, dK {r['dk']['max_abs']:.3e}, "
        f"dV {r['dv']['max_abs']:.3e}; largest share of the allowance "
        f"{max(x['share'] for x in r.values()):.3f} (O {r['o']['share']:.3f}, lse "
        f"{r['lse']['share']:.3f}, dQ {r['dq']['share']:.3f}, dK {r['dk']['share']:.3f}, "
        f"dV {r['dv']['share']:.3f}); split views bitwise equal, forward and backward; "
        f"controls rejected")
    errs = {"flash_fwd": max(r["o"]["max_abs"], r["lse"]["max_abs"]),
            "flash_bwd_dq": r["dq"]["max_abs"],
            "flash_bwd_dkv": max(r["dk"]["max_abs"], r["dv"]["max_abs"])}
    return (q, k, v, do, o, lse, delta), errs


def time_attention(dtype_name, key, inputs) -> dict:
    """Each flash kernel's time, its plain version's and its bound at shape
    ``key`` (causal), and PyTorch's SDPA forward and backward on the same
    inputs."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import attention as A

    q, k, v, do, o, lse, delta = inputs
    shape = ATTN_SHAPES[key]
    runs = {
        "flash_fwd": (lambda: A.flash_fwd(q, k, v, True),
                      lambda: A.flash_fwd_reference(q, k, v, True)),
        "flash_bwd_dq": (lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, True),
                         lambda: A.flash_bwd_dq_reference(q, k, v, do, lse, delta, True)),
        "flash_bwd_dkv": (lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, True),
                          lambda: A.flash_bwd_dkv_reference(q, k, v, do, lse, delta, True)),
    }
    flops, nbytes = attention_work(shape, True, q.element_size())
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    doh = do.transpose(1, 2)
    lib = {"flash_fwd": cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))}
    oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    lib["flash_bwd_dq"] = lib["flash_bwd_dkv"] = cuda_ms(
        lambda: torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True))
    out = {}
    for name, (kernel, plain) in runs.items():
        flop_ms = flops[name] / PEAK_FLOPS[dtype_name] * 1e3
        byte_ms = nbytes[name] / PEAK_BYTES * 1e3
        out[name] = {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
                     "bound_ms": max(flop_ms, byte_ms),
                     "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
                     "library_ms": lib[name]}
        x = out[name]
        log(f"{name}[{dtype_name}] {key}={shape} causal: kernel {x['ms']:.4f} ms, plain "
            f"{x['plain_ms']:.4f} ms, bound {x['bound_ms']:.4f} ms ({x['bound_by']}; "
            f"{flops[name] / 1e9:.3f} GFLOP, {nbytes[name] / 1e6:.2f} MB), "
            f"SDPA {x['library_ms']:.4f} ms; "
            f"{flops[name] / (x['ms'] * 1e-3) / 1e12:.2f} TFLOP/s achieved")
    return out


def check_attention(dtype_name, device) -> dict:
    """All shapes, causal and not; times at shapes (a) and (c). Returns
    {kernel: {max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms}}
    at shape (c)."""
    errs, inputs = {}, {}
    for key in ATTN_SHAPES:
        for causal in (False, True):
            x, e = check_attention_case(dtype_name, device, key, causal)
            if causal:
                inputs[key] = x
            errs = {n: max(errs.get(n, 0.0), e[n]) for n in e}
    time_attention(dtype_name, "a", inputs["a"])
    numbers = time_attention(dtype_name, "c", inputs["c"])
    return {n: {"max_abs_err": errs[n], **numbers[n]} for n in numbers}


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


def femnist_api(ds, fused: bool, aggregator: str = "fedavg", **overrides):
    """FedAvgAPI on the card for the FEMNIST flagship (``overrides`` replace
    FedConfig fields)."""
    from fedml_tpu_torch import ClassificationTrainer, FedAvgAPI, FedConfig, create_model

    cfg = FedConfig(dataset="femnist", model="cnn", client_num_in_total=FEMNIST_CLIENTS,
                    client_num_per_round=10, batch_size=BATCH, lr=0.1, grad_clip=1.0,
                    epochs=1, comm_round=ROUNDS, seed=SEED, fused_kernel=fused)
    trainer = ClassificationTrainer(create_model("cnn", output_dim=ds.class_num))
    return FedAvgAPI(ds, cfg.replace(**overrides), trainer, aggregator_name=aggregator,
                     device="cuda")


def check_trained(tag: str, api, hist, must_fall: bool = True) -> list:
    """Finite globals and finite training losses that fell (unless
    ``must_fall`` is off); returns the losses."""
    import math

    import torch

    for name, t in api.global_variables.items():
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{tag}: global {name} is not finite")
    losses = [h["loss_sum"] / h["total"] for h in hist]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"{tag}: training loss is not finite: {losses}")
    if must_fall and not losses[-1] < losses[0]:
        raise RuntimeError(f"{tag}: training loss did not fall: {losses}")
    return losses


def run_main_path(ds, fused: bool, aggregator: str = "fedavg", tag=None, **overrides):
    tag = tag or ("fused" if fused else "engine")
    api = femnist_api(ds, fused, aggregator, **overrides)
    hist = api.train()
    losses = check_trained(tag, api, hist)
    for h, loss in zip(hist, losses):
        log(f"  {tag} round {h['round']}: {h['round_time'] * 1e3:.2f} ms, train loss "
            f"{loss:.4f}, Test/Acc {h['Test/Acc']:.4f}")
    return hist


def load_nwp():
    from fedml_tpu_torch import load_dataset

    t0 = time.perf_counter()
    ds = load_dataset("stackoverflow_nwp", client_num_in_total=NWP_CLIENTS, seed=SEED)
    log(f"stackoverflow_nwp surrogate: {NWP_CLIENTS} clients, {ds.train.total_samples} "
        f"train windows of {ds.train.x.shape[2]} tokens, padded width {ds.train.n_max}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    return ds


class TimedAggregator:
    """An aggregator whose every call is bracketed by CUDA events."""

    def __init__(self, inner):
        self.inner = inner
        self.events = []

    def init_state(self, global_variables):
        return self.inner.init_state(global_variables)

    def __call__(self, *args):
        import torch

        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = self.inner(*args)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> list:
        import torch

        torch.cuda.synchronize()
        return [start.elapsed_time(end) for start, end in self.events]


def timed_aggregation(api, trainer, cfg) -> TimedAggregator:
    """Rebuild ``api``'s round around a TimedAggregator of its aggregator."""
    from fedml_tpu_torch.algorithms.engine import build_round_fn

    timed = TimedAggregator(api.aggregator)
    api.round_fn = build_round_fn(trainer, cfg, timed, device=api.device)
    return timed


def time_server_step(tag: str, api) -> dict:
    """The FedOpt server step alone on the run's final globals and state,
    with a mean 1e-3 away from the globals: the median of 7 calls between
    CUDA events, the sum of its kernels' device time (torch.profiler), and
    its bound: params, mean and each moment read, params and each moment
    written, over the card's memory rate."""
    import torch

    gv, state = api.global_variables, api.agg_state
    gen = torch.Generator(device=api.device).manual_seed(SEED)
    avg = {k: v + 1e-3 * torch.randn(v.shape, generator=gen, device=api.device)
           for k, v in gv.items()}
    def step():
        return api.aggregator.server_step(gv, avg, state)

    ms = cuda_ms(step)
    kernels = device_events(step)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    n = sum(t.numel() for t in gv.values())
    moments = sum(1 for name in ("mu", "nu", "trace", "sum") if name in state)
    nbytes = (2 + moments) * 4 * n + (1 + moments) * 4 * n
    bound = nbytes / PEAK_BYTES * 1e3
    log(f"{tag} server step ({n} parameters): {ms:.4f} ms between CUDA events, "
        f"{len(kernels)} kernels busy {busy:.4f} ms (profiler); bound {bound:.4f} ms "
        f"({nbytes / 1e6:.1f} MB over {PEAK_BYTES / 1e12:.2f} TB/s)")
    return {"ms": ms, "busy_ms": busy, "bound_ms": bound, "params": n}


def run_nwp_path(ds, aggregator: str = "fedavg", tag: str = "nwp", **overrides) -> list:
    """The StackOverflow NWP surrogate with the transformer LM at full
    width, through FedAvgAPI on the card; with ``fedopt`` the aggregator
    calls are timed and then the server step alone."""
    from fedml_tpu_torch import FedAvgAPI, FedConfig, NWPTrainer, create_model

    cfg = FedConfig(dataset="stackoverflow_nwp", model="transformer_nwp",
                    client_num_in_total=NWP_CLIENTS, client_num_per_round=NWP_PER_ROUND,
                    batch_size=NWP_BATCH, lr=NWP_LR, grad_clip=1.0, epochs=1,
                    comm_round=ROUNDS, seed=SEED).replace(**overrides)
    trainer = NWPTrainer(create_model("transformer_nwp", output_dim=ds.class_num))
    api = FedAvgAPI(ds, cfg, trainer, aggregator_name=aggregator, device="cuda")
    timed = timed_aggregation(api, trainer, cfg) if aggregator == "fedopt" else None
    n_params = sum(t.numel() for t in api.global_variables.values())
    hist = api.train()
    losses = check_trained(tag, api, hist)
    for h, loss in zip(hist, losses):
        test = (f", Test/Acc {h['Test/Acc']:.4f}, Test/Loss {h['Test/Loss']:.4f}"
                if "Test/Acc" in h else "")
        log(f"  {tag} round {h['round']}: {h['round_time'] * 1e3:.2f} ms, train loss "
            f"{loss:.4f}{test}")
    log(f"{tag} path: transformer_nwp {n_params} parameters, median round "
        f"{statistics.median([h['round_time'] * 1e3 for h in hist[1:]]):.2f} ms over rounds "
        f"1-{len(hist) - 1}")
    if timed is not None:
        agg_ms = timed.ms()
        log(f"{tag} aggregator call (weighted mean of {NWP_PER_ROUND} clients + server "
            f"step), device ms a round: {[round(t, 4) for t in agg_ms]}, median of rounds "
            f"1-{len(agg_ms) - 1} {statistics.median(agg_ms[1:]):.4f}")
        time_server_step(tag, api)
    return hist


def count_launches(fn):
    """``fn()`` with every kernel's launch count set to 0 just before and
    read just after: (fn's result, {kernel: launches})."""
    from fedml_tpu_torch.ops import attention, fused_sgd

    fused_sgd.launches = 0
    for name in attention.launches:
        attention.launches[name] = 0
    out = fn()
    return out, {"fused_epoch": fused_sgd.launches, **attention.launches}


def with_launches(tag: str, kernels, fn):
    """``fn()`` with the launch counts of ``kernels`` set to 0 just before
    and read just after; raises if one of them launched no time. Returns
    (fn's result, {kernel: launches})."""
    out, counts = count_launches(fn)
    counts = {k: counts[k] for k in kernels}
    missing = [k for k, c in counts.items() if c <= 0]
    if missing:
        raise RuntimeError(f"the {tag} path launched {missing} no time")
    log(f"{tag} path launches: {counts}")
    return out, counts


def max_diff(a: dict, b: dict) -> float:
    return max((a[k] - b[k]).abs().max().item() for k in a)


def check_fused_server_rules(ds, launches: dict) -> None:
    """Phase 4's fused FEMNIST runs; adds each run's launches to
    ``launches``."""
    import math

    from fedml_tpu_torch.experiments import main_fedavg_robust

    # each round of a pair starts both rules from the same globals: chained
    # rounds of the CNN amplify the first round's 1e-10 rounding of
    # g - (g - avg) to ~1e-6 (the plain version on the CPU, 2 rounds)
    for name, limit, overrides in (
            ("fedopt", 1e-6, dict(server_optimizer="sgd", server_lr=1.0)),
            ("fednova", 1e-4, {})):
        base, other = femnist_api(ds, True), femnist_api(ds, True, name, **overrides)
        diffs, n_base, n_other = [], 0, 0
        for r in range(2):
            other.global_variables = {k: v.clone() for k, v in base.global_variables.items()}
            _, n = with_launches(f"fused fedavg, round {r}", ["fused_epoch"],
                                 lambda: base.train_one_round(r))
            n_base += n["fused_epoch"]
            _, n = with_launches(f"fused {name}, round {r}", ["fused_epoch"],
                                 lambda: other.train_one_round(r))
            n_other += n["fused_epoch"]
            diffs.append(max_diff(other.global_variables, base.global_variables))
        log(f"fused {name} {overrides} vs fedavg, 2 rounds, each from the same globals: "
            f"max abs difference {[f'{d:.3e}' for d in diffs]} (limit {limit:.0e})")
        if not max(diffs) < limit:
            raise RuntimeError(f"fused {name} differs from fedavg by {max(diffs):.3e}")
        launches[f"femnist fused fedavg ({name} pair)"] = n_base
        launches[f"femnist fused {name}"] = n_other

    def yogi():
        api = femnist_api(ds, True, "fedopt", server_optimizer="yogi", server_lr=0.01)
        timed = timed_aggregation(api, api.trainer, api.cfg)
        hist = api.train()
        losses = check_trained("fused fedyogi", api, hist)
        log(f"fused fedyogi (server lr 0.01): train loss {[round(v, 4) for v in losses]}, "
            f"median round {statistics.median([h['round_time'] * 1e3 for h in hist[1:]]):.2f} "
            f"ms, aggregator call device ms {[round(t, 4) for t in timed.ms()]}")
        time_server_step("fused fedyogi", api)

    _, n = with_launches("fused fedyogi", ["fused_epoch"], yogi)
    launches["femnist fused fedyogi"] = n["fused_epoch"]

    # the robust CLI: 30 clients give a padded width of 360, a multiple of
    # the batch, as the fused kernel needs
    with tempfile.TemporaryDirectory() as run_dir:
        argv = ["--dataset", "femnist", "--model", "cnn", "--client_num_in_total", "30",
                "--client_num_per_round", "10", "--batch_size", str(BATCH), "--lr", "0.1",
                "--comm_round", "3", "--frequency_of_the_test", "3", "--fused_kernel", "1",
                "--attacker_num", "1", "--seed", str(SEED), "--device", "cuda",
                "--run_dir", run_dir]
        hist, n = with_launches("fused robust CLI", ["fused_epoch"],
                                lambda: main_fedavg_robust.main(argv))
    values = [h["loss_sum"] for h in hist] + [hist[-1]["Test/Loss"]]
    if not all(math.isfinite(v) for v in values):
        raise RuntimeError(f"robust CLI: non-finite losses {values}")
    log(f"fused robust CLI: train loss {[round(h['loss_sum'] / h['total'], 4) for h in hist]}, "
        f"Test/Loss {hist[-1]['Test/Loss']:.4f}, MainTask/Acc "
        f"{hist[-1]['MainTask/Acc']:.4f}, Backdoor/SuccessRate "
        f"{hist[-1]['Backdoor/SuccessRate']:.4f}")
    launches["femnist fused robust CLI"] = n["fused_epoch"]


def zoo_path(tag: str, launches: dict, fn):
    """Phase 5: ``fn()`` with the four kernels' launches counted (each must
    read 0: no kernel is on these paths); the counts go to
    ``launches[tag]``."""
    out, counts = count_launches(fn)
    if any(counts.values()):
        raise RuntimeError(f"the {tag} path launched a kernel: {counts}")
    launches[tag] = counts
    log(f"{tag} path launches: {counts}")
    return out


def check_zoo_run(tag: str, api, hist, profile: bool = True, must_fall: bool = True) -> None:
    """A phase 5 run: finite globals and a falling loss (see
    ``check_trained``); with ``profile`` one more round under
    torch.profiler; logs the path's numbers."""
    from fedml_tpu_torch.experiments import profile_zoo

    check_trained(tag, api, hist, must_fall)
    if profile:
        prof = profile_zoo.profiled_round(api, len(hist))
        log(profile_zoo.summary(tag, hist, prof))
    else:
        log(f"{tag}: rounds {[round(h['round_time'] * 1e3, 2) for h in hist]} ms, train "
            f"loss {[round(v, 4) for v in profile_zoo.losses(hist)]}")


def gradient_norms(api) -> tuple:
    """(global, fc.weight's) gradient norm of one train-mode step at the
    globals, on client 0's first batch."""
    import torch
    import torch.nn.functional as F

    v = {k: t.detach().clone().requires_grad_(True) for k, t in api.global_variables.items()}
    b = api.cfg.batch_size
    x = torch.from_numpy(api.dataset.train.x[0, :b]).to(api.device)
    y = torch.from_numpy(api.dataset.train.y[0, :b]).to(api.device)
    out, _ = api.trainer.apply(v, x, None, True)
    grads = dict(zip(v, torch.autograd.grad(F.cross_entropy(out.float(), y.long()),
                                            list(v.values()))))
    total = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values())).item()
    return total, grads["fc.weight"].norm().item()


def check_running_statistics(api) -> None:
    """Every global BatchNorm statistic moved from its init (mean 0, var 1)
    and is finite; an eval-mode call returns no new state; the evaluation
    reads the running statistics (resetting them changes Test/Loss)."""
    import torch

    from fedml_tpu_torch.utils.pytree import split_variables

    stats = split_variables(api.global_variables)[1]
    if not stats:
        raise RuntimeError("cross-silo: the globals hold no BatchNorm statistics")
    for k, v in stats.items():
        init = 0.0 if k.endswith(".mean") else 1.0
        if not torch.isfinite(v).all() or torch.equal(v, torch.full_like(v, init)):
            raise RuntimeError(f"cross-silo: statistic {k} is not finite or never moved")
    x = torch.from_numpy(api.dataset.test_global[0][:8]).to(api.device)
    _, state = api.trainer.apply(api.global_variables, x, None, False)
    if state:
        raise RuntimeError("cross-silo: an eval-mode call returned new state")
    kept = api.test_global(0)["Test/Loss"]
    saved = api.global_variables
    api.global_variables = {k: (torch.zeros_like(v) if k.endswith(".mean") else
                                torch.ones_like(v) if k.endswith(".var") else v)
                            for k, v in saved.items()}
    reset = api.test_global(0)["Test/Loss"]
    api.global_variables = saved
    if reset == kept:
        raise RuntimeError("cross-silo: the evaluation does not read the running statistics")
    log(f"cross-silo running statistics: {len(stats)} leaves moved and finite; Test/Loss "
        f"{kept:.4f} with them, {reset:.4f} with mean 0 / var 1")


def check_fedavgm_statistics(launches: dict) -> None:
    """FedAvgM (server SGD lr 1, momentum 0.9) beside FedAvg on cross-silo
    ResNet-56, 2 rounds, each from the same globals, cuDNN deterministic:
    the BatchNorm statistics must equal FedAvg's weighted mean within 1e-6."""
    import torch

    from fedml_tpu_torch.experiments import profile_zoo
    from fedml_tpu_torch.utils.pytree import split_variables

    epochs = ["--epochs", str(XS_PAIR_EPOCHS)]
    base = profile_zoo.make_api("cross_silo", *epochs)
    other = profile_zoo.make_api("cross_silo", *epochs, "--server_optimizer", "sgd",
                                 "--server_lr", "1.0", "--server_momentum", "0.9",
                                 aggregator="fedopt")
    ds = base.dataset
    log(f"cifar10 surrogate: 10 silos (hetero, alpha 0.5), {ds.train.total_samples} train "
        f"rows, padded width {ds.train.n_max}")
    torch.backends.cudnn.deterministic = True
    try:
        stat_diffs, param_diffs, hist, times = [], [], [], []
        for r in range(2):
            other.global_variables = {k: v.clone() for k, v in base.global_variables.items()}
            t0 = time.perf_counter()
            zoo_path(f"cross-silo fedavg (fedavgm pair), round {r}", launches,
                     lambda: base.train_one_round(r))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            hist.append(zoo_path(f"cross-silo fedavgm, round {r}", launches,
                                 lambda: other.train_one_round(r)))
            (bp, bs), (op, os_) = (split_variables(base.global_variables),
                                   split_variables(other.global_variables))
            stat_diffs.append(max_diff(os_, bs))
            param_diffs.append(max_diff(op, bp))
    finally:
        torch.backends.cudnn.deterministic = False
    losses = [h["loss_sum"] / h["total"] for h in hist]
    log(f"cross-silo fedavgm vs fedavg ({XS_PAIR_EPOCHS} epoch), 2 rounds each from the "
        f"same globals: statistics max abs difference {[f'{d:.3e}' for d in stat_diffs]} "
        f"(limit 1e-6), parameters {[f'{d:.3e}' for d in param_diffs]}; fedavgm train loss "
        f"{[round(v, 4) for v in losses]}")
    if not max(stat_diffs) < 1e-6:
        raise RuntimeError(f"fedavgm's BatchNorm statistics differ from fedavg's mean by "
                           f"{max(stat_diffs):.3e}")
    if not all(torch.isfinite(v).all() for v in other.global_variables.values()):
        raise RuntimeError("cross-silo fedavgm: non-finite globals")
    log(f"cross-silo fedavg 1-epoch rounds (cuDNN deterministic): "
        f"{[round(t, 2) for t in times]} ms")


def check_round_budget(tag: str, hist) -> None:
    """Reports each round over XS_ROUND_S; the cut stays XS_EPOCHS."""
    slow = [round(h["round_time"], 1) for h in hist if h["round_time"] > XS_ROUND_S]
    if slow:
        log(f"WARNING {tag}: rounds of {slow} s exceed the {XS_ROUND_S:.0f} s budget that "
            f"E = {XS_EPOCHS} was chosen for (a slower host; the work is the same)")


def run_zoo_paths() -> dict:
    """Phase 5: FedML's benchmark rows beyond FEMNIST on the card. Returns
    {path: {kernel: launches}}."""
    import torch

    from fedml_tpu_torch.experiments import main_fedavg, profile_zoo

    launches: dict = {}
    check_fedavgm_statistics(launches)
    epochs = ["--epochs", str(XS_EPOCHS)]
    api = profile_zoo.make_api("cross_silo", *epochs)
    tag = f"cross-silo resnet56 (E={XS_EPOCHS}, cut from 20; 2 rounds, cut from 100)"
    hist = zoo_path("cross-silo resnet56", launches, api.train)
    check_zoo_run(tag, api, hist, profile=False)
    check_round_budget(tag, hist)
    check_running_statistics(api)
    bf16 = profile_zoo.make_api("cross_silo", *epochs, "--dtype", "bfloat16")
    bf16.global_variables = {k: v.clone() for k, v in api.global_variables.items()}
    bhist = zoo_path("cross-silo resnet56 bf16", launches, bf16.train)
    check_zoo_run(f"cross-silo resnet56 bf16 (E={XS_EPOCHS}, 2 rounds from the float32 "
                  "globals)", bf16, bhist, profile=False)
    check_round_budget("cross-silo resnet56 bf16", bhist)
    one = profile_zoo.make_api("cross_silo", "--epochs", "1")
    one.global_variables = api.global_variables
    zoo_path("cross-silo resnet56, profiled round", launches,
             lambda: log(profile_zoo.summary(f"{tag}; a 1-epoch round profiled", hist,
                                             profile_zoo.profiled_round(one, 2))))
    del api, bf16, one

    t0 = time.perf_counter()
    api = profile_zoo.make_api("fed_cifar100")
    log(f"fed_cifar100: 500 clients x {api.dataset.train.n_max} rows, set up in "
        f"{time.perf_counter() - t0:.1f} s")
    init = {k: v.clone() for k, v in api.global_variables.items()}
    total, fc = gradient_norms(api)
    log(f"fed_cifar100 resnet18_gn at init: a step's global gradient norm {total:.1f}, "
        f"fc.weight's {fc:.3f}, against the clip at {api.cfg.grad_clip}")
    hist = zoo_path("fed_cifar100 resnet18_gn", launches, api.train)
    # This config barely learns in a run, for a cause the JAX package
    # shares (the same model and clip): on 24x24 inputs the last stage is
    # 1x1, so each GroupNorm of 2 channels normalises two numbers and its
    # gradient grows as 1/|a - b|. The global norm logged above is orders
    # of magnitude over the clip at 1.0 (the reference trainer's), which
    # leaves fc and the rest a sliver of their gradient, and the loss only
    # wanders (ROADMAP, Queue 3): over 3 rounds it rose in 2 of 8 runs on
    # the H100, so this path is held to every global having moved.
    still = [k for k, v in api.global_variables.items() if torch.equal(v, init[k])]
    if still:
        raise RuntimeError(f"fed_cifar100: globals that training never moved: {still}")
    zoo_path("fed_cifar100 resnet18_gn, profiled round", launches,
             lambda: check_zoo_run("fed_cifar100 resnet18_gn (3 rounds, cut from 4000)",
                                   api, hist, must_fall=False))
    del api

    for path, rounds in (("shakespeare", 3), ("fed_shakespeare", 2)):
        api = profile_zoo.make_api(path)
        hist = zoo_path(f"{path} rnn", launches, api.train)
        zoo_path(f"{path} rnn, profiled round", launches,
                 lambda: check_zoo_run(f"{path} rnn ({rounds} rounds, cut from 1200)", api,
                                       hist))

    with tempfile.TemporaryDirectory() as run_dir:
        hist = zoo_path("cli defaults (mnist lr)", launches,
                        lambda: main_fedavg.main(["--run_dir", run_dir]))
    losses = [h["loss_sum"] / h["total"] for h in hist]
    if not losses[-1] < losses[0] or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"cli defaults: training loss did not fall: {losses}")
    log(f"cli defaults (mnist lr, {len(hist)} rounds): median round "
        f"{statistics.median([h['round_time'] * 1e3 for h in hist]):.2f} ms, train loss "
        f"{[round(v, 4) for v in losses]}, final Test/Acc {hist[-1]['Test/Acc']:.4f}")
    return launches


def same_bits(tag: str, got, want) -> None:
    """Every tensor of the tree ``got`` holds the bits of ``want``'s (any
    dtype); raises Disagreement."""
    import torch

    from fedml_tpu_torch.utils.pytree import tree_leaves

    a, b = tree_leaves(got), tree_leaves(want)
    if [p for p, _ in a] != [p for p, _ in b]:
        raise Disagreement(f"{tag}: the trees hold other leaves")
    for (path, x), (_, y) in zip(a, b):
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)):
            raise Disagreement(f"{tag}: {path} not bitwise equal")


def round_numbers(tracer) -> dict:
    """The drive's per-round timings from the tracer's spans, over the
    rounds 1..R-2 (round 0 and the last evaluate): the median round span;
    the median spacing between the starts of consecutive rounds (the wall
    a round costs in steady state at any depth: a pipelined round span
    ends before the card finishes it); and each phase's median per-round
    total (a round may hold two ``metrics_fetch`` spans: the round's own
    and its record flush)."""
    rounds = sorted({s["round"] for s in tracer.find_spans("round")})
    steady = rounds[1:-1] or rounds
    starts = {s["round"]: s["t0"] for s in tracer.find_spans("round")}
    totals: dict = {}
    for s in tracer.spans:
        if s["name"] in DRIVE_SPANS and s["round"] in steady:
            per_round = totals.setdefault(s["name"], dict.fromkeys(steady, 0.0))
            per_round[s["round"]] += s["dur_s"] * 1e3
    gaps = [(starts[r + 1] - starts[r]) * 1e3 for r in steady if r + 1 in starts]
    return {"median_round_ms": statistics.median(
                s["dur_s"] * 1e3 for s in tracer.find_spans("round") if s["round"] in steady),
            "round_spacing_ms": statistics.median(gaps) if gaps else None,
            "phase_ms": {k: statistics.median(v.values()) for k, v in totals.items()},
            "rounds": [steady[0], steady[-1]]}


def drive(tag: str, api, **train_kw) -> tuple:
    """``api.train`` under a fresh Tracer; logs ``round_numbers``. Returns
    (history, tracer, numbers)."""
    from fedml_tpu_torch.telemetry import Tracer

    tracer = Tracer()
    hist = api.train(tracer=tracer, **train_kw)
    numbers = round_numbers(tracer)
    log(f"{tag}: rounds {numbers['rounds'][0]}-{numbers['rounds'][1]}: median round "
        f"{numbers['median_round_ms']:.3f} ms, round spacing "
        f"{numbers['round_spacing_ms'] or float('nan'):.3f} ms, per-round phase medians ms "
        f"{ {k: round(v, 3) for k, v in numbers['phase_ms'].items()} }")
    return hist, tracer, numbers


def flip_staged_byte(api, round_idx: int) -> None:
    """A faulted control: ``api.stage_fn`` flips one byte (bits 16-23 of
    the first sample's largest pixel) of round ``round_idx``'s cohort after
    its copy to the card."""
    import torch

    stage = api.stage_fn

    def flipped(r, **kw):
        staged = stage(r, **kw)
        if r == round_idx:
            staged.ready.synchronize()
            flat = staged.x.reshape(-1)
            i = int(flat[: staged.x[0, 0].numel()].abs().argmax())
            flat.view(torch.uint8)[4 * i + 2: 4 * i + 3].bitwise_xor_(0xFF)
            torch.cuda.synchronize()
        return staged

    api.stage_fn = flipped


def check_fused_drives(ds, launches: dict) -> dict:
    """Phase 6, FEMNIST through the fused kernel: 5 rounds at depth 0 and
    at PIPE_DEPTH, 3 rounds + checkpoint + a new api restored for 2 more,
    all bit for bit equal; a depth-PIPE_DEPTH run with one staged byte
    flipped must differ; then the timing pair, TIME_ROUNDS rounds at each
    depth (also bit for bit equal). Each run launches the kernel once a
    round. Returns the timing pair's numbers."""

    def run(tag, depth, rounds=ROUNDS, run_rounds=None, **train_kw):
        api = femnist_api(ds, True, pipeline_depth=depth, comm_round=rounds,
                          frequency_of_the_test=rounds)
        (hist, _, numbers), n = with_launches(tag, ["fused_epoch"],
                                              lambda: drive(tag, api, **train_kw))
        launches[tag] = n["fused_epoch"]
        if n["fused_epoch"] != (run_rounds or rounds):
            raise RuntimeError(f"{tag}: {n['fused_epoch']} fused launches in "
                               f"{run_rounds or rounds} rounds")
        check_trained(tag, api, hist)
        return api, numbers

    eager, _ = run("femnist fused depth 0", 0)
    piped, _ = run(f"femnist fused depth {PIPE_DEPTH}", PIPE_DEPTH)
    same_bits("fused depth 2 vs depth 0 globals", piped.global_variables,
              eager.global_variables)
    same_bits("fused depth 2 vs depth 0 state", piped.agg_state, eager.agg_state)
    with tempfile.TemporaryDirectory() as ckpt:
        run("femnist fused resumed, first 3 rounds", PIPE_DEPTH, 3, ckpt_dir=ckpt,
            ckpt_every=100)
        resumed, _ = run("femnist fused resumed, rounds 3-4", PIPE_DEPTH, run_rounds=2,
                         ckpt_dir=ckpt, ckpt_every=100)
    same_bits("fused resumed vs 5 straight rounds", resumed.global_variables,
              eager.global_variables)
    faulted = femnist_api(ds, True, pipeline_depth=PIPE_DEPTH, frequency_of_the_test=ROUNDS)
    flip_staged_byte(faulted, 2)
    faulted.train()
    must_fail("fused depth 2 with a flipped staged byte",
              lambda: same_bits("faulted", faulted.global_variables, eager.global_variables))
    apis, numbers = {}, {}
    for depth in (0, PIPE_DEPTH):
        apis[depth], numbers[f"depth {depth}"] = run(
            f"femnist fused depth {depth}, {TIME_ROUNDS} rounds", depth, TIME_ROUNDS)
    same_bits(f"fused depth 2 vs depth 0, {TIME_ROUNDS} rounds",
              apis[PIPE_DEPTH].global_variables, apis[0].global_variables)
    log(f"fused drives: depth {PIPE_DEPTH} ({ROUNDS} and {TIME_ROUNDS} rounds) and 3 + 2 "
        f"resumed rounds bit for bit depth 0's; a run with one staged byte flipped differs")
    return numbers


def chaos_seed(rounds: int, clients: int, round_idx: int, **rates) -> int:
    """The first chaos seed whose plan NaN-faults a client in ``round_idx``
    (plans are pure in their seed: the choice is the same on every run)."""
    from fedml_tpu_torch.robustness.chaos import FaultPlan

    return next(s for s in range(1000)
                if FaultPlan(seed=s, **rates).events(round_idx, clients).nan_mask.any())


def check_chaos_cli(run_dir: str) -> None:
    """Phase 6, FEMNIST on the engine path through the CLI with chaos and
    the guard: quarantined_count >= 1 in wandb-summary.json (the last
    round's), guard_verdict events in TRACE.jsonl, finite globals in the
    final checkpoint."""
    import math
    import os

    import torch

    from fedml_tpu_torch.experiments import main_fedavg

    rounds = 3
    seed = chaos_seed(rounds, 10, rounds - 1, drop_rate=0.3, nan_rate=0.3)
    run, ckpt = os.path.join(run_dir, "chaos"), os.path.join(run_dir, "chaos_ckpt")
    argv = ["--dataset", "femnist", "--model", "cnn", "--client_num_in_total",
            str(FEMNIST_CLIENTS), "--client_num_per_round", "10", "--batch_size", str(BATCH),
            "--lr", "0.1", "--comm_round", str(rounds), "--frequency_of_the_test",
            str(rounds), "--seed", str(SEED), "--chaos", "1", "--chaos_seed", str(seed),
            "--chaos_drop_rate", "0.3", "--chaos_nan_rate", "0.3", "--guard", "1",
            "--run_dir", run, "--ckpt_dir", ckpt, "--device", "cuda"]
    hist, n = count_launches(lambda: main_fedavg.main(argv))
    if any(n.values()):
        raise RuntimeError(f"the engine chaos CLI launched a kernel: {n}")
    with open(os.path.join(run, "wandb-summary.json")) as f:
        summary = json.load(f)
    with open(os.path.join(run, "TRACE.jsonl")) as f:
        events = [json.loads(line) for line in f]
    verdicts = [e for e in events if e.get("kind") == "guard_verdict"]
    tree = torch.load(os.path.join(ckpt, f"ckpt_{rounds}", "tree.pt"), weights_only=True)
    finite = all(torch.isfinite(v).all() for v in tree["variables"].values())
    if not (summary.get("quarantined_count", 0) >= 1 and len(verdicts) >= rounds and finite
            and math.isfinite(hist[-1]["Test/Loss"])):
        raise RuntimeError(f"engine chaos CLI: summary {summary}, {len(verdicts)} verdicts, "
                           f"finite globals {finite}")
    log(f"engine chaos CLI (chaos seed {seed}, drop 0.3, NaN 0.3, guard on, depth "
        f"{PIPE_DEPTH}): quarantined {[h['quarantined_count'] for h in hist]}, dropped "
        f"{[h['chaos_dropped'] for h in hist]}, guard verdicts "
        f"{[e['ok'] for e in verdicts]}, median round "
        f"{statistics.median(h['round_time'] * 1e3 for h in hist):.2f} ms, "
        f"Test/Acc {hist[-1]['Test/Acc']:.4f}; globals finite")


def check_nwp_drives(nwp, launches: dict) -> dict:
    """Phase 6, NWP at full width for 3 rounds at depth 0 and at
    PIPE_DEPTH, round 1 NaN-faulting one client (out-of-range token ids):
    the client is quarantined with no device assert, the loss falls and
    the three flash kernels launch."""
    from fedml_tpu_torch import FedAvgAPI, FedConfig, NWPTrainer, create_model
    from fedml_tpu_torch.ops import attention
    from fedml_tpu_torch.robustness.chaos import FaultPlan

    rounds = 3
    rates = dict(nan_rate=0.0, overrides={1: {"nan_rate": 0.02}})
    seed = chaos_seed(rounds, NWP_PER_ROUND, 1, **rates)
    numbers = {}
    for depth in (0, PIPE_DEPTH):
        cfg = FedConfig(dataset="stackoverflow_nwp", model="transformer_nwp",
                        client_num_in_total=NWP_CLIENTS, client_num_per_round=NWP_PER_ROUND,
                        batch_size=NWP_BATCH, lr=NWP_LR, grad_clip=1.0, epochs=1,
                        comm_round=rounds, frequency_of_the_test=rounds, seed=SEED,
                        pipeline_depth=depth)
        trainer = NWPTrainer(create_model("transformer_nwp", output_dim=nwp.class_num))
        api = FedAvgAPI(nwp, cfg, trainer, device="cuda")
        tag = f"nwp depth {depth}"
        (hist, _, numbers[f"depth {depth}"]), launches[tag] = with_launches(
            tag, list(attention.launches),
            lambda: drive(tag, api, chaos=FaultPlan(seed=seed, **rates)))
        losses = check_trained(tag, api, hist)
        quarantined = [h["quarantined_count"] for h in hist]
        if quarantined[1] < 1 or quarantined[0] or quarantined[2]:
            raise RuntimeError(f"{tag}: quarantined {quarantined}, wanted round 1 only")
        log(f"{tag}: chaos seed {seed}, quarantined {quarantined}, participated "
            f"{[h['participated_count'] for h in hist]}, train loss "
            f"{[round(v, 4) for v in losses]}")
    return numbers


def run_drives(ds, nwp, fused_launches: dict, flash_launches: dict) -> dict:
    """Phase 6: the JAX CLI's drive on the card (the pipelined loop, resume,
    chaos with the guard, the tracer's spans). Returns the depth-0 and
    depth-PIPE_DEPTH numbers of the fused and NWP paths."""
    numbers = {"femnist fused": check_fused_drives(ds, fused_launches)}
    with tempfile.TemporaryDirectory() as run_dir:
        check_chaos_cli(run_dir)
    numbers["nwp"] = check_nwp_drives(nwp, flash_launches)
    return numbers


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--calibrate", type=int, default=0, metavar="N",
                        help="only print the kernel's agreement readings at the "
                        "flagship shape for seeds 0..N-1, checking nothing")
    calibrate = parser.parse_args(argv).calibrate
    started = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    try:
        from fedml_tpu_torch.ops import _build, attention, fused_sgd
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = _build.build(["fused_sgd", "flash_attention"])
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(reports) or 'already built'})")
    for name in ("fused_sgd", "flash_attention"):
        # the build keeps each library's ptxas report beside it
        kernels = ptxas_kernels(_build.library_path(name).with_suffix(".ptxas.txt").read_text())
        log(f"  ptxas {name}: {len(kernels)} kernels, max "
            f"{max((x['registers'] for x in kernels.values()), default=0)} registers/thread, "
            f"{sum(x['spill_bytes'] for x in kernels.values())} bytes of spill")
        for line in check_spills(kernels):
            log(f"    {line}")

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
    attn = {d: check_attention(d, dev) for d in ("float32", "bfloat16")}
    log(f"flash_fwd on split views under the profiler: {check_one_launch(dev)}")
    log(f"flash_bwd on split views under the profiler: {check_backward_launches(dev)}")

    # ---- phase 3: the main paths through FedAvgAPI
    from fedml_tpu_torch import load_dataset

    t0 = time.perf_counter()
    ds = capped(load_dataset("femnist", client_num_in_total=FEMNIST_CLIENTS, seed=SEED), CAP)
    log(f"femnist surrogate: {FEMNIST_CLIENTS} clients (cut from 3400), capped at "
        f"{CAP} samples, padded width {ds.train.n_max}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    fused_launches, flash_launches = {}, {}
    fused_hist, n = with_launches("femnist fused fedavg", ["fused_epoch"],
                                  lambda: run_main_path(ds, fused=True))
    fused_launches["femnist fused fedavg"] = n["fused_epoch"]
    engine_hist = run_main_path(ds, fused=False)
    for name, hist in (("fused", fused_hist), ("engine", engine_hist)):
        steady = [h["round_time"] * 1e3 for h in hist[1:]]
        log(f"{name} path: median round {statistics.median(steady):.2f} ms over rounds "
            f"1-{len(hist) - 1}, final Test/Acc {hist[-1]['Test/Acc']:.4f}")

    nwp = load_nwp()
    flash = list(attention.launches)
    _, flash_launches["nwp fedavg"] = with_launches("nwp fedavg", flash,
                                                    lambda: run_nwp_path(nwp))

    # ---- phase 4: server rules and client optimizers
    _, flash_launches["nwp fedadam"] = with_launches(
        "nwp fedadam", flash,
        lambda: run_nwp_path(nwp, "fedopt", "nwp fedadam", server_optimizer="adam",
                             server_lr=1e-2, frequency_of_the_test=ROUNDS))
    run_main_path(ds, False, "fednova", tag="engine fednova+momentum+wd+fedprox",
                  comm_round=2, momentum=0.9, wd=1e-4, fedprox_mu=0.01)
    run_main_path(ds, False, tag="engine amsgrad", comm_round=2, client_optimizer="adam",
                  lr=1e-3)
    check_fused_server_rules(ds, fused_launches)

    # ---- phase 5: FedML's benchmark rows beyond FEMNIST (no kernel runs)
    zoo_launches = run_zoo_paths()
    for path, counts in zoo_launches.items():
        fused_launches[path] = counts["fused_epoch"]
        flash_launches[path] = {k: counts[k] for k in flash}

    # ---- phase 6: the drive (pipelined loop, resume, chaos and the guard)
    drive_numbers = run_drives(ds, nwp, fused_launches, flash_launches)
    del ds, nwp
    launches = sum(fused_launches.values())
    attn_launches = {k: sum(p[k] for p in flash_launches.values()) for k in flash}

    f32 = numbers["float32"]
    kernels = [{
        "name": "fused_epoch",
        "route": "cuda",
        "source": "fedml_tpu_torch/csrc/fused_sgd.cu",
        "replaces": "fedml_tpu/ops/fused_sgd.py:461",
        "launches": launches,
        "launches_by_path": fused_launches,
        "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": None,
        # its kernels on the tensor cores (each on mma.sync, in both types)
        "parts": [f"fused_sgd.cu::{k}" for k in CONV2_KERNELS],
    }]
    replaces = {"flash_fwd": "fedml_tpu/ops/attention.py:142",
                "flash_bwd_dq": "fedml_tpu/ops/attention.py:281",
                "flash_bwd_dkv": "fedml_tpu/ops/attention.py:300"}
    for name, where in replaces.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": "fedml_tpu_torch/csrc/flash_attention.cu",
                        "replaces": where, "launches": attn_launches[name],
                        "launches_by_path": {p: c[name] for p, c in flash_launches.items()},
                        **attn["float32"][name]})
    log(f"bfloat16 fused_epoch: {json.dumps(numbers['bfloat16'])}")
    log(f"bfloat16 flash attention at shape c: {json.dumps(attn['bfloat16'])}")
    log(f"drive depth 0 vs {PIPE_DEPTH}: {json.dumps(drive_numbers)}")
    log(f"chip_smoke wall time: {time.perf_counter() - started:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
