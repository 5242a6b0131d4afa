"""Where the time of a fused FedAvg round goes on the card.

    python -m fedml_tpu_torch.experiments.profile_fused [--rounds 3] [--dtype float32]

Builds the flagship round (10 clients x 200 samples, 28x28, 62 classes,
batch 20, dropout on) on seeded data, runs one warm-up round, then profiles
``--rounds`` rounds of the fused round function with ``torch.profiler``
(CPU and CUDA activities). Prints the card's name and power limit, the
device's busy share of the window's wall time, and the device time and
launches per round of each kind of kernel and of each kernel. Needs a GPU.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from fedml_tpu_torch.algorithms.aggregators import make_aggregator
from fedml_tpu_torch.algorithms.engine import build_round_fn
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.trainer import ClassificationTrainer
from fedml_tpu_torch.models.registry import create_model
from fedml_tpu_torch.ops import _build
from fedml_tpu_torch.utils.device import resolve_device

CLIENTS, SAMPLES, SIDE, CLASSES, BATCH = 10, 200, 28, 62, 20


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    _build.build(["fused_sgd"])

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(CLIENTS, SAMPLES, SIDE, SIDE, 1).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, CLASSES, (CLIENTS, SAMPLES)).astype(np.int32)).to(dev)
    counts = torch.full((CLIENTS,), SAMPLES, dtype=torch.int32, device=dev)
    cfg = FedConfig(batch_size=BATCH, lr=0.1, grad_clip=1.0, epochs=1,
                    client_num_per_round=CLIENTS, fused_kernel=True, dtype=args.dtype)
    trainer = ClassificationTrainer(create_model("cnn", CLASSES, dtype=args.dtype))
    agg = make_aggregator("fedavg", cfg)
    round_fn = build_round_fn(trainer, cfg, agg, device=dev)
    gv = trainer.init(torch.Generator().manual_seed(0), dev)

    def one_round(r, gv):
        gv, _, _ = round_fn(gv, (), x, y, counts, torch.Generator().manual_seed(r))
        return gv

    state = {"gv": one_round(0, gv)}

    def run(r):
        state["gv"] = one_round(r + 1, state["gv"])

    profile_rounds(run, args.rounds, args.dtype)


def busy_ns(spans) -> int:
    """The union of the ``(start, end)`` intervals' lengths: time in which
    two device events overlap counts once."""
    total, cur_start, cur_end = 0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return total if cur_end is None else total + cur_end - cur_start


def measure_rounds(run_round, rounds: int, host_events: bool = True) -> dict:
    """Profile ``run_round(r)`` for r in range(rounds) (after the caller's
    warm-up): {"wall_ms", "busy_ms", "summed_ms", "launches"} per round,
    "streams" (the device streams that ran events), "rows" (device us,
    count, kernel name) for the window, "kinds" {kind: [us, count]} and
    "results" (``run_round``'s return values). "busy_ms" is the union of
    the device events' intervals, "summed_ms" their durations added up
    (above it where events overlap); a busy time above the wall is a fault
    of the measurement and raises. The device events come from the
    profiler's raw results, not its parsed function events (minutes at
    10**5 launches). ``host_events=False`` records the device's activity
    alone: the same readings, without the host-side events (several a
    launch)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host_events:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        results = [run_round(r) for r in range(rounds)]
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    by_name, spans, streams = {}, [], set()
    for ev in prof.profiler.kineto_results.events():
        # kernels, copies and memsets; not the device-side ranges of
        # record_function annotations, which span them
        if ev.device_type() != cuda or getattr(ev, "is_user_annotation", lambda: False)():
            continue
        start, dur = ev.start_ns(), ev.duration_ns()
        total = by_name.setdefault(ev.name(), [0, 0])
        total[0] += dur
        total[1] += 1
        spans.append((start, start + dur))
        streams.add(ev.device_resource_id())
    if not spans:
        raise RuntimeError("the profiler recorded no device time; time with "
                           "CUDA events instead")
    busy_us = busy_ns(spans) / 1e3
    if busy_us > wall_us:
        raise RuntimeError(f"device busy {busy_us:.0f} us over the window's wall "
                           f"{wall_us:.0f} us: the profiler's clock is off")
    rows = sorted(((ns / 1e3, count, name) for name, (ns, count) in by_name.items()),
                  reverse=True)
    kinds: dict = {}
    for us, count, key in rows:
        kind = next((k for k, marks in KINDS if any(m in key for m in marks)), "other")
        total = kinds.setdefault(kind, [0.0, 0])
        total[0] += us
        total[1] += count
    return {"wall_ms": wall_us / 1e3 / rounds, "busy_ms": busy_us / 1e3 / rounds,
            "summed_ms": sum(us for us, _, _ in rows) / 1e3 / rounds,
            "launches": len(spans) / rounds, "streams": len(streams), "rows": rows,
            "kinds": kinds, "results": results}


def profile_rounds(run_round, rounds: int, label: str) -> None:
    """Profile ``run_round(r)`` for r in range(rounds) (after the caller's
    warm-up) and print the wall and device-busy time per round and each
    kernel's device time, share and launches per round."""
    m = measure_rounds(run_round, rounds)
    summed = m["summed_ms"] * 1e3 * rounds
    print(f"{rounds} rounds, {label}: wall {m['wall_ms']:.3f} ms/round, "
          f"device busy {m['busy_ms']:.3f} ms/round "
          f"({100 * m['busy_ms'] / m['wall_ms']:.1f}% of wall), "
          f"{m['launches']:.1f} launches/round")
    print(f"{'ms/round':>10} {'share':>7} {'launches/round':>15}  kind")
    for kind, (us, count) in sorted(m["kinds"].items(), key=lambda kv: -kv[1][0]):
        print(f"{us / 1e3 / rounds:10.3f} {100 * us / summed:6.1f}% "
              f"{count / rounds:15.1f}  {kind}")
    print(f"{'ms/round':>10} {'share':>7} {'launches/round':>15}  kernel")
    for us, count, key in m["rows"]:
        print(f"{us / 1e3 / rounds:10.3f} {100 * us / summed:6.1f}% "
              f"{count / rounds:15.1f}  {key[:110]}")


# kernel kinds by a substring of the profiler's kernel name, first match wins
KINDS = (("flash attention (csrc/flash_attention.cu)", ("flash_fwd_kernel", "flash_bwd_")),
         ("fused epoch conv2 on the tensor cores (csrc/fused_sgd.cu)", ("conv2_",)),
         ("LSTM (cuDNN RNN)", ("RNN_", "LSTM_", "lstm", "rnn")),
         ("convolution (cuDNN)", ("xmma", "cudnn", "implicit_convolve", "implicit_gemm",
                                  "wgrad", "dgrad", "fprop", "winograd", "conv2d")),
         ("GEMM (cuBLAS, CUTLASS)", ("gemm", "splitKreduce")),
         ("reduction", ("reduce_kernel",)),
         ("elementwise", ("elementwise_kernel",)),
         ("copy, memset", ("Memcpy", "Memset", "CatArrayBatchedCopy")))

if __name__ == "__main__":
    main()
