"""Time the flash-attention forward on the card three ways, beside SDPA.

    python -m fedml_tpu_torch.experiments.time_flash

For chip_smoke.py's shapes (a) = (16, 20, 4, 32) and (c) = (8, 2048, 4, 32)
(B, T, H, D), causal, float32 and bfloat16, and for both
``flash_fwd`` and PyTorch's ``scaled_dot_product_attention`` on the same
inputs:

- ``single_ms``: one call between CUDA events, chip_smoke.py's reading;
  where the kernel is short it is mostly the call's host work;
- ``b2b_ms``: 20 calls back to back between two events, over 20: the host
  work of a call overlaps the kernels before it;
- ``device_ms``: the device time per call that ``torch.profiler`` records,
  all kernels of the call summed: the kernels alone.

Each is the median of 7 readings. Prints the card's name and
power limit, then one JSON line per (shape, dtype). Needs a GPU.

To time another checkout's kernel on the same card in the same call, put
that checkout first on the path: ``PYTHONPATH=<checkout> python
fedml_tpu_torch/experiments/time_flash.py``; the line's ``tree`` names the
package that was timed.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.ops import _build
from fedml_tpu_torch.ops import attention as A

SHAPES = {"a": (16, 20, 4, 32), "c": (8, 2048, 4, 32)}
BACK_TO_BACK, REPS = 20, 7


def single_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def b2b_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(BACK_TO_BACK):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / BACK_TO_BACK


def device_ms(fn, attempts: int = 3) -> float:
    """A trace with no device time at all is taken again, up to
    ``attempts`` times."""
    for _ in range(attempts):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(BACK_TO_BACK):
                fn()
            torch.cuda.synchronize()
        us = sum(float(getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0)))
                 for ev in prof.key_averages()
                 if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / BACK_TO_BACK
    raise RuntimeError("the profiler recorded no device time")


def readings(fn) -> dict:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return {name: statistics.median(method(fn) for _ in range(REPS))
            for name, method in (("single_ms", single_ms), ("b2b_ms", b2b_ms),
                                 ("device_ms", device_ms))}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("time_flash: torch finds no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    _build.build(["flash_attention"])
    dev = torch.device("cuda", 0)
    for key, shape in SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.RandomState(0)
            q, k, v = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
                       .to(dev, dtype) for _ in range(3))
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
            line = {"tree": A.__file__, "shape": key, "dims": shape,
                    "dtype": str(dtype).replace("torch.", ""), "causal": True,
                    "flash_fwd": readings(lambda: A.flash_fwd(q, k, v, True)),
                    "sdpa": readings(lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, is_causal=True))}
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
