"""Time the flash-attention kernels on the card three ways, beside SDPA.

    python -m fedml_tpu_torch.experiments.time_flash

For chip_smoke.py's shapes (a) = (16, 20, 4, 32) and (c) = (8, 2048, 4, 32)
(B, T, H, D), causal, float32 and bfloat16, for ``flash_fwd``,
``flash_bwd_dq`` and ``flash_bwd_dkv`` (given the forward's lse and
delta = rowsum(dO * O)) and for PyTorch's ``scaled_dot_product_attention``
forward (``sdpa``) and whole backward (``sdpa_bwd``: dQ, dK and dV) on the
same inputs:

- ``single_ms``: one call between CUDA events, chip_smoke.py's reading;
  where the kernel is short it is mostly the call's host work;
- ``b2b_ms``: 20 calls back to back between two events, over 20: the host
  work of a call overlaps the kernels before it;
- ``device_ms``: the device time per call that ``torch.profiler`` records,
  all kernels of the call summed: the kernels alone.

Each is the median of 7 readings. At shape (a), each flash kernel is also
timed the way a training loop calls it (``in_context``): its own device
time per call when every call comes after other work, namely a float32
GEMM (SIMT: no tensor cores), a bf16 GEMM (tensor cores), 0.2 ms or 20 ms
with the card idle, milliseconds of float32 GEMMs (``after_f32_work``:
the SMs busy and the tensor cores idle, as between two attention calls of
the NWP loop) or of bf16 GEMMs (``after_bf16_work``: as long a load, on
the tensor cores), or 128 MB written to device memory, which evicts the
kernel's code and inputs from the 50 MB L2 as a training step does between
two calls. Inside the NWP loop the tensor-core flash kernels take up to
twice their time alone; these readings tell an instruction-cache cost
(after either GEMM), a tensor-core wake-up cost (after float32 work or an
idle gap, not after bf16 work), a cost of sustained load (after either
kind of work) and the cost of fetching code and inputs from device memory
(after the flush) apart.

Prints the card's name and power limit, the size of each flash kernel's
machine code (``cuobjdump -sass``, 16 bytes an instruction), then one
JSON line per (shape, dtype). Needs a GPU.

To time another checkout's kernel on the same card in the same call, put
that checkout first on the path: ``PYTHONPATH=<checkout> python
fedml_tpu_torch/experiments/time_flash.py``; the line's ``tree`` names the
package that was timed.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import time
from pathlib import Path

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


def own_device_ms(fn, kernel: str, before) -> float:
    """Device time per call of the kernels whose name holds ``kernel``, with
    ``before()`` run ahead of every call."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(BACK_TO_BACK):
            before()
            fn()
        torch.cuda.synchronize()
    us = sum(float(getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0)))
             for ev in prof.key_averages()
             if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA
             and kernel in ev.key)
    return us / 1e3 / BACK_TO_BACK


def in_context(fn, kernel: str, dev) -> dict:
    """``own_device_ms`` after each context of the module docstring (median
    of 7 each); None where the trace held no such kernel."""
    a32, b32 = torch.randn(320, 128, device=dev), torch.randn(128, 512, device=dev)
    a16, b16 = a32.bfloat16(), b32.bfloat16()
    big = torch.randn(2048, 2048, device=dev)
    big16 = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
    flush = torch.empty(32 << 20, device=dev)  # 128 MB, over twice the L2

    def idle(seconds):
        def wait():
            torch.cuda.synchronize()
            time.sleep(seconds)
        return wait

    def f32_work():  # 15 float32 GEMMs of 17 GFLOP: milliseconds of SIMT work
        for _ in range(15):
            big @ big

    def bf16_work():  # 20 bf16 GEMMs of 137 GFLOP: milliseconds on the tensor cores
        for _ in range(20):
            big16 @ big16

    before = {"after_f32_gemm": lambda: a32 @ b32, "after_bf16_gemm": lambda: a16 @ b16,
              "after_idle": idle(2e-4), "after_idle_20ms": idle(2e-2),
              "after_f32_work": f32_work, "after_bf16_work": bf16_work,
              "after_l2_flush": flush.zero_}
    out = {}
    for name, pre in before.items():
        got = [own_device_ms(fn, kernel, pre) for _ in range(REPS)]
        out[name] = statistics.median(got) if all(got) else None
    return out


def code_bytes() -> dict:
    """{``flash_bwd_dq_kernel<float32, 32>``: bytes of machine code} for the
    built flash library, from ``cuobjdump -sass``."""
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*(flash_\w+?_kernel)I(f|13__nv_bfloat16)Li(\d+)E", line)
        if m:
            dtype = "float32" if m.group(2) == "f" else "bfloat16"
            cur = f"{m.group(1)}<{dtype}, {m.group(3)}>"
            out[cur] = 0
        elif "Function :" in line:
            cur = None
        elif cur and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            out[cur] += 16
    return out


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
    print(json.dumps({"tree": A.__file__, "code_bytes": code_bytes()}), flush=True)
    dev = torch.device("cuda", 0)
    for key, shape in SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.RandomState(0)
            q, k, v, do = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
                           .to(dev, dtype) for _ in range(4))
            o, lse = A.flash_fwd(q, k, v, True)
            delta = A.attention_delta(o, do)
            qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
            oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
            doh = do.transpose(1, 2)
            line = {"tree": A.__file__, "shape": key, "dims": shape,
                    "dtype": str(dtype).replace("torch.", ""), "causal": True,
                    "flash_fwd": readings(lambda: A.flash_fwd(q, k, v, True)),
                    "flash_bwd_dq": readings(
                        lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, True)),
                    "flash_bwd_dkv": readings(
                        lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, True)),
                    "sdpa": readings(lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, is_causal=True)),
                    "sdpa_bwd": readings(lambda: torch.autograd.grad(
                        oh, (qh, kh, vh), doh, retain_graph=True))}
            if key == "a":
                line["in_context"] = {
                    "flash_fwd": in_context(lambda: A.flash_fwd(q, k, v, True),
                                            "flash_fwd_kernel", dev),
                    "flash_bwd_dq": in_context(
                        lambda: A.flash_bwd_dq(q, k, v, do, lse, delta, True),
                        "flash_bwd_dq_kernel", dev),
                    "flash_bwd_dkv": in_context(
                        lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta, True),
                        "flash_bwd_dkv_kernel", dev)}
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
