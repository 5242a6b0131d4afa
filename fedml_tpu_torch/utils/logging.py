"""Metrics logging in wandb's file layout, without wandb (PyTorch port of
``fedml_tpu/utils/logging.py``).

The reference logs Train/Acc, Train/Loss, Test/Acc and Test/Loss per round
through wandb (reference FedAVGAggregator.py:136-161), and its CI reads
``wandb/latest-run/files/wandb-summary.json`` (CI-script-fedavg.sh:44-50).
``MetricsLogger`` writes the same files: a per-step ``history.jsonl``, a
``wandb-summary.json`` holding the latest value of every key, and the run's
``config.json``.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any


class MetricsLogger:
    def __init__(self, run_dir: str = "./wandb/latest-run/files",
                 config: dict | None = None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.summary: dict[str, Any] = {}
        self._history_path = os.path.join(run_dir, "history.jsonl")
        self._summary_path = os.path.join(run_dir, "wandb-summary.json")
        self._t0 = time.time()
        if config:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, metrics: dict[str, Any], step: int | None = None):
        rec = dict(metrics)
        if step is not None:
            rec["round"] = step
        rec["_runtime"] = round(time.time() - self._t0, 3)
        with open(self._history_path, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")
        self.summary.update(rec)
        with open(self._summary_path, "w") as f:
            json.dump(self.summary, f, default=float)

    def finish(self):
        """End of the run (the files are complete after every ``log``)."""


class RoundTimer:
    """Per-round wall-clock statistics of the rounds run inside it."""

    def __init__(self):
        self.times: list[float] = []
        self._start: float | None = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._start)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def summary(self) -> dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        return {
            "round_time_mean": self.mean,
            "round_time_p50": ts[len(ts) // 2],
            "round_time_max": ts[-1],
            "rounds_per_sec": 1.0 / self.mean if self.mean else 0.0,
        }


def profile_trace(log_dir: str | None = None):
    """A ``torch.profiler`` context over the host and, when there is one,
    the card, writing a TensorBoard trace into ``log_dir`` on exit."""
    import torch

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "fedml_tpu_torch_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
