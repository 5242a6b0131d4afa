"""Host-side round guard: loss-spike and non-finite-global detection
(PyTorch form of ``fedml_tpu/robustness/guard.py``; the same verdicts and
reason strings).

The in-round quarantine (``algorithms/aggregators.py``) stops a client's
non-finite update from entering the aggregate; the guard is the outer line
for what the quarantine cannot see: finite garbage that sends the global
loss off a cliff, and any non-finite value that reaches the globals by a
path without quarantine. The drive loop (``FedAvgAPI.train``) consults the
guard after every round; on a bad verdict it restores the pre-round
snapshot and re-runs the round with a fresh rng salt.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch


class GuardVerdict(NamedTuple):
    ok: bool
    reason: str  # "" when ok


def _all_finite(variables: dict) -> bool:
    """Every floating leaf of ``variables`` is finite: one reduction per
    leaf on the device, stacked, and one host read."""
    flags = [torch.isfinite(t).all() for t in variables.values()
             if t.is_floating_point() or t.is_complex()]
    if not flags:
        return True
    return bool(torch.stack(flags).all().item())


@dataclass
class RoundGuard:
    """Flags a round when the train loss goes non-finite, the global model
    picks up a non-finite leaf, or the loss spikes past `spike_factor` x the
    median of the last `window` accepted losses (the spike test arms after
    `min_history` accepted rounds: early training is noisy).

    `max_retries` bounds how many times the drive loop re-runs one round on
    a bad verdict before accepting it (a permanently poisoned cohort must
    not livelock the run).
    """

    spike_factor: float = 4.0
    window: int = 8
    min_history: int = 3
    max_retries: int = 2

    def __post_init__(self):
        self._losses: deque = deque(maxlen=self.window)

    def inspect(self, round_idx: int, loss: float,
                global_variables: Optional[dict] = None) -> GuardVerdict:
        """Judge one completed round. Accepted losses enter the history;
        rejected rounds leave it untouched (a spike must not poison the
        baseline it is judged against). The drive loop ledgers every
        verdict as a `guard_verdict` event."""
        loss = float(loss)
        if not np.isfinite(loss):
            return GuardVerdict(False, f"round {round_idx}: non-finite train "
                                       f"loss ({loss})")
        if global_variables is not None and not _all_finite(global_variables):
            return GuardVerdict(False, f"round {round_idx}: non-finite leaf "
                                       f"in global variables")
        if len(self._losses) >= self.min_history:
            baseline = float(np.median(self._losses))
            if baseline > 0 and loss > self.spike_factor * baseline:
                return GuardVerdict(
                    False, f"round {round_idx}: loss {loss:.4g} spiked past "
                           f"{self.spike_factor}x median {baseline:.4g}")
        self._losses.append(loss)
        return GuardVerdict(True, "")

    def reset(self):
        self._losses.clear()
