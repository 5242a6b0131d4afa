"""Seeded deterministic fault schedules (the chaos harness; a copy of
``fedml_tpu/robustness/chaos.py``, host numpy, whose masks and faulted
inputs are the JAX module's bit for bit).

Faults are decided per round from ``np.random.default_rng([seed,
round_idx])``, a pure function of (plan, round_idx, n_clients) and not of
the run's history, so a resumed run, a guard retry and the pipelined
stager all see the same schedule.

Injection happens at the host boundary, before dispatch: dropped clients
become zeros in the ``participation`` mask (the round gives them zero
aggregation weight, ``core/builder.py``), NaN-poisoned clients get NaN
written into their input rows (their update goes non-finite and the
round's quarantine stage excludes it), corrupted clients get a large
multiplicative perturbation (finite garbage, for the guard's loss-spike
test rather than the quarantine).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional

import numpy as np

from fedml_tpu_torch import telemetry

# Distinct third seed word for the straggler-latency rng stream: keeps
# `latencies` draws independent of the `events` stream at the same
# (seed, round_idx) without disturbing its byte-stable draw order.
_STRAGGLER_STREAM = 0x5BA6


class FaultEvents(NamedTuple):
    """Host-side fault decisions for one round (numpy, length n_clients)."""

    participation: np.ndarray  # bool — False = client dropped this round
    nan_mask: np.ndarray  # bool — True = client's update poisoned with NaN
    corrupt_mask: np.ndarray  # bool — True = client data corrupted (finite)

    @property
    def dropped(self) -> int:
        return int((~self.participation).sum())


@dataclass(frozen=True)
class FaultPlan:
    """Per-round fault rates plus optional per-round overrides.

    overrides maps round_idx -> {"drop_rate": ..., "nan_rate": ...,
    "corrupt_rate": ...} (missing keys inherit the plan-level rate), so a
    test can script e.g. "round 3 loses everyone".
    """

    seed: int = 0
    drop_rate: float = 0.0
    nan_rate: float = 0.0
    corrupt_rate: float = 0.0
    # straggler plan (buffered aggregation): each straggling client's update
    # arrives `latency` dispatch rounds late (1..straggler_rounds, uniform)
    # instead of at its birth round. Drawn from a SEPARATE rng stream
    # (seed, round_idx, _STRAGGLER_STREAM) so enabling stragglers never
    # perturbs the drop/nan/corrupt draws above — seeded chaos trajectories
    # from earlier PRs stay bit-identical.
    straggler_rate: float = 0.0
    straggler_rounds: int = 0
    overrides: Dict[int, Dict[str, float]] = field(default_factory=dict)

    def rates_for(self, round_idx: int) -> Dict[str, float]:
        base = {"drop_rate": self.drop_rate, "nan_rate": self.nan_rate,
                "corrupt_rate": self.corrupt_rate}
        base.update(self.overrides.get(round_idx, {}))
        return base

    def events(self, round_idx: int, n_clients: int) -> FaultEvents:
        """Deterministic fault decisions for this round's sampled cohort."""
        rates = self.rates_for(round_idx)
        rng = np.random.default_rng([self.seed, round_idx])
        drop = rng.random(n_clients) < rates["drop_rate"]
        nan = rng.random(n_clients) < rates["nan_rate"]
        corrupt = rng.random(n_clients) < rates["corrupt_rate"]
        # a dropped client never reaches the round program — its other
        # faults are moot; keep the masks disjoint so counts add up
        nan &= ~drop
        corrupt &= ~drop & ~nan
        events = FaultEvents(participation=~drop, nan_mask=nan,
                             corrupt_mask=corrupt)
        telemetry.emit("chaos_inject", round=round_idx,
                       dropped=int(drop.sum()), nan=int(nan.sum()),
                       corrupt=int(corrupt.sum()))
        return events

    def events_block(self, round_start: int, num_rounds: int,
                     n_clients: int) -> tuple:
        """Fault decisions for rounds [round_start, round_start+num_rounds)
        in one call (the JAX superstep drive's [K, C] mask precompute).

        Returns (events, masks): `events` is the per-round FaultEvents list
        (each drawn through `events()`, so per-round purity, overrides AND
        the per-round chaos_inject telemetry are identical to K eager
        calls), `masks` a dict of stacked [K, C] bool arrays keyed
        "participation" / "nan" / "corrupt"."""
        evs = [self.events(round_start + j, n_clients)
               for j in range(num_rounds)]
        masks = {
            "participation": np.stack([e.participation for e in evs]),
            "nan": np.stack([e.nan_mask for e in evs]),
            "corrupt": np.stack([e.corrupt_mask for e in evs]),
        }
        return evs, masks

    def latencies(self, round_idx: int, n_clients: int) -> np.ndarray:
        """Per-client arrival latency (int32 dispatch rounds, 0 = on time)
        for the cohort dispatched at `round_idx` — the seeded straggler
        plan. Pure in (plan, round_idx, n_clients), like `events`, so a
        resumed or guard-retried run replays the identical arrival
        schedule."""
        lat = np.zeros(n_clients, np.int32)
        if self.straggler_rate <= 0.0 or self.straggler_rounds <= 0:
            return lat
        rng = np.random.default_rng([self.seed, round_idx,
                                     _STRAGGLER_STREAM])
        straggle = rng.random(n_clients) < self.straggler_rate
        draws = rng.integers(1, self.straggler_rounds + 1, n_clients,
                             dtype=np.int32)
        lat[straggle] = draws[straggle]
        return lat


def apply_faults(events: FaultEvents, x: np.ndarray) -> np.ndarray:
    """Perturb the cohort's packed input rows [C, n_max, ...] per `events`.

    Only float inputs can carry NaN; for integer/token inputs the NaN fault
    degrades to corruption (max-value fill) which still derails the client's
    update without violating the dtype. Returns a copy; `x` is untouched.
    """
    x = np.asarray(x)
    if not (events.nan_mask.any() or events.corrupt_mask.any()):
        return x
    out = np.array(x, copy=True)
    is_float = np.issubdtype(out.dtype, np.floating)
    for c in np.nonzero(events.nan_mask)[0]:
        if is_float:
            out[c] = np.nan
        else:
            out[c] = np.iinfo(out.dtype).max
    for c in np.nonzero(events.corrupt_mask)[0]:
        if is_float:
            out[c] = out[c] * 1e3 + 7.0
        else:
            out[c] = (out[c] + 13) % max(int(out.max()) + 1, 2)
    return out


def summarize(events: Optional[FaultEvents]) -> Dict[str, int]:
    """Host-side event counts for logging (all zeros when chaos is off)."""
    if events is None:
        return {"chaos_dropped": 0, "chaos_nan": 0, "chaos_corrupt": 0}
    return {
        "chaos_dropped": int((~events.participation).sum()),
        "chaos_nan": int(events.nan_mask.sum()),
        "chaos_corrupt": int(events.corrupt_mask.sum()),
    }
