"""Capped exponential backoff with full jitter: the one retry loop, a copy
of ``fedml_tpu/robustness/retry.py`` (the port imports nothing of the JAX
package).

MQTT reconnect (``comm/mqtt.py``) and dataset downloads
(``data/acquire.py``) share this policy. Full jitter (delay = uniform(0,
min(cap, base * mult^attempt))) is the AWS-architecture variant: under
correlated failures it spreads the retry herd across the whole window
instead of synchronizing it at the cap.

Everything time-like is injectable (``sleep``, ``clock``, ``rng``) so the
backoff sequence is unit-testable deterministically: tests inject a fake
clock and a recorded rng and assert the exact delay sequence, with no real
sleeping.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type


@dataclass(frozen=True)
class RetryPolicy:
    """How to retry: attempts, backoff shape, deadline, what is retryable.

    max_attempts counts total calls (first try included). base_delay is the
    pre-jitter delay after attempt 0; each subsequent failure multiplies it
    by `multiplier`, capped at `max_delay`. With jitter on, the actual sleep
    is uniform in [0, capped_delay]. `deadline` (seconds, measured on the
    injected clock from the first attempt) bounds the whole loop: each sleep
    is clamped to the remaining budget (the loop never sleeps past the
    deadline), and once no budget remains the loop stops retrying and raises
    RetryError.
    """

    max_attempts: int = 5
    base_delay: float = 0.2
    max_delay: float = 30.0
    multiplier: float = 2.0
    jitter: bool = True
    deadline: Optional[float] = None
    retryable: Tuple[Type[BaseException], ...] = (
        ConnectionError, TimeoutError, OSError)

    def delay_for(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        """Pre-sleep delay after failed attempt `attempt` (0-based)."""
        capped = min(self.max_delay, self.base_delay * self.multiplier ** attempt)
        if not self.jitter:
            return capped
        return ((rng or random).random()) * capped


class RetryError(Exception):
    """All attempts exhausted (or deadline passed). `.last` is the final
    underlying exception, `.attempts` how many calls were made."""

    def __init__(self, message: str, last: BaseException, attempts: int):
        super().__init__(message)
        self.last = last
        self.attempts = attempts


def call_with_retry(
    fn: Callable,
    *args,
    policy: Optional[RetryPolicy] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    rng: Optional[random.Random] = None,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    abort: Optional[Callable[[], bool]] = None,
    **kwargs,
):
    """Call fn(*args, **kwargs), retrying per `policy`.

    on_retry(attempt, exc, delay) fires before each sleep — callers log or
    count there. `abort()` is polled before every attempt and before every
    sleep; returning True stops the loop immediately (re-raising the last
    exception, or RetryError("aborted") before any attempt) — MQTT clients
    pass their shutdown Event here so a closing client never sits out a
    30 s backoff.
    """
    policy = policy or RetryPolicy()
    if policy.max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {policy.max_attempts}")
    start = clock()
    last: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        if abort is not None and abort():
            if last is not None:
                raise last
            raise RetryError("aborted before first attempt",
                             RuntimeError("aborted"), 0)
        try:
            return fn(*args, **kwargs)
        except policy.retryable as e:
            last = e
            final = attempt == policy.max_attempts - 1
            delay = 0.0 if final else policy.delay_for(attempt, rng)
            if not final and policy.deadline is not None:
                remaining = policy.deadline - (clock() - start)
                if remaining <= 0.0:
                    final = True
                else:
                    # clamp, don't give up: a jittered draw that would
                    # overshoot sleeps exactly the remaining budget, so the
                    # deadline buys every attempt it can afford
                    delay = min(delay, remaining)
            if final:
                raise RetryError(
                    f"{fn!r} failed after {attempt + 1} attempt(s): {e}",
                    e, attempt + 1) from e
            if on_retry is not None:
                on_retry(attempt, e, delay)
            if abort is not None and abort():
                raise last
            if delay > 0:
                sleep(delay)
    raise AssertionError("unreachable")  # loop always returns or raises
