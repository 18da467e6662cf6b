"""Shared retry policy: exponential backoff, full jitter, deadline budgets.

Every reconnect loop in the stack (``Communicator``, ``ChannelGroup``,
``AnalysisSession``, ``GatewayClient``) used to roll its own linear
sleep; they now share this one policy so behaviour under faults is
uniform and testable (DESIGN.md §15).

The backoff follows the "full jitter" scheme: attempt ``k`` sleeps a
uniform random draw from ``[0, min(cap, base * 2**k)]``.  Jitter is what
prevents a fleet of producers that lost the same staging server from
reconnecting in lockstep; the deadline budget is what turns "hangs
forever" into a typed, catchable :class:`RetryExhausted`.

Callers drive the policy through :meth:`RetryPolicy.attempts`::

    for attempt in policy.attempts("staging reconnect"):
        try:
            return do_io()
        except ConnectionError as e:
            attempt.backoff(e)      # sleeps, or raises RetryExhausted

``attempt.backoff`` never sleeps while the caller holds a lock unless
the caller does — the policy itself takes none.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Iterator, Optional


class RetryExhausted(ConnectionError):
    """All retry attempts (or the deadline budget) were consumed.

    ``last`` carries the final underlying error so callers can still
    branch on the root cause after the policy gives up.
    """

    def __init__(self, msg: str, last: Optional[BaseException] = None):
        super().__init__(msg)
        self.last = last


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + full jitter, bounded by retries and a deadline.

    ``retries``     — max re-attempts after the first try (0 = fail fast).
    ``base_s``      — backoff scale: attempt k waits U(0, base * 2**k).
    ``cap_s``       — ceiling on a single sleep.
    ``deadline_s``  — total budget across all attempts incl. sleeps
                      (None = unbounded by time).
    ``seed``        — optional deterministic jitter (tests / chaos runs).
    """

    retries: int = 3
    base_s: float = 0.05
    cap_s: float = 2.0
    deadline_s: Optional[float] = None
    seed: Optional[int] = None

    def attempts(self, what: str = "operation") -> Iterator["_Attempt"]:
        """Yield one :class:`_Attempt` per try (``retries + 1`` total)."""
        rng = random.Random(self.seed) if self.seed is not None else random
        start = time.monotonic()
        k = 0
        while True:
            yield _Attempt(self, what, k, start, rng)
            k += 1

    def remaining(self, start: float) -> Optional[float]:
        if self.deadline_s is None:
            return None
        return self.deadline_s - (time.monotonic() - start)


class _Attempt:
    """One try under a :class:`RetryPolicy`; ``backoff`` sleeps or raises."""

    __slots__ = ("policy", "what", "index", "start", "_rng")

    def __init__(self, policy: RetryPolicy, what: str, index: int,
                 start: float, rng):
        self.policy = policy
        self.what = what
        self.index = index
        self.start = start
        self._rng = rng

    def backoff(self, err: Optional[BaseException] = None) -> None:
        """Record a failure: sleep before the next attempt, or raise
        :class:`RetryExhausted` when retries / the deadline ran out."""
        p = self.policy
        if self.index >= p.retries:
            raise RetryExhausted(
                f"{self.what}: gave up after {self.index + 1} attempts"
                + (f" ({err})" if err else ""), last=err) from err
        delay = self._rng.uniform(0.0, min(p.cap_s, p.base_s * (2 ** self.index)))
        left = p.remaining(self.start)
        if left is not None:
            if left <= 0:
                raise RetryExhausted(
                    f"{self.what}: deadline {p.deadline_s}s exhausted after "
                    f"{self.index + 1} attempts" + (f" ({err})" if err else ""),
                    last=err) from err
            delay = min(delay, left)
        if delay > 0:
            time.sleep(delay)
