"""Runtime-resilience primitives: backoff, deadline budgets, breakers.

The serving stack (artifact store, selector, engine) rides through
transient faults with three small, composable, stdlib-only pieces:

:class:`BackoffPolicy`
    Seeded-jitter exponential backoff.  The jitter stream is derived
    from ``sha1(seed | salt)`` — **not** ``hash()``, which is
    per-process salted for strings — so a retry schedule is
    reproducible across runs and processes.  That determinism is what
    lets the chaos drills assert exact retry counts and the tests
    compare delay sequences byte-for-byte.

:class:`DeadlineBudget`
    A monotonic wall-clock budget shared across a retry loop or a bulk
    operation (``warm_start(verify=True)`` bounds its verification pass
    with one).  The clock is injectable so tests drive time by hand.

:class:`CircuitBreaker`
    closed → (``failure_threshold`` consecutive failures) → open →
    (``reset_s`` elapsed) → half-open → (probe success → closed, probe
    failure → open again).  While open, :meth:`CircuitBreaker.allow`
    returns False so callers skip the failing dependency entirely and
    fall back (the engine falls to the selector's deadline-exempt base
    rung).  Every trip/close is counted and traced.

:func:`call_with_retries`
    Ties the three together around one callable.

Everything here is instrumented through ``repro_torch.obs`` — counters
``resilience.retries`` / ``resilience.giveups`` /
``breaker.<name>.trips`` and tracer events — so every retry and trip is
visible in traces and forensics dumps.  No module-level mutable state:
all bookkeeping lives on instances behind instance locks.
"""

from __future__ import annotations

import hashlib
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import TRACER

__all__ = [
    "BackoffPolicy",
    "BreakerOpen",
    "CircuitBreaker",
    "DeadlineBudget",
    "call_with_retries",
]


class BreakerOpen(RuntimeError):
    """Raised by :func:`call_with_retries` when the breaker refuses the
    call — the protected function was *not* invoked."""


def _seed_int(seed: int, salt: str) -> int:
    digest = hashlib.sha1(f"{seed}|{salt}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


@dataclass(frozen=True)
class BackoffPolicy:
    """Deterministic seeded-jitter exponential backoff.

    ``delays(salt)`` yields the sleep before each retry — at most
    ``max_attempts - 1`` values for ``max_attempts`` total tries.  Each
    delay is ``min(base_s * factor**i, max_s)`` with the top ``jitter``
    fraction randomized by a :class:`random.Random` seeded from
    ``(seed, salt)``, so two callers with different salts (e.g. two
    artifact paths) decorrelate without losing reproducibility.
    """

    base_s: float = 0.001
    factor: float = 2.0
    max_s: float = 0.25
    jitter: float = 0.5
    max_attempts: int = 4
    seed: int = 0

    def delays(self, salt: str = "") -> Iterator[float]:
        rng = random.Random(_seed_int(self.seed, salt))
        for i in range(max(0, self.max_attempts - 1)):
            cap = min(self.base_s * (self.factor ** i), self.max_s)
            yield cap * (1.0 - self.jitter) + cap * self.jitter * rng.random()


class DeadlineBudget:
    """A wall-clock budget: ``remaining()`` counts down from ``budget_s``
    on the (injectable, monotonic) ``clock``.  ``clamp(delay)`` bounds a
    backoff sleep so a retry loop can never overshoot its deadline."""

    def __init__(self, budget_s: float,
                 clock: Callable[[], float] = time.monotonic):
        if budget_s <= 0:
            raise ValueError("budget_s must be > 0")
        self.budget_s = float(budget_s)
        self._clock = clock
        self._t0 = clock()

    def elapsed(self) -> float:
        return self._clock() - self._t0

    def remaining(self) -> float:
        return max(0.0, self.budget_s - self.elapsed())

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def clamp(self, delay_s: float) -> float:
        return min(delay_s, self.remaining())


class CircuitBreaker:
    """Consecutive-failure circuit breaker with a timed half-open probe.

    Thread-safe via an instance lock; the clock is injectable for tests.
    ``trip_count`` counts closed→open *and* half-open→open transitions
    (also surfaced as the ``breaker.<name>.trips`` counter).
    """

    def __init__(self, name: str = "default", *,
                 failure_threshold: int = 3, reset_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_s = float(reset_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._trips = 0

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    @property
    def trip_count(self) -> int:
        with self._lock:
            return self._trips

    def _maybe_half_open(self) -> None:
        # caller holds the lock
        if self._state == "open" \
                and self._clock() - self._opened_at >= self.reset_s:
            self._state = "half-open"
            TRACER.event("breaker.half_open", breaker=self.name)

    def allow(self) -> bool:
        """May the protected call proceed?  False only while open (a
        half-open breaker admits the probe call)."""
        with self._lock:
            self._maybe_half_open()
            return self._state != "open"

    def record_success(self) -> None:
        with self._lock:
            closing = self._state != "closed"
            self._state = "closed"
            self._failures = 0
        if closing:
            TRACER.event("breaker.close", breaker=self.name)

    def record_failure(self) -> None:
        with self._lock:
            self._maybe_half_open()
            if self._state == "half-open":
                tripped = True  # failed probe: straight back to open
            else:
                self._failures += 1
                tripped = self._state == "closed" \
                    and self._failures >= self.failure_threshold
            if tripped:
                self._state = "open"
                self._failures = 0
                self._opened_at = self._clock()
                self._trips += 1
        if tripped:
            obs_metrics.counter(f"breaker.{self.name}.trips").inc()
            TRACER.event("breaker.trip", breaker=self.name)


def call_with_retries(
    fn: Callable[[], object],
    *,
    policy: BackoffPolicy | None = None,
    budget: DeadlineBudget | None = None,
    retry_on: tuple = (OSError,),
    breaker: CircuitBreaker | None = None,
    sleep: Callable[[float], None] = time.sleep,
    name: str = "op",
    salt: str = "",
) -> object:
    """Call ``fn`` until it succeeds, retrying ``retry_on`` exceptions
    under ``policy``'s deterministic backoff, bounded by ``budget``.

    Raises :class:`BreakerOpen` (without calling ``fn``) when the
    breaker is open; re-raises the last exception once attempts or
    budget run out.  Successes and failures feed the breaker.
    """
    policy = policy if policy is not None else BackoffPolicy()
    delays = policy.delays(salt or name)
    attempts = 0
    outcome = "ok"
    sp = TRACER.start("resilience.retry", op=name) if TRACER else None
    try:
        while True:
            if breaker is not None and not breaker.allow():
                outcome = "breaker-open"
                raise BreakerOpen(name)
            attempts += 1
            try:
                result = fn()
            except retry_on:
                if breaker is not None:
                    breaker.record_failure()
                obs_metrics.counter("resilience.retries").inc()
                delay = next(delays, None)
                if delay is None or (budget is not None and budget.expired()):
                    outcome = "exhausted"
                    obs_metrics.counter("resilience.giveups").inc()
                    raise
                if budget is not None:
                    delay = budget.clamp(delay)
                TRACER.event("resilience.retry", op=name, attempt=attempts,
                             delay_s=round(delay, 6))
                if delay > 0.0:
                    sleep(delay)
            else:
                if breaker is not None:
                    breaker.record_success()
                return result
    finally:
        if sp:
            TRACER.finish(sp, outcome=outcome, attempts=attempts)
