"""Retry policies: exponential backoff + jitter + deadline + breaker.

One policy object serves every unreliable edge in the system — the
HTTP transport's delivery loop, ``Messaging._send_remote``, and the
multihost coordinator join — so operational tuning is a handful of
environment variables instead of per-call-site constants (the
reference hard-codes its retry constants inline,
pydcop/infrastructure/communication.py:66-78).

Determinism: jitter draws from a caller-supplied ``random.Random`` so
chaos tests can fix the whole retry trajectory with one seed; without
one the delays are deterministic (pure exponential, no jitter).

A copy of ``pydcop_tpu/resilience/retry.py`` (pure Python).
"""

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

logger = logging.getLogger("pydcop.resilience.retry")


class RetryExhaustedError(Exception):
    """All attempts failed; ``last_error`` holds the final cause."""

    def __init__(self, message: str, last_error: Optional[BaseException]):
        super().__init__(message)
        self.last_error = last_error


class CircuitOpenError(Exception):
    """The circuit breaker is open: the call was not attempted."""


class CircuitBreaker:
    """Per-destination failure latch (closed → open → half-open).

    After ``failure_threshold`` consecutive failures the circuit opens
    and :meth:`allow` answers False — callers skip the doomed attempt
    (and its connect timeout) entirely.  After ``reset_timeout``
    seconds one probe call is allowed through (half-open); its outcome
    closes or re-opens the circuit.  Thread-safe: transports share one
    breaker per destination across sender threads.
    """

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout: float = 2.0,
                 name: Optional[str] = None):
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.name = name  # destination label for trace/metrics events
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probing = False
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if time.monotonic() - self._opened_at >= self.reset_timeout:
                return "half_open"
            return "open"

    def allow(self) -> bool:
        """True when a call may be attempted now.  In the half-open
        state only ONE caller gets the probe; others stay blocked until
        its outcome is recorded."""
        with self._lock:
            if self._opened_at is None:
                return True
            if time.monotonic() - self._opened_at < self.reset_timeout:
                return False
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self):
        with self._lock:
            reclosed = self._opened_at is not None
            self._failures = 0
            self._opened_at = None
            self._probing = False
        if reclosed:
            from pydcop_tpu_torch.observability.trace import tracer

            if tracer.enabled:
                tracer.instant("breaker_close", "resilience",
                               dest=self.name or "?")

    def record_failure(self):
        with self._lock:
            self._failures += 1
            self._probing = False
            tripped = False
            if self._failures >= self.failure_threshold:
                if self._opened_at is None:
                    tripped = True
                    logger.debug(
                        "Circuit opened after %d failures", self._failures
                    )
                # A failed half-open probe re-arms the full timeout.
                self._opened_at = time.monotonic()
        if tripped:
            # A trip is a rare, operationally-significant event: it is
            # counted unconditionally (breaker state belongs in every
            # metrics dump) and traced when a trace is being taken.
            from pydcop_tpu_torch.observability.metrics import registry
            from pydcop_tpu_torch.observability.trace import tracer

            registry.counter(
                "pydcop_breaker_trips_total",
                "Circuit breakers opened after repeated failures",
            ).inc(dest=self.name or "?")
            if tracer.enabled:
                tracer.instant("breaker_trip", "resilience",
                               dest=self.name or "?",
                               failures=self._failures)

    def reset(self):
        self.record_success()


def _env_float(name: str, default: Optional[float]) -> Optional[float]:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return float(raw)


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with optional jitter and overall deadline.

    ``delay_for(attempt)`` (attempt 1 = the delay before the first
    RE-try) is ``min(base_delay * multiplier**(attempt-1), max_delay)``
    plus up to ``jitter`` fraction of itself, drawn from ``rng`` when
    one is given.  ``deadline`` bounds the whole :meth:`call` (first
    attempt included); ``max_attempts`` bounds the attempt count.
    Either bound alone is enough; with neither the policy would retry
    forever, so ``call`` requires at least one.
    """

    max_attempts: Optional[int] = 5
    base_delay: float = 0.1
    max_delay: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.1
    deadline: Optional[float] = None

    @classmethod
    def from_env(cls, prefix: str = "PYDCOP_RETRY_",
                 **defaults) -> "RetryPolicy":
        """Build a policy from ``<prefix>MAX_ATTEMPTS / BASE_DELAY /
        MAX_DELAY / MULTIPLIER / JITTER / DEADLINE`` env vars, falling
        back to ``defaults`` then the dataclass defaults."""
        base = cls(**defaults)
        raw_attempts = os.environ.get(prefix + "MAX_ATTEMPTS")
        max_attempts = (
            int(raw_attempts) if raw_attempts not in (None, "")
            else base.max_attempts
        )
        return cls(
            max_attempts=max_attempts,
            base_delay=_env_float(prefix + "BASE_DELAY", base.base_delay),
            max_delay=_env_float(prefix + "MAX_DELAY", base.max_delay),
            multiplier=_env_float(prefix + "MULTIPLIER", base.multiplier),
            jitter=_env_float(prefix + "JITTER", base.jitter),
            deadline=_env_float(prefix + "DEADLINE", base.deadline),
        )

    def delay_for(self, attempt: int, rng=None) -> float:
        """Backoff before retry ``attempt`` (1-based), jittered."""
        delay = min(
            self.base_delay * self.multiplier ** max(attempt - 1, 0),
            self.max_delay,
        )
        if self.jitter and rng is not None:
            delay += delay * self.jitter * rng.random()
        return delay

    def call(self, fn: Callable, *args,
             retry_on: Tuple[Type[BaseException], ...] = (Exception,),
             rng=None,
             sleep: Callable[[float], None] = time.sleep,
             breaker: Optional[CircuitBreaker] = None,
             on_retry: Optional[Callable] = None,
             **kwargs):
        """Run ``fn`` under this policy; returns its result.

        Raises :class:`CircuitOpenError` without attempting when
        ``breaker`` is open, and :class:`RetryExhaustedError` once
        attempts or the deadline run out.  ``on_retry(attempt, error,
        delay)`` is called before each backoff sleep.
        """
        if self.max_attempts is None and self.deadline is None:
            raise ValueError(
                "RetryPolicy.call needs max_attempts or deadline"
            )
        start = time.monotonic()
        attempt = 0
        last_error: Optional[BaseException] = None
        while True:
            if breaker is not None and not breaker.allow():
                raise CircuitOpenError(
                    f"circuit open (state={breaker.state})"
                )
            attempt += 1
            try:
                result = fn(*args, **kwargs)
            except retry_on as e:
                last_error = e
                if breaker is not None:
                    breaker.record_failure()
            else:
                if breaker is not None:
                    breaker.record_success()
                return result
            if self.max_attempts is not None and \
                    attempt >= self.max_attempts:
                raise RetryExhaustedError(
                    f"{attempt} attempts failed: {last_error}",
                    last_error,
                )
            delay = self.delay_for(attempt, rng)
            if self.deadline is not None and \
                    time.monotonic() + delay - start > self.deadline:
                raise RetryExhaustedError(
                    f"deadline {self.deadline}s exceeded after "
                    f"{attempt} attempts: {last_error}",
                    last_error,
                )
            if on_retry is not None:
                try:
                    on_retry(attempt, last_error, delay)
                except Exception:
                    logger.exception("on_retry callback failed")
            from pydcop_tpu_torch.observability.trace import tracer

            if tracer.enabled:
                tracer.instant(
                    "retry", "resilience", attempt=attempt,
                    delay=delay, error=str(last_error)[:200],
                )
            sleep(delay)
