"""The port's ``resilience/retry.py`` (a copy of the reference's):
``TestRetryPolicy`` and ``TestCircuitBreaker`` of
``tests/unit/test_resilience_battery.py``, case for case, against the
port, and the two packages' policies and breakers side by side.

Tolerance: none — the backoff delays (seeded jitter included), the
breaker's state sequence and the raised types are the reference's.
"""

import random
import time

import pytest

import pydcop_tpu.resilience.retry as reference_retry
from pydcop_tpu_torch.resilience.retry import (
    CircuitBreaker,
    CircuitOpenError,
    RetryExhaustedError,
    RetryPolicy,
)


class TestRetryPolicy:
    def test_backoff_is_exponential_and_capped(self):
        policy = RetryPolicy(base_delay=0.1, multiplier=2.0,
                             max_delay=0.5, jitter=0.0)
        delays = [policy.delay_for(a) for a in range(1, 6)]
        assert delays == [0.1, 0.2, 0.4, 0.5, 0.5]

    def test_jitter_is_bounded_and_seeded(self):
        import random

        policy = RetryPolicy(base_delay=1.0, jitter=0.5)
        d1 = policy.delay_for(1, random.Random(7))
        d2 = policy.delay_for(1, random.Random(7))
        assert d1 == d2
        assert 1.0 <= d1 <= 1.5

    def test_call_retries_until_success(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("down")
            return "up"

        policy = RetryPolicy(max_attempts=5, base_delay=0.001,
                             jitter=0.0)
        assert policy.call(flaky) == "up"
        assert len(calls) == 3

    def test_call_exhausts_attempts(self):
        policy = RetryPolicy(max_attempts=3, base_delay=0.001,
                             jitter=0.0)
        with pytest.raises(RetryExhaustedError) as exc:
            policy.call(lambda: (_ for _ in ()).throw(OSError("x")))
        assert isinstance(exc.value.last_error, OSError)

    def test_deadline_stops_before_max_attempts(self):
        policy = RetryPolicy(max_attempts=1000, base_delay=0.2,
                             jitter=0.0, deadline=0.1)
        calls = []

        def failing():
            calls.append(1)
            raise OSError("x")

        with pytest.raises(RetryExhaustedError):
            policy.call(failing)
        assert len(calls) == 1  # next backoff would cross the deadline

    def test_call_requires_a_bound(self):
        policy = RetryPolicy(max_attempts=None, deadline=None)
        with pytest.raises(ValueError):
            policy.call(lambda: None)

    def test_from_env(self, monkeypatch):
        monkeypatch.setenv("PYDCOP_RETRY_MAX_ATTEMPTS", "9")
        monkeypatch.setenv("PYDCOP_RETRY_BASE_DELAY", "0.25")
        monkeypatch.setenv("PYDCOP_RETRY_DEADLINE", "12")
        policy = RetryPolicy.from_env("PYDCOP_RETRY_")
        assert policy.max_attempts == 9
        assert policy.base_delay == 0.25
        assert policy.deadline == 12
        # Unset vars keep the passed defaults.
        policy = RetryPolicy.from_env("PYDCOP_OTHER_", max_attempts=2)
        assert policy.max_attempts == 2


class TestCircuitBreaker:
    def test_opens_after_threshold_then_half_opens(self):
        breaker = CircuitBreaker(failure_threshold=3,
                                 reset_timeout=0.1)
        for _ in range(3):
            assert breaker.allow()
            breaker.record_failure()
        assert breaker.state == "open"
        assert not breaker.allow()
        time.sleep(0.12)
        assert breaker.state == "half_open"
        # Exactly one probe allowed, and a success closes the circuit.
        assert breaker.allow()
        assert not breaker.allow()
        breaker.record_success()
        assert breaker.state == "closed"
        assert breaker.allow()

    def test_failed_probe_rearms_timeout(self):
        breaker = CircuitBreaker(failure_threshold=1,
                                 reset_timeout=0.1)
        breaker.record_failure()
        time.sleep(0.12)
        assert breaker.allow()  # probe
        breaker.record_failure()
        assert breaker.state == "open"
        assert not breaker.allow()

    def test_policy_call_respects_breaker(self):
        breaker = CircuitBreaker(failure_threshold=1,
                                 reset_timeout=60.0)
        policy = RetryPolicy(max_attempts=1)
        with pytest.raises(RetryExhaustedError):
            policy.call(
                lambda: (_ for _ in ()).throw(OSError("x")),
                breaker=breaker,
            )
        with pytest.raises(CircuitOpenError):
            policy.call(lambda: "never runs", breaker=breaker)


@pytest.mark.parametrize("kw", [
    dict(base_delay=0.1, multiplier=2.0, max_delay=0.5, jitter=0.0),
    dict(base_delay=1.0, jitter=0.5),
    dict(base_delay=0.03, multiplier=3.0, max_delay=2.0, jitter=0.25),
])
def test_delays_equal_the_reference(kw):
    """The same policy gives the same delay at every attempt, with the
    same seeded jitter draws."""
    ours = RetryPolicy(**kw)
    theirs = reference_retry.RetryPolicy(**kw)
    rng_a, rng_b = random.Random(11), random.Random(11)
    for attempt in range(1, 9):
        assert ours.delay_for(attempt, rng_a) == \
            theirs.delay_for(attempt, rng_b)


def test_breaker_states_equal_the_reference():
    """One failure/success script drives both breakers through the
    same states and the same allow() answers."""
    ours = CircuitBreaker(failure_threshold=2, reset_timeout=0.05)
    theirs = reference_retry.CircuitBreaker(failure_threshold=2,
                                            reset_timeout=0.05)
    script = ["allow", "fail", "allow", "fail", "allow", "wait",
              "allow", "allow", "fail", "wait", "allow", "ok", "allow"]
    for step in script:
        got = []
        for breaker in (ours, theirs):
            if step == "allow":
                got.append(breaker.allow())
            elif step == "fail":
                breaker.record_failure()
            elif step == "ok":
                breaker.record_success()
            got.append(breaker.state)
        if step == "wait":
            time.sleep(0.06)
            got = [ours.state, theirs.state]
        assert got[:len(got) // 2] == got[len(got) // 2:], (step, got)
