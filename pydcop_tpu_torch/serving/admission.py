"""Admission control for the solve service: backpressure + breaker.

Two rejection modes, mapped to distinct HTTP statuses by the front
end (serving/http.py):

- **Queue backpressure (429).** The request queue has a high-water
  mark; a submit that would push the depth past it is rejected
  *immediately* with :class:`QueueFull` — the client learns to back
  off now, instead of its request rotting in an unbounded queue (a 429,
  never a hang or a silently dropped request).

- **Circuit breaker (503).** Repeated dispatch failures (engine
  errors, ``RecoveryExhausted``) trip a
  :class:`~pydcop_tpu_torch.resilience.retry.CircuitBreaker`; while it is
  open every submit is rejected with :class:`ServiceUnavailable` so a
  sick engine sheds load instead of queueing doomed work.  After the
  reset timeout the breaker half-opens and the next dispatched batch
  is the probe: its outcome closes or re-opens the circuit.

Every rejection is counted in ``pydcop_requests_total{status}`` by
the service, so the request ledger balances even under overload.

A copy of ``pydcop_tpu/serving/admission.py`` (pure Python).
"""

from dataclasses import dataclass
from typing import Optional

from pydcop_tpu_torch.resilience.retry import CircuitBreaker


class AdmissionRejected(Exception):
    """Base: the request was refused at the door.  ``http_status``
    maps the subclass onto the wire."""

    http_status = 503


class QueueFull(AdmissionRejected):
    """Queue depth at/above the high-water mark: back off and retry."""

    http_status = 429


class ServiceUnavailable(AdmissionRejected):
    """The dispatch breaker is open: the engine is failing."""

    http_status = 503


@dataclass(frozen=True)
class AdmissionPolicy:
    """Knobs: ``high_water`` is the queue-depth rejection threshold;
    the breaker fields mirror CircuitBreaker's."""

    high_water: int = 256
    breaker_failures: int = 3
    breaker_reset_s: float = 5.0


class AdmissionController:
    """Stateless depth check + the service's dispatch breaker.

    The breaker is shared with the dispatch path: the scheduler calls
    :meth:`record_dispatch` after every batch, and :meth:`admit`
    refuses while the circuit is open.  Half-open intentionally
    admits — the next dispatch is the recovery probe.
    """

    def __init__(self, policy: Optional[AdmissionPolicy] = None):
        self.policy = policy or AdmissionPolicy()
        self.breaker = CircuitBreaker(
            failure_threshold=self.policy.breaker_failures,
            reset_timeout=self.policy.breaker_reset_s,
            name="serve_dispatch",
        )

    def admit(self, queue_depth: int) -> None:
        """Raise the matching :class:`AdmissionRejected` subclass when
        the request must be refused; return silently otherwise."""
        if self.breaker.state == "open":
            raise ServiceUnavailable(
                "dispatch circuit open after repeated engine failures; "
                f"retry after {self.policy.breaker_reset_s}s"
            )
        if queue_depth >= self.policy.high_water:
            raise QueueFull(
                f"request queue at high-water mark "
                f"({queue_depth}/{self.policy.high_water}); back off"
            )

    def record_dispatch(self, ok: bool) -> None:
        if ok:
            self.breaker.record_success()
            return
        was_open = self.breaker.state == "open"
        self.breaker.record_failure()
        if not was_open and self.breaker.state == "open":
            # The service just went 503: a postmortem bundle now
            # holds the dispatch failures that tripped the circuit.
            from pydcop_tpu_torch.observability import flight

            flight.trigger(
                "breaker_open", breaker="serve_dispatch",
                failure_threshold=self.policy.breaker_failures)

    @property
    def breaker_state(self) -> str:
        return self.breaker.state
