"""Heartbeat failure detection: the phi-accrual suspicion estimator.

A copy of ``PhiAccrualEstimator`` from ``pydcop_tpu/resilience/
health.py`` (pure Python): it scores one member's heartbeat
inter-arrival history, ``phi(t) = -log10(P[interval > t])`` under a
normal fit, and counts silence in configured intervals for the bounded
death verdict.  The fleet router (serving/router.py) scores every
replica's /healthz answers with it.

The reference module's agent-runtime half — ``HealthComputation``,
``HeartbeatEmitter``, ``HealthMonitor`` and ``attach_health``, which
ride on ``infrastructure/*`` — is not ported (ROADMAP.md, Queue A
item 7, the agent runtime).
"""

import math
from collections import deque
from typing import Deque, Optional


class PhiAccrualEstimator:
    """Suspicion level from one agent's heartbeat arrival history.

    Keeps the last ``window`` inter-arrival intervals; :meth:`phi`
    scores the current silence against their normal fit:
    ``phi(t) = -log10(P[interval > t])``.  With too few samples the
    configured ``expected`` interval stands in for the mean.  The
    standard deviation is floored at 25% of the mean so a perfectly
    regular history cannot make the detector hair-triggered: a gap
    must be several expected intervals long before phi alone crosses
    the suspicion threshold.
    """

    def __init__(self, expected: float, window: int = 20):
        self.expected = expected
        self._intervals: Deque[float] = deque(maxlen=window)
        self.last_beat: Optional[float] = None
        self.beats = 0

    def beat(self, now: float):
        if self.last_beat is not None:
            # Clock hiccups (now <= last) contribute a zero interval.
            self._intervals.append(max(now - self.last_beat, 0.0))
        self.last_beat = now
        self.beats += 1

    def mean_interval(self) -> float:
        if not self._intervals:
            return self.expected
        # Never trust an estimate below the configured cadence: a
        # burst of queued heartbeats (delay fault released) would
        # otherwise shrink the mean toward 0 and make phi
        # hair-triggered on the next ordinary gap.
        return max(sum(self._intervals) / len(self._intervals),
                   self.expected)

    def missed(self, now: float, anchor: float) -> float:
        """Silence so far, in units of the CONFIGURED interval — not
        the adaptive mean: the miss count backs the death verdict,
        whose detection-latency bound (``dead_misses x interval``)
        must hold regardless of what a faulty link did to the observed
        arrival history (only phi, the advisory suspicion score,
        adapts to it)."""
        last = self.last_beat if self.last_beat is not None else anchor
        return max(now - last, 0.0) / self.expected

    def phi(self, now: float, anchor: float) -> float:
        """-log10 of the probability that a live agent stays silent
        this long, under a normal fit of the interval history."""
        last = self.last_beat if self.last_beat is not None else anchor
        elapsed = max(now - last, 0.0)
        mean = self.mean_interval()
        if len(self._intervals) >= 2:
            var = sum((x - mean) ** 2 for x in self._intervals) \
                / len(self._intervals)
            std = math.sqrt(var)
        else:
            std = 0.0
        std = max(std, 0.25 * mean, 1e-6)
        # P[interval > elapsed] under N(mean, std).
        z = (elapsed - mean) / std
        p_longer = 0.5 * math.erfc(z / math.sqrt(2.0))
        if p_longer <= 0.0:
            return float("inf")
        return -math.log10(p_longer)
