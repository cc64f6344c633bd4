"""Rollback-and-recover for guarded engine segments.

Port of ``pydcop_tpu/resilience/recovery.py`` (single device).  A
NaN/Inf inside the solve loop silently corrupts every later cycle.
``run_checkpointed`` already pauses at every K-cycle segment boundary,
so that boundary becomes a guard: a device-side NaN/Inf scan over the
state (plus an optional cost-divergence window) whose verdict comes to
the host in the boundary's one transfer.

On a tripped guard the :class:`RecoveryPolicy` rolls the solve back to
the last validated snapshot (bit-identical restore, asserted) and
re-runs the segment with escalating intervention: (1) reseeded
tie-break noise on the messages, (2) a damping bump, (3) both, with a
fresh seed, until the restart budget is spent — then
:class:`RecoveryExhausted` carries the partial trajectory.  The noise
is ``jax.random``'s, bit for bit (``utils/prng.py``), so a recovered
run equals the reference's on the same inputs, on the CPU and on the
card.  With no trips the guarded run equals the unguarded one.

Every trip and every attempt is a trace instant/span and a registry
counter, as in the reference: a ``guard_trip`` instant and
``pydcop_guard_trips_total{kind}`` per trip, a ``recovery_rollback``
span and ``pydcop_recovery_attempts_total{action}`` per attempt, and
the flight recorder's ``guard_trip`` / ``recovery_exhausted``
triggers (postmortem bundles).

Device loss on the partitioned engine (``trip_shard``) takes its own
path: roll back, re-partition onto the surviving mesh
(``ShardedMaxSumEngine.repartition_after_loss``), remap the snapshot,
resume — with a ``shard_loss`` trip, a ``repartition`` rollback span
and the flight recorder's ``shard_loss`` trigger.
"""

import logging
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from pydcop_tpu_torch.observability import flight
from pydcop_tpu_torch.observability.metrics import registry as metrics_registry
from pydcop_tpu_torch.observability.trace import tracer
from pydcop_tpu_torch.utils import prng
from pydcop_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

logger = logging.getLogger("pydcop_tpu_torch.resilience.recovery")


class GuardViolation(NamedTuple):
    """One tripped segment guard.  ``shard`` is set only for
    ``shard_loss`` trips (the lost device's mesh position)."""

    kind: str      # "nonfinite" | "divergence" | "injected" |
    #                "shard_loss"
    cycle: int     # end cycle of the segment that tripped
    detail: str
    shard: Optional[int] = None

    def as_dict(self) -> Dict[str, Any]:
        out = {"kind": self.kind, "cycle": int(self.cycle),
               "detail": self.detail}
        if self.shard is not None:
            out["shard"] = int(self.shard)
        return out


class NoSurvivingDevices(RuntimeError):
    """A shard loss left the mesh empty: there is nothing left to
    re-partition onto.  Raised by the engine's shard-loss hook and
    turned into :class:`RecoveryExhausted` (with the partial
    trajectory) by the recovery run."""


class RecoveryExhausted(RuntimeError):
    """The restart budget is spent: the solve cannot self-heal.

    ``partial`` holds the last VALIDATED assignment and cycle
    (``assignment`` is None when the guard tripped before any segment
    validated), with the violation history and attempt count."""

    def __init__(self, message: str, *,
                 violations: List[GuardViolation],
                 attempts: int,
                 partial: Dict[str, Any]):
        super().__init__(message)
        self.violations = list(violations)
        self.attempts = attempts
        self.partial = dict(partial)


@dataclass
class RecoveryPolicy:
    """Guard thresholds + the escalation ladder of ``run_checkpointed``.

    The NaN/Inf guard is always on.  The cost-divergence guard is
    opt-in (``divergence_window > 0``): it trips when every cost in
    the last ``divergence_window`` segment boundaries exceeds
    ``divergence_factor * |best cost seen| + divergence_slack``.

    ``trip_cycles`` injects guard trips (tests, chaos runs): the first
    segment ending at or past each listed cycle trips once with kind
    ``"injected"``.

    ``trip_shard`` injects DEVICE LOSSES on a partitioned engine
    (``(cycle, shard)`` pairs: the first segment ending at or past
    ``cycle`` loses mesh position ``shard``).  A shard loss does not
    walk the escalation ladder and does not consume the restart budget:
    the engine rolls back to the last validated snapshot, re-partitions
    the factor graph onto the surviving mesh, remaps the snapshot and
    resumes; only when no device remains does the run abort with
    :class:`RecoveryExhausted` carrying the partial trajectory.

    ``verify_restore`` (default True) asserts that every rollback
    restored the snapshot bit for bit before intervening.
    """

    max_restarts: int = 3
    noise_scale: float = 1e-3
    noise_seed: int = 0
    damping_bump: float = 0.2
    damping_cap: float = 0.95
    divergence_window: int = 0
    divergence_factor: float = 3.0
    divergence_slack: float = 0.0
    trip_cycles: Tuple[int, ...] = field(default_factory=tuple)
    trip_shard: Tuple[Tuple[int, int], ...] = field(
        default_factory=tuple)
    verify_restore: bool = True

    def __post_init__(self):
        if self.max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0: {self.max_restarts}")
        if self.noise_scale < 0:
            raise ValueError(
                f"noise_scale must be >= 0: {self.noise_scale}")
        for entry in self.trip_shard:
            if len(tuple(entry)) != 2:
                raise ValueError(
                    "trip_shard entries are (cycle, shard) pairs: "
                    f"{entry!r}")

    def action_for(self, attempt: int) -> str:
        """Attempt 1 reseeds tie-break noise, attempt 2 bumps damping,
        later attempts do both with a fresh seed."""
        if attempt <= 1:
            return "reseed_noise"
        if attempt == 2:
            return "damping_bump"
        return "reseed_noise+damping_bump"


def perturb_state(state, scale: float, seed: int):
    """Deterministic tie-break noise: add uniform(-scale, +scale) noise
    (``jax.random``'s threefry stream, ``utils/prng.py``, the key
    folded with the leaf's index — every leaf counts, the int8 and
    scalar ones too) to every floating-point leaf of rank >= 1, and
    clear ``stable`` (the perturbed messages must re-converge).  Same
    (seed, scale, structure) -> the reference's perturbation."""
    leaves = tree_leaves(state)
    key = None
    out = []
    for i, leaf in enumerate(leaves):
        if leaf.dtype.is_floating_point and leaf.dim() >= 1:
            if key is None:
                key = prng.PRNGKey(seed, device=leaf.device)
            noise = prng.uniform(
                prng.fold_in(key, i), leaf.shape, dtype=leaf.dtype,
                minval=-scale, maxval=scale)
            out.append(leaf + noise)
        else:
            out.append(leaf)
    perturbed = tree_unflatten(state, out)
    if hasattr(perturbed, "_replace") and hasattr(perturbed, "stable"):
        perturbed = perturbed._replace(
            stable=torch.tensor(False, device=perturbed.stable.device))
    return perturbed


def _assert_bit_identical(restored, snapshot):
    """The rollback contract: the restored state IS the snapshot, byte
    for byte."""
    r_leaves, s_leaves = tree_leaves(restored), tree_leaves(snapshot)
    if len(r_leaves) != len(s_leaves):
        raise AssertionError("rollback restore changed the leaf count")
    for i, (r, s) in enumerate(zip(r_leaves, s_leaves)):
        r, s = r.cpu().numpy(), s.cpu().numpy()
        if r.dtype != s.dtype or r.tobytes() != s.tobytes():
            raise AssertionError(
                f"rollback restore not bit-identical at leaf {i} "
                f"(dtype {r.dtype}, shape {r.shape})"
            )


class RecoveryRun:
    """Mutable guard/recovery state for ONE ``run_checkpointed`` call.

    The engine owns the loop; this object owns the verdicts: ``check``
    scores each segment's guard outputs, ``retain`` keeps a validated
    state, ``rollback`` restores + intervenes or raises
    :class:`RecoveryExhausted` once the budget is spent.  No segment
    writes into a state tensor, so a retained state is a reference,
    not a copy.
    """

    def __init__(self, policy: RecoveryPolicy, engine):
        self.policy = policy
        self.engine = engine
        self.attempts = 0
        self.trips: List[GuardViolation] = []
        self.actions: List[str] = []
        self.best_cost: Optional[float] = None
        self._window = deque(maxlen=max(policy.divergence_window, 1))
        # Sorted, duplicates kept: (c, c, c) arms three consecutive
        # trips at cycle c.
        self._pending_injections = sorted(policy.trip_cycles)
        # (cycle, shard) device-loss injections, sorted by cycle: the
        # second entry's shard applies to the ALREADY-SHRUNK mesh.
        self._pending_shard_trips = sorted(
            tuple(t) for t in policy.trip_shard)
        self.shard_losses = 0
        self._m_trips = metrics_registry.counter(
            "pydcop_guard_trips_total",
            "Engine segment guard trips")
        self._m_attempts = metrics_registry.counter(
            "pydcop_recovery_attempts_total",
            "Recovery rollback attempts by escalation action")
        self._snap_state = None
        self._snap_values = None

    # -- snapshots ------------------------------------------------------ #

    def retain(self, state, values) -> None:
        """Keep a VALIDATED state as the rollback target."""
        self._snap_state = state
        self._snap_values = values

    @property
    def snapshot_state(self):
        return self._snap_state

    @property
    def snapshot_cycle(self) -> Optional[int]:
        if self._snap_state is None:
            return None
        return int(self._snap_state.cycle)

    # -- guard verdicts ------------------------------------------------- #

    def check(self, end_cycle: int, finite: bool,
              cost: float) -> Optional[GuardViolation]:
        """Score one segment's guard outputs; None means valid."""
        if self._pending_injections \
                and end_cycle >= self._pending_injections[0]:
            at = self._pending_injections.pop(0)
            return GuardViolation(
                "injected", end_cycle, f"injected trip armed at "
                f"cycle {at}")
        if self._pending_shard_trips \
                and end_cycle >= self._pending_shard_trips[0][0]:
            at, shard = self._pending_shard_trips.pop(0)
            return GuardViolation(
                "shard_loss", end_cycle,
                f"injected loss of shard {shard} armed at cycle "
                f"{at}", shard=int(shard))
        if not finite:
            return GuardViolation(
                "nonfinite", end_cycle, "NaN/Inf in solver state")
        if self.policy.divergence_window > 0:
            if self.best_cost is None or cost < self.best_cost:
                self.best_cost = cost
            self._window.append(cost)
            threshold = (
                self.policy.divergence_factor * abs(self.best_cost)
                + self.policy.divergence_slack
            )
            if len(self._window) == self._window.maxlen \
                    and min(self._window) > threshold:
                return GuardViolation(
                    "divergence", end_cycle,
                    f"cost window min {min(self._window):.6g} > "
                    f"threshold {threshold:.6g} "
                    f"(best {self.best_cost:.6g})")
        return None

    # -- rollback + escalation ----------------------------------------- #

    def _partial(self) -> Dict[str, Any]:
        """The best-known state for a RecoveryExhausted carrier."""
        partial: Dict[str, Any] = {
            "assignment": None,
            "cycle": self.snapshot_cycle,
            "converged": False,
        }
        if self._snap_values is not None:
            partial["assignment"] = (
                self.engine.meta.assignment_from_indices(
                    self._snap_values.cpu().numpy())
            )
        return partial

    def rollback(self, violation: GuardViolation):
        """Restore the last valid snapshot and intervene; returns the
        (state, values) to continue from.  Raises RecoveryExhausted
        past the restart budget.  ``shard_loss`` violations take the
        repartition path instead of the escalation ladder."""
        if violation.kind == "shard_loss":
            return self._rollback_shard_loss(violation)
        self.trips.append(violation)
        self._m_trips.inc(kind=violation.kind)
        if tracer.active:
            tracer.instant("guard_trip", "resilience",
                           kind=violation.kind,
                           cycle=int(violation.cycle),
                           detail=violation.detail)
        self.attempts += 1
        # Flight-recorder anomaly: the escalation is black-box evidence
        # whether or not the run survives it.
        flight.trigger("guard_trip", trip_kind=violation.kind,
                       cycle=int(violation.cycle),
                       attempt=self.attempts,
                       detail=violation.detail)
        if self.attempts > self.policy.max_restarts:
            partial = self._partial()
            flight.trigger(
                "recovery_exhausted", force=True,
                trip_kind=violation.kind,
                cycle=int(violation.cycle),
                attempts=self.attempts,
                last_valid_cycle=self.snapshot_cycle)
            raise RecoveryExhausted(
                f"recovery budget exhausted after "
                f"{self.policy.max_restarts} restarts; last trip: "
                f"{violation.kind} at cycle {violation.cycle}",
                violations=self.trips, attempts=self.attempts,
                partial=partial,
            )
        action = self.policy.action_for(self.attempts)
        self.actions.append(action)
        self._m_attempts.inc(action=action)
        logger.warning(
            "Guard trip (%s at cycle %d): rollback to cycle %s, "
            "attempt %d/%d, action=%s",
            violation.kind, violation.cycle, self.snapshot_cycle,
            self.attempts, self.policy.max_restarts, action,
        )
        with tracer.span("recovery_rollback", "resilience",
                         attempt=self.attempts, action=action,
                         kind=violation.kind,
                         to_cycle=self.snapshot_cycle):
            # A copy: a later trip must be able to roll back to this
            # same snapshot again whatever the continuing loop does.
            restored = tree_map(torch.clone, self._snap_state)
            if self.policy.verify_restore:
                _assert_bit_identical(restored, self._snap_state)
            if "reseed_noise" in action and self.policy.noise_scale:
                restored = perturb_state(
                    restored, self.policy.noise_scale,
                    self.policy.noise_seed + self.attempts,
                )
            if "damping_bump" in action:
                engine = self.engine
                bumped = min(
                    engine.damping + self.policy.damping_bump,
                    self.policy.damping_cap,
                )
                logger.warning(
                    "Recovery damping bump: %.3f -> %.3f",
                    engine.damping, bumped)
                engine.damping = bumped
        # The diverged branch's costs must not poison the next
        # window's verdict.
        self._window.clear()
        return restored, self._snap_values

    def _rollback_shard_loss(self, violation: GuardViolation):
        """Shard-loss recovery: roll back to the last validated snapshot
        AND re-partition onto the surviving mesh.  No noise or damping
        intervention (losing a device says nothing about the numerics)
        and no restart budget consumed.  The engine hook builds the new
        mesh, re-partitions (memoized) and remaps the snapshot;
        :class:`NoSurvivingDevices` becomes :class:`RecoveryExhausted`
        carrying the partial trajectory."""
        self.trips.append(violation)
        self._m_trips.inc(kind="shard_loss")
        if tracer.active:
            tracer.instant("guard_trip", "resilience",
                           kind="shard_loss",
                           cycle=int(violation.cycle),
                           shard=violation.shard,
                           detail=violation.detail)
        flight.trigger("shard_loss", shard=violation.shard,
                       cycle=int(violation.cycle),
                       detail=violation.detail)
        hook = getattr(self.engine, "repartition_after_loss", None)
        if hook is None:
            raise ValueError(
                "trip_shard requires a partitioned sharded engine "
                "(solve with shards=N); this engine has no "
                "repartition_after_loss hook")
        self.shard_losses += 1
        self.actions.append("repartition")
        self._m_attempts.inc(action="repartition")
        logger.warning(
            "Shard loss (shard %s at cycle %d): rollback to cycle "
            "%s and re-partition onto the surviving mesh",
            violation.shard, violation.cycle, self.snapshot_cycle,
        )
        with tracer.span("recovery_rollback", "resilience",
                         attempt=self.attempts, action="repartition",
                         kind="shard_loss",
                         to_cycle=self.snapshot_cycle,
                         lost_shard=violation.shard):
            try:
                state = hook(violation.shard, self._snap_state)
            except NoSurvivingDevices as exc:
                flight.trigger(
                    "recovery_exhausted", force=True,
                    trip_kind="shard_loss", shard=violation.shard,
                    cycle=int(violation.cycle))
                raise RecoveryExhausted(
                    f"no surviving devices after loss of shard "
                    f"{violation.shard} at cycle {violation.cycle}",
                    violations=self.trips, attempts=self.attempts,
                    partial=self._partial(),
                ) from exc
        # The old snapshot's layout died with the lost shard: the
        # remapped state IS the new rollback target.
        self.retain(state, self._snap_values)
        self._window.clear()
        return state, self._snap_values

    def metrics(self) -> Dict[str, Any]:
        return {
            "guard_trips": len(self.trips),
            "recovery_attempts": self.attempts,
            "recovery_actions": list(self.actions),
            "shard_losses": self.shard_losses,
            "guard_violations": [v.as_dict() for v in self.trips],
        }
