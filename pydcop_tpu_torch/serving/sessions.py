"""Stateful solve sessions: incremental dynamic-DCOP serving.

Port of ``pydcop_tpu/serving/sessions.py``: the same wire semantics,
journal records and checkpoint NPZ (``DynamicMaxSumEngine.checkpoint``
writes the reference's arrays, so either package restores the other's
snapshot).  Each session's engine is the port's
``engine/dynamic.py::DynamicMaxSumEngine`` on the service's device; the
oracle tier runs the port's ``engine/dpop.py::DpopEngine`` there too.

A one-shot ``POST /solve`` answers one problem and forgets it.  A
*session* is a solve that LIVES across requests — the workload shape
of the reference's ``Scenario`` model (sensor nets, meeting
scheduling, smart grids: events mutate the problem mid-run) and of
every long-lived production client:

- ``POST /session`` opens a solve backed by ONE
  :class:`~pydcop_tpu_torch.engine.dynamic.DynamicMaxSumEngine`, owned by
  the scheduler thread (the same single thread that owns every other
  device dispatch);
- ``PATCH /session/<id>/events`` streams scenario events
  (change/add/remove factor, add variable, agent placement — the
  ``dcop/scenario.py`` vocabulary, engine/dynamic.apply_action)
  that are applied BETWEEN engine segments.  In-shape edits are pure
  array surgery — zero recompiles, the structure-cache hit; the
  engine re-keys only when the shape envelope dies (slack exhausted,
  new variable).  Messages warm-start from the pre-event fixpoint and
  decimation clamps release on the TOUCHED variables only;
- ``GET /session/<id>/events`` (SSE) streams anytime
  assignment/cost after every segment;
- ``DELETE /session/<id>`` closes the session with a final result.

Durability rides the journal (serving/journal.py): the open, every
acknowledged event batch, periodic engine-state checkpoints and the
close are all records, so ``--recover`` replays WHOLE sessions after a
SIGKILL — rebuild the engine from the open record, re-apply the
pre-checkpoint batches structurally, restore the checkpointed message
state, apply the journaled-but-unapplied batches, and re-converge warm
(:meth:`SessionManager.recover`).  A PATCH's 200 is the same durable
promise a submit's 202 is: the record reaches the OS before the ack.

Wire protocol, recovery semantics and knobs: docs/sessions.md.
"""

import contextlib
import logging
import os
import queue
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from pydcop_tpu_torch.engine.dynamic import (
    EVENT_ACTIONS,
    apply_action,
    build_dynamic_engine,
)
from pydcop_tpu_torch.observability import flight
from pydcop_tpu_torch.observability.metrics import CycleSnapshotter
from pydcop_tpu_torch.observability.metrics import registry as metrics_registry
from pydcop_tpu_torch.observability.trace import tracer
from pydcop_tpu_torch.serving import journal as journal_mod
from pydcop_tpu_torch.serving.admission import AdmissionRejected

logger = logging.getLogger("pydcop.serving.sessions")

# Session states.  OPEN sessions accept events and run segments;
# CLOSED/ERROR are terminal; REPLAYABLE is terminal for THIS process
# only — the journal still holds the session, a --recover restart
# resumes it.  MIGRATING freezes new event acks while a migration
# export drains the session (serving/migration.py) — it resolves to
# MIGRATED (terminal here: another replica owns the warm engine now)
# or back to OPEN when the move fails.
OPEN = "OPEN"
CLOSED = "CLOSED"
ERROR = "ERROR"
REPLAYABLE = "REPLAYABLE"
MIGRATING = "MIGRATING"
MIGRATED = "MIGRATED"
# Epoch fencing (partition tolerance): a replica that kept serving a
# session through a partition while the router repointed ownership
# elsewhere holds a STALE copy — when the partition heals, the copy
# is FENCED (terminal here: every write 409s) instead of silently
# double-applying events the new owner already owns.
FENCED = "FENCED"

# checkpoint_session sentinel: "compute the rebased problem yourself"
# vs. an explicit rebased yaml (or None for a plain marker) the
# export path already computed.
_UNSET = object()

# Session solver parameters and their defaults.  ``max_cycles`` is the
# re-convergence budget per ACTIVATION (open, or one event batch);
# ``segment_cycles`` the anytime-stream granularity — smaller segments
# mean fresher SSE assignments at more host syncs.  ``slack`` is the
# engine's spare-factor-row fraction (the in-place-mutation budget:
# bigger slack = more add_factor events before a recompile).
# ``decimation_margin`` (None = off) clamps decided variables between
# segments; events release clamps on touched variables only.
SESSION_PARAMS: Dict[str, Any] = {
    "max_cycles": 500,
    "segment_cycles": 50,
    "damping": 0.5,
    "damping_nodes": "both",
    "stability": 0.1,
    "noise": 0.01,
    "slack": 0.25,
    "decimation_margin": None,
}

_DAMPING_NODES = ("vars", "factors", "both", "none")


def normalize_session_params(
        overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Session-parameter canonicalization, same contract as
    serving/binning.normalize_params: unknown keys and untypeable
    values raise (400 at the front end), never reach the scheduler
    thread."""
    params = dict(SESSION_PARAMS)
    for key, value in (overrides or {}).items():
        if key not in SESSION_PARAMS:
            raise ValueError(
                f"unknown session parameter {key!r}; valid: "
                f"{', '.join(sorted(SESSION_PARAMS))}")
        params[key] = value
    try:
        params["max_cycles"] = int(params["max_cycles"])
        params["segment_cycles"] = int(params["segment_cycles"])
        for key in ("damping", "stability", "noise", "slack"):
            params[key] = float(params[key])
        if params["decimation_margin"] is not None:
            margin = float(params["decimation_margin"])
            # margin <= 0 means OFF — the same contract as the
            # maxsum decimation_margin knob
            # (algorithms/maxsum.decimation_plan_from_params); a 0.0
            # must not mean "clamp everything" on one surface and
            # "disabled" on the other.
            params["decimation_margin"] = (margin if margin > 0
                                           else None)
    except (TypeError, ValueError) as exc:
        raise ValueError(f"bad session parameter value: {exc}")
    if params["segment_cycles"] <= 0 or params["max_cycles"] <= 0:
        raise ValueError(
            "max_cycles and segment_cycles must be positive")
    if params["damping_nodes"] not in _DAMPING_NODES:
        raise ValueError(
            f"damping_nodes must be one of {_DAMPING_NODES}, got "
            f"{params['damping_nodes']!r}")
    return params


def validate_events(events: Any) -> List[Dict[str, Any]]:
    """Shape-level wire validation of a PATCH event batch, on the
    submitting thread: the action types must be known and the
    per-action required keys present, so a malformed batch is a 400
    BEFORE it is journaled — never a scheduler-thread surprise.
    (Semantic errors — unknown factor names, scope mismatches — can
    only surface at apply time, against the engine state the batch
    actually meets; those turn the session's event SEQ into an error
    result instead.)"""
    if not isinstance(events, list) or not events:
        raise ValueError("events must be a non-empty list of actions")
    out = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event[{i}] must be an object")
        etype = ev.get("type")
        if etype not in EVENT_ACTIONS:
            raise ValueError(
                f"event[{i}] has unknown type {etype!r}; valid: "
                f"{', '.join(EVENT_ACTIONS)}")
        if etype in ("change_factor", "add_factor"):
            if not ev.get("name"):
                raise ValueError(f"event[{i}] ({etype}) needs 'name'")
            if "table" not in ev and "expression" not in ev:
                raise ValueError(
                    f"event[{i}] ({etype}) needs a 'table' or an "
                    "'expression'")
        elif etype == "remove_factor" and not ev.get("name"):
            raise ValueError(f"event[{i}] (remove_factor) needs 'name'")
        elif etype == "add_variable":
            if not ev.get("name") or not ev.get("domain"):
                raise ValueError(
                    f"event[{i}] (add_variable) needs 'name' and "
                    "'domain'")
        elif etype in ("remove_agent", "add_agent") \
                and not ev.get("agent"):
            raise ValueError(f"event[{i}] ({etype}) needs 'agent'")
        out.append(dict(ev))
    return out


def apply_event_batch(engine, events: Optional[List[Dict[str, Any]]]
                      ) -> "tuple[List[str], List[str], Optional[str]]":
    """Apply one wire-form action batch to an engine, in order,
    stopping at the first semantic failure (earlier actions STAND).

    This is the single definition of batch-apply semantics — the
    live path (:meth:`SessionManager._work_events`) and crash replay
    (:meth:`SessionManager._recover_one`) both call it, so a
    recovered session deterministically reproduces the engine state
    the live session had, INCLUDING partially-applied failed batches
    (divergent hand-rolled copies here were how live-tolerant /
    replay-fatal drift crept in).  Returns ``(applied_action_types,
    touched_variable_names, error_or_None)``.

    The whole batch applies under the engine's deferred-edit session
    (``DynamicMaxSumEngine.batch_edits``): per-bucket edits accumulate
    host-side and materialize as ONE copy per touched bucket per
    batch instead of one per action — behavior-identical (the flush
    runs even on the early error return, so earlier actions stand
    exactly as before), just without the per-action full-bucket
    copies the note flagged."""
    applied: List[str] = []
    touched: List[str] = []
    ctx = (engine.batch_edits()
           if hasattr(engine, "batch_edits")
           else contextlib.nullcontext())
    try:
        with ctx:
            for action in events or []:
                args = {k: v for k, v in action.items()
                        if k != "type"}
                try:
                    info = apply_action(engine, action["type"], args)
                except Exception as exc:  # noqa: BLE001 — batch-
                    # scoped error: earlier actions stand.
                    return (applied, touched,
                            f"event apply failed: {exc}")
                touched.extend(info["touched"])
                applied.append(action["type"])
    except Exception as exc:  # noqa: BLE001 — a flush failure at
        # batch exit keeps the tuple contract too: the caller (live
        # work AND --recover replay) must get a batch error, never an
        # exception that aborts the whole session's replay.
        return applied, touched, f"event apply failed: {exc}"
    return applied, touched, None


def scenario_yaml_to_events(yaml_src: str) -> List[Dict[str, Any]]:
    """Flatten a dcop/scenario.py YAML script into one wire-form
    event batch (the ``PATCH`` body's ``"scenario"`` spelling):
    actions keep their order across events; delay events are dropped —
    a session's time base is its client's PATCH cadence, not the
    script's wall clock."""
    from pydcop_tpu_torch.dcop.yamldcop import load_scenario

    events: List[Dict[str, Any]] = []
    for ev in load_scenario(yaml_src):
        if ev.is_delay:
            continue
        for action in ev.actions or []:
            events.append({"type": action.type, **action.args})
    return events


class SessionLimit(AdmissionRejected):
    """Too many live sessions: backpressure, not failure (429)."""

    http_status = 429


class SessionClosed(Exception):
    """Events/close against a terminal session (409 on the wire)."""


class StaleEpoch(SessionClosed):
    """An event batch carried an ownership epoch that doesn't match
    this replica's copy of the session (or the copy itself is
    FENCED).  A structured 409 on the wire — the split-brain guard:
    the client (or router) reconciles ownership instead of this
    replica double-applying what the real owner already owns."""

    def __init__(self, session_id: str, session_epoch: int,
                 request_epoch: Optional[int]):
        self.session_id = session_id
        self.session_epoch = int(session_epoch)
        self.request_epoch = (None if request_epoch is None
                              else int(request_epoch))
        super().__init__(
            f"session {session_id} ownership epoch is "
            f"{session_epoch}, request carried {request_epoch} — "
            "stale owner fenced; reconcile via the router")


@dataclass
class SolveSession:
    """One stateful solve: a warm engine plus its bookkeeping.

    The ENGINE is only ever touched on the scheduler thread
    (:meth:`SessionManager.run_work`); everything else is snapshotted
    under the manager lock."""

    id: str
    trace_id: str
    dcop_yaml: str
    params: Dict[str, Any]
    engine: Any
    status: str = OPEN
    # Ownership epoch: bumped by the fleet router on every repoint
    # (migration, dead-replica adoption), journaled with the open
    # record, checked against the epoch each forwarded event batch
    # carries.  1 for sessions that never moved (and for every
    # journal written before epochs existed).
    epoch: int = 1
    seq: int = 0            # acknowledged (journaled) event batches
    applied_seq: int = 0    # batches actually applied to the engine
    events_applied: int = 0  # individual actions applied
    recompiles: int = 0
    segments: int = 0
    budget: int = 0          # re-convergence cycles left, this activation
    last_cycle: int = 0
    events_since_ckpt: int = 0
    replayed: bool = False
    last: Optional[Dict[str, Any]] = None
    final: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    done: threading.Event = field(default_factory=threading.Event)
    subscribers: List["queue.Queue"] = field(default_factory=list)
    # In-memory copy of every acknowledged batch (seq/events/
    # trace_id), the migration-export fallback when the engine's
    # current problem can't be rebased to yaml: bundle = base problem
    # + this log.  Trimmed at every REBASED checkpoint (the base
    # advances past those batches), so it holds at most one
    # checkpoint interval of events — except on the rare rebase-
    # failure path, where it must keep the full tail.
    event_log: List[Dict[str, Any]] = field(default_factory=list)
    # Serializes seq-assign + journal append + enqueue for THIS
    # session: concurrent PATCHes must reach the journal and the
    # queue in seq order, or crash replay (which applies in seq
    # order) would reconstruct a different engine state than the
    # live process had.
    order_lock: threading.Lock = field(
        default_factory=threading.Lock)
    # Exact-certification oracle bookkeeping (docs/sessions.md): the
    # highest event seq whose quiesced fixpoint has been certified by
    # a background DPOP solve, and the seq a certify timer is already
    # pending for (both -1 initially so the seq-0 fixpoint — the
    # initial convergence before any event — is certifiable too).
    certified_seq: int = -1
    certify_scheduled_seq: int = -1


@dataclass
class SessionWork:
    """One unit of session work on the service queue.  The scheduler
    routes these to :meth:`SessionManager.run_work` between request
    flushes — session mutations and segments interleave with batched
    one-shot dispatches on the single device-owning thread."""

    kind: str   # "events" | "segment" | "close" | "export" | "certify"
    session: SolveSession
    events: Optional[List[Dict[str, Any]]] = None
    seq: int = 0
    trace_id: str = ""
    drain: bool = True       # close: run a final settle segment?
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    # Export drain: the work re-enqueued ITSELF behind acked event
    # batches still in the queue — run_work must not wake the waiter
    # yet (see _work_export).
    deferred: bool = False


class SessionManager:
    """Owns every live session of one SolveService.

    Open/close/event acks happen on submitting threads (journal
    appends included — the ack is durable before it is returned);
    engine work happens on the scheduler thread via :class:`SessionWork`
    items on the service queue.  ``max_sessions`` bounds live engines
    (each holds device arrays); past it, opens are 429s."""

    def __init__(self, service, max_sessions: int = 64,
                 segment_cycles: Optional[int] = None,
                 checkpoint_every_events: int = 8,
                 session_keep: int = 256,
                 certify_after: Optional[float] = None):
        self.service = service
        self.max_sessions = int(max_sessions)
        self.default_segment_cycles = segment_cycles
        self.checkpoint_every_events = int(checkpoint_every_events)
        # Exact-certification oracle: when set, a session whose event
        # stream has quiesced for this many seconds gets a background
        # DPOP solve of its CURRENT (mutated) problem on the scheduler
        # thread — certifying the warm fixpoint as optimal, or
        # replacing the served assignment with the true optimum.  None
        # disables the tier (the default: exact solves are not free).
        self.certify_after = (None if certify_after is None
                              else float(certify_after))
        self.certifications = 0
        self.certified_improved = 0
        self.certify_skipped_width = 0
        self.last_certification: Optional[Dict[str, Any]] = None
        # Terminal-session retention (the session analogue of the
        # service's result_keep): closed/errored sessions keep their
        # final result pollable until evicted oldest-first past this
        # bound — each tracked session pins a whole engine (device
        # arrays + compiled-program cache), so a long-lived service
        # must not retain every session it ever served.
        self.session_keep = int(session_keep)
        self._sessions: Dict[str, SolveSession] = {}
        self._lock = threading.Lock()
        self.opened = 0
        self.closed = 0
        self.errored = 0
        self.replayed_sessions = 0
        self.migrated_in = 0
        self.migrated_out = 0
        reg = metrics_registry
        self._active_g = reg.gauge(
            "pydcop_sessions_active",
            "Live stateful solve sessions")
        self._events_total = reg.counter(
            "pydcop_session_events_total",
            "Scenario-event actions applied to live sessions, by type")
        self._segments_total = reg.counter(
            "pydcop_session_segments_total",
            "Engine segments run on behalf of sessions")
        self._recompiles_total = reg.counter(
            "pydcop_session_recompiles_total",
            "Session engine recompiles (events that outgrew the "
            "shape envelope / slack budget)")
        self._sessions_total = reg.counter(
            "pydcop_sessions_total",
            "Session lifecycle outcomes (opened/closed/error/"
            "recovered)")

    # -- open / events / close (submitting threads) -------------------- #

    def open(self, dcop, params: Optional[Dict[str, Any]] = None,
             session_id: Optional[str] = None,
             trace_id: Optional[str] = None,
             epoch: int = 1) -> SolveSession:
        """Open a session: build the dynamic engine (host-side, on
        the calling thread — malformed problems fail synchronously as
        400s), journal the open record, enqueue the first
        convergence segment.  Returns the session; its id/trace_id
        are the client's handles."""
        if not self.service._started:
            raise RuntimeError("SolveService is not started")
        merged = normalize_session_params(params)
        if self.default_segment_cycles and "segment_cycles" not in (
                params or {}):
            merged["segment_cycles"] = int(self.default_segment_cycles)
        # Fast-path backpressure BEFORE the engine build: a saturated
        # service must reject opens cheaply, not pay a full
        # factor-graph construction per 429.  The authoritative
        # check-and-insert still happens under one lock hold below.
        with self._lock:
            live = sum(1 for s in self._sessions.values()
                       if s.status == OPEN)
            if live >= self.max_sessions:
                raise SessionLimit(
                    f"session limit reached ({self.max_sessions} "
                    "live)")
            if session_id and session_id in self._sessions:
                raise ValueError(
                    f"duplicate session id {session_id!r}")
        from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

        engine = build_dynamic_engine(dcop, merged,
                                      device=self.service.device)
        # This engine's dispatches are session work: the efficiency
        # rollup's request class must say so (a scenario replay or
        # direct dynamic-engine use stays "dynamic").
        engine.efficiency_class = "session"
        yaml_src = dcop_yaml(dcop)
        sess = SolveSession(
            id=session_id or f"s{uuid.uuid4().hex[:12]}",
            trace_id=trace_id or uuid.uuid4().hex[:16],
            dcop_yaml=yaml_src,
            params=merged,
            engine=engine,
            budget=merged["max_cycles"],
            epoch=max(int(epoch), 1),
        )
        with self._lock:
            # Limit check and insert under ONE lock hold: a
            # check-then-insert race would let concurrent opens
            # overshoot max_sessions — exactly the warm-engine
            # resource bound the knob exists to enforce.
            live = sum(1 for s in self._sessions.values()
                       if s.status == OPEN)
            if live >= self.max_sessions:
                raise SessionLimit(
                    f"session limit reached ({self.max_sessions} "
                    "live)")
            if sess.id in self._sessions:
                raise ValueError(f"duplicate session id {sess.id!r}")
            self._sessions[sess.id] = sess
            self._prune_terminal_locked()
        journal = self.service._journal
        if journal is not None:
            # BEFORE the ack, exactly like submit(): the session id
            # this hands back must survive a process kill.
            try:
                journal.append(journal_mod.session_open_record(
                    sess.id, yaml_src, merged,
                    trace_id=sess.trace_id, epoch=sess.epoch))
                self.service._journal_records.inc(kind="session_open")
            except Exception as exc:
                with self._lock:
                    self._sessions.pop(sess.id, None)
                raise RuntimeError(
                    f"session journal append failed: {exc}") from exc
        self.opened += 1
        self._sessions_total.inc(status="opened")
        self._refresh_gauge()
        if tracer.active:
            tracer.instant("session_open", "serving",
                           session=sess.id, trace_id=sess.trace_id)
        self._publish(sess, "open")
        self._enqueue(SessionWork("segment", sess))
        return sess

    def apply_events(self, session_id: str,
                     events: List[Dict[str, Any]],
                     wait: Optional[float] = None,
                     epoch: Optional[int] = None,
                     trace_id: Optional[str] = None
                     ) -> Dict[str, Any]:
        """Acknowledge one event batch: validate (400s raise here),
        journal it (the ack is durable), enqueue the apply.  With
        ``wait`` (seconds), block for the post-event segment and
        include its result.  The returned ``seq`` is the batch's
        position in the session's event order.

        ``epoch`` (set on every router-forwarded batch) is the
        ownership fence: a mismatch against this replica's copy is a
        structured 409 (:class:`StaleEpoch`) — never an apply.  A
        direct client (no router, ``epoch=None``) skips the check."""
        sess = self._get(session_id)
        if sess.status == FENCED:
            raise StaleEpoch(session_id, sess.epoch, epoch)
        if sess.status != OPEN:
            raise SessionClosed(
                f"session {session_id} is {sess.status}")
        if epoch is not None and int(epoch) != sess.epoch:
            raise StaleEpoch(session_id, sess.epoch, epoch)
        events = validate_events(events)
        # A router-propagated batch context is adopted as
        # this batch's trace id so the apply's spans land in the same
        # fleet trace as the router's forwarding instant; a direct
        # client's batch mints its own, as before.
        batch_trace = trace_id or uuid.uuid4().hex[:16]
        # seq assignment, journal append and enqueue are ONE atomic
        # step per session: with concurrent PATCHes (the front end is
        # a threading HTTP server) a later seq must never reach the
        # journal or the scheduler before an earlier one — replay
        # applies batches in seq order and must reconstruct exactly
        # the state the live engine had.  The journal write is a
        # flushed append (sub-ms); holding the per-session lock
        # across it also makes the failure rollback safe (no other
        # thread can have taken a later seq meanwhile).
        with sess.order_lock:
            # Re-check under the SAME lock a migration export uses to
            # freeze the session (and a fence uses to revoke it): a
            # batch acked after the export drained would be journaled
            # here but absent from the bundle — a lost acked event on
            # the target.  Holding order_lock makes freeze-vs-ack
            # atomic (409: the client retries against the new owner).
            if sess.status == FENCED:
                raise StaleEpoch(session_id, sess.epoch, epoch)
            if sess.status != OPEN:
                raise SessionClosed(
                    f"session {session_id} is {sess.status}")
            if epoch is not None and int(epoch) != sess.epoch:
                raise StaleEpoch(session_id, sess.epoch, epoch)
            with self._lock:
                sess.seq += 1
                seq = sess.seq
            journal = self.service._journal
            if journal is not None:
                try:
                    journal.append(journal_mod.session_event_record(
                        sess.id, seq, events, trace_id=batch_trace))
                    self.service._journal_records.inc(
                        kind="session_event")
                except Exception as exc:
                    with self._lock:
                        sess.seq -= 1
                    raise RuntimeError(
                        f"session journal append failed: {exc}"
                    ) from exc
            sess.event_log.append({"seq": seq, "events": events,
                                   "trace_id": batch_trace})
            work = SessionWork("events", sess, events=events,
                               seq=seq, trace_id=batch_trace)
            # Event work is an acked durable batch: it may WAIT for
            # queue room (the scheduler is draining it) but must
            # never be silently skipped — a dropped batch would make
            # the live engine diverge from the journal the 200
            # promises.  If the queue stays full past the block
            # window the whole session fails LOUDLY (journaled
            # close, so replay and live agree the batch never
            # applied) instead of serving divergent state.
            if not self._enqueue(work, block_s=30.0):
                self._fail(sess,
                           "service queue full; session failed "
                           "rather than skipping an acked event "
                           "batch")
                raise RuntimeError(
                    "service queue full: session event batch could "
                    "not be scheduled; session closed as ERROR")
        out = {
            "session_id": sess.id,
            "seq": seq,
            "trace_id": batch_trace,
            "events": len(events),
        }
        if wait:
            work.done.wait(wait)
            if work.done.is_set():
                out["applied"] = work.error is None
                if work.error is not None:
                    out["error"] = work.error
                if work.result is not None:
                    out["result"] = work.result
                out["recompiles"] = sess.recompiles
            else:
                out["applied"] = None  # still queued past the wait
        return out

    def close(self, session_id: str,
              wait: float = 60.0) -> Dict[str, Any]:
        """Close a session: a final settle segment runs, the close is
        journaled (the engine checkpoint file is retired with it) and
        the final result returned.  Closing a terminal session
        returns its existing final result (idempotent DELETEs)."""
        sess = self._get(session_id)
        if sess.status != OPEN:
            if sess.final is not None:
                return dict(sess.final)
            raise SessionClosed(
                f"session {session_id} is {sess.status}")
        work = SessionWork("close", sess)
        self._enqueue(work)
        work.done.wait(wait)
        if not work.done.is_set():
            raise TimeoutError(
                f"session {session_id} close timed out after "
                f"{wait}s")
        if work.error is not None and sess.final is None:
            raise RuntimeError(work.error)
        return dict(sess.final or {})

    # -- migration (serving/migration.py drives these) ----------------- #

    def export_session(self, session_id: str,
                       wait: float = 60.0) -> Dict[str, Any]:
        """Drain-checkpoint a session for migration and return its
        bundle.  The session is left MIGRATING: new PATCHes 409
        until :meth:`retire_session` (move succeeded) or
        :meth:`resume_session` (move failed) resolves it."""
        sess = self._get(session_id)
        if sess.status != OPEN:
            raise SessionClosed(
                f"session {session_id} is {sess.status}")
        work = SessionWork("export", sess)
        if not self._enqueue(work, block_s=10.0):
            raise RuntimeError(
                "service queue full: session export could not be "
                "scheduled")
        work.done.wait(wait)
        if not work.done.is_set():
            raise TimeoutError(
                f"session {session_id} export timed out after "
                f"{wait}s")
        if work.error is not None:
            raise RuntimeError(work.error)
        return work.result or {}

    def resume_session(self, session_id: str) -> Dict[str, Any]:
        """Un-freeze a MIGRATING session after a failed move: back to
        OPEN with a fresh re-convergence budget — the session must
        never have zero owners."""
        sess = self._get(session_id)
        with sess.order_lock:
            if sess.status != MIGRATING:
                raise SessionClosed(
                    f"session {session_id} is {sess.status}")
            sess.status = OPEN
            sess.budget = sess.params["max_cycles"]
        self._refresh_gauge()
        self._publish(sess, "resumed")
        self._enqueue(SessionWork("segment", sess))
        return {"session_id": sess.id, "status": OPEN}

    def retire_session(self, session_id: str,
                       moved_to: Optional[str] = None
                       ) -> Dict[str, Any]:
        """Finish a migration on the source side: journal a MIGRATED
        close (this segment's --recover must not resurrect what the
        target now owns), retire the checkpoint and end the SSE
        streams — subscribers get a terminal ``migrated`` event, then
        reconnect through the router and land on the new owner.
        Idempotent for already-MIGRATED sessions."""
        sess = self._get(session_id)
        with sess.order_lock:
            if sess.status == MIGRATED and sess.final is not None:
                return dict(sess.final)
            if sess.status != MIGRATING:
                raise SessionClosed(
                    f"session {session_id} is {sess.status}")
            sess.status = MIGRATED
        sess.final = {
            "session_id": sess.id,
            "trace_id": sess.trace_id,
            "status": MIGRATED,
        }
        if moved_to:
            sess.final["moved_to"] = moved_to
        self.migrated_out += 1
        self._sessions_total.inc(status="migrated")
        self._journal_close(sess, MIGRATED)
        self._retire_ckpt(sess)
        self._refresh_gauge()
        self._publish(sess, "migrated",
                      {"moved_to": moved_to} if moved_to else None)
        sess.done.set()
        return dict(sess.final)

    def fence_session(self, session_id: str,
                      epoch: int) -> Dict[str, Any]:
        """Revoke this replica's copy of a session whose ownership
        moved while the replica was partitioned/presumed dead:
        terminal FENCED, journaled (this segment's ``--recover`` must
        not resurrect the stale copy), checkpoint retired, SSE
        subscribers get a terminal ``fenced`` event — they reconnect
        through the router and land on the real owner.  Idempotent;
        a fence carrying an epoch BELOW this copy's is itself stale
        and rejected (:class:`StaleEpoch`)."""
        sess = self._get(session_id)
        epoch = int(epoch)
        with sess.order_lock:
            if sess.status == FENCED:
                return dict(sess.final or {"session_id": sess.id,
                                           "status": FENCED})
            if epoch < sess.epoch:
                raise StaleEpoch(session_id, sess.epoch, epoch)
            if sess.status not in (OPEN, MIGRATING, REPLAYABLE):
                # Terminal already: the copy can't serve writes, so
                # there is nothing left to fence.
                return {"session_id": sess.id,
                        "status": sess.status}
            sess.status = FENCED
            # Record the epoch that outranked this copy: a later
            # stale write gets told how far behind it is.
            sess.epoch = max(sess.epoch, epoch)
        sess.final = {
            "session_id": sess.id,
            "trace_id": sess.trace_id,
            "status": FENCED,
            "epoch": epoch,
        }
        self._sessions_total.inc(status="fenced")
        self._journal_close(sess, FENCED)
        self._retire_ckpt(sess)
        self._refresh_gauge()
        self._publish(sess, "fenced", {"epoch": epoch})
        sess.done.set()
        logger.info("session %s fenced at epoch %d (stale copy "
                    "revoked)", sess.id, epoch)
        return dict(sess.final)

    def status(self, session_id: str) -> Dict[str, Any]:
        sess = self._get(session_id)
        with self._lock:
            out = {
                "session_id": sess.id,
                "trace_id": sess.trace_id,
                "status": sess.status,
                "epoch": sess.epoch,
                "seq": sess.seq,
                "applied_seq": sess.applied_seq,
                "events_applied": sess.events_applied,
                "recompiles": sess.recompiles,
                "segments": sess.segments,
                "cycles": sess.last_cycle,
                "clamped": len(sess.engine.clamps),
                "replayed": sess.replayed,
                "last": dict(sess.last) if sess.last else None,
            }
            if sess.final is not None:
                out["final"] = dict(sess.final)
            if sess.error is not None:
                out["error"] = sess.error
        return out

    def _get(self, session_id: str) -> SolveSession:
        with self._lock:
            sess = self._sessions.get(session_id)
        if sess is None:
            raise KeyError(session_id)
        return sess

    def _prune_terminal_locked(self) -> None:
        """Evict oldest TERMINAL sessions (and their engines) past
        ``session_keep``; live sessions are never evicted — their
        clients still hold the id.  Caller holds the lock."""
        excess = len(self._sessions) - self.session_keep
        if excess <= 0:
            return
        # MIGRATING is live-adjacent, not terminal: its client still
        # holds the id and the move may resolve back to OPEN.
        for sid in [sid for sid, s in self._sessions.items()
                    if s.status not in (OPEN, MIGRATING)][:excess]:
            del self._sessions[sid]

    def _enqueue(self, work: SessionWork,
                 block_s: Optional[float] = None) -> bool:
        """Queue one work item.  ``block_s=None`` (segments, close,
        recovery kick-offs) never blocks: that work is re-creatable —
        a dropped continuation segment resumes at the next PATCH and
        a --recover restart rebuilds everything.  Acked EVENT batches
        pass a block window instead (see :meth:`apply_events`) —
        they are the one kind that must not be skipped.  Returns
        whether the item was queued."""
        try:
            if block_s is None:
                self.service._queue.put_nowait(work)
            else:
                self.service._queue.put(work, timeout=block_s)
            return True
        except queue.Full:
            logger.warning(
                "service queue full: session %s %s work dropped",
                work.session.id, work.kind)
            work.error = "service queue full"
            work.done.set()
            return False

    # -- SSE ----------------------------------------------------------- #

    def subscribe(self, session_id: str) -> "queue.Queue":
        """Per-session SSE feed: replays the latest segment event on
        connect, then streams every subsequent segment/terminal
        event."""
        sess = self._get(session_id)
        q: "queue.Queue" = queue.Queue(maxsize=256)
        with self._lock:
            sess.subscribers.append(q)
            replay = sess.final or sess.last
        if replay is not None:
            with contextlib.suppress(queue.Full):
                q.put_nowait(dict(replay))
        return q

    def unsubscribe(self, session_id: str, q: "queue.Queue") -> None:
        with self._lock:
            sess = self._sessions.get(session_id)
            if sess is not None and q in sess.subscribers:
                sess.subscribers.remove(q)

    def _publish(self, sess: SolveSession, phase: str,
                 payload: Optional[Dict[str, Any]] = None) -> None:
        """One session-lifecycle event: to the session's own SSE
        subscribers (full payload, anytime assignment included), to
        the global /events stream (compact — no assignment), and as a
        trace instant when tracing is on."""
        event = {
            "ts": time.time(),
            "event": "session",
            "phase": phase,
            "id": sess.id,
            "trace_id": sess.trace_id,
            "status": sess.status,
            "seq": sess.seq,
        }
        if payload:
            event.update(payload)
        with self._lock:
            if phase in ("segment", "closed", "error", "replayable"):
                if phase == "segment":
                    sess.last = dict(event)
            elif phase == "certified" and "assignment" in event:
                # An improving certification REPLACES the served
                # anytime answer in place: merge the exact
                # cost/assignment over the last segment event (the
                # SSE replay-on-connect and close paths read
                # ``sess.last``) without touching the warm engine —
                # no recompile, and the next event batch resumes the
                # iterative fixpoint exactly where it was.
                merged = dict(sess.last or {})
                merged.update({k: event[k] for k in (
                    "assignment", "cost", "optimal",
                    "certified_seq") if k in event})
                sess.last = merged
            subscribers = list(sess.subscribers)
        for q in subscribers:
            try:
                q.put_nowait(dict(event))
            except queue.Full:
                with contextlib.suppress(queue.Empty, queue.Full):
                    q.get_nowait()
                    q.put_nowait(dict(event))
        # The global stream is compact: no assignment, top-level OR
        # nested (the closed event's "final" dict carries one too).
        compact = {k: v for k, v in event.items()
                   if k != "assignment"}
        if isinstance(compact.get("final"), dict):
            compact["final"] = {
                k: v for k, v in compact["final"].items()
                if k != "assignment"}
        CycleSnapshotter.publish(compact)
        if tracer.active:
            tracer.instant(f"session_{phase}", "serving",
                           session=sess.id, trace_id=sess.trace_id)

    # -- scheduler-thread work ----------------------------------------- #

    def run_work(self, work: SessionWork) -> None:
        """Execute one session work item (scheduler thread only).
        Bound into the session's trace context so every span the
        engine records underneath — ``jit_compile``, engine calls —
        is attributable to the session like a one-shot request's
        dispatch spans."""
        sess = work.session
        # MIGRATING still runs "events" (acked batches queued before
        # the export freeze MUST apply — the export re-enqueues
        # itself behind them) and "export" itself; everything else
        # needs OPEN.
        allowed = (sess.status == OPEN
                   or (sess.status == MIGRATING
                       and work.kind in ("events", "export")))
        if not allowed:
            work.error = f"session is {sess.status}"
            work.done.set()
            return
        ids = [sess.trace_id]
        if work.trace_id:
            ids.append(work.trace_id)
        ctx = (tracer.context(trace_ids=ids)
               if tracer.active else contextlib.nullcontext())
        try:
            with ctx:
                if work.kind == "events":
                    self._work_events(work)
                elif work.kind == "segment":
                    self._work_segment(sess)
                elif work.kind == "close":
                    self._work_close(work)
                elif work.kind == "export":
                    self._work_export(work)
                elif work.kind == "certify":
                    self._work_certify(work)
                else:
                    raise ValueError(
                        f"unknown session work {work.kind!r}")
        except Exception as exc:  # noqa: BLE001 — fail the session,
            # never the scheduler thread.
            logger.exception("session %s %s work failed",
                             sess.id, work.kind)
            self._fail(sess, f"{work.kind} failed: {exc}")
            work.error = str(exc)
        finally:
            if not work.deferred:
                work.done.set()

    def _work_events(self, work: SessionWork) -> None:
        """Apply one acknowledged batch between segments: array
        surgery + clamp release on touched variables, then an
        immediate re-convergence segment (the PATCH ``wait`` answer).
        A semantically-bad action (unknown factor, scope mismatch)
        fails THIS batch — the session survives, already-applied
        actions of the batch stand (:func:`apply_event_batch`; crash
        replay reapplies through the same helper, so the recovered
        engine state matches even for failed batches), and the
        post-batch segment still runs — a partially-applied batch
        must not leave the session serving the stale pre-event
        assignment."""
        sess = work.session
        span = (tracer.span("session_events", "serving",
                            session=sess.id, seq=work.seq,
                            n_actions=len(work.events or []))
                if tracer.active else None)
        with (span if span is not None else contextlib.nullcontext()):
            before = sess.engine.recompile_count
            applied, touched, error = apply_event_batch(
                sess.engine, work.events)
            for action_type in applied:
                self._events_total.inc(type=action_type)
            sess.events_applied += len(applied)
            recompiled = sess.engine.recompile_count - before
            sess.recompiles += recompiled
            if recompiled:
                self._recompiles_total.inc(recompiled)
            if error is not None:
                work.error = error
                logger.warning("session %s event batch %d: %s",
                               sess.id, work.seq, error)
                self._publish(sess, "event_error", {
                    "batch_seq": work.seq, "error": error})
            if touched:
                # The event re-opened exactly this neighborhood;
                # clamps elsewhere keep their decided values.
                sess.engine.release_clamps(touched)
            sess.applied_seq = work.seq
            sess.events_since_ckpt += 1
            sess.budget = sess.params["max_cycles"]
        self._maybe_checkpoint(sess)
        work.result = self._run_segment(sess, batch_seq=work.seq)
        self._continue(sess)

    def _work_segment(self, sess: SolveSession) -> None:
        self._run_segment(sess)
        self._continue(sess)

    def _run_segment(self, sess: SolveSession,
                     batch_seq: Optional[int] = None
                     ) -> Dict[str, Any]:
        """One warm engine segment + the anytime publication."""
        # Always a FULL segment_cycles: max_cycles is part of the
        # engine call's key, so sizing the last segment to the budget
        # remainder would make a second cold key per shape to save at
        # most one segment's cycles — the budget is enforced
        # host-side instead, and may overshoot by less than one
        # segment.
        seg = sess.params["segment_cycles"]
        t_seg = time.perf_counter()
        span = (tracer.span("session_segment", "serving",
                            session=sess.id, cycles=seg)
                if tracer.active else None)
        with (span if span is not None else contextlib.nullcontext()):
            res = sess.engine.run(max_cycles=seg)
            cost = sess.engine.cost(res.assignment)
        t_seg_end = time.perf_counter()
        ran = max(res.cycles - sess.last_cycle, 0)
        sess.last_cycle = res.cycles
        sess.budget = max(sess.budget - max(ran, seg), 0)
        sess.segments += 1
        self._segments_total.inc()
        if (res.converged
                and sess.params["decimation_margin"] is not None):
            sess.engine.decimate(
                margin=sess.params["decimation_margin"])
        # Segment time ledger (the session face of the request
        # ledger): device compile/execute from the engine's
        # overlapping-fields split, everything else in the segment
        # wall — assignment decode + host cost evaluation — is
        # ``decode``.  Components sum to the measured segment wall.
        from pydcop_tpu_torch.observability import efficiency

        split = efficiency.split_device_time(
            res.time_s, res.compile_time_s)
        ledger = efficiency.make_ledger(
            t_seg_end - t_seg,
            compile=split["compile"],
            execute=split["execute"],
            decode=max((t_seg_end - t_seg) - res.time_s, 0.0),
        )
        efficiency.tracker.record_ledger(ledger, kind="session")
        payload = {
            "cycle": res.cycles,
            "cost": cost,
            "converged": res.converged,
            "assignment": res.assignment,
            "recompiles": sess.recompiles,
            "clamped": len(sess.engine.clamps),
            "ledger": ledger,
        }
        if batch_seq is not None:
            payload["batch_seq"] = batch_seq
        self._publish(sess, "segment", payload)
        return payload

    def _continue(self, sess: SolveSession) -> None:
        """Re-enqueue the session while it still has re-convergence
        budget and has not converged — segments interleave with other
        traffic instead of monopolizing the scheduler."""
        if sess.status != OPEN:
            return
        last = sess.last or {}
        if last.get("converged") or sess.budget <= 0:
            # Quiesced: the warm fixpoint is what clients will be
            # served until the next event.  If the oracle tier is on,
            # arm the certification timer — a fresh event batch
            # before it fires advances applied_seq and the stale
            # certify work no-ops.
            self._maybe_schedule_certify(sess)
            return
        self._enqueue(SessionWork("segment", sess))

    def _maybe_schedule_certify(self, sess: SolveSession) -> None:
        if self.certify_after is None or sess.status != OPEN:
            return
        target = sess.applied_seq
        if sess.certified_seq >= target \
                or sess.certify_scheduled_seq >= target:
            return
        sess.certify_scheduled_seq = target

        def _fire():
            # Timer thread: only enqueue (put_nowait is thread-safe);
            # all engine work stays on the scheduler thread.
            self._enqueue(SessionWork("certify", sess, seq=target))

        timer = threading.Timer(self.certify_after, _fire)
        timer.daemon = True
        timer.start()

    def _work_close(self, work: SessionWork) -> None:
        sess = work.session
        last = sess.last
        if last is None or (work.drain and not last.get("converged")
                            and sess.budget > 0):
            last = self._run_segment(sess)
        sess.final = {
            "session_id": sess.id,
            "trace_id": sess.trace_id,
            "status": CLOSED,
            "assignment": last.get("assignment"),
            "cost": last.get("cost"),
            "cycles": last.get("cycle"),
            "converged": last.get("converged"),
            "events_applied": sess.events_applied,
            "event_batches": sess.applied_seq,
            "recompiles": sess.recompiles,
            "segments": sess.segments,
        }
        sess.status = CLOSED
        self.closed += 1
        self._sessions_total.inc(status="closed")
        self._journal_close(sess, CLOSED)
        self._retire_ckpt(sess)
        self._refresh_gauge()
        self._publish(sess, "closed", {"final": dict(sess.final)})
        work.result = sess.final
        sess.done.set()

    def _work_export(self, work: SessionWork) -> None:
        """Drain-checkpoint the session into a migration bundle
        (scheduler thread).  Freeze first (new acks 409 under the
        same order_lock apply_events holds), then make sure every
        ALREADY-acked batch has applied: if any are still queued
        behind this work, re-enqueue ourselves after them
        (``deferred`` keeps the waiter blocked) — the freeze bounds
        the loop to the batches acked before it.  Any failure resumes
        the session: a failed export must never cost an owner."""
        sess = work.session
        work.deferred = False
        with sess.order_lock:
            if sess.status not in (OPEN, MIGRATING):
                work.error = f"session is {sess.status}"
                return
            sess.status = MIGRATING
            if sess.applied_seq != sess.seq:
                work.deferred = True
                if not self._enqueue(work):
                    work.deferred = False
                    work.error = ("service queue full during export "
                                  "drain")
                    sess.status = OPEN
                return
        try:
            from pydcop_tpu_torch.serving import migration as migration_mod

            rebased = None
            try:
                rebased = migration_mod.engine_dcop_yaml(
                    sess.engine, name=f"session_{sess.id}")
            except Exception as exc:  # noqa: BLE001 — fall back to
                # base problem + the acked-batch log.
                logger.info(
                    "session %s: problem rebase failed (%s); "
                    "bundling base problem + %d event batch(es)",
                    sess.id, exc, len(sess.event_log))
            npz_bytes = None
            ckpt_seq = None
            if self.checkpoint_session(sess, rebased_yaml=rebased):
                path = self._ckpt_path(sess)
                with contextlib.suppress(OSError):
                    with open(path, "rb") as f:
                        npz_bytes = f.read()
            elif sess.engine._state is not None:
                # Journal-less service: snapshot straight into the
                # bundle via a throwaway tmp file.
                fd, tmp = tempfile.mkstemp(suffix=".npz")
                os.close(fd)
                try:
                    sess.engine.checkpoint(tmp)
                    with open(tmp, "rb") as f:
                        npz_bytes = f.read()
                except Exception as exc:  # noqa: BLE001 — a cold
                    # import beats a failed migration.
                    logger.warning(
                        "session %s: export snapshot failed (%s); "
                        "bundle ships without warm state",
                        sess.id, exc)
                finally:
                    with contextlib.suppress(OSError):
                        os.unlink(tmp)
            if npz_bytes is not None:
                ckpt_seq = sess.applied_seq
            work.result = migration_mod.build_bundle(
                sess.id, sess.trace_id,
                rebased or sess.dcop_yaml,
                rebased=rebased is not None,
                params=sess.params,
                seq=sess.seq,
                cycle=sess.last_cycle,
                events=(None if rebased is not None
                        else list(sess.event_log)),
                npz_bytes=npz_bytes,
                ckpt_seq=ckpt_seq,
                epoch=sess.epoch,
            )
            self._publish(sess, "migrating")
        except Exception as exc:  # noqa: BLE001
            logger.exception("session %s export failed", sess.id)
            work.error = f"export failed: {exc}"
            with sess.order_lock:
                if sess.status == MIGRATING:
                    sess.status = OPEN
            self._enqueue(SessionWork("segment", sess))

    def _work_certify(self, work: SessionWork) -> None:
        """The session oracle (scheduler thread): an exact DPOP solve
        of the session's CURRENT mutated problem, run only after the
        event stream quiesced for ``certify_after`` seconds.  Either
        certifies the warm fixpoint as optimal (delta 0) or replaces
        the served assignment with the true optimum — in both cases
        the certified delta goes to the session SSE stream and the
        /stats rollup.  Failures degrade to a log line: the oracle is
        an accuracy tier, never allowed to kill a healthy session."""
        sess = work.session
        if sess.applied_seq != work.seq or sess.certified_seq >= work.seq:
            # Stale: new events arrived while the timer ran (their
            # quiescence re-arms with a newer seq), or a concurrent
            # timer already certified this seq.
            return
        last = sess.last or {}
        fixpoint_cost = last.get("cost")
        if fixpoint_cost is None:
            return
        t0 = time.perf_counter()
        try:
            from pydcop_tpu_torch.computations_graph import pseudotree as pt
            from pydcop_tpu_torch.dcop.yamldcop import load_dcop
            from pydcop_tpu_torch.engine.dpop import (
                DpopEngine,
                dpop_feasibility,
            )
            from pydcop_tpu_torch.serving import migration as migration_mod

            # Rebase the engine's live problem (event surgery
            # included) back to a DCOP — the same round-trip the
            # migration exporter uses.  Unrebasable problems skip
            # certification rather than certifying the wrong problem.
            yaml_src = migration_mod.engine_dcop_yaml(
                sess.engine, name=f"certify_{sess.id}")
            dcop = load_dcop(yaml_src)
            tree = pt.build_computation_graph(dcop)
            verdict = dpop_feasibility(tree, mode=dcop.objective,
                                       cec=True)
            if not verdict["feasible"]:
                self.certify_skipped_width += 1
                self._publish(sess, "certify_skipped", {
                    "reason": "rejected_width",
                    "induced_width": verdict["induced_width"],
                    "max_elements": (verdict["cec_max_elements"]
                                     or verdict["max_elements"]),
                })
                return
            span = (tracer.span("session_certify", "serving",
                                session=sess.id, seq=work.seq)
                    if tracer.active else None)
            with (span if span is not None
                  else contextlib.nullcontext()):
                res = DpopEngine(tree, mode=dcop.objective,
                                 cec=True,
                                 device=self.service.device).run()
                # Score the exact assignment with the ENGINE's cost
                # function — the same scale every published segment
                # cost uses, so the delta below is apples-to-apples.
                exact_cost = sess.engine.cost(res.assignment)
            delta = (float(fixpoint_cost) - float(exact_cost)
                     if dcop.objective == "min"
                     else float(exact_cost) - float(fixpoint_cost))
            improved = delta > 1e-9
            sess.certified_seq = work.seq
            self.certifications += 1
            if improved:
                self.certified_improved += 1
            payload: Dict[str, Any] = {
                "certified_seq": work.seq,
                "certified_cost": exact_cost,
                "fixpoint_cost": fixpoint_cost,
                "delta": delta,
                "optimal": True,
                "improved": improved,
                "induced_width": res.metrics.get("induced_width"),
                "certify_s": time.perf_counter() - t0,
            }
            if improved:
                # _publish folds the exact assignment + cost into
                # sess.last — the served answer upgrades in place,
                # the warm engine is untouched.
                payload["assignment"] = res.assignment
                payload["cost"] = exact_cost
            self.last_certification = {
                "session": sess.id, "seq": work.seq,
                "delta": delta, "improved": improved,
                "certified_cost": exact_cost,
                "fixpoint_cost": fixpoint_cost,
            }
            work.result = dict(payload)
            self._publish(sess, "certified", payload)
        except Exception as exc:  # noqa: BLE001 — oracle failures
            # must not take the session down with them.
            logger.warning("session %s certification failed: %s",
                           sess.id, exc)

    def _fail(self, sess: SolveSession, message: str) -> None:
        sess.error = message
        sess.status = ERROR
        sess.final = {
            "session_id": sess.id, "trace_id": sess.trace_id,
            "status": ERROR, "error": message,
        }
        self.errored += 1
        self._sessions_total.inc(status="error")
        self._journal_close(sess, ERROR)
        self._retire_ckpt(sess)
        self._refresh_gauge()
        flight.trigger("session_error", session=sess.id,
                       trace_id=sess.trace_id, error=message)
        self._publish(sess, "error", {"error": message})
        sess.done.set()

    def _journal_close(self, sess: SolveSession, status: str) -> None:
        journal = self.service._journal
        if journal is None:
            return
        try:
            journal.append(journal_mod.session_close_record(
                sess.id, status))
            self.service._journal_records.inc(kind="session_close")
        except Exception as exc:  # noqa: BLE001 — at most one
            # duplicate replay after a crash, never a dead service.
            logger.warning("session close journal append failed for "
                           "%s: %s", sess.id, exc)

    # -- checkpoint / recovery ----------------------------------------- #

    def _ckpt_path(self, sess: SolveSession) -> Optional[str]:
        if not self.service.journal_dir:
            return None
        return os.path.join(self.service.journal_dir,
                            f"session_{sess.id}.npz")

    def checkpoint_session(self, sess: SolveSession,
                           rebased_yaml: Any = _UNSET) -> bool:
        """Snapshot the engine's warm message state next to the
        journal (tmp+rename — a crash mid-write leaves the previous
        snapshot) and journal the marker.  Returns True when a
        checkpoint landed.  Only meaningful on the scheduler thread
        (or after it stopped: the stop() park path).

        The marker is REBASED whenever the engine's current problem
        serializes back to yaml (serving/migration.engine_dcop_yaml):
        recovery then rebuilds the factor layout from the marker
        alone and compaction drops the pre-checkpoint event tail —
        replay time is bounded by the checkpoint cadence, not session
        age (the recovery bound).  Pass ``rebased_yaml``
        (a yaml string, or None for a plain marker) to skip the
        recompute when the caller already serialized it."""
        path = self._ckpt_path(sess)
        if path is None or sess.engine._state is None:
            return False
        if rebased_yaml is _UNSET:
            try:
                from pydcop_tpu_torch.serving import (
                    migration as migration_mod)

                rebased_yaml = migration_mod.engine_dcop_yaml(
                    sess.engine, name=f"session_{sess.id}")
            except Exception as exc:  # noqa: BLE001 — a plain
                # (un-rebased) marker is the older behavior:
                # strictly worse replay time, never worse
                # correctness.
                logger.info(
                    "session %s: checkpoint rebase failed (%s); "
                    "writing a plain marker", sess.id, exc)
                rebased_yaml = None
        # np.savez appends ".npz" to names without it: the tmp name
        # must already end in .npz or the rename source won't exist.
        tmp = path + ".tmp.npz"
        try:
            sess.engine.checkpoint(tmp)
            os.replace(tmp, path)
            journal = self.service._journal
            if journal is not None:
                journal.append(journal_mod.session_ckpt_record(
                    sess.id, sess.applied_seq, path,
                    cycle=sess.last_cycle, dcop=rebased_yaml))
                self.service._journal_records.inc(
                    kind="session_ckpt")
        except Exception as exc:  # noqa: BLE001 — a failed snapshot
            # costs replay time after a crash, never the session.
            logger.warning("session %s checkpoint failed: %s",
                           sess.id, exc)
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            return False
        sess.events_since_ckpt = 0
        if rebased_yaml:
            # The base problem advanced past every batch through
            # applied_seq: the in-memory fallback log (and the
            # export-bundle base) advance with it.  order_lock —
            # apply_events appends to the log under it, so the
            # filter-and-replace can't drop a concurrent ack.
            with sess.order_lock:
                sess.dcop_yaml = rebased_yaml
                sess.event_log[:] = [
                    r for r in sess.event_log
                    if r.get("seq", 0) > sess.applied_seq]
        return True

    def _maybe_checkpoint(self, sess: SolveSession) -> None:
        if (self.checkpoint_every_events > 0
                and sess.events_since_ckpt
                >= self.checkpoint_every_events):
            self.checkpoint_session(sess)

    def _retire_ckpt(self, sess: SolveSession) -> None:
        path = self._ckpt_path(sess)
        if path:
            with contextlib.suppress(OSError):
                os.unlink(path)

    def recover(self, pending: List[Dict[str, Any]]) -> int:
        """Resume journaled sessions after a crash (service start,
        ``--recover``): rebuild each engine from the open record,
        re-apply the pre-checkpoint event batches STRUCTURALLY (the
        factor layout must match before message state can land),
        restore the checkpointed messages when a valid snapshot
        exists (cold-start warmup otherwise — correctness never
        depends on the checkpoint), apply the journaled-but-unapplied
        batches, and enqueue a re-convergence segment.  Decimation
        clamps are NOT restored — recovery re-converges unclamped,
        which costs cycles, never correctness."""
        from pydcop_tpu_torch.dcop.yamldcop import load_dcop

        recovered = 0
        if pending:
            flight.trigger("session_replay", n_sessions=len(pending))
        span = (tracer.span("session_replay", "serving",
                            n_sessions=len(pending))
                if tracer.active and pending else None)
        with (span if span is not None else contextlib.nullcontext()):
            for rec in pending:
                open_rec = rec["open"]
                sid = open_rec.get("id")
                try:
                    sess = self._recover_one(
                        load_dcop, open_rec, rec.get("ckpt"),
                        rec.get("events") or [])
                except Exception as exc:  # noqa: BLE001 — one bad
                    # session must not abort the rest of the replay.
                    logger.warning(
                        "session replay failed for %s: %s", sid, exc)
                    journal = self.service._journal
                    if journal is not None and sid:
                        with contextlib.suppress(Exception):
                            journal.append(
                                journal_mod.session_close_record(
                                    sid, ERROR))
                    continue
                recovered += 1
                if tracer.active:
                    tracer.instant("session_replay_session",
                                   "serving", session=sess.id,
                                   trace_id=sess.trace_id)
        self.replayed_sessions += recovered
        if recovered:
            self._sessions_total.inc(recovered, status="recovered")
            logger.info("session recovery resumed %d session(s)",
                        recovered)
        self._refresh_gauge()
        return recovered

    def _recover_one(self, load_dcop, open_rec, ckpt_rec,
                     event_recs) -> SolveSession:
        # A REBASED checkpoint marker carries the session's problem
        # as of its seq (engine_dcop_yaml): the factor layout
        # rebuilds from the marker alone and the pre-checkpoint
        # batches (already dropped by journal compaction) never
        # replay — recovery work is bounded by the checkpoint
        # cadence, not session age.
        base_yaml = (ckpt_rec or {}).get("dcop") or open_rec["dcop"]
        dcop = load_dcop(base_yaml)
        params = normalize_session_params(
            open_rec.get("params") or {})
        engine = build_dynamic_engine(dcop, params,
                                      device=self.service.device)
        engine.efficiency_class = "session"
        sess = SolveSession(
            id=open_rec["id"],
            trace_id=(open_rec.get("trace_id")
                      or uuid.uuid4().hex[:16]),
            dcop_yaml=base_yaml,
            params=params,
            engine=engine,
            budget=params["max_cycles"],
            replayed=True,
            epoch=max(int(open_rec.get("epoch") or 1), 1),
        )
        ckpt_seq = (ckpt_rec or {}).get("seq", -1)
        pre = [r for r in event_recs
               if r.get("seq", 0) <= ckpt_seq]
        post = [r for r in event_recs
                if r.get("seq", 0) > ckpt_seq]
        applied = 0
        # Batches replay through the SAME apply_event_batch the live
        # path used, with the same tolerance: a batch that failed
        # semantically in live operation fails identically here
        # (earlier actions stand, later batches still apply) — the
        # recovered engine state matches the crashed process's, and
        # one bad batch can never void the durable 200s that
        # followed it.
        for rec in pre:
            batch_applied, _touched, error = apply_event_batch(
                engine, rec.get("events"))
            applied += len(batch_applied)
            if error is not None:
                logger.warning(
                    "session %s replay: batch %s failed as it did "
                    "live: %s", sess.id, rec.get("seq"), error)
        if ckpt_rec is not None:
            try:
                engine.restore(ckpt_rec["path"])
                sess.last_cycle = int(ckpt_rec.get("cycle", 0))
            except Exception as exc:  # noqa: BLE001 — a bad snapshot
                # degrades to a cold warm-up, never kills the replay.
                logger.warning(
                    "session %s checkpoint restore failed (%s); "
                    "re-converging cold", sess.id, exc)
        for rec in post:
            batch_applied, touched, error = apply_event_batch(
                engine, rec.get("events"))
            applied += len(batch_applied)
            if error is not None:
                logger.warning(
                    "session %s replay: batch %s failed as it did "
                    "live: %s", sess.id, rec.get("seq"), error)
            if touched:
                engine.release_clamps(touched)
        # Every journaled batch was processed (applied or failed
        # batch-scoped, same as live): both counters land on the max
        # journaled seq.
        sess.seq = max(
            [r.get("seq", 0) for r in event_recs]
            + [(ckpt_rec or {}).get("seq", 0)] or [0])
        sess.applied_seq = sess.seq
        sess.events_applied = applied
        # Seed the migration-export fallback log with the batches
        # the base problem does NOT already include.
        base_seq = ((ckpt_rec or {}).get("seq", 0)
                    if (ckpt_rec or {}).get("dcop") else -1)
        sess.event_log = [
            {"seq": r.get("seq", 0), "events": r.get("events") or [],
             "trace_id": r.get("trace_id", "")}
            for r in event_recs if r.get("seq", 0) > base_seq]
        with self._lock:
            self._sessions[sess.id] = sess
        self._publish(sess, "open", {"replayed": True})
        self._enqueue(SessionWork("segment", sess))
        return sess

    # -- shutdown ------------------------------------------------------ #

    def park_all(self) -> int:
        """Service stop: checkpoint every OPEN session's warm state
        (a --recover restart resumes from it instead of re-converging
        cold) and mark it REPLAYABLE (journaled services) or ERROR
        (journal-less — the state is genuinely gone).  Wakes every
        waiter.  Returns the parked-session count.  Runs after the
        scheduler halted, so touching the engines is safe."""
        with self._lock:
            # MIGRATING parks too: a stop mid-migration leaves the
            # journal authoritative — no close record was written, so
            # a --recover restart resumes the session here (worst
            # case the target ALSO imported it; the router pin
            # decides the owner).
            open_sessions = [s for s in self._sessions.values()
                             if s.status in (OPEN, MIGRATING)]
        journaled = self.service._journal is not None
        for sess in open_sessions:
            if journaled:
                self.checkpoint_session(sess)
                sess.status = REPLAYABLE
                sess.final = {
                    "session_id": sess.id,
                    "trace_id": sess.trace_id,
                    "status": REPLAYABLE,
                    "error": "service stopped; session journaled "
                             "for --recover replay",
                }
                self._publish(sess, "replayable")
            else:
                self._fail(sess, "service stopped with the session "
                                 "open (no journal to replay from)")
                continue
            sess.done.set()
        self._refresh_gauge()
        return len(open_sessions)

    # -- introspection ------------------------------------------------- #

    def active_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._sessions.values()
                       if s.status == OPEN)

    def _refresh_gauge(self) -> None:
        self._active_g.set(self.active_count())

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            live = [s for s in self._sessions.values()
                    if s.status == OPEN]
            return {
                "active": len(live),
                "opened": self.opened,
                "closed": self.closed,
                "errored": self.errored,
                "replayed": self.replayed_sessions,
                "migrated_in": self.migrated_in,
                "migrated_out": self.migrated_out,
                "max_sessions": self.max_sessions,
                "events_applied": sum(
                    s.events_applied
                    for s in self._sessions.values()),
                "recompiles": sum(
                    s.recompiles for s in self._sessions.values()),
                # The oracle tier's rollup (docs/sessions.md): how
                # many quiesced fixpoints were certified, how many
                # certifications IMPROVED the served answer, and the
                # most recent certified-cost delta.
                "certify_after": self.certify_after,
                "certifications": self.certifications,
                "certified_improved": self.certified_improved,
                "certify_skipped_width": self.certify_skipped_width,
                "last_certification": (
                    dict(self.last_certification)
                    if self.last_certification else None),
            }
