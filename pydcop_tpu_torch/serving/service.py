"""The multi-tenant solve service: queue, binning dispatch, results.

Port of ``pydcop_tpu/serving/service.py``, behaviour for behaviour, on
one torch device (``device=``, default ``"cuda"``: without a card the
constructor raises unless ``device="cpu"`` is passed).  A bin goes
through the port's batch path (``engine/batch.py``): a same-structure
or envelope-padded stack is placed as one disjoint-union graph and the
edge-layout superstep runs on it (``run_stacked``), a lane group as
one lane-major union (``run_lane_packed``); warm dispatches queue on a
side stream of the card (``launch_*``) and are collected after the next
one launched (``collect_*``).  A stack with ``prune`` runs
synchronously: the pruned phase predicate is read on the host each
cycle, so ``launch_stacked`` returns ``None`` for it.

``SolveService`` turns the device engine into a throughput service:
callers :meth:`~SolveService.submit` DCOPs (each compiled on the
submitting thread — malformed problems fail synchronously, and
same-structure requests hit the layout cache), a scheduler
thread (serving/scheduler.py) drains the bounded queue, bins requests
by structure signature (serving/binning.py) and dispatches each bin
as ONE device dispatch (engine/batch.run_stacked, padded up the
bin-size ladder so ragged batch sizes reuse dispatch shapes).
Results stream back per request with latency accounting; admission
control (serving/admission.py) sheds load at the high-water mark and
opens a circuit breaker on repeated dispatch failure.

Request-plane telemetry (all registered on the process registry, so
the serving front end's ``/metrics`` exposes them):

- ``pydcop_requests_total{status}`` — every submit accounted:
  ``ok`` / ``error`` / ``rejected_queue_full`` /
  ``rejected_unavailable`` / ``rejected_bad_request``;
- ``pydcop_request_latency_seconds`` — submit→result histogram
  (p50/p99 straight off the buckets);
- ``pydcop_serve_queue_depth`` / ``pydcop_serve_batch_occupancy`` —
  live gauges;
- ``pydcop_serve_dispatches_total{kind}`` (``batched``/``solo``) and
  ``pydcop_serve_batched_requests_total`` — the batch-coalescing
  evidence (N same-structure requests in << N dispatches);
- per-batch ``serve_dispatch`` trace spans when tracing is on.

Fault tolerance (docs/resilience.md "Serving & sharding fault
tolerance"):

- **Durable journal + crash recovery** (``journal_dir=``): every
  admitted request is journaled BEFORE ``submit`` returns (the 202 is
  a durable promise), terminal outcomes are journaled too, and
  ``recover=True`` replays accepted-but-unfinished entries through
  the normal queue on start (``serve_replay`` span,
  ``pydcop_serve_replayed_total``) — a kill -9 mid-burst loses zero
  acknowledged requests.
- **Deadlines** (``submit(..., deadline_s=...)``): the scheduler
  drops already-expired work before binning — terminal state
  ``EXPIRED``, ledger status ``rejected_deadline``, 504 on the wire.
- **Poison isolation**: a failed multi-request bin dispatch BISECTS
  instead of failing wholesale — halves are retried
  (``pydcop_serve_dispatch_retries_total``) until the poison request
  fails alone and its bin-mates succeed; only the isolated singleton
  failure feeds the admission breaker.
- **Graceful drain**: ``stop(drain=True)`` returns a summary dict;
  with a journal, requests still queued at shutdown stay journaled
  as REPLAYABLE instead of being failed (``pydcop serve`` wires this
  to SIGTERM/SIGINT).
"""

import contextlib
import itertools
import logging
import os
import queue
import threading
import time
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.engine import batch as engine_batch
from pydcop_tpu_torch.engine.compile import compile_dcop
from pydcop_tpu_torch.observability import efficiency, flight
from pydcop_tpu_torch.observability.metrics import CycleSnapshotter
from pydcop_tpu_torch.observability.metrics import registry as metrics_registry
from pydcop_tpu_torch.observability.profiler import profiler
from pydcop_tpu_torch.observability.trace import tracer
from pydcop_tpu_torch.ops.dpop import UtilTooLargeError
from pydcop_tpu_torch.serving import binning, journal as journal_mod
from pydcop_tpu_torch.serving.admission import (
    AdmissionController,
    AdmissionPolicy,
    AdmissionRejected,
)

logger = logging.getLogger("pydcop.serving.service")

# Request states (FINISHED / ERROR / EXPIRED are terminal;
# REPLAYABLE is terminal for THIS process only — the journal still
# holds the accepted record, so a --recover restart replays it).
QUEUED = "QUEUED"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
ERROR = "ERROR"
EXPIRED = "EXPIRED"
REPLAYABLE = "REPLAYABLE"


class _DuplicateDelivery(Exception):
    """A caller-supplied request id was delivered again (duplicate
    socket delivery, a router retry after a lost response): resolved
    inside ``_submit`` by acknowledging the ORIGINAL — never an
    error, never a second execution."""


class WidthRejected(ValueError):
    """``algo="dpop"`` on a problem whose UTIL hypercubes bust
    ``ops/dpop.MAX_NODE_ELEMENTS`` even after CEC shrinkage.

    Raised ON THE SUBMITTING THREAD (width is decided from the
    pseudo-tree before any table exists), so the front end turns it
    into a structured 400 ``rejected_width`` — never a dispatch-time
    ``MemoryError`` feeding the admission breaker and a 500."""

    status = "rejected_width"

    def __init__(self, message: str, max_elements: int = 0,
                 cap: int = 0):
        super().__init__(message)
        self.max_elements = int(max_elements)
        self.cap = int(cap)


@dataclass
class SolveRequest:
    """One in-flight problem: compiled form + bookkeeping.

    ``deadline_s`` is a freshness budget relative to ``t_submit``:
    the scheduler refuses to dispatch the request past it (terminal
    state ``EXPIRED``).  ``replayed`` marks requests resurrected from
    the journal by crash recovery (their clock restarts at replay —
    the original submit clock died with the crashed process)."""

    id: str
    dcop: DCOP
    graph: Any
    meta: Any
    params: Dict[str, Any]
    bin: Any
    t_submit: float
    deadline_s: Optional[float] = None
    replayed: bool = False
    # Exact-inference requests (params["algo"] == "dpop") carry their
    # pseudo-tree from the submit-time width check to the dispatch —
    # built once per request, on the submitting thread.
    exact_tree: Any = None
    # Time-ledger breakpoints (observability/efficiency.py): enqueue
    # (submit-thread work ends), dispatch pickup, and the flush-plan
    # wall this request waited through — contiguous with the device
    # and decode intervals measured at dispatch, so the ledger's
    # components sum to the measured end-to-end latency.
    t_enqueue: float = 0.0
    t_dispatch: float = 0.0
    plan_s: float = 0.0
    # Request-scoped causality key: minted at submit, carried through
    # the journal record, queue entry, dispatch context and every
    # span/instant the request touches (docs/observability.md
    # "Tracing a single request").
    trace_id: str = ""
    status: str = QUEUED
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, Any]] = None


class DispatchPlan(NamedTuple):
    """One device dispatch the scheduler should fire for a flush
    (:meth:`SolveService.plan_flush`).  ``envelope``/``lane_d`` both
    None is the exact same-structure path; ``envelope`` (a
    serving/binning.Envelope) mask-pads a heterogeneous group to one
    shape; ``lane_d`` (a domain rung) lane-packs it as a disjoint
    union (engine/batch.run_lane_packed)."""

    reqs: List["SolveRequest"]
    envelope: Optional[Any] = None
    lane_d: Optional[int] = None


class PendingBatch(NamedTuple):
    """One launched-but-uncollected pipelined dispatch
    (:meth:`SolveService.launch_dispatch`): the device is executing
    bin k while the scheduler launches bin k+1 and decodes bin k-1.
    Consumed exactly once by :meth:`SolveService.collect_dispatch`.
    ``t_launch_end`` bounds the overlap measurement — host wall after
    it and before collect was spent on OTHER work while this
    dispatch's device work was in flight."""

    reqs: List["SolveRequest"]
    pending: Any                    # engine_batch.PendingDispatch
    envelope: Optional[Any] = None
    lane_d: Optional[int] = None
    t_launch_end: float = 0.0


class SolveService:
    """Bounded-queue, structure-binned batching solve service.

    Knobs: ``max_queue`` bounds the request queue (also the default
    admission high-water mark), ``batch_window_s`` is how long the
    scheduler lingers after the first request collecting batch-mates,
    ``max_batch`` caps one dispatch, ``bin_sizes`` is the
    padding ladder (engine/batch.DEFAULT_BIN_SIZES when None),
    ``default_params`` overrides the solver defaults
    (serving/binning.DEFAULT_PARAMS) service-wide, ``admission`` the
    backpressure/breaker policy, ``result_keep`` bounds completed-
    result retention (oldest evicted first — a long-lived service must
    not leak every response it ever produced).

    **Envelope batching**: structure bins
    are exact, so diverse traffic degenerates to batch-size-1 — every
    flush's leftover SINGLETON bins are therefore grouped by
    shape-envelope key (serving/binning.envelope_key over
    ``envelope_ladder``) and packed into one mask-padded dispatch when
    the modeled win beats solo dispatch
    (serving/binning.pack_decision: padding waste vs
    ``envelope_overhead_ms`` per dispatch, with the portfolio
    cache's measured per-structure times as free priors).  Groups
    whose domain rung is at most ``lane_domain_max`` (and that don't
    request pruning — an edge-major-only kernel) route through
    lane packing instead (engine/batch.run_lane_packed): a disjoint
    union with no per-member shape padding at all.  Results stay
    bit-identical to solo ``api.solve`` either way (mask-padded lanes
    and union members compute exactly the solo messages — battery- and
    smoke-asserted); ``envelope_packing=False`` restores the old
    solo-singleton behavior.

    ``journal_dir`` enables the durable request journal
    (serving/journal.py): acks become crash-durable, and
    ``recover=True`` replays accepted-but-unfinished requests through
    the normal queue on :meth:`start`.  ``journal_sync`` adds an
    fsync per record (machine-crash durability) at a per-request
    latency cost; the default flush already survives a process kill.
    """

    def __init__(self, max_queue: int = 256,
                 batch_window_s: float = 0.02,
                 max_batch: int = 16,
                 bin_sizes: Optional[List[int]] = None,
                 default_params: Optional[Dict[str, Any]] = None,
                 admission: Optional[AdmissionPolicy] = None,
                 result_keep: int = 4096,
                 journal_dir: Optional[str] = None,
                 journal_sync: bool = False,
                 recover: bool = False,
                 envelope_packing: bool = True,
                 envelope_ladder: Optional[
                     binning.EnvelopeLadder] = None,
                 envelope_overhead_ms: Optional[float] = None,
                 lane_pack: bool = True,
                 lane_domain_max: int = 8,
                 pipeline: bool = True,
                 speculate: bool = False,
                 session_max: int = 64,
                 session_segment_cycles: Optional[int] = None,
                 session_checkpoint_every_events: int = 8,
                 session_keep: int = 256,
                 session_certify_after: Optional[float] = None,
                 device: DeviceLike = "cuda"):
        # Resolved first: without a card a "cuda" service raises here,
        # before any thread or journal exists.
        self.device = resolve_device(device)
        if admission is None:
            admission = AdmissionPolicy(high_water=max_queue)
        self.admission = AdmissionController(admission)
        self.batch_window_s = batch_window_s
        self.max_batch = max(int(max_batch), 1)
        self.bin_sizes = tuple(
            bin_sizes or engine_batch.DEFAULT_BIN_SIZES)
        self.default_params = binning.normalize_params(default_params)
        self.result_keep = result_keep
        self.envelope_packing = bool(envelope_packing)
        self.envelope_ladder = (envelope_ladder
                                or binning.DEFAULT_LADDER)
        self.envelope_overhead_ms = float(
            envelope_overhead_ms if envelope_overhead_ms is not None
            else binning.PACK_OVERHEAD_MS)
        self.lane_pack = bool(lane_pack)
        self.lane_domain_max = int(lane_domain_max)
        # Closed-loop hot path: pipelined flush decode
        # (launch bin k+1 while bin k's arrays are still in flight)
        # and speculative envelope builds (predict the dispatches the
        # traffic will need and build their kernel libraries off the
        # scheduler thread).  ``--no_pipeline`` / ``--no_speculate`` isolate
        # each piece.
        self.pipeline = bool(pipeline)
        self.speculate = bool(speculate)
        self._speculator = None
        self._scheduler_ident: Optional[int] = None
        # Per-flush caches the planner refreshes at most once per
        # flush: the autotune JSON document (portfolio priors) and
        # the ledger-fitted pack-model constants.
        self._flush_autotune_data: Optional[Dict[str, Any]] = None
        self._flush_constants: Optional[Dict[str, float]] = None
        # Per-structure solve-time priors for the pack decision
        # (portfolio-cache reads memoized — the JSON file must not be
        # re-read per flush).
        self._prior_memo: Dict[str, Optional[float]] = {}
        # Recent pack-vs-solo decisions, replayable surface for tests
        # and /stats.
        self.envelope_decisions: "deque" = deque(maxlen=64)
        self.journal_dir = journal_dir
        self.journal_sync = journal_sync
        self.recover_on_start = recover
        self._journal = None
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._requests: "OrderedDict[str, SolveRequest]" = OrderedDict()
        # Outcomes recovered from the journal's completed-with-result
        # tail (--recover): rid -> wire-form result dict.  Read-mostly
        # after start(); bounded by journal.COMPLETED_KEEP.
        self._recovered_results: "OrderedDict[str, Dict[str, Any]]" = \
            OrderedDict()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._scheduler = None
        self._started = False
        # Dispatch ledger (also mirrored into the registry).
        self.dispatches = 0
        self.batched_dispatches = 0
        self.batched_requests = 0
        self.envelope_dispatches = 0
        self.lane_dispatches = 0
        self.envelope_packed_requests = 0
        self.completed = 0
        self.failed = 0
        self.expired = 0
        self.replayed = 0
        self.dispatch_retries = 0
        self.pipelined_dispatches = 0
        self.speculative_hits = 0
        # prune="auto" submits resolved through the portfolio cache.
        self.portfolio_resolved = 0
        self.deduped = 0
        # Exact-inference plane: dispatches completed via
        # DpopEngine, and the shared warm-key set that keeps repeat
        # same-signature solves attributed as warm in the jit ledger.
        self.dpop_dispatches = 0
        self._dpop_warm: set = set()
        self.last_stop: Optional[Dict[str, Any]] = None
        reg = metrics_registry
        self._req_total = reg.counter(
            "pydcop_requests_total",
            "Solve-service requests by terminal status")
        self._latency = reg.histogram(
            "pydcop_request_latency_seconds",
            "Submit-to-result latency of solve-service requests")
        self._queue_depth = reg.gauge(
            "pydcop_serve_queue_depth",
            "Solve-service requests waiting in the queue")
        self._occupancy = reg.gauge(
            "pydcop_serve_batch_occupancy",
            "Real-instance fraction of the last dispatched batch")
        self._dispatch_total = reg.counter(
            "pydcop_serve_dispatches_total",
            "Device dispatches by kind (batched = >1 real instance)")
        self._batched_reqs = reg.counter(
            "pydcop_serve_batched_requests_total",
            "Requests that shared their device dispatch with others")
        self._pad_waste = reg.counter(
            "pydcop_serve_padded_lanes_total",
            "Padded (wasted) batch lanes dispatched to the device")
        self._retries = reg.counter(
            "pydcop_serve_dispatch_retries_total",
            "Bisection retry dispatches after a failed bin dispatch")
        self._envelope_total = reg.counter(
            "pydcop_serve_envelope_dispatches_total",
            "Heterogeneous-structure packed dispatches by kind "
            "(envelope = mask-padded stack, lane = disjoint union)")
        self._envelope_decided = reg.counter(
            "pydcop_serve_envelope_decisions_total",
            "Per-flush envelope pack-vs-solo cost decisions by verdict")
        self._envelope_waste_g = reg.gauge(
            "pydcop_serve_envelope_waste",
            "Padded-cell fraction of the last envelope-packed dispatch")
        self._replayed_total = reg.counter(
            "pydcop_serve_replayed_total",
            "Journaled requests replayed through the queue on "
            "crash recovery")
        self._journal_records = reg.counter(
            "pydcop_serve_journal_records_total",
            "Request-journal records appended, by kind")
        # Stateful solve sessions:
        # long-lived DynamicMaxSumEngine solves whose scenario events
        # apply between engine segments on the scheduler thread.
        from pydcop_tpu_torch.serving.sessions import SessionManager

        self.sessions = SessionManager(
            self, max_sessions=session_max,
            segment_cycles=session_segment_cycles,
            checkpoint_every_events=session_checkpoint_every_events,
            session_keep=session_keep,
            certify_after=session_certify_after)

    # -- lifecycle ----------------------------------------------------- #

    def start(self) -> "SolveService":
        from pydcop_tpu_torch.serving.scheduler import BinScheduler

        if self._started:
            return self
        # Activated like an ObservabilitySession: request-plane detail
        # counters should record while the service runs; the prior
        # state is restored on stop so an embedding process (tests,
        # bench) is left the way it was found.  The device cost profiler
        # rides along (one profiled throwaway dispatch per cache key,
        # observability/profiler.py): efficiency must be an
        # always-scrapeable signal, not a bench-only one.
        # ``PYDCOP_XLA_PROFILE=0`` still vetoes.
        self._was_active = metrics_registry.active
        metrics_registry.active = True
        self._was_profiling = profiler.enabled
        profiler.enabled = True
        pending = []
        pending_sessions = []
        recovered_results = []
        if self.journal_dir and self._journal is None:
            if self.recover_on_start:
                (self._journal, pending, pending_sessions,
                 recovered_results) = \
                    journal_mod.RequestJournal.recover_full(
                        self.journal_dir, sync=self.journal_sync)
            else:
                self._journal = journal_mod.RequestJournal(
                    self.journal_dir, sync=self.journal_sync)
        if self.speculate and self._speculator is None:
            from pydcop_tpu_torch.serving.speculate import (
                SpeculativeCompiler,
            )

            self._speculator = SpeculativeCompiler(
                bin_sizes=self.bin_sizes, device=self.device)
            self._speculator.start()
        self._scheduler = BinScheduler(
            self, batch_window_s=self.batch_window_s,
            max_batch=self.max_batch)
        self._scheduler.start()
        self._scheduler_ident = self._scheduler.thread_ident()
        self._started = True
        if self._journal is not None:
            # Journal backlog feeds the operator surfaces while the
            # service runs: /healthz (replay debt before a restart)
            # and postmortem bundles (what was pending at the
            # anomaly).  The bound method is kept so stop() can
            # identity-clear exactly this registration.
            self._flight_provider = self.journal_summary
            flight.set_journal_provider(self._flight_provider)
        if recovered_results:
            # The predecessor's journaled outcomes: a client still
            # polling a pre-crash ack gets its 200 from here instead
            # of a 404 (the in-memory result cache died with the
            # process).  Live requests shadow this cache — result()
            # checks ``_requests`` first.
            with self._lock:
                for rec in recovered_results:
                    self._recovered_results[rec["id"]] = (
                        rec.get("result") or {})
        if pending:
            self._replay(pending)
        if pending_sessions:
            # Whole-session replay: engines rebuilt from the open
            # records, warm state restored from the newest checkpoint,
            # journaled-but-unapplied event batches re-applied
            # (serving/sessions.py SessionManager.recover).
            self.sessions.recover(pending_sessions)
        return self

    def stop(self, drain: bool = True,
             timeout: float = 30.0) -> Dict[str, Any]:
        """Stop the scheduler.  ``drain=True`` (default) lets queued
        requests finish first — a service shutdown must not silently
        drop accepted work; ``drain=False`` skips the wait.  Requests
        still queued after the drain window are journaled-REPLAYABLE
        when a journal is active (a ``--recover`` restart picks them
        up; in-process ``result(wait=...)`` waiters are woken with a
        ``REPLAYABLE`` result instead of sleeping out their window),
        and failed with a shutdown error otherwise.

        Returns a drain summary: ``drained`` (requests completed
        between the stop call and the scheduler halt), ``replayable``
        (left in the journal for the next ``--recover`` start) and
        ``failed_pending`` (dropped with an error — journal-less
        services only)."""
        if not self._started:
            return dict(self.last_stop or
                        {"drained": 0, "replayable": 0,
                         "failed_pending": 0, "parked_sessions": 0})
        completed_before = self.completed
        if drain:
            deadline = time.monotonic() + timeout
            while (not self._queue.empty()
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        self._scheduler.shutdown(timeout=timeout)
        self._scheduler = None
        if self._speculator is not None:
            self._speculator.stop()
            self._speculator = None
        self._started = False
        metrics_registry.active = self._was_active
        profiler.enabled = getattr(self, "_was_profiling", False)
        # Anything still queued (drain=False, drain timeout, or a
        # submit that raced the shutdown): journaled services leave it
        # REPLAYABLE — the accepted record survives, a --recover
        # restart replays it — journal-less services fail it.  The
        # queue may also hold the scheduler's unconsumed shutdown
        # sentinel — skip anything that isn't a request.
        failed_pending = 0
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if not isinstance(req, SolveRequest):
                # Queued session work dies with the queue (the
                # session itself is parked below); wake any PATCH
                # waiter blocked on it.
                done = getattr(req, "done", None)
                if done is not None:
                    req.error = "service stopped"
                    done.set()
                continue
            if self._journal is not None:
                logger.info("request %s left journaled-replayable "
                            "at shutdown", req.id)
            else:
                failed_pending += 1
                self._finish_error(req,
                                   "service stopped before dispatch")
        # Park open sessions AFTER the scheduler halted (their
        # engines are safe to touch) and BEFORE the journal closes:
        # journaled sessions checkpoint their warm state + stay
        # REPLAYABLE for --recover, journal-less ones fail.
        parked_sessions = self.sessions.park_all()
        replayable = 0
        if self._journal is not None:
            # Identity-guarded: never strip a sibling journaled
            # service's registration.
            provider = getattr(self, "_flight_provider", None)
            if provider is not None:
                flight.clear_journal_provider(provider)
            # Every accepted-but-not-terminal request — whether still
            # queued or caught mid-collection in the scheduler — has
            # its accepted record on disk and no completion: the next
            # --recover start replays exactly this set.
            with self._lock:
                replayable_reqs = [
                    r for r in self._requests.values()
                    if not r.done.is_set()]
            replayable = len(replayable_reqs)
            self._journal.close()
            self._journal = None
            # Wake in-process waiters: a result(wait=...) caller must
            # not sleep its full window for an answer this process can
            # no longer produce.  The journal keeps only the accepted
            # record — REPLAYABLE is terminal for this process, not
            # for the request.
            for req in replayable_reqs:
                req.result = {
                    "id": req.id, "status": REPLAYABLE,
                    "error": "service stopped before dispatch; "
                             "journaled for --recover replay",
                }
                req.status = REPLAYABLE
                req.done.set()
        self.last_stop = {
            "drained": self.completed - completed_before,
            "replayable": replayable,
            "failed_pending": failed_pending,
            "parked_sessions": parked_sessions,
        }
        return dict(self.last_stop)

    def __enter__(self) -> "SolveService":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- request plane ------------------------------------------------- #

    def submit(self, dcop: DCOP,
               params: Optional[Dict[str, Any]] = None,
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None) -> str:
        """Admit, compile and enqueue one problem; returns the request
        id.  Raises :class:`~pydcop_tpu_torch.serving.admission.
        AdmissionRejected` (429/503 at the front end) on backpressure
        and ``ValueError`` (400) on malformed problems/parameters.

        ``deadline_s`` (optional, seconds from now): the scheduler
        refuses to dispatch the request past its deadline — terminal
        ``EXPIRED`` (504 on the wire, ``rejected_deadline`` in the
        ledger) instead of burning device time on an answer nobody is
        waiting for.

        With a journal, the accepted record reaches the OS before
        this returns — the id this hands back survives a process
        kill.

        Every submit mints a ``trace_id`` (returned alongside the id
        over the wire, journaled with the accepted record, stamped on
        every span the request later touches) — ``pydcop trace query
        --request <trace_id>`` reconstructs the request's span tree
        from a trace file.  A caller-supplied ``trace_id`` (the fleet
        router's wire-propagated context) is adopted
        instead, so this replica's spans nest under the router's
        admission trace in the fleet collector.

        Compilation happens HERE, on the submitting thread: structure
        errors surface synchronously, concurrent clients compile in
        parallel, and the scheduler thread stays dedicated to device
        dispatch.  Same-structure submissions hit the layout
        cache, so the steady-state compile cost is the cost-table
        fill."""
        if not self._started:
            raise RuntimeError("SolveService is not started")
        t_submit = time.perf_counter()
        trace_id = trace_id or uuid.uuid4().hex[:16]
        if not tracer.active:
            return self._submit(dcop, params, request_id, deadline_s,
                                t_submit, trace_id)
        with tracer.span("serve_submit", "serving",
                         trace_id=trace_id):
            return self._submit(dcop, params, request_id, deadline_s,
                                t_submit, trace_id)

    def _submit(self, dcop: DCOP, params, request_id, deadline_s,
                t_submit: float, trace_id: str) -> str:
        if request_id is not None:
            # Submit is IDEMPOTENT on caller-supplied ids (the fleet
            # router mints one per request and, after an ambiguous
            # forward failure, retries against this same replica): a
            # re-delivery — duplicate on the wire, a resend after the
            # response was lost, even across a restart (the journal
            # feeds _recovered_results; replay keeps original ids) —
            # acknowledges the ORIGINAL instead of executing twice or
            # rejecting.  Internally-minted ids (request_id=None)
            # skip this: a fresh ``r<N>`` colliding with a recovered
            # result would falsely swallow a brand-new request.
            with self._lock:
                known = (request_id in self._requests
                         or request_id in self._recovered_results)
                if known:
                    self.deduped += 1
            if known:
                self._req_total.inc(status="deduped")
                # Telemetry-visible dedupe: the fleet forensics tree
                # proves "N deliveries, one execute" from this
                # instant alone (it carries the router's propagated
                # trace_id, same as the winning delivery's spans).
                if tracer.active:
                    tracer.instant("serve_dedupe", "serving",
                                   request=request_id,
                                   trace_id=trace_id)
                return request_id
        try:
            self.admission.admit(self._queue.qsize())
        except AdmissionRejected as rejection:
            status = ("rejected_queue_full"
                      if rejection.http_status == 429
                      else "rejected_unavailable")
            self._req_total.inc(status=status)
            raise
        # Everything below is the caller's fault when it raises
        # (unknown/bad-typed params, malformed problem, duplicate id,
        # bad deadline -> 400 at the front end): still a ledger
        # entry, so pydcop_requests_total reconciles against
        # client-side counts even when clients misbehave.
        try:
            if deadline_s is not None:
                deadline_s = float(deadline_s)
                if not deadline_s > 0:
                    raise ValueError(
                        f"deadline_s must be > 0, got {deadline_s}")
            merged = dict(self.default_params)
            if params:
                merged.update(params)
            merged = binning.normalize_params(merged)
            graph, meta = compile_dcop(
                dcop, noise_level=merged["noise"])
            if merged["prune"] == "auto":
                # Consume the portfolio racer's persisted decision
                # for this structure (engine/autotune): pruned maxsum
                # when it won the race, dense otherwise.  Replay
                # only — the serving hot path never measures; a cache
                # miss resolves dense.  Resolved BEFORE the bin key,
                # so a bin is homogeneous in the device program it
                # dispatches.
                from pydcop_tpu_torch.engine.autotune import (
                    cached_portfolio_choice,
                    graph_shape_key,
                    portfolio_key,
                )

                choice = cached_portfolio_choice(portfolio_key(
                    graph_shape_key(graph, self.device.type)))
                merged["prune"] = 1 if choice == "maxsum_prune" else 0
                with self._lock:
                    self.portfolio_resolved += 1
            exact_tree = None
            if merged["algo"] == "dpop":
                exact_tree = self._check_width(dcop)
            req = SolveRequest(
                id=request_id or f"r{next(self._ids)}",
                dcop=dcop, graph=graph, meta=meta, params=merged,
                bin=binning.bin_key(graph, merged),
                t_submit=t_submit, deadline_s=deadline_s,
                trace_id=trace_id, exact_tree=exact_tree,
            )
            with self._lock:
                if req.id in self._requests:
                    if request_id is not None:
                        # Two deliveries raced past the early dedupe
                        # check: the one that lost the insert race is
                        # a duplicate, not an error.
                        raise _DuplicateDelivery()
                    raise ValueError(
                        f"duplicate request id {req.id!r}")
                self._requests[req.id] = req
                self._prune_locked()
        except _DuplicateDelivery:
            with self._lock:
                self.deduped += 1
            self._req_total.inc(status="deduped")
            if tracer.active:
                tracer.instant("serve_dedupe", "serving",
                               request=request_id, trace_id=trace_id)
            return request_id
        except WidthRejected:
            # Its own ledger status: an over-wide exact request is a
            # capacity verdict about the problem, not a malformed
            # payload — operators watching rejected_bad_request for
            # client bugs must not see width verdicts in that count.
            self._req_total.inc(status="rejected_width")
            raise
        except Exception:
            self._req_total.inc(status="rejected_bad_request")
            raise
        if self._journal is not None:
            # BEFORE the queue and before the caller can ack: the 202
            # must never outlive the journal record.  A failed append
            # fails the submit — a durability promise the service
            # cannot keep must not be made.
            try:
                from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

                self._journal.append(journal_mod.accepted_record(
                    req.id, dcop_yaml(dcop), req.params,
                    deadline_s=deadline_s, t_submit=t_submit,
                    trace_id=trace_id))
                self._journal_records.inc(kind="accepted")
            except Exception as exc:
                with self._lock:
                    self._requests.pop(req.id, None)
                self._req_total.inc(status="error")
                raise RuntimeError(
                    f"request journal append failed: {exc}") from exc
        # Published BEFORE the enqueue: once the request is in the
        # queue the scheduler may dispatch (and even finish) it ahead
        # of this thread's next line, and SSE clients are promised
        # accepted → dispatched → finished in order.
        self._publish_lifecycle("accepted", req)
        req.t_enqueue = time.perf_counter()
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            # qsize raced past the high-water check: same contract as
            # an admission rejection, never a blocking put.  The
            # journal must agree the request is terminal — without
            # the completion record a --recover restart would replay
            # a request its client saw rejected.
            with self._lock:
                self._requests.pop(req.id, None)
            req.status = ERROR
            self._journal_done(req)
            self._req_total.inc(status="rejected_queue_full")
            # The stream already saw "accepted": close the lifecycle
            # out rather than leaving watchers waiting forever.
            self._publish_lifecycle("error", req)
            raise QueueFullRace(
                f"request queue full ({self._queue.maxsize})")
        self._queue_depth.set(self._queue.qsize())
        return req.id

    def _replay(self, records: List[Dict[str, Any]]) -> None:
        """Re-enqueue journaled accepted-but-unfinished requests
        through the normal queue (crash recovery).  Replayed requests
        keep their original ids (clients poll the id they were acked
        with) and skip admission — they were admitted by the previous
        process; their accepted records already survive in the
        compacted journal, so nothing is re-journaled here.  A record
        that no longer compiles is failed (journaled terminal) rather
        than dropped."""
        from pydcop_tpu_torch.dcop.yamldcop import load_dcop

        # Replay start is black-box-worthy: the bundle shows what the
        # crashed predecessor left behind (and the tail will show
        # whether the replay itself went wrong).
        flight.trigger("journal_replay", n_pending=len(records))
        span = (tracer.span("serve_replay", "serving",
                            n_pending=len(records))
                if tracer.active else None)
        replayed = 0
        with (span if span is not None else contextlib.nullcontext()):
            for rec in records:
                rid = rec.get("id")
                try:
                    dcop = load_dcop(rec["dcop"])
                    merged = binning.normalize_params(
                        rec.get("params") or {})
                    graph, meta = compile_dcop(
                        dcop, noise_level=merged["noise"])
                    # The deadline clock restarts at replay: the
                    # original submit clock died with the crashed
                    # process, and expiring everything on principle
                    # would turn recovery into a mass 504.
                    req = SolveRequest(
                        id=rid, dcop=dcop, graph=graph, meta=meta,
                        params=merged,
                        bin=binning.bin_key(graph, merged),
                        t_submit=time.perf_counter(),
                        deadline_s=rec.get("deadline_s"),
                        replayed=True,
                        # Keep the pre-crash causality key (older
                        # journals have none: mint fresh).
                        trace_id=(rec.get("trace_id")
                                  or uuid.uuid4().hex[:16]),
                    )
                    with self._lock:
                        self._requests[req.id] = req
                    # Replays re-enter the documented lifecycle from
                    # the top: an SSE client that creates its
                    # per-request state on "accepted" must see
                    # replayed requests too.  Before the put, like
                    # submit() — the scheduler may dispatch first.
                    self._publish_lifecycle("accepted", req)
                    req.t_enqueue = time.perf_counter()
                    self._queue.put(req, timeout=30.0)
                except Exception as exc:  # noqa: BLE001 — one bad
                    # record must not abort the rest of the replay.
                    logger.warning("journal replay failed for %s: %s",
                                   rid, exc)
                    with self._lock:
                        req = self._requests.get(rid)
                    if req is not None:
                        self._finish_error(
                            req, f"journal replay failed: {exc}")
                    elif self._journal is not None and rid:
                        # No request object to fail (the yaml itself
                        # would not load): journal the terminal
                        # directly so the record cannot replay
                        # forever.
                        try:
                            self._journal.append(
                                journal_mod.completed_record(
                                    rid, ERROR, result={
                                        "id": rid, "status": ERROR,
                                        "error": ("journal replay "
                                                  f"failed: {exc}"),
                                    }))
                            self._journal_records.inc(kind="completed")
                        except Exception:
                            logger.warning(
                                "could not journal replay failure "
                                "for %s", rid)
                        self._req_total.inc(status="error")
                    continue
                replayed += 1
                if tracer.active:
                    tracer.instant("serve_replay_request", "serving",
                                   id=rid, trace_id=req.trace_id)
        self.replayed += replayed
        if replayed:
            self._replayed_total.inc(replayed)
            logger.info("journal recovery replayed %d request(s)",
                        replayed)
        self._queue_depth.set(self._queue.qsize())

    def record_bad_request(self) -> None:
        """Ledger a client error rejected before :meth:`submit` could
        run (the front end validates wire-level fields like
        ``timeout`` first) — the request ledger must reconcile against
        client-side counts on every path."""
        self._req_total.inc(status="rejected_bad_request")

    def result(self, request_id: str,
               wait: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """The request's result dict, or None while pending.  With
        ``wait`` (seconds), block up to that long for completion.
        Ids finished by a crashed predecessor resolve from the
        recovered-result cache (--recover).  Raises ``KeyError`` for
        unknown ids."""
        with self._lock:
            req = self._requests.get(request_id)
            if req is None:
                recovered = self._recovered_results.get(request_id)
        if req is None:
            if recovered is not None:
                return dict(recovered)
            raise KeyError(request_id)
        if wait:
            req.done.wait(wait)
        return req.result if req.done.is_set() else None

    def status(self, request_id: str) -> str:
        with self._lock:
            req = self._requests.get(request_id)
            if req is None:
                recovered = self._recovered_results.get(request_id)
        if req is None:
            if recovered is not None:
                return recovered.get("status", ERROR)
            raise KeyError(request_id)
        return req.status

    def trace_id(self, request_id: str) -> str:
        """The request's causality key (the handle ``pydcop trace
        query --request`` takes).  Raises ``KeyError`` for unknown
        ids."""
        with self._lock:
            req = self._requests.get(request_id)
            if req is None:
                recovered = self._recovered_results.get(request_id)
        if req is None:
            if recovered is not None and recovered.get("trace_id"):
                return recovered["trace_id"]
            raise KeyError(request_id)
        return req.trace_id

    def _prune_locked(self):
        """Evict oldest COMPLETED results past result_keep (pending
        requests are never evicted — their clients still hold the
        id).  Amortized O(excess), not a full-table scan: the table
        is insertion-ordered, so eviction pops completed entries off
        the front, rotating still-pending heads to the back (each
        entry rotates at most once per call, bounding the loop even
        when everything old is still pending)."""
        excess = len(self._requests) - self.result_keep
        if excess <= 0:
            return
        rotations = 0
        while excess > 0 and rotations < len(self._requests):
            rid = next(iter(self._requests))
            if self._requests[rid].done.is_set():
                del self._requests[rid]
                excess -= 1
            else:
                self._requests.move_to_end(rid)
                rotations += 1

    # -- flush planning (called by the scheduler thread) --------------- #

    def plan_flush(self, bins: Dict[Any, List[SolveRequest]]
                   ) -> List[DispatchPlan]:
        """Turn one coalescing window's bins into dispatch plans.

        Multi-request bins keep the exact same-structure path
        unchanged (identical shapes, zero padding).  Leftover
        SINGLETON bins — exactly the population structure binning
        cannot batch — are grouped by the coarser envelope tier:
        same solver params + same shape envelope
        (serving/binning.envelope_key), or same domain rung for the
        lane route (the disjoint union accepts any variable/factor
        counts, so lane groups only need the domain and params to
        agree).  Each group of >= 2 goes through the
        :func:`~pydcop_tpu_torch.serving.binning.pack_decision` cost model —
        packed only when the modeled dispatch-overhead saving beats
        the padding waste — and losing groups fall back to solo
        dispatches, so a pathological group can never be slower than
        the old behavior by more than the model's error.

        The planning wall is stamped on every request in the flush
        (``plan_s``) — each of them waited through it, so it is a real
        component of each one's latency ledger (the ``plan`` column of
        where-the-time-went).

        Planner crashes degrade HERE, once per flush: planning is an
        optimization, never a correctness dependency, so an exception
        logs ONE traceback and falls back to the old one-plan-per-bin
        behavior for the whole flush (the scheduler's per-chunk guard
        stays the last line of defense)."""
        t_plan = time.perf_counter()
        self._refresh_flush_caches()
        try:
            return self._plan_flush(bins)
        except Exception:  # noqa: BLE001 — degrade, don't crash
            logger.exception(
                "flush planning crashed; dispatching per bin")
            return [DispatchPlan(list(bins[k]))
                    for k in sorted(bins, key=lambda k: -len(bins[k]))]
        finally:
            plan_s = time.perf_counter() - t_plan
            for reqs in bins.values():
                for req in reqs:
                    req.plan_s = plan_s

    def _refresh_flush_caches(self) -> None:
        """Once-per-flush reads of the autotune surfaces the planner
        consults per GROUP otherwise: the shape-cache JSON document
        (portfolio priors for structures not yet memoized) and the
        ledger-fitted pack-model constants (a cold start falls back
        to the compiled-in defaults via ``None``)."""
        from pydcop_tpu_torch.engine import autotune

        try:
            self._flush_autotune_data = autotune._load_cache(
                autotune.cache_path())
        except Exception:  # noqa: BLE001 — priors are an optimization
            self._flush_autotune_data = None
        self._flush_constants = None
        if autotune.pack_fit_enabled():
            try:
                fitted = autotune.fitted_pack_constants(
                    efficiency.backend_name())
                if (fitted
                        and self.envelope_overhead_ms
                        != binning.PACK_OVERHEAD_MS):
                    # An operator-set (or test-forced) dispatch
                    # overhead must not be silently overridden by the
                    # fitted one — only the MODEL constants apply.
                    fitted = {k: v for k, v in fitted.items()
                              if k != "overhead_ms"}
                self._flush_constants = fitted or None
            except Exception:  # noqa: BLE001
                self._flush_constants = None

    def _plan_flush(self, bins: Dict[Any, List[SolveRequest]]
                    ) -> List[DispatchPlan]:
        plans: List[DispatchPlan] = []
        singles: List[SolveRequest] = []
        for key in sorted(bins, key=lambda k: -len(bins[k])):
            reqs = bins[key]
            if reqs[0].params.get("algo") == "dpop":
                # Exact-inference bins never enter envelope/lane
                # packing: DPOP batches WITHIN each problem (the
                # level-batched signature buckets), and cross-problem
                # stacking has no meaning for a tree sweep.
                plans.append(DispatchPlan(list(reqs)))
            elif len(reqs) > 1 or not self.envelope_packing:
                plans.append(DispatchPlan(list(reqs)))
            else:
                singles.append(reqs[0])
        if len(singles) == 1:
            self._observe_for_speculation(singles[0], count=1)
            plans.append(DispatchPlan(singles))
            return plans
        groups: Dict[Any, List[SolveRequest]] = {}
        for req in singles:
            env = binning.envelope_key(req.graph,
                                       self.envelope_ladder)
            params_part = req.bin[1]
            lane_ok = (self.lane_pack
                       and env.d_env <= self.lane_domain_max
                       and not req.params.get("prune"))
            gkey = (("lane", env.d_env, params_part) if lane_ok
                    else ("envelope", env, params_part))
            groups.setdefault(gkey, []).append(req)
        for gkey, group in groups.items():
            self._observe_for_speculation(group[0], count=len(group))
            # Decide per max_batch CHUNK, not per group: the
            # scheduler dispatches at most max_batch requests per
            # device call, so a 20-member group runs as 16+4 — the
            # cost model must price the dispatches that will actually
            # execute, or borderline verdicts are computed against a
            # shape that never runs.
            for i in range(0, len(group), self.max_batch):
                reqs = group[i:i + self.max_batch]
                if len(reqs) == 1:
                    plans.append(DispatchPlan(reqs))
                    continue
                # Lane groups are keyed by the domain RUNG (so
                # near-sized domains coalesce) but packed at the
                # chunk's exact max domain — the union's shapes are
                # ladder-bounded by row/var rounding regardless, and
                # rounding the domain would charge every member the
                # rung's hypercube blowup.
                shape = (max(r.graph.dmax for r in reqs)
                         if gkey[0] == "lane" else gkey[1])
                decision = self._pack_decision(gkey[0], shape, reqs)
                if not decision["packed"]:
                    plans.extend(DispatchPlan([r]) for r in reqs)
                    continue
                if gkey[0] == "lane":
                    plans.append(DispatchPlan(reqs, lane_d=shape))
                else:
                    plans.append(DispatchPlan(reqs, envelope=shape))
        return plans

    def _observe_for_speculation(self, req: SolveRequest,
                                 count: int) -> None:
        """Feed the arrival histogram: one cheap ``observe`` per
        envelope group per flush — the speculator predicts the bin
        rungs this structure's traffic will need next and builds their
        kernel libraries off-thread.  Never raises into the planner."""
        if self._speculator is None:
            return
        if req.params.get("algo") == "dpop":
            return
        try:
            env = binning.envelope_key(req.graph,
                                       self.envelope_ladder)
            self._speculator.observe(req.graph, env, req.params,
                                     count)
        except Exception:  # noqa: BLE001 — speculation is optional
            pass

    def _pack_decision(self, kind: str, shape,
                       reqs: List[SolveRequest]) -> Dict[str, Any]:
        """Model one group's pack-vs-solo choice and record it (the
        bounded ``envelope_decisions`` log, /stats, and the decision
        counter) so the choice is replayable and auditable."""
        real = [binning.graph_cells(r.graph) for r in reqs]
        if kind == "lane":
            packed_total = binning.lane_union_cells(
                [r.graph for r in reqs], shape)
            label = f"lane_d{shape}"
        else:
            # Stacked envelope: the batch pads up the bin-size ladder,
            # and every lane (padding lanes included) is a full
            # envelope's worth of cells.
            packed_total = (
                engine_batch.bin_size_for(len(reqs), self.bin_sizes)
                * binning.envelope_cells(shape))
            label = binning.envelope_label(shape)
        priors, sources = [], []
        for r, cells in zip(reqs, real):
            ms, src = self._solve_prior(r, cells)
            priors.append(ms)
            sources.append(src)
        decision = binning.pack_decision(
            real, priors, packed_total,
            max_cycles=reqs[0].params["max_cycles"],
            overhead_ms=self.envelope_overhead_ms,
            constants=self._flush_constants)
        decision.update({
            "kind": kind,
            "label": label,
            "prior_ms": [round(p, 4) for p in priors],
            "prior_sources": sources,
        })
        # Locked: stats() snapshots this deque from other threads,
        # and an unguarded append (maxlen eviction mutates too) can
        # raise mid-iteration there.
        with self._lock:
            self.envelope_decisions.append(decision)
        self._envelope_decided.inc(
            verdict="packed" if decision["packed"] else "solo")
        return decision

    def _solve_prior(self, req: SolveRequest, real_cells: int):
        """Per-structure solo solve-time prior: the portfolio
        cache's measured race time when one exists for this structure
        (memoized — one JSON read per structure per process), the
        cells*cycles model otherwise."""
        from pydcop_tpu_torch.engine.autotune import (
            PORTFOLIO_RACE_CYCLES,
            cached_portfolio_timing_ms,
            graph_shape_key,
            portfolio_key,
        )

        portfolio_ms = None
        try:
            skey = graph_shape_key(req.graph, self.device.type)
            if skey in self._prior_memo:
                portfolio_ms = self._prior_memo[skey]
            else:
                # The flush-preloaded JSON document (one disk read
                # per flush, not one per unmemoized group member).
                portfolio_ms = cached_portfolio_timing_ms(
                    portfolio_key(skey),
                    data=self._flush_autotune_data)
                self._prior_memo[skey] = portfolio_ms
        except Exception:  # noqa: BLE001 — a prior is an optimization
            portfolio_ms = None
        return binning.solve_prior_ms(
            real_cells, req.params["max_cycles"], portfolio_ms,
            race_cycles=PORTFOLIO_RACE_CYCLES,
            constants=self._flush_constants)

    # -- dispatch plane (called by the scheduler thread) --------------- #

    def dispatch(self, reqs: List[SolveRequest],
                 envelope=None, lane_d: Optional[int] = None) -> None:
        """Solve one same-bin batch in a single device dispatch and
        complete every request in it.

        An engine failure on a MULTI-request batch does not fail the
        batch wholesale: the bin is BISECTED and each half retried
        (``pydcop_serve_dispatch_retries_total``), recursively, until
        the poison request fails ALONE and its bin-mates succeed —
        log-bounded (at most ``2·n - 1`` dispatches for one poison
        request in a bin of n).  Only the isolated singleton failure
        feeds the admission breaker, so one poison client cannot open
        the circuit for a healthy engine — while a genuinely down
        engine still fails every singleton and trips it."""
        t_dequeue = time.perf_counter()
        for req in reqs:
            req.status = RUNNING
            req.t_dispatch = t_dequeue
            if tracer.active:
                # The queue wait started on the submitting thread and
                # ended here on the scheduler thread: record it
                # retroactively from its explicit endpoints so the
                # request tree shows time-in-queue as a real span.
                tracer.complete(
                    "serve_queued", "serving",
                    t0=req.t_submit, t1=t_dequeue,
                    trace_id=req.trace_id, request=req.id)
            self._publish_lifecycle("dispatched", req)
        self._queue_depth.set(self._queue.qsize())
        self._dispatch_attempt(reqs, retry_depth=0,
                               envelope=envelope, lane_d=lane_d)

    def launch_dispatch(self, reqs: List[SolveRequest],
                        envelope=None, lane_d: Optional[int] = None,
                        ) -> Optional[PendingBatch]:
        """Pipelined dispatch front half: issue
        the device call for this batch WITHOUT waiting for its
        results (the work queues on a side stream of the card,
        engine/timing.launch_engine_call) so the scheduler can launch
        the next bin / decode the previous one while the device works.

        Returns a :class:`PendingBatch` to hand to
        :meth:`collect_dispatch`, or None when this batch must go
        through the synchronous :meth:`dispatch` instead — pipelining
        disabled, a DPOP bin (the exact engine owns its own batching),
        a test double stubbing the device call (``_run_batch`` /
        ``dispatch`` overridden: the stub IS the contract under test),
        a cold dispatch shape (the kernel build must be timed and
        attributed on the synchronous path), a pruned stack (its phase
        predicate is read on the host every cycle), or a launch
        failure (the synchronous path owns error isolation and
        bisection)."""
        if not self.pipeline:
            return None
        params = reqs[0].params
        if params.get("algo") == "dpop":
            return None
        if (type(self)._run_batch is not SolveService._run_batch
                or "_run_batch" in self.__dict__
                or type(self).dispatch is not SolveService.dispatch
                or "dispatch" in self.__dict__):
            return None
        graphs = [r.graph for r in reqs]
        t_dequeue = time.perf_counter()
        try:
            if lane_d is not None:
                pending = engine_batch.launch_lane_packed(
                    graphs,
                    max_cycles=params["max_cycles"],
                    damping=params["damping"],
                    damping_nodes=params["damping_nodes"],
                    stability=params["stability"],
                    d_env=lane_d,
                    ladder=binning.UNION_LADDER,
                    device=self.device,
                )
            else:
                pending = engine_batch.launch_stacked(
                    graphs,
                    max_cycles=params["max_cycles"],
                    damping=params["damping"],
                    damping_nodes=params["damping_nodes"],
                    stability=params["stability"],
                    pad_to_bins=self.bin_sizes,
                    prune=bool(params.get("prune", 0)),
                    envelope=envelope,
                    device=self.device,
                )
        except Exception as exc:  # noqa: BLE001 — sync path retries
            logger.debug("pipelined launch failed (%s); falling back "
                         "to the synchronous path", exc)
            return None
        if pending is None:
            return None
        for req in reqs:
            req.status = RUNNING
            req.t_dispatch = t_dequeue
            if tracer.active:
                tracer.complete(
                    "serve_queued", "serving",
                    t0=req.t_submit, t1=t_dequeue,
                    trace_id=req.trace_id, request=req.id)
            self._publish_lifecycle("dispatched", req)
        self._queue_depth.set(self._queue.qsize())
        self.pipelined_dispatches += 1
        return PendingBatch(reqs, pending, envelope, lane_d,
                            time.perf_counter())

    def collect_dispatch(self, pb: PendingBatch) -> None:
        """Pipelined dispatch back half: block on the launched device
        work, then run the SAME decode/terminal tail as the
        synchronous path.  Never raises: a collect failure re-runs
        the batch through the synchronous dispatch attempt (the
        results are deterministic, so re-execution is safe, and the
        synchronous path owns bisection/breaker semantics)."""
        t_collect0 = time.perf_counter()
        reqs = pb.reqs
        ctx = (tracer.context(
            trace_ids=[r.trace_id for r in reqs])
            if tracer.active else contextlib.nullcontext())
        with ctx:
            span = (tracer.span(
                "serve_dispatch", "serving",
                bin=binning.bin_label(reqs[0].bin),
                n_real=len(reqs),
                packing=("lane" if pb.lane_d is not None else
                         "envelope" if pb.envelope is not None else
                         "structure"),
                retry_depth=0, pipelined=True)
                if tracer.active else None)
            try:
                with (span if span is not None
                      else contextlib.nullcontext()):
                    if pb.pending.kind == "lane":
                        values, cycles, batch_result = \
                            engine_batch.collect_lane_packed(
                                pb.pending)
                    else:
                        values, cycles, batch_result = \
                            engine_batch.collect_stacked(pb.pending)
                    if span is not None:
                        span.args["batch_size"] = \
                            batch_result.metrics["batch_size"]
                        span.args["pad_fraction"] = \
                            batch_result.metrics["pad_fraction"]
            except Exception as exc:  # noqa: BLE001
                logger.warning(
                    "pipelined collect failed (%d requests): %s; "
                    "re-dispatching synchronously", len(reqs), exc)
                self._dispatch_attempt(reqs, retry_depth=0,
                                       envelope=pb.envelope,
                                       lane_d=pb.lane_d)
                return
            t_dev1 = time.perf_counter()
            # Overlap accounting: host wall between launch-done and
            # collect-start was spent on other dispatches' work while
            # this one's device work was in flight, clamped to the
            # dispatch's own execute wall.
            run_s = float(batch_result.metrics.get(
                "run_time_s", batch_result.time_s))
            overlap = min(max(t_collect0 - pb.t_launch_end, 0.0),
                          max(run_s, 0.0))
            efficiency.tracker.record_overlap(overlap, run_s)
            self._complete_batch(reqs, batch_result, values, cycles,
                                 pb.pending.t_launch, t_dev1)

    def _dispatch_attempt(self, reqs: List[SolveRequest],
                          retry_depth: int,
                          envelope=None,
                          lane_d: Optional[int] = None) -> None:
        if not tracer.active:
            return self._dispatch_attempt_inner(
                reqs, retry_depth, envelope=envelope, lane_d=lane_d)
        # Thread-bound context: every span/instant recorded under
        # this dispatch — serve_dispatch itself, the engine_segment
        # inside run_stacked, jit_compile — carries
        # the batch's trace_ids without the engine knowing about
        # requests.  `pydcop trace query --request ID` matches on it.
        with tracer.context(trace_ids=[r.trace_id for r in reqs]):
            return self._dispatch_attempt_inner(
                reqs, retry_depth, envelope=envelope, lane_d=lane_d)

    def _dispatch_attempt_inner(self, reqs: List[SolveRequest],
                                retry_depth: int,
                                envelope=None,
                                lane_d: Optional[int] = None) -> None:
        params = reqs[0].params
        span = (tracer.span(
            "serve_dispatch", "serving",
            bin=binning.bin_label(reqs[0].bin),
            n_real=len(reqs),
            packing=("lane" if lane_d is not None else
                     "envelope" if envelope is not None else
                     "structure"),
            retry_depth=retry_depth) if tracer.active else None)
        t_dev0 = time.perf_counter()
        try:
            with (span if span is not None
                  else contextlib.nullcontext()):
                if envelope is None and lane_d is None:
                    # Positional call kept for the exact path: test
                    # doubles and the overload smoke stub
                    # _run_batch(reqs, params).
                    values, cycles, batch_result = self._run_batch(
                        reqs, params)
                else:
                    values, cycles, batch_result = self._run_batch(
                        reqs, params, envelope=envelope,
                        lane_d=lane_d)
                if span is not None:
                    span.args["batch_size"] = \
                        batch_result.metrics["batch_size"]
                    span.args["pad_fraction"] = \
                        batch_result.metrics["pad_fraction"]
        except UtilTooLargeError as exc:
            # Width bust discovered only at dispatch (the submit-time
            # gate passed on CEC-shrunk estimates, the actual sweep
            # still blew the cap).  This is the PROBLEM's shape, not a
            # device fault: reject the whole bin with the structured
            # width status, feed nothing to the admission breaker, and
            # skip bisection — halving a bin cannot un-widen a tree.
            self._dispatch_total.inc(kind="rejected_width")
            for req in reqs:
                self._finish_rejected_width(req, str(exc))
            return
        except Exception as exc:  # noqa: BLE001 — fail/bisect the
            # batch, not the scheduler thread: the service must keep
            # serving.
            self._dispatch_total.inc(kind="failed")
            if len(reqs) == 1:
                logger.warning("serve dispatch failed (isolated "
                               "request %s): %s", reqs[0].id, exc)
                self.admission.record_dispatch(ok=False)
                if retry_depth > 0:
                    # Bisection just isolated the poison request: the
                    # black box should hold the whole bisection walk
                    # and the innocent bin-mates' recovery.
                    flight.trigger(
                        "poison_bin", request=reqs[0].id,
                        trace_id=reqs[0].trace_id,
                        retry_depth=retry_depth, error=str(exc))
                self._finish_error(reqs[0],
                                   f"dispatch failed: {exc}")
                return
            logger.warning(
                "serve dispatch failed (%d requests): bisecting to "
                "isolate the poison request: %s", len(reqs), exc)
            mid = len(reqs) // 2
            for half in (reqs[:mid], reqs[mid:]):
                self.dispatch_retries += 1
                self._retries.inc()
                self._dispatch_attempt(half, retry_depth + 1,
                                       envelope=envelope,
                                       lane_d=lane_d)
            return
        self._complete_batch(reqs, batch_result, values, cycles,
                             t_dev0, t_dev1=None)

    def _complete_batch(self, reqs: List[SolveRequest], batch_result,
                        values, cycles, t_dev0: float,
                        t_dev1: Optional[float] = None) -> None:
        """Decode + terminal tail of a SUCCESSFUL device dispatch,
        shared verbatim by the synchronous path
        (:meth:`_dispatch_attempt_inner`) and the pipelined one
        (:meth:`collect_dispatch`) so their accounting cannot drift:
        per-request decode with its own failure isolation, honest
        ledgers, journal/lifecycle terminals — plus the closed-loop
        feedback taps (pack-model fit samples, speculation hit
        accounting)."""
        self.admission.record_dispatch(ok=True)
        metrics = batch_result.metrics
        self.dispatches += 1
        kind = "batched" if len(reqs) > 1 else "solo"
        self._dispatch_total.inc(kind=kind)
        if len(reqs) > 1:
            self.batched_dispatches += 1
            self.batched_requests += len(reqs)
            self._batched_reqs.inc(len(reqs))
        packing = metrics.get("packing") or "structure"
        if packing in ("envelope", "lane"):
            self.envelope_dispatches += 1
            if packing == "lane":
                self.lane_dispatches += 1
            if len(reqs) > 1:
                self.envelope_packed_requests += len(reqs)
            self._envelope_total.inc(kind=packing)
            self._envelope_waste_g.set(
                metrics.get("envelope_waste") or 0.0)
        self._occupancy.set(
            metrics["n_real"] / metrics["batch_size"])
        pad_lanes = metrics["batch_size"] - metrics["n_real"]
        if pad_lanes:
            self._pad_waste.inc(pad_lanes)
        if t_dev1 is None:
            t_dev1 = time.perf_counter()
        self._feed_closed_loop(reqs, batch_result)
        converged_lanes = metrics.get("converged_lanes") or []
        for i, req in enumerate(reqs):
            # Per-request decode guard: one cost function that raises
            # on its own selected assignment must fail THAT request,
            # not the batch-mates (already solved) or the scheduler
            # thread (which serves everyone after them).
            try:
                assignment = req.meta.assignment_from_indices(
                    values[i])
                cost, violations = req.dcop.solution_cost(assignment)
            except Exception as exc:  # noqa: BLE001
                logger.warning("result decode failed for %s: %s",
                               req.id, exc)
                self._finish_error(req, f"result decode failed: {exc}")
                continue
            # Per-request finish clock AFTER the decode: this
            # request's latency honestly includes its own host
            # post-processing (and its wait behind batch-mates
            # decoded before it — the ledger's ``decode`` column).
            t_done = time.perf_counter()
            ledger = self._request_ledger(
                req, batch_result, t_dev0, t_dev1, t_done)
            req.result = {
                "id": req.id,
                "trace_id": req.trace_id,
                "status": FINISHED,
                "assignment": assignment,
                "cost": cost,
                "violations": violations,
                "cycles": int(cycles[i]),
                "converged": (bool(converged_lanes[i])
                              if i < len(converged_lanes) else None),
                "latency": {
                    "total_s": t_done - req.t_submit,
                    "dispatch_s": batch_result.time_s,
                    "queued_s": (t_done - req.t_submit
                                 - batch_result.time_s),
                },
                "ledger": ledger,
                "batch": {
                    "size": metrics["batch_size"],
                    "n_real": metrics["n_real"],
                    "pad_fraction": metrics["pad_fraction"],
                    "cold_start": metrics["cold_start"],
                    "packing": packing,
                    "envelope_waste": (
                        metrics["envelope_waste_lanes"][i]
                        if i < len(metrics.get(
                            "envelope_waste_lanes") or [])
                        else None),
                },
            }
            if metrics.get("optimal"):
                # Exact-inference dispatch: the served assignment is a
                # certified optimum, and the client can trust it as
                # one (the flag only ever rides a DPOP sweep's
                # result — iterative engines never set it).
                req.result["optimal"] = True
            req.status = FINISHED
            self.completed += 1
            self._req_total.inc(status="ok")
            efficiency.tracker.record_ledger(
                ledger,
                backend=(metrics.get("efficiency") or {}).get(
                    "backend"))
            # The exemplar makes the latency histogram navigable: the
            # bucket this observation lands in remembers this
            # trace_id, so a p99 spike in /metrics is one `pydcop
            # trace query` away from the spans that produced it.
            self._latency.observe(t_done - req.t_submit,
                                  exemplar=req.trace_id)
            self._journal_done(req)
            req.done.set()
            self._publish_lifecycle("finished", req)

    def _feed_closed_loop(self, reqs: List[SolveRequest],
                          batch_result) -> None:
        """The measured-dispatch feedback taps: a warm
        maxsum dispatch feeds one (cells, cycles, execute) sample to
        the online pack-model fit, and a cold dispatch whose program
        key was speculated counts as a speculation hit (its kernel
        libraries were built off the request path, so the cold call
        found them in the library cache).  Both are advisory: failures are
        swallowed, the dispatch result is already decided."""
        metrics = batch_result.metrics
        try:
            program_key = metrics.get("program_key")
            if (self._speculator is not None and program_key
                    and metrics.get("cold_start")):
                if self._speculator.record_hit(program_key):
                    self.speculative_hits += 1
            cells = metrics.get("cells_total")
            if cells and not metrics.get("cold_start"):
                from pydcop_tpu_torch.engine import autotune

                if autotune.pack_fit_enabled():
                    run_s = float(metrics.get(
                        "run_time_s", batch_result.time_s))
                    autotune.record_pack_sample(
                        efficiency.backend_name(), int(cells),
                        int(reqs[0].params["max_cycles"]), run_s)
        except Exception:  # noqa: BLE001 — feedback, not serving
            pass

    def _request_ledger(self, req: SolveRequest, batch_result,
                        t_dev0: float, t_dev1: float,
                        t_done: float) -> Dict[str, Any]:
        """One request's time ledger from its contiguous breakpoints:
        submit (admission+compile+journal on the submitting thread),
        queue (bounded queue + coalescing window), plan (flush
        planning), prep (scheduler bookkeeping + host-side batch
        assembly), compile/execute (the device wall, split by the
        overlapping-fields convention), decode (device end → this
        request finished, its own host post-processing included).
        The intervals tile [t_submit, t_done], so the components sum
        to the measured total — the invariant the battery asserts.
        Bisection-retry walls land in ``prep`` (everything between
        dispatch pickup and the SUCCESSFUL device call)."""
        # The inner device wall when the dispatch reported one (the
        # outer time_s additionally holds the profiler's cold-capture
        # and batch-assembly host work — that belongs in ``prep``).
        run_s = float(batch_result.metrics.get(
            "run_time_s", batch_result.time_s))
        compile_s = float(batch_result.compile_time_s)
        split = efficiency.split_device_time(run_s, compile_s)
        t_enq = req.t_enqueue or req.t_submit
        t_disp = req.t_dispatch or t_dev0
        plan_s = min(max(req.plan_s, 0.0), max(t_disp - t_enq, 0.0))
        prep = (max(t_dev0 - t_disp, 0.0)
                + max((t_dev1 - t_dev0) - run_s, 0.0))
        return efficiency.make_ledger(
            t_done - req.t_submit,
            submit=t_enq - req.t_submit,
            queue=max(t_disp - t_enq - plan_s, 0.0),
            plan=plan_s,
            prep=prep,
            compile=split["compile"],
            execute=split["execute"],
            decode=max(t_done - t_dev1, 0.0),
        )

    def run_session_work(self, work) -> None:
        """Scheduler hook: one stateful-session work item (event
        apply / engine segment / close — serving/sessions.py).
        Guarded so a session failure can never kill the scheduler
        thread; session-level error handling lives in the manager."""
        try:
            self.sessions.run_work(work)
        except Exception:  # noqa: BLE001 — last line of defense
            logger.exception("session work crashed")
            done = getattr(work, "done", None)
            if done is not None and not done.is_set():
                work.error = "internal session work error"
                done.set()

    def _check_width(self, dcop: DCOP):
        """Submit-time width gate for ``algo="dpop"``: build the
        pseudo-tree, verdict via engine/dpop.dpop_feasibility (CEC
        shrinkage included — pruning is how the ceiling rises), raise
        :class:`WidthRejected` when even the shrunk hypercubes bust
        ``ops/dpop.MAX_NODE_ELEMENTS``.  Returns the pseudo-tree so
        the dispatch never rebuilds it."""
        from pydcop_tpu_torch.computations_graph import pseudotree as pt
        from pydcop_tpu_torch.engine.dpop import dpop_feasibility

        tree = pt.build_computation_graph(dcop)
        verdict = dpop_feasibility(tree, mode=dcop.objective, cec=True)
        if not verdict["feasible"]:
            effective = (verdict["cec_max_elements"]
                         or verdict["max_elements"])
            raise WidthRejected(
                f"problem too wide for exact inference: largest UTIL "
                f"hypercube has {effective} elements (cap "
                f"{verdict['max_elements_cap']}, induced width "
                f"{verdict['induced_width']}); use the iterative "
                f"solver (algo=maxsum) for this structure",
                max_elements=effective,
                cap=verdict["max_elements_cap"])
        return tree

    def _run_batch_dpop(self, reqs, params):
        """Exact-inference dispatch: one DpopEngine solve per request
        (no cross-problem stacking — the level-batched signature
        buckets batch WITHIN each problem, and same-bin requests share
        every compiled kernel through the signature cache plus the
        service-wide warm set).  Returns the same ``(values, cycles,
        batch_result)`` triple as the stacked path, so the generic
        decode/ledger/lifecycle code downstream is one code path."""
        import numpy as np

        from pydcop_tpu_torch.computations_graph import pseudotree as pt
        from pydcop_tpu_torch.engine.dpop import DpopEngine
        from pydcop_tpu_torch.engine.runner import DeviceRunResult

        t0 = time.perf_counter()
        values, cycles, kernel_calls = [], [], 0
        compile_s = 0.0
        for req in reqs:
            tree = req.exact_tree
            if tree is None:
                tree = pt.build_computation_graph(req.dcop)
            engine = DpopEngine(
                tree, mode=req.dcop.objective, cec=True,
                warm=self._dpop_warm, device=self.device)
            res = engine.run()
            index_of = {
                name: {v: i for i, v in enumerate(dom)}
                for name, dom in zip(req.meta.var_names,
                                     req.meta.domains)
            }
            values.append(np.asarray(
                [index_of[n][res.assignment[n]]
                 for n in req.meta.var_names], dtype=np.int64))
            cycles.append(res.cycles)
            kernel_calls += res.metrics.get("kernel_calls", 0)
            compile_s += res.compile_time_s
        elapsed = time.perf_counter() - t0
        with self._lock:
            self.dpop_dispatches += 1
        batch_result = DeviceRunResult(
            assignment={},
            cycles=max(cycles) if cycles else 0,
            converged=True,
            time_s=elapsed,
            compile_time_s=min(compile_s, elapsed),
            metrics={
                "batch_size": len(reqs),
                "n_real": len(reqs),
                "pad_fraction": 0.0,
                "cold_start": compile_s > 0.0,
                "run_time_s": elapsed,
                "converged_lanes": [True] * len(reqs),
                "packing": "dpop",
                "optimal": True,
                "kernel_calls": kernel_calls,
            },
        )
        if efficiency.tracker.enabled:
            record = efficiency.tracker.record_dispatch(
                key=f"dpop_batch_{len(reqs)}",
                structure=efficiency.structure_label(reqs[0].graph),
                backend=efficiency.backend_name(),
                time_s=elapsed, compile_s=batch_result.compile_time_s,
                cycles=max(cycles) if cycles else 0,
                n_real=len(reqs), batch_size=len(reqs),
                pad_fraction=0.0, envelope_waste=0.0,
                packing="dpop", cost_entry=None,
            )
            if record is not None:
                batch_result.metrics["efficiency"] = record
        return np.asarray(values), np.asarray(cycles), batch_result

    def _run_batch(self, reqs, params, envelope=None,
                   lane_d: Optional[int] = None):
        """The device call, isolated for tests to stub failures.
        ``envelope`` routes a heterogeneous group through mask-padded
        envelope stacking, ``lane_d`` through the disjoint-union lane
        pack; both default to the exact same-structure stack."""
        if params.get("algo") == "dpop":
            return self._run_batch_dpop(reqs, params)
        graphs = [r.graph for r in reqs]
        if lane_d is not None:
            return engine_batch.run_lane_packed(
                graphs,
                max_cycles=params["max_cycles"],
                damping=params["damping"],
                damping_nodes=params["damping_nodes"],
                stability=params["stability"],
                d_env=lane_d,
                # Coarse union rounding: a handful of dispatch
                # shapes must cover every group composition (see
                # binning.UNION_LADDER).
                ladder=binning.UNION_LADDER,
                device=self.device,
            )
        return engine_batch.run_stacked(
            graphs,
            max_cycles=params["max_cycles"],
            damping=params["damping"],
            damping_nodes=params["damping_nodes"],
            stability=params["stability"],
            pad_to_bins=self.bin_sizes,
            prune=bool(params.get("prune", 0)),
            envelope=envelope,
            device=self.device,
        )

    def _finish_rejected_width(self, req: SolveRequest, message: str):
        """Terminal for a dispatch-time width bust: an ERROR result
        whose ``status_detail`` is ``rejected_width`` (the front end
        maps it to a 400 — the client sent an un-servable problem
        shape, not a flaky one worth retrying)."""
        req.result = {
            "id": req.id, "trace_id": req.trace_id,
            "status": ERROR,
            "status_detail": "rejected_width",
            "error": f"problem too wide for exact inference: {message}",
            "latency": {
                "total_s": time.perf_counter() - req.t_submit,
            },
            "ledger": self._terminal_ledger(req),
        }
        req.status = ERROR
        self.failed += 1
        self._req_total.inc(status="rejected_width")
        self._journal_done(req)
        req.done.set()
        self._publish_lifecycle("error", req)

    def _finish_error(self, req: SolveRequest, message: str):
        req.result = {
            "id": req.id, "trace_id": req.trace_id,
            "status": ERROR, "error": message,
            "latency": {
                "total_s": time.perf_counter() - req.t_submit,
            },
            "ledger": self._terminal_ledger(req),
        }
        req.status = ERROR
        self.failed += 1
        self._req_total.inc(status="error")
        self._journal_done(req)
        req.done.set()
        self._publish_lifecycle("error", req)

    def _finish_expired(self, req: SolveRequest):
        """Terminal EXPIRED: the deadline passed before dispatch.  A
        504 on the wire, ``rejected_deadline`` in the ledger, and a
        journaled terminal — an expired request must not resurrect on
        a --recover restart."""
        req.result = {
            "id": req.id, "trace_id": req.trace_id,
            "status": EXPIRED,
            "error": (f"deadline of {req.deadline_s}s exceeded "
                      "before dispatch"),
            "latency": {
                "total_s": time.perf_counter() - req.t_submit,
            },
            "ledger": self._terminal_ledger(req),
        }
        req.status = EXPIRED
        self.expired += 1
        self._req_total.inc(status="rejected_deadline")
        self._journal_done(req)
        req.done.set()
        self._publish_lifecycle("expired", req)

    def _terminal_ledger(self, req: SolveRequest) -> Dict[str, Any]:
        """Ledger for a request that terminated without a decoded
        result (error/expired), still summing to the measured total.
        Time after dispatch pickup — failed device attempts, decode
        failures — is ``prep``, not queue: an operator chasing a
        queue-wait spike must not be sent device-side seconds."""
        now = time.perf_counter()
        t_enq = req.t_enqueue or req.t_submit
        t_disp = req.t_dispatch or now
        return efficiency.make_ledger(
            now - req.t_submit,
            submit=t_enq - req.t_submit,
            queue=max(min(t_disp, now) - t_enq, 0.0),
            prep=max(now - t_disp, 0.0) if req.t_dispatch else 0.0,
        )

    def _publish_lifecycle(self, phase: str, req: SolveRequest):
        """One request-lifecycle event onto the SSE ``/events``
        stream (accepted → dispatched → finished / error / expired,
        each carrying the trace_id) and, when tracing/flight is on, a
        matching trace instant — a watching client follows a request
        through the service in real time with the same id it would
        hand to ``pydcop trace query``."""
        if tracer.active:
            tracer.instant(f"serve_{phase}", "serving",
                           request=req.id, trace_id=req.trace_id)
        CycleSnapshotter.publish({
            "ts": time.time(),
            "event": "request",
            "phase": phase,
            "id": req.id,
            "trace_id": req.trace_id,
            "status": req.status,
        })

    def expire_if_overdue(self, req: SolveRequest) -> bool:
        """Scheduler hook: drop already-expired work BEFORE binning.
        True means the request was expired and must not be
        dispatched."""
        if req.deadline_s is None:
            return False
        if time.perf_counter() - req.t_submit <= req.deadline_s:
            return False
        self._finish_expired(req)
        return True

    def _journal_done(self, req: SolveRequest):
        """Journal a terminal outcome WITH the result payload: the
        outcome is durable, not just the fact of completion, so a
        client polling across a crash gets its 200 from the
        replacement process (journal.completed_results).  Never
        raises into the scheduler thread: a failed completion append
        costs at most one duplicate solve after a crash, never the
        service."""
        if self._journal is None:
            return
        try:
            try:
                rec = journal_mod.completed_record(
                    req.id, req.status, result=req.result)
                journal_mod.encode_record(rec)
            except (TypeError, ValueError):
                # A result that will not serialize (should not
                # happen — it is served as JSON) degrades to the
                # payload-less tombstone rather than losing the
                # terminal record entirely.
                rec = journal_mod.completed_record(req.id, req.status)
            self._journal.append(rec)
            self._journal_records.inc(kind="completed")
        except Exception as exc:  # noqa: BLE001
            logger.warning("journal completion append failed for "
                           "%s: %s", req.id, exc)

    # -- introspection ------------------------------------------------- #

    def journal_summary(self) -> Dict[str, Any]:
        """Journal backlog, the operator's replay-debt gauge:
        ``pending_replayable`` (accepted records with no terminal —
        exactly what a ``--recover`` restart would replay right now)
        and the journal's on-disk byte size.  Surfaced in /healthz
        while a journaled service runs, and folded into postmortem
        bundles (observability/flight.py's journal provider)."""
        with self._lock:
            pending = sum(1 for r in self._requests.values()
                          if not r.done.is_set())
        size = 0
        if self._journal is not None:
            try:
                size = os.path.getsize(self._journal.path)
            except OSError:
                size = 0
        return {
            "dir": self.journal_dir,
            "active": self._journal is not None,
            "pending_replayable": pending,
            # Open sessions are replay debt too: a --recover restart
            # rebuilds each one from its open/ckpt/event records.
            "open_sessions": self.sessions.active_count(),
            "journal_bytes": size,
        }

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            tracked = len(self._requests)
            recent_decisions = list(self.envelope_decisions)[-8:]
        eff = efficiency.tracker.summary()
        return {
            "queue_depth": self._queue.qsize(),
            "high_water": self.admission.policy.high_water,
            "breaker_state": self.admission.breaker_state,
            "dispatches": self.dispatches,
            "batched_dispatches": self.batched_dispatches,
            "batched_requests": self.batched_requests,
            "envelope_packing": self.envelope_packing,
            "envelope_dispatches": self.envelope_dispatches,
            "lane_dispatches": self.lane_dispatches,
            "envelope_packed_requests": self.envelope_packed_requests,
            "envelope_decisions": recent_decisions,
            "completed": self.completed,
            "failed": self.failed,
            "expired": self.expired,
            "replayed": self.replayed,
            "dispatch_retries": self.dispatch_retries,
            "dpop_dispatches": self.dpop_dispatches,
            "portfolio_resolved": self.portfolio_resolved,
            "deduped": self.deduped,
            # The closed-loop hot path's /stats faces:
            # pipelined launch/collect counters with the overlap
            # fraction, and the speculative compiler's ledger —
            # ``speculative_compiles_total`` with at least one hit is
            # the smoke-asserted signal that compile stalls left the
            # request path.
            "pipeline": {
                "enabled": self.pipeline,
                "pipelined_dispatches": self.pipelined_dispatches,
                "overlap_fraction":
                    eff["pipeline_overlap_fraction"],
            },
            "speculation": dict(
                {"enabled": self.speculate,
                 "hits": self.speculative_hits},
                **(self._speculator.stats()
                   if self._speculator is not None else
                   {"speculative_compiles_total": 0})),
            "journal": (self.journal_dir
                        if self._journal is not None else None),
            "sessions": self.sessions.stats(),
            "tracked_requests": tracked,
            "max_batch": self.max_batch,
            "batch_window_s": self.batch_window_s,
            "bin_sizes": list(self.bin_sizes),
            # The /stats face of the histogram exemplars: the p50/p99
            # buckets' last-seen trace_ids, each resolvable by
            # `pydcop trace query --request <trace_id>`.
            "latency_exemplars": {
                q: self._latency.quantile_exemplar(v)
                for q, v in (("p50", 0.50), ("p99", 0.99))
            },
            # The efficiency plane's compact face: resolved
            # backend, attainment/useful-work rollup and the ledger's
            # where-the-time-went component sums.  The full document
            # (per-structure top-N, waste taxonomy) lives on
            # ``GET /profile``.
            "efficiency": eff,
        }

    def health_summary(self) -> Dict[str, Any]:
        """The /healthz contribution: breaker open → failing (503);
        journaled services also report their replay debt
        (``journal.pending_replayable`` / ``journal_bytes``) so an
        operator sees what a restart would replay BEFORE restarting."""
        stats = self.stats()
        status = ("failing" if stats["breaker_state"] == "open"
                  else "ok")
        summary = {"status": status, "serving": stats}
        if self._journal is not None:
            summary["journal"] = self.journal_summary()
        return summary


class QueueFullRace(AdmissionRejected):
    """put_nowait lost the depth race: treated exactly like a
    high-water rejection (429)."""

    http_status = 429
