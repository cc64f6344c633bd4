"""The batching scheduler: drain, bin, dispatch.

Port of ``pydcop_tpu/serving/scheduler.py``.  One daemon thread owns
every device dispatch (torch work on the card stays on a single
thread; concurrency lives in the batch axis, not in racing
dispatches).  The loop:

1. Block on the service queue for the next request.
2. Linger ``batch_window_s`` draining more requests into per-bin
   lists — this is the coalescing window that turns a burst of N
   same-structure requests into one stacked dispatch.  The window is
   latency the *first* request pays to buy batch-mates; under
   sustained load the queue is never empty and the window barely
   waits.
3. Dispatch each bin (largest first — most amortization per compile)
   in ``max_batch``-sized chunks through
   :meth:`~pydcop_tpu_torch.serving.service.SolveService.dispatch`.

Different bins collected in one window still dispatch separately —
the two-structures-never-share-a-dispatch invariant lives in the bin
key (serving/binning.py), not in scheduler timing.
"""

import logging
import queue
import threading
import time
from typing import Dict, List

from pydcop_tpu_torch.serving.sessions import SessionWork

logger = logging.getLogger("pydcop.serving.scheduler")

# Queue sentinel: wakes the loop for shutdown.
_STOP = object()


class BinScheduler:
    """Daemon scheduler thread for one SolveService."""

    def __init__(self, service, batch_window_s: float = 0.02,
                 max_batch: int = 16):
        self.service = service
        self.batch_window_s = batch_window_s
        self.max_batch = max(int(max_batch), 1)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="pydcop-serve-scheduler",
            daemon=True)

    def start(self):
        self._thread.start()

    def thread_ident(self):
        """The scheduler thread's ident — the one thread allowed to
        own a device dispatch (the speculation battery asserts
        background compiles never run on it)."""
        return self._thread.ident

    def shutdown(self, timeout: float = 30.0):
        self._stop.set()
        # Unblock a waiting get() immediately.
        try:
            self.service._queue.put_nowait(_STOP)
        except queue.Full:
            pass
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            logger.warning("scheduler thread did not stop in %.1fs",
                           timeout)

    # -- loop ---------------------------------------------------------- #

    def _run(self):
        q = self.service._queue
        while not self._stop.is_set():
            try:
                first = q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is _STOP:
                continue
            # Session work (stateful sessions, serving/sessions.py)
            # runs between request flushes on this same thread — one
            # thread owns every device dispatch, batched or session.
            if isinstance(first, SessionWork):
                self.service.run_session_work(first)
                continue
            # Deadline enforcement happens HERE, before binning: work
            # that expired while queued is dropped (terminal EXPIRED,
            # 504) instead of burning a device dispatch — and never
            # contaminates a batch whose other members are still
            # fresh.
            if self._expire(first):
                continue
            bins: Dict = {}
            bins.setdefault(first.bin, []).append(first)
            session_work: List = []
            self._collect(q, bins, session_work)
            self._dispatch_bins(bins)
            # Session work drained during the window runs AFTER the
            # flush (events apply between segments/dispatches by
            # design) but in its original queue order.
            for work in session_work:
                self.service.run_session_work(work)
        # Shutdown: the service fails anything still queued.

    def _expire(self, req) -> bool:
        """Drop overdue work before binning; guarded so a broken
        deadline check can never kill the scheduler thread."""
        try:
            return self.service.expire_if_overdue(req)
        except Exception:  # noqa: BLE001 — last line of defense
            logger.exception("deadline check crashed; dispatching "
                             "the request anyway")
            return False

    def _collect(self, q, bins: Dict,
                 session_work: List = None) -> None:
        """Linger up to the batch window, draining arrivals into
        per-bin lists.  Stops early once the largest bin can fill a
        whole dispatch — waiting longer would only add latency to a
        batch that is already full.  Session work drained mid-window
        is stashed (in order) for the caller to run after the flush —
        it must not block collection, and its engine mutations belong
        between dispatches."""
        deadline = time.monotonic() + self.batch_window_s
        while not self._stop.is_set():
            if max(len(v) for v in bins.values()) >= self.max_batch:
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            try:
                req = q.get(timeout=remaining)
            except queue.Empty:
                return
            if req is _STOP:
                return
            if isinstance(req, SessionWork):
                if session_work is not None:
                    session_work.append(req)
                else:
                    self.service.run_session_work(req)
                continue
            if self._expire(req):
                continue
            bins.setdefault(req.bin, []).append(req)

    def _dispatch_bins(self, bins: Dict) -> None:
        # The flush plan (serving/service.plan_flush): multi-request
        # bins keep the exact path; leftover singleton bins are
        # envelope-grouped and packed when the per-flush cost model
        # says one padded dispatch beats N solo ones.  Planner
        # crashes degrade INSIDE plan_flush (once-per-flush log +
        # one-plan-per-bin fallback) — this guard is only the last
        # line of defense against the wrapper itself breaking.
        try:
            plans = self.service.plan_flush(bins)
        except Exception:  # noqa: BLE001 — last line of defense
            logger.exception("flush planning crashed; dispatching "
                             "per bin")
            from pydcop_tpu_torch.serving.service import DispatchPlan

            plans = [DispatchPlan(list(bins[k]))
                     for k in sorted(bins,
                                     key=lambda k: -len(bins[k]))]
        chunks: List = []
        for plan in plans:
            reqs: List = plan.reqs
            for i in range(0, len(reqs), self.max_batch):
                chunks.append((reqs[i:i + self.max_batch],
                               plan.envelope, plan.lane_d))
        # Pipelined flush: launch chunk k+1's
        # device call while chunk k's arrays are still in flight, and
        # drain completed dispatches in PICKUP order (a request's
        # terminal callbacks fire in the order the scheduler picked
        # its chunk up — the ordering tests rely on).  At most two
        # dispatches are in flight: deeper pipelines buy nothing
        # (one device) and hold more results hostage to a crash.
        launch = getattr(self.service, "launch_dispatch", None)
        collect = getattr(self.service, "collect_dispatch", None)
        pipelined = launch is not None and collect is not None
        pending: List = []
        for chunk, envelope, lane_d in chunks:
            pb = None
            if pipelined:
                try:
                    pb = launch(chunk, envelope=envelope,
                                lane_d=lane_d)
                except Exception:  # noqa: BLE001
                    logger.exception("pipelined launch crashed; "
                                     "falling back to synchronous "
                                     "dispatch")
                    pb = None
            if pb is not None:
                pending.append(pb)
                while len(pending) > 1:
                    self._collect_one(pending.pop(0), collect)
                continue
            # Synchronous chunk (pipelining off, cold program, DPOP,
            # or a stubbed device call): drain EVERY in-flight
            # dispatch first so terminal ordering stays pickup order.
            while pending:
                self._collect_one(pending.pop(0), collect)
            # Last line of defense: dispatch() fails batches
            # cleanly on engine errors, but NOTHING may kill this
            # thread — a dead scheduler turns the service into a
            # black hole that accepts work it will never do.
            try:
                if envelope is None and lane_d is None:
                    # Positional call on the exact path: test
                    # doubles stub dispatch(reqs).
                    self.service.dispatch(chunk)
                else:
                    self.service.dispatch(chunk,
                                          envelope=envelope,
                                          lane_d=lane_d)
            except Exception as exc:  # noqa: BLE001
                logger.exception("dispatch crashed")
                for req in chunk:
                    if not req.done.is_set():
                        self.service._finish_error(
                            req, f"internal dispatch error: {exc}")
        while pending:
            self._collect_one(pending.pop(0), collect)

    def _collect_one(self, pb, collect) -> None:
        """Drain one in-flight dispatch; collect_dispatch handles its
        own failures (synchronous re-run), so anything escaping here
        is a harness bug — fail the batch, never the thread."""
        try:
            collect(pb)
        except Exception as exc:  # noqa: BLE001
            logger.exception("pipelined collect crashed")
            for req in pb.reqs:
                if not req.done.is_set():
                    self.service._finish_error(
                        req, f"internal dispatch error: {exc}")
