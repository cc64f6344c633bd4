"""Fleet trace plane: wire-propagated trace context +
lossy span shipping + the router-side merged-trace collector.

The reference pyDCOP streams every agent's cycle/metric records to a
collector (``pydcop solve --collect_on``); our fleet had the same
blind spot at the process boundary — spans stopped at each replica
and ``pydcop trace merge`` was an offline manual step.  This module
closes the loop in three pieces:

- :class:`TraceContext` / :data:`HEADER`: the one wire field
  (``X-Pydcop-Trace: <trace_id>[;parent=<span_id>]``) the router
  stamps onto every forwarded submit, session event batch, epoch
  fence, migration call and retry attempt.  Replicas adopt the
  inbound ``trace_id`` (``service.submit(trace_id=...)``,
  ``sessions.open/apply_events(trace_id=...)``) so their existing
  ``serve_*``/``session_*``/engine-segment spans carry the router's
  id — cross-process causality without cross-process span parents
  (the ``query_request`` lane stitcher builds the tree from
  time containment per lane).
- :class:`SpanShipper`: a worker-side tap on the default flight
  recorder that copies every completed span/instant into a BOUNDED
  queue and batch-POSTs it to the router (``POST /fleet/spans``)
  from a daemon thread.  Lossy by design: a full queue or a dead
  collector increments ``dropped_spans`` and never blocks or slows
  the solve path — telemetry must not backpressure solves.
- :class:`FleetCollector`: the router-side store — one bounded lane
  per source (each replica plus the router itself), rebased onto the
  unix clock with the anchor machinery and id-namespaced per
  lane, scrapeable live at ``GET /fleet/trace`` and queryable per
  request at ``GET /fleet/forensics/<id>``.

``PYDCOP_FLEET_TRACE=0`` turns the whole plane off (read per call so
the perf-smoke pairwise gate can toggle it at runtime); the spawned
workers inherit the knob through the router's environment.

A copy of ``pydcop_tpu/observability/fleettrace.py`` (pure Python):
the same header, span records and collector document.
"""

import json
import logging
import os
import threading
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("pydcop.observability.fleettrace")

# The one wire field.  A header on forwarded HTTP requests; the same
# encoded string rides as a JSON field where a body is more natural
# (migration bundles already carry the session trace_id).
HEADER = "X-Pydcop-Trace"
ENV_KNOB = "PYDCOP_FLEET_TRACE"

# Shipper bounds: the queue cap is the non-negotiable backpressure
# contract (record() is O(1) and never blocks), the batch cap keeps a
# single POST body small, and the interval paces the daemon thread.
MAX_QUEUE = 4096
BATCH_MAX = 512
FLUSH_INTERVAL_S = 0.25
SHIP_TIMEOUT_S = 5.0

# Collector bound, per source lane: old events fall off the head.
LANE_EVENTS = 20000

# Id namespacing stride across sources in the merged trace — same
# scheme as trace.merge_traces, far above any real per-process span
# count.
_ID_STRIDE = 10 ** 9


def enabled() -> bool:
    """The fleet-trace master switch, read per call: default ON;
    ``PYDCOP_FLEET_TRACE=0`` (or false/off/no) disables minting,
    header stamping and shipping without a restart."""
    return os.environ.get(ENV_KNOB, "1").strip().lower() not in (
        "0", "false", "off", "no")


class TraceContext:
    """One request's wire context: the fleet-unique ``trace_id``
    every span adopts, plus (annotation only — nesting is built from
    time containment, not cross-process parents) the router span id
    it was minted under."""

    __slots__ = ("trace_id", "parent")

    def __init__(self, trace_id: str, parent: Optional[str] = None):
        self.trace_id = trace_id
        self.parent = parent

    def encode(self) -> str:
        if self.parent:
            return f"{self.trace_id};parent={self.parent}"
        return self.trace_id

    @staticmethod
    def decode(value: Optional[str]) -> Optional["TraceContext"]:
        """Tolerant decode: a malformed header yields None (the
        replica simply mints its own ids, exactly the pre-fleet
        behavior) — never an error on the request path."""
        if not value or not isinstance(value, str):
            return None
        parts = value.strip().split(";")
        trace_id = parts[0].strip()
        if not trace_id or len(trace_id) > 128:
            return None
        parent = None
        for part in parts[1:]:
            key, _, val = part.partition("=")
            if key.strip() == "parent" and val.strip():
                parent = val.strip()[:128]
        return TraceContext(trace_id, parent)


def mint() -> TraceContext:
    """A fresh admission-time context (router-side)."""
    return TraceContext(uuid.uuid4().hex[:16])


def decode_headers(headers) -> Optional[TraceContext]:
    """Pull the context off an inbound request's header map
    (``email.message.Message`` duck type — ``.get`` suffices)."""
    try:
        return TraceContext.decode(headers.get(HEADER))
    except Exception:  # noqa: BLE001 — telemetry never 500s a solve
        return None


def _copy_event(event: Dict[str, Any]) -> Dict[str, Any]:
    """Shallow-copy an event plus its args dict: recorded events are
    LIVE dicts (timed jit calls mutate ``args`` after the record), so
    anything leaving the recording thread must snapshot them — same
    contract as flight.FlightRecorder."""
    out = dict(event)
    args = out.get("args")
    if isinstance(args, dict):
        out["args"] = dict(args)
    return out


class _FlightTap:
    """Wraps whatever recorder currently sits on ``tracer.flight``:
    events keep flowing to it unchanged, and a copy goes to the
    sink.  Every other attribute (trigger/bundle/snapshot) delegates
    to the inner recorder so the postmortem plumbing keeps working
    with the tap installed."""

    def __init__(self, inner, sink: Callable[[Dict[str, Any]], None]):
        self.inner = inner
        self._sink = sink

    def record(self, event: Dict[str, Any]) -> None:
        if self.inner is not None:
            self.inner.record(event)
        try:
            self._sink(event)
        except Exception:  # noqa: BLE001 — never break the solve path
            pass

    def __getattr__(self, name):
        if self.inner is None:
            raise AttributeError(name)
        return getattr(self.inner, name)


def _install_tap(sink) -> _FlightTap:
    from pydcop_tpu_torch.observability.trace import tracer

    tap = _FlightTap(tracer.flight, sink)
    tracer.set_flight(tap)
    return tap


def _remove_tap(tap: Optional[_FlightTap]) -> None:
    from pydcop_tpu_torch.observability.trace import tracer

    if tap is None:
        return
    if tracer.flight is tap:
        tracer.set_flight(tap.inner)
    # Someone re-installed a recorder over the tap meanwhile: leave
    # their recorder alone — the tap just stops receiving events.


class SpanShipper:
    """Worker-side completed-span shipper.

    ``record()`` (called from the flight tap on whatever thread just
    closed a span) is a bounded O(1) append — when the queue is full
    the event is counted in ``dropped_spans`` and forgotten.  A
    daemon thread drains batches to the collector URL over the
    netfault seam; a failed ship re-counts the batch as dropped
    (lossy, honest, never retried — telemetry is not a durability
    domain)."""

    def __init__(self, source: str = "worker",
                 max_queue: int = MAX_QUEUE,
                 batch_max: int = BATCH_MAX,
                 flush_interval_s: float = FLUSH_INTERVAL_S):
        self.source = source
        self.max_queue = max_queue
        self.batch_max = batch_max
        self.flush_interval_s = flush_interval_s
        self.url: Optional[str] = None
        self._queue: deque = deque()
        self._dropped = 0
        self.shipped = 0
        self.batches = 0
        self._tap: Optional[_FlightTap] = None
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._wake = threading.Event()

    # -- hot path ------------------------------------------------------- #

    def record(self, event: Dict[str, Any]) -> None:
        # No lock: deque.append is atomic, and the bound check racing
        # a concurrent pop can only UNDER-fill, never block.  The
        # drop counter may undercount by a hair under contention;
        # honesty requires it to be nonzero whenever drops happened,
        # which a benign lost increment cannot violate for the
        # sustained overload that causes drops.
        if len(self._queue) >= self.max_queue:
            self._dropped += 1
            return
        self._queue.append(_copy_event(event))

    @property
    def dropped_spans(self) -> int:
        return self._dropped

    def stats(self) -> Dict[str, Any]:
        return {
            "source": self.source,
            "url": self.url,
            "queued": len(self._queue),
            "shipped": self.shipped,
            "batches": self.batches,
            "dropped_spans": self._dropped,
        }

    # -- lifecycle ------------------------------------------------------ #

    def start(self) -> "SpanShipper":
        if self._tap is None:
            self._tap = _install_tap(self.record)
        if self._thread is None:
            self._stopping.clear()
            self._thread = threading.Thread(
                target=self._flush_loop,
                name="pydcop-span-shipper", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        _remove_tap(self._tap)
        self._tap = None
        self._stopping.set()
        self._wake.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=2.0)

    def set_target(self, url: Optional[str], source: str) -> None:
        self.url = url
        self.source = source
        self._wake.set()

    def _flush_loop(self) -> None:
        while not self._stopping.is_set():
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            try:
                self.flush()
            except Exception:  # noqa: BLE001 — shipper never dies
                logger.debug("span flush failed", exc_info=True)

    def flush(self) -> int:
        """Drain up to one batch to the collector; returns how many
        events shipped (0 when idle, unconfigured, or the ship
        failed — failed batches are dropped, counted, not retried)."""
        url = self.url
        batch: List[Dict[str, Any]] = []
        while self._queue and len(batch) < self.batch_max:
            try:
                batch.append(self._queue.popleft())
            except IndexError:
                break
        if not batch:
            return 0
        if not url:
            self._dropped += len(batch)
            return 0
        from pydcop_tpu_torch.observability.trace import trace_header
        from pydcop_tpu_torch.serving import netfault

        doc = {
            "source": self.source,
            "header": trace_header(),
            "dropped_spans": self._dropped,
            "events": batch,
        }
        try:
            host, port, path = _split_url(url)
            status, _ctype, _body = netfault.exchange(
                self.source, "router", host, port, "POST", path,
                body=json.dumps(doc, default=str).encode(),
                timeout=SHIP_TIMEOUT_S)
        except OSError:
            self._dropped += len(batch)
            return 0
        if status != 200:
            self._dropped += len(batch)
            return 0
        self.shipped += len(batch)
        self.batches += 1
        return len(batch)


def _split_url(url: str):
    """``http://host:port[/base]`` -> (host, port, ship path)."""
    rest = url.split("://", 1)[-1]
    hostport, _, base = rest.partition("/")
    host, _, port = hostport.partition(":")
    path = ("/" + base.rstrip("/") if base else "") + "/fleet/spans"
    return host, int(port or 80), path


# Process-wide shipper: the worker's /admin/trace_collector endpoint
# (the router pushes its collector URL there at fleet start, after
# restarts, and on joins) configures exactly one of these.
_shipper: Optional[SpanShipper] = None
_shipper_lock = threading.Lock()


def configure_shipper(url: Optional[str], source: str = "worker",
                      enable: bool = True) -> Dict[str, Any]:
    """(Re)configure the process-wide span shipper: ``enable=False``
    (or no url) detaches the tap and stops shipping; otherwise the
    shipper is created on first use and retargeted in place.
    Idempotent; returns the resulting state."""
    global _shipper
    with _shipper_lock:
        if not enable or not url or not enabled():
            if _shipper is not None:
                _shipper.stop()
                stats = _shipper.stats()
                _shipper = None
                return {"enabled": False, **stats}
            return {"enabled": False}
        if _shipper is None:
            _shipper = SpanShipper(source)
            _shipper.start()
        _shipper.set_target(url, source)
        return {"enabled": True, **_shipper.stats()}


def shipper() -> Optional[SpanShipper]:
    return _shipper


class FleetCollector:
    """Router-side merged-trace store: one bounded event lane per
    source (each replica that ships batches, plus the router process
    itself via a flight tap), each with the shipping process's clock
    anchor so :meth:`merged_events` can rebase every lane onto the
    shared unix clock — the same alignment trick as
    ``trace.load_events_aligned``, applied live."""

    def __init__(self, lane_events: int = LANE_EVENTS):
        self._lock = threading.Lock()
        self._lanes: Dict[str, Dict[str, Any]] = {}
        self._order: List[str] = []
        self._tap: Optional[_FlightTap] = None
        self._router_header: Optional[Dict[str, Any]] = None
        self.lane_events = lane_events

    # -- ingest --------------------------------------------------------- #

    def _lane(self, source: str,
              header: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        lane = self._lanes.get(source)
        if lane is None:
            lane = {"header": header or {},
                    "events": deque(maxlen=self.lane_events),
                    "dropped": 0}
            self._lanes[source] = lane
            self._order.append(source)
        elif header:
            lane["header"] = header
        return lane

    def ingest(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """One shipped batch (``POST /fleet/spans`` body)."""
        source = str(doc.get("source") or "unknown")
        events = doc.get("events") or []
        if not isinstance(events, list):
            raise ValueError("'events' must be a list")
        with self._lock:
            lane = self._lane(source, doc.get("header"))
            lane["events"].extend(
                e for e in events if isinstance(e, dict))
            try:
                lane["dropped"] = max(
                    lane["dropped"],
                    int(doc.get("dropped_spans") or 0))
            except (TypeError, ValueError):
                pass
        return {"accepted": len(events), "source": source}

    def record(self, event: Dict[str, Any]) -> None:
        """Flight-tap sink for the router's own process."""
        with self._lock:
            if self._router_header is None:
                from pydcop_tpu_torch.observability.trace import (
                    trace_header,
                )

                self._router_header = trace_header()
            lane = self._lane("router", self._router_header)
            lane["events"].append(_copy_event(event))

    def attach_router_tap(self) -> None:
        if self._tap is None:
            self._tap = _install_tap(self.record)

    def detach_router_tap(self) -> None:
        _remove_tap(self._tap)
        self._tap = None

    # -- query ---------------------------------------------------------- #

    def dropped_spans(self) -> int:
        with self._lock:
            return sum(l["dropped"] for l in self._lanes.values())

    def sources(self) -> List[str]:
        with self._lock:
            return list(self._order)

    def merged_events(self) -> List[Dict[str, Any]]:
        """Every lane rebased onto the unix clock (per-source anchor
        offset), shifted so the earliest event sits near 0, tids
        namespaced ``source:tid`` and integer span ids strided per
        source — the in-memory equivalent of ``pydcop trace merge``
        over one file per process, directly consumable by
        ``query_request``/``check_well_nested``."""
        with self._lock:
            lanes = [(src,
                      dict(self._lanes[src]["header"]),
                      list(self._lanes[src]["events"]))
                     for src in self._order]
        out: List[Dict[str, Any]] = []
        for li, (src, header, events) in enumerate(lanes):
            try:
                offset = (float(header.get("anchor_unix_us"))
                          - float(header.get("anchor_perf_us")))
            except (TypeError, ValueError):
                offset = 0.0
            base = li * _ID_STRIDE
            for ev in events:
                ev = _copy_event(ev)
                try:
                    ev["ts"] = float(ev.get("ts", 0.0)) + offset
                except (TypeError, ValueError):
                    continue
                ev["tid"] = f"{src}:{ev.get('tid', 0)}"
                for key in ("id", "parent"):
                    val = ev.get(key)
                    if isinstance(val, int):
                        ev[key] = base + val
                out.append(ev)
        if out:
            t0 = min(e["ts"] for e in out)
            for ev in out:
                ev["ts"] -= t0
        out.sort(key=lambda e: e["ts"])
        return out

    def merged_doc(self) -> Dict[str, Any]:
        """The ``GET /fleet/trace`` body: merged events plus the
        lossiness ledger (what each source admits to dropping)."""
        with self._lock:
            sources = [{"source": src,
                        "events": len(self._lanes[src]["events"]),
                        "dropped_spans": self._lanes[src]["dropped"]}
                       for src in self._order]
        return {
            "version": 1,
            "sources": sources,
            "dropped_spans": sum(s["dropped_spans"]
                                 for s in sources),
            "events": self.merged_events(),
        }
