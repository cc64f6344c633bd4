"""Live telemetry endpoint: scrape a RUNNING solve.

A copy of ``pydcop_tpu/observability/server.py`` (stdlib only): the same
routes and bodies.  In the port ``/healthz`` answers ``ok`` unless a
health provider is registered (the agent runtime, not ported yet).

Until now metrics only materialized as end-of-run files (JSONL
snapshots + a ``.prom`` dump) — useless for watching a long
``pydcop solve`` or orchestrator run while it runs.
:class:`TelemetryServer` is a stdlib-only (``http.server``) HTTP
endpoint over the process-wide observability state:

- ``GET /metrics`` — the metrics registry in Prometheus text
  exposition format (scrape it directly, no pushgateway);
- ``GET /healthz`` — a JSON health verdict sourced from the active
  :class:`~pydcop_tpu_torch.resilience.health.HealthMonitor` when one is
  registered (``alive``/``suspect``/``dead`` statuses per agent;
  any dead agent turns the endpoint 503) and a plain ``ok`` when
  none is — orchestration probes work in both modes;
- ``GET /events`` — a Server-Sent-Events stream of cycle/cost
  snapshots pushed by whichever
  :class:`~pydcop_tpu_torch.observability.metrics.CycleSnapshotter` the
  current run drives (the class-wide listener hook), with keepalive
  comments while the solve is between chunks;
- ``GET /profile`` — the live device-efficiency rollup
  (observability/efficiency.py): backend-honest attainment, request
  time-ledger breakdown, waste by cause, top structures by device
  time.

Lifecycle is owned by
:class:`~pydcop_tpu_torch.observability.ObservabilitySession` (``api.solve
(serve_metrics=PORT)`` / ``pydcop solve --serve_metrics PORT``), but
the server is freestanding — tests and tools start one directly.
``port=0`` asks the OS for a free port (:attr:`port` reports the
assignment), which is what keeps parallel test runs collision-free.

The server thread and every connection handler are daemons: a wedged
scraper can never keep the solve process alive.
"""

import json
import logging
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("pydcop.observability.server")

# Process-wide health source: the thread-backend run loop registers its
# HealthMonitor summary here for the duration of the run (see
# infrastructure/run.solve_with_agents); /healthz falls back to a plain
# "ok" when nothing is registered.
_health_provider: Optional[Callable[[], Dict[str, Any]]] = None
_health_lock = threading.Lock()


def set_health_provider(fn: Optional[Callable[[], Dict[str, Any]]]):
    """Register (or clear, with ``None``) the process-wide health
    source consumed by ``/healthz``."""
    global _health_provider
    with _health_lock:
        _health_provider = fn


def get_health_provider() -> Optional[Callable[[], Dict[str, Any]]]:
    with _health_lock:
        return _health_provider


def _probe_diagnostics() -> Optional[Dict[str, Any]]:
    """Accelerator-probe failure root cause for the /healthz body.

    The bench/CLI backend guards record every probe outcome via
    ``utils.cleanenv.record_diag`` — until now that evidence was
    bench-log-only, so an operator watching a CPU-fallback service
    had no way to see WHY the accelerator was skipped.  Returns None
    when no probe ever failed (the common healthy case keeps the
    body small); failures never flip the health status — a CPU
    fallback still serves correctly, the body just says what
    happened."""
    try:
        from pydcop_tpu_torch.utils.cleanenv import (
            diag_events,
            is_probe_failure,
        )
    except Exception:  # noqa: BLE001 — probe must answer
        return None
    failures = [e for e in diag_events() if is_probe_failure(e)]
    if not failures:
        return None
    last = failures[-1]
    return {
        "failures": len(failures),
        "last_event": last.get("event"),
        "last_error": last.get("error"),
        "last_unix": last.get("unix"),
        "recent": failures[-5:],
    }


def health_verdict() -> Dict[str, Any]:
    """The /healthz body: provider data + an overall ``status`` rolled
    up from per-agent statuses (any dead -> ``failing``, any suspect
    -> ``degraded``, else ``ok``), plus the accelerator-probe failure
    root cause when any probe failed (``accelerator_probe`` key —
    informational, never changes the status).  Provider failures
    report ``unknown`` rather than crashing the probe."""
    provider = get_health_provider()
    if provider is None:
        data = {"status": "ok", "detail": "no health monitor active"}
    else:
        try:
            data = dict(provider())
        except Exception as exc:  # noqa: BLE001 — probe must answer
            data = {"status": "unknown",
                    "detail": f"health provider failed: {exc}"}
        else:
            statuses = data.get("statuses", {})
            if any(s == "dead" for s in statuses.values()):
                status = "failing"
            elif any(s == "suspect" for s in statuses.values()):
                status = "degraded"
            else:
                status = "ok"
            data.setdefault("status", status)
    probe = _probe_diagnostics()
    if probe is not None:
        data.setdefault("accelerator_probe", probe)
    return data


class _Handler(BaseHTTPRequestHandler):
    # Set per-server via the factory in TelemetryServer.start().
    telemetry: "TelemetryServer"

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: N802 — stdlib name
        logger.debug("telemetry %s", fmt % args)

    def _reply(self, code: int, body: bytes, content_type: str,
               close: bool = False):
        """``close=True`` advertises Connection: close (and makes the
        server honor it) — required on error replies sent WITHOUT
        reading a request body, or the unread bytes corrupt the next
        keep-alive request on the socket."""
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if close:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — stdlib name
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            # Content negotiation per the Prometheus convention: the
            # classic v0.0.4 text parser errors on exemplar suffixes,
            # so they only ride when the scraper explicitly Accepts
            # the OpenMetrics dialect (Prometheus does exactly this
            # when exemplar storage is enabled).
            openmetrics = ("application/openmetrics-text"
                           in self.headers.get("Accept", ""))
            body = self.telemetry.registry.to_prometheus(
                openmetrics=openmetrics).encode()
            self._reply(
                200, body,
                "application/openmetrics-text; version=1.0.0; "
                "charset=utf-8" if openmetrics
                else "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/metrics.json":
            # The registry snapshot as JSON: the machine-mergeable
            # form the fleet router's GET /fleet/metrics aggregator
            # pulls from every replica (text exposition round-trips
            # lossily; the snapshot keeps kinds and histogram
            # structure intact).
            self._reply(200,
                        json.dumps(self.telemetry.registry.snapshot(),
                                   default=str).encode(),
                        "application/json")
        elif path == "/healthz":
            verdict = health_verdict()
            code = 503 if verdict.get("status") == "failing" else 200
            self._reply(code, json.dumps(verdict).encode(),
                        "application/json")
        elif path == "/profile":
            # The live efficiency rollup: backend-honest
            # attainment, the request-ledger where-the-time-went
            # breakdown, waste by cause, top structures by device
            # time.  ``pydcop profile report --url`` renders it.
            from pydcop_tpu_torch.observability.efficiency import tracker

            self._reply(200,
                        json.dumps(tracker.rollup(),
                                   default=str).encode(),
                        "application/json")
        elif path == "/events":
            self._stream_events()
        elif path == "/debug/bundle":
            self._debug_bundle()
        else:
            self._reply(404, b'{"error": "unknown path"}',
                        "application/json")

    def _debug_bundle(self):
        """Cut an on-demand postmortem bundle: written to the
        recorder's bundle dir AND returned in the response (the
        ``pydcop debug bundle`` client saves it locally) — the
        operator gets the evidence even when the server host's disk
        is not reachable."""
        from pydcop_tpu_torch.observability.flight import get_flight

        recorder = get_flight()
        if recorder is None:
            self._reply(503,
                        b'{"error": "flight recorder disabled '
                        b'(PYDCOP_FLIGHT_RECORDER=0)"}',
                        "application/json")
            return
        try:
            doc = recorder.make_bundle("on_demand", {"via": "http"})
            doc["path"] = recorder.write_bundle(doc)
        except Exception as exc:  # noqa: BLE001 — probe must answer
            self._reply(500, json.dumps(
                {"error": f"bundle failed: {exc}"}).encode(),
                "application/json")
            return
        self._reply(200, json.dumps(doc, default=str).encode(),
                    "application/json")

    def _stream_events(self):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        # SSE is an unbounded body: no Content-Length, close delimits.
        self.send_header("Connection", "close")
        self.end_headers()
        q = self.telemetry._subscribe()
        try:
            # Replay the latest snapshot so a client connecting between
            # chunks sees state immediately, not on the next boundary.
            last = self.telemetry.last_event
            if last is not None:
                self._write_event(last)
            while not self.telemetry._stopping.is_set():
                try:
                    event = q.get(timeout=1.0)
                except queue.Empty:
                    self.wfile.write(b": keepalive\n\n")
                    self.wfile.flush()
                    continue
                self._write_event(event)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # client went away — normal SSE termination
        finally:
            self.telemetry._unsubscribe(q)

    def _write_event(self, event: Dict[str, Any]):
        payload = json.dumps(event, default=str).encode()
        self.wfile.write(b"data: " + payload + b"\n\n")
        self.wfile.flush()


class TelemetryServer:
    """Serve /metrics, /healthz and /events for the process-wide
    observability state.  ``start()`` binds (``port=0`` = OS-assigned,
    see :attr:`port`) and serves from a daemon thread; ``stop()``
    shuts down and unhooks the snapshot listener.

    Subclasses mount extra routes by overriding :attr:`handler_class`
    with a ``_Handler`` subclass (the serving front end,
    serving/http.py, adds ``POST /solve`` / ``GET /result`` this
    way and keeps /metrics, /healthz and /events mounted alongside).
    """

    handler_class = _Handler

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry=None):
        from pydcop_tpu_torch.observability.metrics import (
            registry as default_registry,
        )

        self.host = host
        self._requested_port = port
        self.registry = (registry if registry is not None
                         else default_registry)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._subscribers: List[queue.Queue] = []
        self._sub_lock = threading.Lock()
        self.last_event: Optional[Dict[str, Any]] = None

    # -- snapshot fan-out ---------------------------------------------- #

    def _subscribe(self) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=256)
        with self._sub_lock:
            self._subscribers.append(q)
        return q

    def _unsubscribe(self, q: queue.Queue):
        with self._sub_lock:
            if q in self._subscribers:
                self._subscribers.remove(q)

    def _on_snapshot(self, event: Dict[str, Any]):
        # One-off request-lifecycle events fan out live but must not
        # occupy the replay slot: a client connecting mid-run is
        # promised "the latest snapshot" (cycle/cost state), not the
        # terminal phase of some unrelated already-finished request.
        if event.get("event") != "request":
            self.last_event = event
        with self._sub_lock:
            subscribers = list(self._subscribers)
        for q in subscribers:
            try:
                q.put_nowait(event)
            except queue.Full:
                # Slow consumer: drop the oldest so the stream stays
                # current instead of stalling the producer.
                try:
                    q.get_nowait()
                    q.put_nowait(event)
                except (queue.Empty, queue.Full):
                    pass

    # -- lifecycle ----------------------------------------------------- #

    @property
    def port(self) -> Optional[int]:
        if self._httpd is None:
            return None
        return self._httpd.server_address[1]

    @property
    def url(self) -> Optional[str]:
        port = self.port
        return None if port is None else f"http://{self.host}:{port}"

    def start(self) -> "TelemetryServer":
        from pydcop_tpu_torch.observability.metrics import CycleSnapshotter

        if self._httpd is not None:
            return self
        handler = type("BoundHandler", (self.handler_class,),
                       {"telemetry": self})
        self._httpd = ThreadingHTTPServer(
            (self.host, self._requested_port), handler)
        self._httpd.daemon_threads = True
        self._stopping.clear()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="pydcop-telemetry", daemon=True)
        self._thread.start()
        CycleSnapshotter.add_global_listener(self._on_snapshot)
        logger.info("telemetry server listening on %s", self.url)
        return self

    def stop(self):
        from pydcop_tpu_torch.observability.metrics import CycleSnapshotter

        if self._httpd is None:
            return
        CycleSnapshotter.remove_global_listener(self._on_snapshot)
        self._stopping.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
