"""HTTP front end for the solve service (stdlib-only).

Extends the telemetry endpoint
(:class:`~pydcop_tpu_torch.observability.server.TelemetryServer`) with the
request plane, so one port serves the solve API *and* its own
telemetry:

- ``POST /solve`` — body ``{"dcop": "<dcop yaml>", "params": {...},
  "wait": bool, "timeout": s, "deadline_s": s}``.  Returns 202 + a
  request id (poll ``/result/<id>``), or the finished result directly
  with ``"wait": true`` (200; 202 + id if the wait timed out).
  ``deadline_s`` is a freshness budget: work still queued past it is
  dropped by the scheduler (504, ``rejected_deadline``).  Errors:
  400 malformed body/problem/params (a malformed ``timeout`` or
  ``deadline_s`` is a 400, never silently coerced), 429 queue past
  high-water (back off and retry), 503 dispatch breaker open.
- ``GET /result/<id>`` — 200 + result when done, 202 while pending,
  504 + result when the deadline expired it, 404 unknown id.
- ``GET /stats`` — the service's dispatch/queue/breaker ledger.
- ``GET /metrics`` / ``/healthz`` / ``/events`` — mounted unchanged
  from the telemetry server; ``/healthz`` additionally reflects the
  serving state (open dispatch breaker → ``failing`` → 503).
- Stateful sessions (docs/sessions.md): ``POST /session`` opens a
  long-lived solve (201 + session_id/trace_id),
  ``PATCH /session/<id>/events`` streams scenario events into it
  (the 200 is journal-durable like a submit's 202),
  ``GET /session/<id>`` polls status, ``GET /session/<id>/events``
  streams anytime assignment/cost per segment (SSE), and
  ``DELETE /session/<id>`` closes with the final result.

curl examples live in docs/serving.md and docs/sessions.md.

A copy of ``pydcop_tpu/serving/http.py``: the same routes, status
codes and JSON bodies, on the port's ``observability/server.py``.
"""

import contextlib
import json
import logging
import math
import queue
from typing import Any, Dict, Optional

from pydcop_tpu_torch.observability import fleettrace
from pydcop_tpu_torch.observability.server import (
    TelemetryServer,
    _Handler,
    get_health_provider,
    set_health_provider,
)
from pydcop_tpu_torch.observability.trace import tracer
from pydcop_tpu_torch.serving.admission import AdmissionRejected
from pydcop_tpu_torch.serving.service import SolveService, WidthRejected
from pydcop_tpu_torch.serving.sessions import (
    SessionClosed,
    StaleEpoch,
    scenario_yaml_to_events,
)

logger = logging.getLogger("pydcop.serving.http")

# Request bodies are small YAML problems; refuse anything huge before
# reading it (a misbehaving client must not balloon the process).
MAX_BODY_BYTES = 8 << 20


def _positive_float(value: Any, name: str) -> float:
    """Strict wire-field validation: a finite number > 0, or
    ValueError.  Non-finite values are rejected — ``timeout: inf``
    would pin one of the server's handler threads forever."""
    try:
        out = float(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"{name} must be a number of seconds, got {value!r}")
    if not math.isfinite(out) or not out > 0:
        raise ValueError(
            f"{name} must be a finite number > 0, got {out}")
    return out


def _result_code(result: Dict[str, Any]) -> int:
    """HTTP status for a terminal result body: 504 for a
    deadline-expired request, 400 for a dispatch-time width rejection
    (the client sent a problem exact inference cannot afford — a
    client fault, not a server one), 200 otherwise (a generic ERROR
    result is a well-formed 200 reply whose body says the solve
    failed)."""
    if result.get("status") == "EXPIRED":
        return 504
    if result.get("status_detail") == "rejected_width":
        return 400
    return 200


class _ServeHandler(_Handler):
    """Telemetry routes + the solve request plane."""

    def _json(self, code: int, payload: Dict[str, Any],
              close: bool = False):
        self._reply(code, json.dumps(payload, default=str).encode(),
                    "application/json", close=close)

    def _read_json_body(self) -> Optional[Dict[str, Any]]:
        """Read + decode the request's JSON object body; replies the
        4xx itself and returns None on failure (callers just
        return)."""
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = 0
        if length <= 0 or length > MAX_BODY_BYTES:
            self._json(400, {"error": "body required (JSON, "
                                      f"<= {MAX_BODY_BYTES} bytes)"},
                       close=True)
            return None
        raw = self.rfile.read(length)
        try:
            body = json.loads(raw)
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as exc:
            self._json(400, {"error": f"bad request body: {exc}"})
            return None
        return body

    def do_GET(self):  # noqa: N802 — stdlib name
        path = self.path.split("?", 1)[0]
        service = self.telemetry.service
        if path.startswith("/session/"):
            rest = path[len("/session/"):]
            if rest.endswith("/events"):
                self._stream_session(rest[:-len("/events")])
                return
            try:
                self._json(200, service.sessions.status(rest))
            except KeyError:
                self._json(404, {"error": f"unknown session {rest!r}"})
            return
        if path.startswith("/result/"):
            rid = path[len("/result/"):]
            # Both lookups can KeyError: the id may be unknown, or
            # the entry may be evicted between the two calls
            # (result() pending -> completion -> a concurrent
            # submit's retention prune).  Either way: 404.
            try:
                result = service.result(rid)
                if result is None:
                    self._json(202, {"id": rid,
                                     "status": service.status(rid),
                                     "trace_id": service.trace_id(rid)})
                    return
            except KeyError:
                self._json(404, {"error": f"unknown request {rid!r}"})
                return
            self._json(_result_code(result), result)
        elif path == "/stats":
            self._json(200, service.stats())
        else:
            super().do_GET()

    def do_POST(self):  # noqa: N802 — stdlib name
        path = self.path.split("?", 1)[0]
        if path == "/session":
            self._open_session()
            return
        if path.startswith("/admin/"):
            self._admin(path[len("/admin/"):])
            return
        if path != "/solve":
            # Replying without reading the body would leave it on the
            # socket and corrupt the next keep-alive request (the
            # handler speaks HTTP/1.1): advertise-and-close on every
            # error path that skips the read.
            self._json(404, {"error": "unknown path"}, close=True)
            return
        body = self._read_json_body()
        if body is None:
            return
        yaml_src = body.get("dcop")
        if not isinstance(yaml_src, str) or not yaml_src.strip():
            self._json(400, {"error": "bad request body: body needs "
                                      "a 'dcop' key holding the "
                                      "problem as a dcop yaml string"})
            return
        service = self.telemetry.service
        # Wire-level fields validate BEFORE submit: a malformed
        # ``timeout`` used to be silently coerced to 30.0 by a bare
        # except — a typo'd client ran with a default it never chose.
        # Now it is a 400 (``rejected_bad_request`` in the ledger),
        # and because nothing was submitted yet there is no orphaned
        # accepted request behind the rejection.
        try:
            timeout = _positive_float(
                body.get("timeout", 30.0), "timeout")
            deadline_s = body.get("deadline_s")
            if deadline_s is not None:
                deadline_s = _positive_float(deadline_s, "deadline_s")
            # Caller-supplied id (the fleet router mints fleet-unique
            # ids so /result polls can be pinned to the owning
            # replica; worker-local counters would collide across a
            # fleet).  Validated like every other wire field.
            request_id = body.get("request_id")
            if request_id is not None and (
                    not isinstance(request_id, str)
                    or not request_id.strip()):
                raise ValueError(
                    f"request_id must be a non-empty string, got "
                    f"{request_id!r}")
        except ValueError as exc:
            service.record_bad_request()
            self._json(400, {"error": f"bad request body: {exc}"})
            return
        # The fleet router's wire-propagated trace context:
        # adopting it makes this replica's serve_* spans part of the
        # router's admission trace in the fleet collector.
        ctx = fleettrace.decode_headers(self.headers)
        try:
            from pydcop_tpu_torch.dcop.yamldcop import load_dcop

            dcop = load_dcop(yaml_src)
            rid = service.submit(dcop, params=body.get("params"),
                                 request_id=request_id,
                                 deadline_s=deadline_s,
                                 trace_id=(ctx.trace_id if ctx
                                           else None))
        except AdmissionRejected as exc:
            self._json(exc.http_status, {
                "error": str(exc),
                "status": "rejected",
                "retry": exc.http_status == 429,
            })
            return
        except WidthRejected as exc:
            # ``algo:"dpop"`` on a problem whose UTIL hypercubes bust
            # the element cap even after CEC shrinkage.  The width
            # check runs on the submitting thread before anything is
            # queued, so this is a clean structured 400: no orphaned
            # request, nothing fed to the admission breaker, and the
            # body tells the client exactly how far over the cap the
            # problem is (retrying the same shape cannot help).
            self._json(400, {
                "error": str(exc),
                "status": exc.status,
                "max_elements": exc.max_elements,
                "max_elements_cap": exc.cap,
                "retry": False,
            })
            return
        except RuntimeError as exc:
            # Server-side submit failure (journal append I/O): the
            # request was valid and the fault is ours — a 400 would
            # tell a well-behaved client to stop retrying.
            self._json(500, {"error": f"internal error: {exc}"})
            return
        except Exception as exc:  # noqa: BLE001 — malformed problem
            self._json(400, {"error": f"bad problem: {exc}"})
            return
        if body.get("wait"):
            result = service.result(rid, wait=timeout)
            if result is not None:
                self._json(_result_code(result), result)
                return
            # Fell through the wait window: hand back the id.
        # The trace_id rides every ack: the client holds the handle
        # that `pydcop trace query --request` takes without another
        # round trip (a request may be gone from retention by the
        # time anyone wants its trace).
        try:
            trace_id = service.trace_id(rid)
        except KeyError:  # evicted already (tiny result_keep)
            trace_id = None
        self._json(202, {"id": rid, "status": "queued",
                         "trace_id": trace_id,
                         "result_url": f"/result/{rid}"})

    # -- migration admin plane (docs/serving.md) ----------------------- #

    def _admin(self, op: str):
        """``POST /admin/<op>_session`` — the worker side of live
        session migration (docs/serving.md).  The fleet router drives
        these; they are same-box trust, like ``/solve``:

        - ``export_session`` — drain + checkpoint the session, freeze
          it MIGRATING, return the portable bundle (200).
        - ``import_session`` — journal + rebuild a bundle's session
          here (201).  The import journals *before* it rebuilds, so a
          crash mid-import leaves a replayable journal, never a lost
          session.
        - ``retire_session`` — close out a MIGRATING session on the
          source once the target owns it (200, idempotent).
        - ``resume_session`` — roll a MIGRATING session back to OPEN
          after a failed import (200).
        - ``fence_session`` — revoke this replica's stale copy of a
          session whose ownership epoch moved on while it was
          partitioned (200, idempotent; 409 when the fence itself is
          stale).
        """
        if op == "trace_collector":
            # ``POST /admin/trace_collector`` — the router pushes its
            # fleet-collector address here (at fleet start, after a
            # replica restart, on a --join) so this process's span
            # shipper knows where completed spans go; ``enable:
            # false`` detaches it (the perf-smoke pairwise gate
            # toggles tracing at runtime this way).
            body = self._read_json_body()
            if body is None:
                return
            try:
                out = fleettrace.configure_shipper(
                    body.get("url"),
                    source=str(body.get("source") or "worker"),
                    enable=bool(body.get("enable", True)))
            except Exception as exc:  # noqa: BLE001 — admin answers
                self._json(500, {"error": f"internal error: {exc}"})
                return
            self._json(200, out)
            return
        if op not in ("export_session", "import_session",
                      "retire_session", "resume_session",
                      "fence_session"):
            self._json(404, {"error": "unknown path"}, close=True)
            return
        body = self._read_json_body()
        if body is None:
            return
        service = self.telemetry.service
        # Migration/fence admin calls are router-driven: the fleet
        # context on them tags this replica's side of the hop (the
        # import/export spans inside the session manager record
        # under it via the thread-bound args).
        ctx = fleettrace.decode_headers(self.headers)
        admin_ctx = (tracer.context(trace_ids=[ctx.trace_id])
                     if ctx is not None and tracer.active
                     else contextlib.nullcontext())
        try:
            with admin_ctx:
                if op == "import_session":
                    from pydcop_tpu_torch.serving import migration

                    sess = migration.install_bundle(
                        service.sessions, body)
                    self._json(201, {"session_id": sess.id,
                                     "trace_id": sess.trace_id,
                                     "seq": sess.seq,
                                     "status": sess.status})
                    return
                sid = body.get("session_id")
                if not isinstance(sid, str) or not sid.strip():
                    raise ValueError(
                        "body needs a 'session_id' string")
                if op == "export_session":
                    wait = _positive_float(
                        body.get("wait", 60.0), "wait")
                    out = service.sessions.export_session(
                        sid, wait=wait)
                elif op == "retire_session":
                    out = service.sessions.retire_session(
                        sid, moved_to=body.get("moved_to"))
                elif op == "fence_session":
                    out = service.sessions.fence_session(
                        sid, int(body.get("epoch") or 0))
                else:  # resume_session
                    out = service.sessions.resume_session(sid)
                self._json(200, out)
        except KeyError as exc:
            self._json(404, {"error": f"unknown session: {exc}"})
        except StaleEpoch as exc:
            self._json(409, {"error": str(exc), "stale_epoch": True,
                             "session_epoch": exc.session_epoch,
                             "request_epoch": exc.request_epoch})
        except SessionClosed as exc:
            self._json(409, {"error": str(exc)})
        except TimeoutError as exc:
            self._json(504, {"error": str(exc)})
        except ValueError as exc:
            service.record_bad_request()
            self._json(400, {"error": f"bad request body: {exc}"})
        except Exception as exc:  # noqa: BLE001 — admin must answer
            logger.warning("admin %s failed: %s", op, exc)
            self._json(500, {"error": f"internal error: {exc}"})

    # -- stateful sessions (docs/sessions.md) -------------------------- #

    def _open_session(self):
        """``POST /session`` — body ``{"dcop": yaml, "params":
        {...}}``: opens a stateful solve whose engine lives across
        requests.  201 + session_id/trace_id; the session starts
        converging immediately and streams anytime results on
        ``GET /session/<id>/events``."""
        body = self._read_json_body()
        if body is None:
            return
        yaml_src = body.get("dcop")
        if not isinstance(yaml_src, str) or not yaml_src.strip():
            self._json(400, {"error": "bad request body: body needs "
                                      "a 'dcop' key holding the "
                                      "problem as a dcop yaml string"})
            return
        service = self.telemetry.service
        try:
            from pydcop_tpu_torch.dcop.yamldcop import load_dcop

            dcop = load_dcop(yaml_src)
            ctx = fleettrace.decode_headers(self.headers)
            sess = service.sessions.open(
                dcop, params=body.get("params"),
                session_id=body.get("session_id"),
                trace_id=ctx.trace_id if ctx else None)
        except AdmissionRejected as exc:
            self._json(exc.http_status, {
                "error": str(exc), "status": "rejected",
                "retry": exc.http_status == 429,
            })
            return
        except RuntimeError as exc:
            self._json(500, {"error": f"internal error: {exc}"})
            return
        except Exception as exc:  # noqa: BLE001 — malformed problem
            service.record_bad_request()
            self._json(400, {"error": f"bad problem: {exc}"})
            return
        self._json(201, {
            "session_id": sess.id,
            "trace_id": sess.trace_id,
            "status": sess.status,
            "events_url": f"/session/{sess.id}/events",
        })

    def do_PATCH(self):  # noqa: N802 — stdlib name
        """``PATCH /session/<id>/events`` — body ``{"events": [...]}``
        (wire actions) or ``{"scenario": "<scenario yaml>"}``; with
        ``"wait": true`` the reply carries the post-event segment
        result.  The 200 is durable: the batch is journaled before
        the ack."""
        path = self.path.split("?", 1)[0]
        if not (path.startswith("/session/")
                and path.endswith("/events")):
            self._json(404, {"error": "unknown path"}, close=True)
            return
        sid = path[len("/session/"):-len("/events")]
        body = self._read_json_body()
        if body is None:
            return
        service = self.telemetry.service
        # Wire-level parsing FIRST, in its own guard: a malformed
        # scenario yaml raises KeyError('type'/'id') from the loader,
        # which the unknown-session handler below would otherwise
        # mistranslate into a 404 for a perfectly live session.
        try:
            events = body.get("events")
            if events is None and body.get("scenario"):
                events = scenario_yaml_to_events(body["scenario"])
            wait = None
            if body.get("wait"):
                wait = _positive_float(
                    body.get("timeout", 30.0), "timeout")
            epoch = body.get("epoch")
            if epoch is not None:
                epoch = int(epoch)
        except Exception as exc:  # noqa: BLE001 — malformed body
            service.record_bad_request()
            self._json(400, {"error": f"bad events: {exc}"})
            return
        ctx = fleettrace.decode_headers(self.headers)
        try:
            out = service.sessions.apply_events(
                sid, events, wait=wait, epoch=epoch,
                trace_id=ctx.trace_id if ctx else None)
        except KeyError:
            self._json(404, {"error": f"unknown session {sid!r}"})
            return
        except StaleEpoch as exc:
            # Structured 409: the fenced/stale side MUST be
            # machine-distinguishable from an ordinary closed-session
            # race — clients re-resolve ownership through the router
            # instead of retrying here.
            self._json(409, {"error": str(exc), "stale_epoch": True,
                             "session_epoch": exc.session_epoch,
                             "request_epoch": exc.request_epoch})
            return
        except SessionClosed as exc:
            self._json(409, {"error": str(exc)})
            return
        except RuntimeError as exc:
            self._json(500, {"error": f"internal error: {exc}"})
            return
        except Exception as exc:  # noqa: BLE001 — malformed events
            service.record_bad_request()
            self._json(400, {"error": f"bad events: {exc}"})
            return
        self._json(200, out)

    def do_DELETE(self):  # noqa: N802 — stdlib name
        """``DELETE /session/<id>`` — close the session; 200 + the
        final result (idempotent: a second DELETE returns the same
        final)."""
        path = self.path.split("?", 1)[0]
        if not path.startswith("/session/"):
            self._json(404, {"error": "unknown path"}, close=True)
            return
        sid = path[len("/session/"):]
        service = self.telemetry.service
        try:
            final = service.sessions.close(sid)
        except KeyError:
            self._json(404, {"error": f"unknown session {sid!r}"})
            return
        except SessionClosed as exc:
            self._json(409, {"error": str(exc)})
            return
        except TimeoutError as exc:
            self._json(504, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 — close must answer
            self._json(500, {"error": f"internal error: {exc}"})
            return
        self._json(200, final)

    def _stream_session(self, sid: str):
        """``GET /session/<id>/events`` — per-session SSE: the latest
        segment event replays on connect, then every segment /
        terminal event streams as it lands.  The stream ends when the
        session reaches a terminal state."""
        service = self.telemetry.service
        try:
            q = service.sessions.subscribe(sid)
        except KeyError:
            self._json(404, {"error": f"unknown session {sid!r}"})
            return
        # Router-proxied streams carry the fleet context: the attach
        # instant is what lets forensics show WHO was watching the
        # session while the events under inspection streamed.
        ctx = fleettrace.decode_headers(self.headers)
        if ctx is not None and tracer.active:
            tracer.instant("session_stream_attach", "serving",
                           session=sid, trace_id=ctx.trace_id)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            while not self.telemetry._stopping.is_set():
                try:
                    event = q.get(timeout=1.0)
                except queue.Empty:
                    self.wfile.write(b": keepalive\n\n")
                    self.wfile.flush()
                    continue
                self._write_event(event)
                if event.get("status") in ("CLOSED", "ERROR",
                                           "REPLAYABLE", "MIGRATED"):
                    break
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # client went away — normal SSE termination
        finally:
            service.sessions.unsubscribe(sid, q)


class ServeFrontEnd(TelemetryServer):
    """One HTTP server binding the solve API + telemetry routes.

    Owns neither the service's lifecycle nor the registry — start the
    :class:`SolveService` first (or use :func:`pydcop_tpu_torch.api.serve`,
    which wires both).  While running, the service's health summary
    feeds the process-wide ``/healthz`` provider so an open dispatch
    breaker turns the probe 503.
    """

    handler_class = _ServeHandler

    def __init__(self, service: SolveService, port: int = 0,
                 host: str = "127.0.0.1", registry=None):
        super().__init__(port=port, host=host, registry=registry)
        self.service = service
        self._prior_provider = None

    def start(self) -> "ServeFrontEnd":
        super().start()
        # Save/restore, don't clobber: a process embedding the front
        # end next to a health-monitored thread run must get its
        # provider back when the front end stops.
        self._prior_provider = get_health_provider()
        set_health_provider(self.service.health_summary)
        return self

    def stop(self):
        set_health_provider(self._prior_provider)
        self._prior_provider = None
        super().stop()
