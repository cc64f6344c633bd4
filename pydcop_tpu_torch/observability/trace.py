"""Process-wide tracer: timestamped spans with parent/child
correlation, exported as Chrome ``trace_event`` JSON or JSONL.

A copy of ``pydcop_tpu/observability/trace.py`` (pure Python): the same
span names, event fields and file formats, so either package's traces
read with the other's tools.

The runtime is threaded (one thread per agent, HTTP server threads,
retry sweepers, fault timers); a single locked event list would
serialize every instrumented site on one mutex.  Instead each thread
appends to its own buffer (``threading.local``) — the only lock is
taken once per thread per session, when the buffer is registered for
export — so recording is a list append plus a dict build.

Disabled (the default) costs ONE attribute check: every instrumented
site guards on ``tracer.enabled``, :meth:`Tracer.span` returns a
shared no-op context manager singleton (no allocation), and
:meth:`Tracer.instant` returns before touching its arguments.  The
zero-overhead contract is asserted in the observability battery.

Span events carry ``id``/``parent`` correlation ids (a per-thread span
stack): a message-handling span opened inside an agent-step span
records the step as its parent, so one trace file reconstructs the
whole causal tree of a chaos run.  Chrome ``trace_event`` output loads
directly in ``chrome://tracing`` / Perfetto (spans are ``ph:"X"``
complete events, instants ``ph:"i"``); JSONL output is one event per
line for ad-hoc ``jq``/pandas processing.

Multi-process runs: every exported file carries a HEADER with the
process/host identity and a monotonic-to-wall clock anchor
(``perf_counter`` timestamps are only comparable within one process).
:func:`merge_traces` uses the anchors to align N per-process traces
onto one wall-clock axis and namespaces their thread lanes, so a
distributed run collapses into a single well-nested Perfetto tab;
:func:`diff_trace_summaries` compares two traces span-name by
span-name (count/total/p50 deltas, regression flags) — the ``pydcop
trace merge`` / ``trace diff`` commands drive both.

Request-scoped causality (the serve plane): :meth:`Tracer.context`
binds args (e.g. a request ``trace_id``, or a batch's ``trace_ids``)
onto the CURRENT THREAD for the duration of a ``with`` block — every
span and instant recorded inside carries them, so engine internals
are tagged with the requests riding a dispatch without the engine
knowing about requests.  :func:`query_request` filters a trace down
to one request's events and rebuilds its span tree (``pydcop trace
query --request ID``).

Flight recorder: :meth:`Tracer.set_flight` attaches an always-on
bounded ring (observability/flight.py) that receives events EVEN
WHILE file tracing is off.  Sites whose events belong in a
postmortem guard on ``tracer.active`` (true when either the session
tracer or the flight ring wants events); per-message hot paths keep
guarding on ``tracer.enabled`` so the ring holds signal, not message
spam.
"""

import itertools
import json
import math
import os
import socket
import threading
import time
from collections import defaultdict
from typing import (
    Any,
    Dict,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
)

_US = 1e6  # trace_event timestamps are microseconds

HEADER_KEY = "pydcop_trace_header"
_HEADER_VERSION = 1


class TraceFileError(ValueError):
    """A trace file that cannot be read as events: missing, empty,
    truncated mid-write, or not Chrome-JSON/JSONL at all.  Commands
    catch this and print the message instead of a traceback."""


def trace_header() -> Dict[str, Any]:
    """Identity + clock anchor stamped into every exported trace.

    ``anchor_perf_us`` and ``anchor_unix_us`` are sampled
    back-to-back: their difference maps this process's
    ``perf_counter`` timeline onto the wall clock, which is what lets
    :func:`merge_traces` align traces from different processes (each
    process's perf_counter has an arbitrary epoch)."""
    return {
        "version": _HEADER_VERSION,
        "pid": os.getpid(),
        "host": socket.gethostname(),
        "anchor_perf_us": time.perf_counter() * _US,
        "anchor_unix_us": time.time() * _US,
    }


class _NoopSpan:
    """Shared do-nothing context manager returned while disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    """An open span; records a complete (``ph:"X"``) event on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "span_id",
                 "parent_id", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.span_id = next(tracer._ids)
        self.parent_id = 0
        self._t0 = 0.0

    def __enter__(self):
        stack = self._tracer._stack()
        self.parent_id = stack[-1] if stack else 0
        stack.append(self.span_id)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        self._tracer._record({
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": self._t0 * _US,
            "dur": (t1 - self._t0) * _US,
            "id": self.span_id,
            "parent": self.parent_id,
            "args": self.args,
        })
        return False


class _TraceContext:
    """Pushes bound args for the current thread; see Tracer.context."""

    __slots__ = ("_tracer", "args")

    def __init__(self, tracer: "Tracer", args: Dict[str, Any]):
        self._tracer = tracer
        self.args = args

    def __enter__(self):
        local = self._tracer._ensure_local()
        local.ctx_stack.append(self.args)
        self._tracer._rebuild_ctx()
        return self

    def __exit__(self, *exc):
        local = self._tracer._ensure_local()
        # Remove by identity, not equality (two contexts may bind
        # equal dicts), and survive an enable() that reset the stack
        # mid-block.
        local.ctx_stack[:] = [
            a for a in local.ctx_stack if a is not self.args
        ]
        self._tracer._rebuild_ctx()
        return False


class Tracer:
    """Per-thread-buffered span/instant recorder.

    Lifecycle: :meth:`enable` clears previous events and starts a
    session; :meth:`disable` stops recording (events stay readable for
    export); :meth:`events` / :meth:`export_chrome` /
    :meth:`export_jsonl` read them back.

    ``active`` is the recording-wanted flag call sites guard on when
    their events should also reach the flight recorder's always-on
    ring: it is true while the session tracer is enabled OR a flight
    ring is attached (:meth:`set_flight`).  ``enabled`` alone still
    gates the per-message hot paths.
    """

    def __init__(self):
        self.enabled = False
        # Attached flight ring (observability/flight.FlightRecorder)
        # or None; ``active`` is kept in sync so hot sites pay one
        # attribute check, not two.
        self.flight = None
        self.active = False
        self._lock = threading.Lock()
        self._local = threading.local()
        # (tid, thread name, buffer) per registered thread.
        self._buffers: List[tuple] = []
        # Bumping the generation invalidates every thread's cached
        # buffer, so enable() drops stale events without touching
        # other threads' locals.
        self._generation = 0
        # Monotone lane ids, independent of _buffers length: flight-
        # only threads get a tid without a registration.
        self._tid_counter = 0
        self._ids = itertools.count(1)

    # -- recording ----------------------------------------------------- #

    def _ensure_local(self):
        if getattr(self._local, "gen", None) != self._generation:
            buf: list = []
            thread = threading.current_thread()
            self._local.buf = buf
            self._local.stack = []
            # Context-binding state survives nothing across a
            # generation bump: a fresh session starts unbound (open
            # _TraceContext blocks re-register on exit harmlessly).
            self._local.ctx_stack = []
            self._local.ctx = {}
            self._local.gen = self._generation
            with self._lock:
                # Synthetic tid, not thread.ident: the OS reuses
                # idents once a thread exits (killed agents, repair
                # threads), which would merge two threads' lanes and
                # break span nesting within one exported lane.
                self._tid_counter += 1
                self._local.tid = self._tid_counter
                # Register the buffer for export ONLY while a file
                # session is recording: in flight-only mode
                # (enabled=False, ring attached — the production
                # serve default) events go to the bounded ring and
                # the buffer stays empty, so keeping a registration
                # per short-lived thread (one HTTP handler thread
                # per request) would grow _buffers without bound.
                # enable() bumps the generation, so a thread first
                # seen in flight-only mode re-registers here the
                # moment a session starts.
                if self.enabled:
                    self._buffers.append(
                        (self._local.tid, thread.name, buf))
        return self._local

    def _buf(self) -> list:
        return self._ensure_local().buf

    def _stack(self) -> list:
        return self._ensure_local().stack

    def _rebuild_ctx(self):
        local = self._ensure_local()
        flat: Dict[str, Any] = {}
        for args in local.ctx_stack:
            flat.update(args)
        local.ctx = flat

    def context(self, **args) -> _TraceContext:
        """Bind args onto every span/instant the CURRENT THREAD
        records inside the ``with`` block (explicit event args win on
        key collision).  The serve dispatch path binds the batch's
        ``trace_ids`` here, so engine spans recorded underneath are
        request-attributable without the engine knowing about
        requests.  Nestable; inner bindings shadow outer ones."""
        return _TraceContext(self, args)

    def _record(self, event: Dict[str, Any]):
        enabled = self.enabled
        flight = self.flight
        if not enabled and flight is None:
            return
        local = self._ensure_local()
        ctx = local.ctx
        if ctx:
            # Merge INTO the existing args dict (explicit event args
            # win) rather than replacing it: timed_jit_call mutates
            # span.args after exit to attach measured XLA cost, and
            # the recorded event must keep holding that same dict by
            # reference or the attribution is silently lost whenever
            # a trace context is bound (the serve dispatch path).
            args = event.get("args")
            if args is None:
                event["args"] = dict(ctx)
            else:
                for k, v in ctx.items():
                    args.setdefault(k, v)
        event["tid"] = local.tid
        if enabled:
            local.buf.append(event)
        if flight is not None:
            flight.record(event)

    def span(self, name: str, cat: str = "default", **args) -> Any:
        """Context manager recording a complete span on exit.

        Hot call sites should still guard on ``tracer.enabled`` (or
        ``tracer.active`` for events that belong in flight-recorder
        postmortems) so the kwargs dict is never built while off."""
        if not self.active:
            return NOOP_SPAN
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "default", **args):
        """Record a point-in-time event."""
        if not self.active:
            return
        parent = self._stack()
        self._record({
            "name": name,
            "cat": cat,
            "ph": "i",
            "ts": time.perf_counter() * _US,
            "id": next(self._ids),
            "parent": parent[-1] if parent else 0,
            "args": args,
        })

    def complete(self, name: str, cat: str = "default", *,
                 t0: float, t1: float, **args):
        """Record an already-finished span from explicit
        ``perf_counter`` timestamps (seconds).  For intervals whose
        start lived on no thread — a request's queue wait starts on
        the submitting thread and ends on the scheduler thread; the
        dispatcher records it retroactively here."""
        if not self.active:
            return
        self._record({
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": float(t0) * _US,
            "dur": max(float(t1) - float(t0), 0.0) * _US,
            "id": next(self._ids),
            "parent": 0,
            "args": args,
        })

    # -- lifecycle ----------------------------------------------------- #

    def set_flight(self, recorder) -> None:
        """Attach (or detach, with ``None``) the always-on flight
        ring.  While attached, ``active`` stays true and every
        recorded event is appended to the ring even when the session
        tracer is disabled."""
        self.flight = recorder
        self.active = self.enabled or recorder is not None

    def enable(self):
        """Start a fresh tracing session (previous events dropped).

        ``_tid_counter`` is NOT reset: the flight ring outlives
        sessions, and re-issuing tid 1.. to the new session's threads
        would merge a pre-session thread's ring events with an
        unrelated post-session thread's lane in a postmortem bundle."""
        with self._lock:
            self._generation += 1
            self._buffers = []
            self.enabled = True
            self.active = True

    def disable(self):
        """Stop recording; buffered events stay readable for export."""
        self.enabled = False
        self.active = self.flight is not None

    def clear(self):
        """Drop all events; recording state unchanged.  Lane ids keep
        counting up (see :meth:`enable`)."""
        with self._lock:
            self._generation += 1
            self._buffers = []

    # -- readback / export --------------------------------------------- #

    def events(self) -> List[Dict[str, Any]]:
        """All recorded events, globally sorted by timestamp."""
        with self._lock:
            buffers = [(tid, name, list(buf))
                       for tid, name, buf in self._buffers]
        merged = [ev for _, _, buf in buffers for ev in buf]
        merged.sort(key=lambda e: e["ts"])
        return merged

    def thread_names(self) -> Dict[int, str]:
        with self._lock:
            return {tid: name for tid, name, _ in self._buffers}

    def export_chrome(self, path: str):
        """Write Chrome ``trace_event`` JSON (open in chrome://tracing
        or https://ui.perfetto.dev)."""
        pid = os.getpid()
        trace_events = [
            {
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": tid, "args": {"name": name},
            }
            for tid, name in sorted(self.thread_names().items())
        ]
        for ev in self.events():
            out = {
                "name": ev["name"],
                "cat": ev["cat"],
                "ph": ev["ph"],
                "ts": ev["ts"],
                "pid": pid,
                "tid": ev["tid"],
                "args": dict(ev.get("args") or {}),
            }
            if ev["ph"] == "X":
                out["dur"] = ev["dur"]
            else:
                out["s"] = "t"  # thread-scoped instant
            # Correlation ids ride in args: the Chrome schema has no
            # parent field for X events, and viewers ignore extras.
            out["args"]["span_id"] = ev.get("id", 0)
            out["args"]["parent_id"] = ev.get("parent", 0)
            trace_events.append(out)
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "traceEvents": trace_events,
                    "displayTimeUnit": "ms",
                    # Viewers ignore unknown top-level keys; trace
                    # merge reads the identity + clock anchor here.
                    HEADER_KEY: trace_header(),
                },
                f, default=str,
            )
        os.replace(tmp, path)

    def export_jsonl(self, path: str):
        """One JSON event per line (jq/pandas-friendly); the first
        line is the process-identity/clock-anchor header."""
        names = self.thread_names()
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps({HEADER_KEY: trace_header()}) + "\n")
            for ev in self.events():
                row = dict(ev)
                row["thread"] = names.get(ev["tid"], str(ev["tid"]))
                f.write(json.dumps(row, default=str) + "\n")
        os.replace(tmp, path)

    def export(self, path: str, fmt: str = "chrome"):
        if fmt == "chrome":
            self.export_chrome(path)
        elif fmt == "jsonl":
            self.export_jsonl(path)
        else:
            raise ValueError(
                f"unknown trace format {fmt!r}: use 'chrome' or 'jsonl'"
            )


tracer = Tracer()


def get_tracer() -> Tracer:
    return tracer


# --------------------------------------------------------------------- #
# trace-file readback + analysis (pydcop trace summary, make trace-demo)


def _parse_trace(path: str) -> Tuple[Optional[Dict[str, Any]],
                                     List[Dict[str, Any]],
                                     Dict[Any, str]]:
    """Internal loader: ``(header, events, thread_names)``.

    ``thread_names`` maps tid -> label, recovered from Chrome
    ``thread_name`` metadata events or per-event ``thread`` fields
    (JSONL) — :func:`merge_traces` labels merged lanes with these.
    """
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError as exc:
        raise TraceFileError(f"cannot read trace file {path}: {exc}")
    if not text.strip():
        raise TraceFileError(f"trace file {path} is empty")
    header: Optional[Dict[str, Any]] = None
    try:
        # One JSON document: the Chrome container, a bare list, or a
        # single-line JSONL file (one event object).
        data = json.loads(text)
        if isinstance(data, dict):
            header = data.get(HEADER_KEY)
            if header is not None and not isinstance(header, dict):
                raise TraceFileError(
                    f"trace file {path} has a corrupt header: "
                    f"{HEADER_KEY} is {type(header).__name__}, "
                    "not an object")
            events = data.get("traceEvents")
            if events is None:
                if "ph" not in data:
                    raise TraceFileError(
                        f"{path} parsed as JSON but is not a trace "
                        "(no traceEvents list, not an event object)")
                events = [data]
        else:
            events = data
    except json.JSONDecodeError as exc:
        # Multiple documents: JSONL, one event per line.  A line that
        # does not parse means a truncated/corrupt file — say so.
        events = []
        for n, line in enumerate(text.splitlines(), start=1):
            if not line.strip():
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                if n == 1:
                    if line.lstrip().startswith(
                            '{"' + HEADER_KEY):
                        # The exporter writes the header first, so a
                        # process killed mid-write most often tears
                        # exactly this line — name the failure.
                        raise TraceFileError(
                            f"trace file {path} has a truncated or "
                            "corrupt header line (process died "
                            "mid-export?)")
                    raise TraceFileError(
                        f"{path} is neither Chrome-trace JSON "
                        f"({exc}) nor JSONL (line 1 unparsable)"
                    )
                raise TraceFileError(
                    f"trace file {path} is truncated or corrupt: "
                    f"line {n} is not valid JSON"
                )
            if isinstance(row, dict) and HEADER_KEY in row:
                header = row[HEADER_KEY]
                if not isinstance(header, dict):
                    raise TraceFileError(
                        f"trace file {path} has a corrupt header: "
                        f"{HEADER_KEY} is {type(header).__name__}, "
                        "not an object")
                continue
            events.append(row)
    if not isinstance(events, list):
        raise TraceFileError(
            f"{path} parsed as JSON but holds no event list")
    names: Dict[Any, str] = {}
    kept = []
    for ev in events:
        if not isinstance(ev, dict) or "ph" not in ev:
            continue
        if ev.get("ph") == "M":
            if ev.get("name") == "thread_name":
                label = (ev.get("args") or {}).get("name")
                if label:
                    names[ev.get("tid")] = str(label)
            continue
        if ev.get("thread"):
            names.setdefault(ev.get("tid"), str(ev["thread"]))
        kept.append(ev)
    if events and not kept:
        raise TraceFileError(
            f"{path} parsed as JSON but holds no trace events")
    return header, kept, names


def load_trace(path: str
               ) -> Tuple[Optional[Dict[str, Any]],
                          List[Dict[str, Any]]]:
    """Load ``(header, events)`` from a Chrome-trace JSON or JSONL
    trace file.

    ``header`` is the process-identity/clock-anchor record written by
    the exporters (None for traces from before headers existed).
    Events come back in the normalized internal shape (name/cat/ph/
    ts/dur/tid/args); Chrome metadata events (``ph:"M"``) and the
    header row are dropped from the event list.

    Raises :class:`TraceFileError` — never a bare decode traceback —
    on a missing, empty, truncated or non-trace file.
    """
    header, events, _ = _parse_trace(path)
    return header, events


def load_trace_file(path: str) -> List[Dict[str, Any]]:
    """Events only — see :func:`load_trace` for the (header, events)
    form and the error contract."""
    return load_trace(path)[1]


def _clock_anchor_offset(header: Optional[Dict[str, Any]],
                         path: str) -> Optional[float]:
    """The file's perf_counter→wall-clock rebase offset (µs), or
    None for a legacy headerless/anchorless trace (degraded-merge
    mode).  A header that CARRIES anchor fields but cannot yield a
    finite offset — one field missing, a non-numeric value, NaN/Inf —
    is corrupt, not legacy: raise a :class:`TraceFileError` naming
    the file instead of letting a KeyError/ValueError escape
    mid-merge."""
    if not header:
        return None
    a_unix = header.get("anchor_unix_us")
    a_perf = header.get("anchor_perf_us")
    if a_unix is None and a_perf is None:
        return None
    try:
        a_unix = float(a_unix)
        a_perf = float(a_perf)
    except (TypeError, ValueError):
        raise TraceFileError(
            f"trace file {path} has a corrupt clock anchor in its "
            f"header (anchor_unix_us={header.get('anchor_unix_us')!r}"
            f", anchor_perf_us={header.get('anchor_perf_us')!r})")
    if not (math.isfinite(a_unix) and math.isfinite(a_perf)):
        raise TraceFileError(
            f"trace file {path} has a non-finite clock anchor in "
            f"its header ({a_unix}, {a_perf})")
    return a_unix - a_perf


def _alignment_offsets(
        loaded: Sequence[Tuple[str, Optional[Dict[str, Any]],
                               List[Dict[str, Any]]]]
) -> Tuple[List[float], List[bool]]:
    """The shared alignment core of ``merge_traces`` and
    ``load_events_aligned``: per-file rebase offsets (µs) plus which
    files carried a clock anchor.  All anchored → wall-clock
    offsets; any file anchorless (legacy) → degraded mode, every file
    rebased to its own first event.  Raises :class:`TraceFileError`
    (via :func:`_clock_anchor_offset`) on corrupt anchors."""
    anchors = [_clock_anchor_offset(header, path)
               for path, header, _ in loaded]
    anchored = [off is not None for off in anchors]
    if all(anchored):
        return list(anchors), anchored
    return [
        -min((float(ev["ts"]) for ev in events if "ts" in ev),
             default=0.0)
        for _, _, events in loaded
    ], anchored


def merge_traces(paths: Sequence[str], out_path: str
                 ) -> Dict[str, Any]:
    """Align and merge N per-process trace files into one Chrome
    trace; returns a summary dict (files, events, lanes, offsets).

    Alignment: each file's header anchors its process-local
    ``perf_counter`` timeline to the wall clock, so events are
    rebased as ``ts + (anchor_unix_us - anchor_perf_us)`` — after
    which all files share one axis — then shifted so the earliest
    merged event sits at 0.  When ANY input lacks an anchor
    (headerless legacy trace), wall-clock alignment is impossible, so
    EVERY file degrades to starting at 0 on the merged axis —
    mixing a wall-rebased file with a raw-``perf_counter`` one would
    otherwise scatter the lanes decades apart.  The summary's
    ``aligned`` flag says which mode applied.

    Lanes: every (file, tid) pair maps to a FRESH merged tid, so two
    processes' thread-1 lanes can never collide, and each lane is
    labeled ``host:pid thread-name`` (thread names recovered from
    Chrome ``thread_name`` metadata or JSONL ``thread`` fields).
    Span correlation ids are namespaced per file for the same reason.
    Per-lane nesting is preserved (a uniform per-file shift cannot
    reorder spans within a lane), so ``check_well_nested`` holds on
    the merged trace iff it held on the inputs.

    Shard lanes: events tagged with a scalar ``shard`` arg (the
    partitioned engine's per-shard ``shard_segment`` instants —
    engine/runner.py) are demuxed onto their own
    ``(file, tid, shard)`` lane labeled ``... [shard N]``, so a
    sharded solve reads as one lane per shard in Perfetto instead of
    an interleaved pile on the dispatching host thread.
    """
    if len(paths) < 2:
        raise TraceFileError("trace merge needs at least two files")
    loaded = []
    for path in paths:
        header, events, names = _parse_trace(path)
        loaded.append((path, header, events, names))
    offsets, anchored = _alignment_offsets(
        [(path, header, events)
         for path, header, events, _ in loaded])
    aligned = all(anchored)
    base = min(
        (float(ev["ts"]) + off
         for (_, _, events, _), off in zip(loaded, offsets)
         for ev in events if "ts" in ev),
        default=0.0,
    )
    lane_map: Dict[Tuple[int, Any], int] = {}
    lane_names: Dict[int, str] = {}
    merged: List[Dict[str, Any]] = []
    _ID_STRIDE = 10 ** 9  # far above any single-process span count

    def _lane(fi: int, tid, label: str) -> int:
        key = (fi, tid)
        if key not in lane_map:
            lane_map[key] = len(lane_map) + 1
            lane_names[lane_map[key]] = label
        return lane_map[key]

    for fi, ((path, header, events, names), off) in enumerate(
            zip(loaded, offsets)):
        who = (f"{header.get('host', '?')}:{header.get('pid', '?')}"
               if header else f"file{fi}")
        for ev in events:
            out = dict(ev)
            out["ts"] = float(ev.get("ts", 0.0)) + off - base
            thread = (names.get(ev.get("tid"))
                      or str(ev.get("tid", "?")))
            shard = (ev.get("args") or {}).get("shard")
            if isinstance(shard, (int, str)) and not isinstance(
                    shard, bool):
                out["tid"] = _lane(
                    fi, (ev.get("tid"), "shard", shard),
                    f"{who} {thread} [shard {shard}]")
            else:
                out["tid"] = _lane(fi, ev.get("tid"),
                                   f"{who} {thread}")
            out.pop("thread", None)
            # Correlation ids (top-level in JSONL events, inside args
            # for re-loaded Chrome exports): namespace per file so
            # cross-process id reuse cannot fake a parent link.
            # Integer ids only — foreign Chrome traces (JAX profiler,
            # chrome://tracing async events) carry string ids like
            # "0x42", which pass through untouched rather than crash.
            for holder, id_key, parent_key in (
                    (out, "id", "parent"),
                    (out.get("args") or {}, "span_id", "parent_id")):
                for k in (id_key, parent_key):
                    value = holder.get(k)
                    if isinstance(value, int) and value:
                        holder[k] = value + fi * _ID_STRIDE
            merged.append(out)
    merged.sort(key=lambda e: e["ts"])
    trace_events = [
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
         "args": {"name": name}}
        for tid, name in sorted(lane_names.items())
    ]
    for ev in merged:
        out = {
            "name": ev.get("name"), "cat": ev.get("cat", "default"),
            "ph": ev.get("ph"), "ts": ev["ts"], "pid": 0,
            "tid": ev["tid"], "args": dict(ev.get("args") or {}),
        }
        if ev.get("ph") == "X":
            out["dur"] = ev.get("dur", 0.0)
        else:
            out["s"] = "t"
        if ev.get("id"):
            out["args"].setdefault("span_id", ev["id"])
        if ev.get("parent"):
            out["args"].setdefault("parent_id", ev["parent"])
        trace_events.append(out)
    tmp = f"{out_path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            HEADER_KEY: {
                "version": _HEADER_VERSION,
                "merged_from": [
                    {"path": p, "header": h, "clock_anchor": anch}
                    for (p, h, _, _), anch in zip(loaded, anchored)
                ],
                "aligned": aligned,
            },
        }, f, default=str)
    os.replace(tmp, out_path)
    return {
        "files": len(paths),
        "events": len(merged),
        "lanes": len(lane_names),
        "anchored": sum(anchored),
        "aligned": aligned,
        "span_us": (merged[-1]["ts"] - merged[0]["ts"]
                    if merged else 0.0),
    }


def load_events_aligned(paths: Sequence[str]
                        ) -> List[Dict[str, Any]]:
    """The in-memory form of :func:`merge_traces` for analysis
    commands (``pydcop trace query`` over several per-process
    files): one file loads as-is; several load rebased onto one axis
    via their clock anchors (degrading to per-file zero like merge
    when any input is anchorless) with lanes namespaced per file so
    two processes' thread-1 lanes never collide.  Raises
    :class:`TraceFileError` on unreadable files or corrupt
    anchors."""
    if not paths:
        raise TraceFileError("no trace files given")
    loaded = []
    for path in paths:
        header, events, _ = _parse_trace(path)
        loaded.append((path, header, events))
    if len(loaded) == 1:
        return list(loaded[0][2])
    offsets, _ = _alignment_offsets(loaded)
    # Shift so the earliest event lands at ~0, exactly like
    # merge_traces: wall-clock rebasing alone leaves epoch-scale µs
    # timestamps, which would make the query output (ts_ms) unreadable
    # for precisely the cross-process case this path exists for.
    base = min(
        (float(ev["ts"]) + off
         for (_, _, events), off in zip(loaded, offsets)
         for ev in events if "ts" in ev),
        default=0.0)
    out: List[Dict[str, Any]] = []
    for fi, ((path, header, events), off) in enumerate(
            zip(loaded, offsets)):
        for ev in events:
            row = dict(ev)
            row["ts"] = float(ev.get("ts", 0.0)) + off - base
            row["tid"] = f"{fi}:{ev.get('tid')}"
            out.append(row)
    out.sort(key=lambda e: e["ts"])
    return out


def _per_name_stats(events: Iterable[Dict[str, Any]]
                    ) -> Dict[str, Dict[str, float]]:
    durs: Dict[str, List[float]] = defaultdict(list)
    for ev in events:
        if ev.get("ph") == "X":
            durs[ev.get("name") or "?"].append(
                float(ev.get("dur", 0.0)) / 1000.0)
        elif ev.get("ph") == "i":
            durs[ev.get("name") or "?"].append(0.0)
    out = {}
    for name, values in durs.items():
        values.sort()
        out[name] = {
            "count": len(values),
            "total_ms": sum(values),
            "p50_ms": values[len(values) // 2] if values else 0.0,
        }
    return out


def diff_trace_summaries(events_a: Iterable[Dict[str, Any]],
                         events_b: Iterable[Dict[str, Any]],
                         threshold: float = 0.25,
                         min_delta_ms: float = 1.0,
                         ) -> List[Dict[str, Any]]:
    """Per-span-name deltas between two traces (A = baseline, B =
    candidate): count, total and p50 duration on each side, and a
    ``regressed`` flag when B's total grew beyond ``threshold``
    (relative) AND ``min_delta_ms`` (absolute — spans in the noise
    floor never flag).  Span names present on only one side are
    reported with zeros on the other; a name absent from A has no
    defined relative growth, so ``delta_rel`` is None there (NOT
    float('inf'), which json.dumps would emit as the non-JSON token
    ``Infinity``) and only the absolute floor gates its flag.
    Sorted by absolute total delta, largest first."""
    stats_a = _per_name_stats(events_a)
    stats_b = _per_name_stats(events_b)
    rows = []
    for name in sorted(set(stats_a) | set(stats_b)):
        a = stats_a.get(name, {"count": 0, "total_ms": 0.0,
                               "p50_ms": 0.0})
        b = stats_b.get(name, {"count": 0, "total_ms": 0.0,
                               "p50_ms": 0.0})
        delta = b["total_ms"] - a["total_ms"]
        rel = (delta / a["total_ms"] if a["total_ms"] > 0
               else (None if delta > 0 else 0.0))
        rows.append({
            "name": name,
            "count_a": a["count"], "count_b": b["count"],
            "total_ms_a": a["total_ms"], "total_ms_b": b["total_ms"],
            "p50_ms_a": a["p50_ms"], "p50_ms_b": b["p50_ms"],
            "delta_total_ms": delta,
            "delta_rel": rel,
            "regressed": (delta >= min_delta_ms
                          and (rel is None or rel >= threshold)),
        })
    rows.sort(key=lambda r: -abs(r["delta_total_ms"]))
    return rows


def summarize_spans(events: Iterable[Dict[str, Any]],
                    by: str = "name", top: Optional[int] = None
                    ) -> List[Dict[str, Any]]:
    """Aggregate complete spans by ``name`` (or ``cat``): count, total
    / mean / max duration in ms, sorted by total descending.  Instant
    events aggregate with zero duration (their counts still matter —
    fault drops and breaker trips are instants)."""
    agg: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0, 0.0])
    for ev in events:
        if ev.get("ph") not in ("X", "i"):
            continue
        key = ev.get(by) or "?"
        dur_ms = float(ev.get("dur", 0.0)) / 1000.0
        entry = agg[key]
        entry[0] += 1
        entry[1] += dur_ms
        entry[2] = max(entry[2], dur_ms)
    rows = [
        {
            by: key, "count": count, "total_ms": total,
            "mean_ms": total / count if count else 0.0, "max_ms": mx,
        }
        for key, (count, total, mx) in agg.items()
    ]
    rows.sort(key=lambda r: (-r["total_ms"], -r["count"], r[by]))
    return rows[:top] if top else rows


def event_matches_request(ev: Dict[str, Any],
                          trace_id: str) -> bool:
    """True when the event is tagged with this request's trace id —
    either directly (``args.trace_id``, request-scoped events) or as
    a member of a batch (``args.trace_ids``, the dispatch-context
    tag every engine event under a serve dispatch inherits)."""
    args = ev.get("args") or {}
    if args.get("trace_id") == trace_id:
        return True
    ids = args.get("trace_ids")
    return (isinstance(ids, (list, tuple))
            and trace_id in ids)


def query_request(events: Iterable[Dict[str, Any]],
                  trace_id: str) -> Dict[str, Any]:
    """One request's span tree out of a (possibly merged) trace.

    Filters events tagged with ``trace_id`` (see
    :func:`event_matches_request`) and rebuilds their causal tree:
    within each thread lane, spans nest by time containment (the
    per-thread span stack guarantees matched spans on one lane nest
    properly); instants attach to the innermost containing span.
    Lanes are stitched under one synthetic request root ordered by
    time, so a request that crossed threads/processes (submit on an
    HTTP handler, queue+dispatch+engine on the scheduler — rebased
    lanes after a merge) still reads as a single tree.

    Returns ``{trace_id, events, spans, instants, lanes, names,
    well_nested, tree}`` — ``tree`` is a list of root nodes, each
    ``{name, cat, ph, ts_ms, dur_ms, tid, args, children}``;
    ``well_nested`` is False when the matched spans violate per-lane
    nesting (a corrupted or mis-merged trace)."""
    matched = [ev for ev in events
               if ev.get("ph") in ("X", "i")
               and event_matches_request(ev, trace_id)]
    spans = [ev for ev in matched if ev.get("ph") == "X"]
    instants = [ev for ev in matched if ev.get("ph") == "i"]
    try:
        check_well_nested(spans)
        well_nested = True
    except (ValueError, KeyError, TypeError):
        well_nested = False

    def _node(ev: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "name": ev.get("name"),
            "cat": ev.get("cat", "default"),
            "ph": ev.get("ph"),
            "ts_ms": float(ev.get("ts", 0.0)) / 1000.0,
            "dur_ms": float(ev.get("dur", 0.0)) / 1000.0,
            "tid": ev.get("tid"),
            "args": dict(ev.get("args") or {}),
            "children": [],
        }

    roots: List[Dict[str, Any]] = []
    by_tid: Dict[Any, List[Dict[str, Any]]] = defaultdict(list)
    for ev in spans:
        by_tid[ev.get("tid")].append(ev)
    for tid_spans in by_tid.values():
        tid_spans.sort(key=lambda e: (float(e.get("ts", 0.0)),
                                      -float(e.get("dur", 0.0))))
        stack: List[tuple] = []  # (end_ts, node)
        for ev in tid_spans:
            start = float(ev.get("ts", 0.0))
            end = start + float(ev.get("dur", 0.0))
            node = _node(ev)
            while stack and start >= stack[-1][0] - 1.0:
                stack.pop()
            if stack:
                stack[-1][1]["children"].append(node)
            else:
                roots.append(node)
            stack.append((end, node))
    # Instants: innermost containing matched span on the same lane,
    # else a root of their own.
    for ev in instants:
        ts = float(ev.get("ts", 0.0))
        tid = ev.get("tid")
        best = None
        best_span = None

        def _walk(node):
            nonlocal best, best_span
            start = node["ts_ms"] * 1000.0
            end = start + node["dur_ms"] * 1000.0
            if (node["ph"] == "X" and node["tid"] == tid
                    and start - 1.0 <= ts <= end + 1.0):
                span_len = end - start
                if best is None or span_len < best:
                    best = span_len
                    best_span = node
            for child in node["children"]:
                _walk(child)

        for root in roots:
            _walk(root)
        node = _node(ev)
        if best_span is not None:
            best_span["children"].append(node)
        else:
            roots.append(node)
    roots.sort(key=lambda n: n["ts_ms"])
    for root in roots:
        root["children"].sort(key=lambda n: n["ts_ms"])
    return {
        "trace_id": trace_id,
        "events": len(matched),
        "spans": len(spans),
        "instants": len(instants),
        "lanes": len({ev.get("tid") for ev in matched}),
        "names": sorted({ev.get("name") for ev in matched}),
        "well_nested": well_nested,
        "tree": roots,
    }


def check_well_nested(events: Iterable[Dict[str, Any]]) -> None:
    """Raise ``ValueError`` unless, per thread, complete spans form a
    proper nesting (every pair either disjoint or contained).  Spans
    are recorded via a per-thread stack, so a violation means a
    corrupted trace file — ``make trace-demo`` gates on this."""
    by_tid: Dict[Any, List[tuple]] = defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        ts = float(ev["ts"])
        by_tid[ev.get("tid")].append((ts, ts + float(ev["dur"]), ev))
    eps = 1.0  # µs of timer slack between adjacent spans
    for tid, spans in by_tid.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: List[tuple] = []
        for start, end, ev in spans:
            while stack and start >= stack[-1][1] - eps:
                stack.pop()
            if stack and end > stack[-1][1] + eps:
                raise ValueError(
                    f"span {ev.get('name')!r} [{start:.0f}, {end:.0f}] "
                    f"on tid {tid} overlaps enclosing span "
                    f"{stack[-1][2].get('name')!r} "
                    f"[{stack[-1][0]:.0f}, {stack[-1][1]:.0f}] "
                    "without nesting"
                )
            stack.append((start, end, ev))
