"""``python -m pydcop_tpu_torch fleet``: request forensics over the
fleet trace plane.

A copy of ``pydcop_tpu/commands/fleet.py`` (the same flags, output and
exit codes).  ``fleet forensics REQUEST_ID --url http://ROUTER`` asks a
RUNNING router for ``/fleet/forensics/<id>`` — the request's causal
tree reconstructed from the router-merged trace: the admission span,
every route pick (replica + affinity/spill reason), injected faults
and NotSent-vs-ambiguous retries, dedupe hits on the winning replica,
and that replica's serve ledger (queue wait, dispatch, engine
segments), printed as one annotated timeline.

``fleet forensics REQUEST_ID --trace FILE [FILE...]`` answers the same
question offline from a saved ``/fleet/trace`` document (or any
exported trace files): the id is resolved to its ``trace_id`` by
scanning span args, then the tree is rebuilt with the same
per-lane-nesting machinery as ``trace query``.

Exit codes: 0 printed a tree, 1 unknown request, 2 bad input
(unreachable router / unreadable trace file).
"""

import json
import sys

# Router instants that deserve a callout in the timeline: the name
# maps to the annotation prefix the printer attaches.
_ANNOTATIONS = {
    "router_route_pick": "route-pick",
    "router_repick": "REPICK",
    "router_retry": "RETRY",
    "router_fence_flush": "fence-flush",
    "router_migrate": "MIGRATE",
    "router_session_events": "events-batch",
    "router_session_open": "session-open",
    "serve_dedupe": "DEDUPE-HIT",
    "netfault_injected": "FAULT",
}


def set_parser(subparsers):
    parser = subparsers.add_parser(
        "fleet", help="fleet-wide observability: request forensics")
    fleet_sub = parser.add_subparsers(
        title="fleet commands", dest="fleet_command")

    forensics = fleet_sub.add_parser(
        "forensics",
        help="one request's causal tree across router and replicas")
    forensics.add_argument(
        "request_id",
        help="router-minted request id (the 'request_id' in the "
             "submit ack), or a session id")
    forensics.add_argument(
        "--url", default=None, metavar="URL",
        help="router base url (e.g. http://127.0.0.1:8099); asks "
             "the live /fleet/forensics surface")
    forensics.add_argument(
        "--trace", default=None, nargs="+", metavar="FILE",
        help="offline mode: saved /fleet/trace JSON or exported "
             "trace files (several are clock-anchor aligned)")
    forensics.add_argument(
        "--timeout", type=float, default=10.0,
        help="HTTP timeout for --url (seconds, default 10)")
    forensics.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the reconstructed tree as one JSON document")
    forensics.set_defaults(func=run_forensics)

    parser.set_defaults(func=_no_subcommand(parser))


def _no_subcommand(parser):
    def run(_args) -> int:
        parser.print_help(sys.stderr)
        return 2

    return run


def fetch_forensics(url: str, request_id: str,
                    timeout: float = 10.0):
    """GET the router's live forensics doc.  Returns (doc, None) on
    200, (None, message) otherwise — a 404 message means the id is
    unknown, anything else means the router was unreachable/refused."""
    from urllib.error import HTTPError, URLError
    from urllib.request import urlopen

    endpoint = (url.rstrip("/") + "/fleet/forensics/"
                + request_id.strip("/"))
    try:
        with urlopen(endpoint, timeout=timeout) as resp:  # noqa: S310
            return json.loads(resp.read()), None
    except HTTPError as exc:
        try:
            detail = json.loads(exc.read()).get("error", "")
        except ValueError:
            detail = ""
        return None, f"{exc.code}: {detail or exc.reason}"
    except (URLError, OSError, ValueError) as exc:
        return None, f"router unreachable: {exc}"


def _events_from_files(paths):
    """Load events from saved /fleet/trace docs OR plain trace files
    (mixed is fine): a fleet doc's events are already merged/rebased;
    plain files go through the clock-anchor aligner."""
    from pydcop_tpu_torch.observability.trace import (
        TraceFileError,
        load_events_aligned,
    )

    fleet_docs, plain = [], []
    for path in paths:
        try:
            with open(path, encoding="utf-8") as fh:
                head = json.load(fh)
        except (OSError, ValueError):
            head = None
        if isinstance(head, dict) and "sources" in head \
                and isinstance(head.get("events"), list):
            fleet_docs.append(head)
        else:
            plain.append(path)
    events = []
    for doc in fleet_docs:
        events.extend(doc["events"])
    if plain:
        events.extend(load_events_aligned(plain))
    return events


def resolve_trace_id(events, request_id: str):
    """Find the trace_id a request/session id belongs to by scanning
    span args (the router tags every fleet event with both)."""
    for ev in events:
        args = ev.get("args") or {}
        if request_id in (args.get("request"), args.get("session")):
            tid = args.get("trace_id")
            if tid:
                return tid
    return None


def print_forensics(doc, request_id: str, out=None) -> None:
    """The annotated timeline: ``trace query``'s tree printer plus
    fleet callouts (route picks, retries, dedupe hits, faults).

    ``out`` is resolved at call time (a ``sys.stdout`` default would
    freeze whatever stream was installed at import)."""
    out = out if out is not None else sys.stdout
    nesting = ("well-nested" if doc.get("well_nested")
               else "NOT WELL-NESTED (lossy shipping or clock skew?)")
    dropped = doc.get("dropped_spans")
    loss = (f", {dropped} span(s) dropped fleet-wide"
            if dropped else "")
    print(f"request {request_id} (trace {doc.get('trace_id')}): "
          f"{doc.get('spans', 0)} spans, {doc.get('instants', 0)} "
          f"instants on {doc.get('lanes', 0)} lane(s), "
          f"{nesting}{loss}", file=out)

    def _print(node, depth):
        indent = "  " * depth
        mark = _ANNOTATIONS.get(node["name"])
        if node["ph"] == "X":
            head = f"{node['name']} {node['dur_ms']:.3f} ms"
        else:
            head = f"* {node['name']}"
        if mark:
            head = f"[{mark}] {head}"
        extras = {k: v for k, v in (node.get("args") or {}).items()
                  if k not in ("trace_id", "trace_ids")}
        detail = (" " + " ".join(f"{k}={v}" for k, v
                                 in sorted(extras.items()))
                  if extras else "")
        print(f"{indent}{head} [{node['cat']}] "
              f"@{node['ts_ms']:.3f} ms (lane {node['tid']})"
              f"{detail}", file=out)
        for child in node.get("children", ()):
            _print(child, depth + 1)

    for root in doc.get("tree", ()):
        _print(root, 0)


def run_forensics(args) -> int:
    if bool(args.url) == bool(args.trace):
        print("pydcop fleet forensics: pass exactly one of --url "
              "(live router) or --trace FILE (offline)",
              file=sys.stderr)
        return 2

    if args.url:
        doc, err = fetch_forensics(args.url, args.request_id,
                                   args.timeout)
        if doc is None:
            print(f"pydcop fleet forensics: {err}", file=sys.stderr)
            return 1 if err and err.startswith("404") else 2
    else:
        from pydcop_tpu_torch.observability.trace import (
            TraceFileError,
            query_request,
        )

        try:
            events = _events_from_files(args.trace)
        except TraceFileError as exc:
            print(f"pydcop fleet forensics: {exc}", file=sys.stderr)
            return 2
        trace_id = resolve_trace_id(events, args.request_id)
        if trace_id is None:
            print(f"pydcop fleet forensics: no span mentions request "
                  f"{args.request_id!r} in {len(args.trace)} "
                  "file(s)", file=sys.stderr)
            return 1
        doc = query_request(events, trace_id)
        doc["request_id"] = args.request_id

    if args.as_json:
        print(json.dumps(doc))
        return 0 if doc.get("events") else 1
    if not doc.get("events"):
        print(f"pydcop fleet forensics: trace for "
              f"{args.request_id!r} is empty", file=sys.stderr)
        return 1
    print_forensics(doc, args.request_id)
    return 0
