"""``python -m pydcop_tpu_torch trace``: inspect, merge and compare
trace files (port of ``pydcop_tpu/commands/trace.py``; the trace files
of either package read the same).

``trace summary FILE`` prints top-k span aggregates (count,
total/mean/max duration) from a Chrome ``trace_event`` JSON or a JSONL
trace — the quick "where did the time go" answer that does not need a
browser (``--json`` emits the same rows machine-readably, the input
side of ``trace diff`` and CI assertions).  Instant events (fault
injections, breaker trips, message sends) aggregate with zero
duration; their counts are the point.

``trace query --request ID FILE [FILE...]`` reconstructs ONE
request's span tree out of a trace: every span/instant tagged with
the request's ``trace_id`` (directly, or via a dispatch's
``trace_ids`` batch tag) is filtered out and re-nested by time
containment per lane, then stitched under one root ordered by time —
the submit, queue wait, serve dispatch and engine segments of a
single request, even when they crossed threads or processes
(multiple files are clock-anchor aligned like ``merge``).  The
trace_id comes from the submit ack (HTTP ``trace_id`` field), a
latency-histogram exemplar, or ``/stats``.

``trace merge OUT IN1 IN2 ...`` aligns N per-process traces on
one wall-clock axis (each exported trace carries a monotonic-to-wall
anchor in its header; offsets are corrected per file) and namespaces
their thread lanes, producing one Chrome trace for the whole
multi-process run.  ``trace diff A B`` compares two traces
span-name by span-name (count/total/p50 deltas) and exits 1 when a
span regressed beyond ``--threshold`` — the trace-level counterpart
of the bench sentinel.

All subcommands print a one-line error (exit 2) instead of a
traceback on empty/truncated/non-trace files.
"""

import json
import sys


def set_parser(subparsers):
    parser = subparsers.add_parser(
        "trace", help="inspect, merge and compare trace files")
    trace_sub = parser.add_subparsers(
        title="trace commands", dest="trace_command")

    summary = trace_sub.add_parser(
        "summary", help="top-k span aggregates of a trace file")
    summary.add_argument("trace_file", help="chrome-JSON or JSONL "
                                            "trace file")
    summary.add_argument("--top", type=int, default=15,
                         help="rows to print (default 15)")
    summary.add_argument("--by", default="name",
                         choices=["name", "cat"],
                         help="aggregate by span name or category")
    summary.add_argument("--json", action="store_true",
                         dest="as_json",
                         help="emit the summary as one JSON document "
                              "(machine-readable; used by trace diff "
                              "pipelines and CI)")
    summary.set_defaults(func=run_summary)

    merge = trace_sub.add_parser(
        "merge", help="merge N per-process traces into one aligned "
                      "Chrome trace")
    merge.add_argument("out_file", help="merged Chrome-trace output")
    merge.add_argument("trace_files", nargs="+",
                       help="two or more input traces (chrome or "
                            "jsonl; clock-anchor headers align them)")
    merge.set_defaults(func=run_merge)

    diff = trace_sub.add_parser(
        "diff", help="per-span-name count/total/p50 deltas between "
                     "two traces")
    diff.add_argument("trace_a", help="baseline trace")
    diff.add_argument("trace_b", help="candidate trace")
    diff.add_argument("--threshold", type=float, default=0.25,
                      help="relative total-duration growth that "
                           "flags a regression (default 0.25)")
    diff.add_argument("--min_delta_ms", type=float, default=1.0,
                      help="absolute growth floor below which a span "
                           "never flags (default 1 ms)")
    diff.add_argument("--json", action="store_true", dest="as_json",
                      help="emit the full diff rows as JSON")
    diff.set_defaults(func=run_diff)

    query = trace_sub.add_parser(
        "query", help="one request's span tree out of a trace "
                      "(filter by trace_id, re-nest, print)")
    query.add_argument("trace_files", nargs="+",
                       help="one or more trace files (several are "
                            "clock-anchor aligned like merge)")
    query.add_argument("--request", required=True, metavar="TRACE_ID",
                       help="the request's trace_id (from the submit "
                            "ack, a latency exemplar, or /stats)")
    query.add_argument("--json", action="store_true", dest="as_json",
                       help="emit the reconstructed tree as JSON")
    query.set_defaults(func=run_query)

    parser.set_defaults(func=_no_subcommand(parser))


def _no_subcommand(parser):
    def run(_args) -> int:
        parser.print_help(sys.stderr)
        return 2

    return run


def _load(path):
    """load_trace_file with the command-level error contract."""
    from pydcop_tpu_torch.observability.trace import (
        TraceFileError,
        load_trace_file,
    )

    try:
        return load_trace_file(path)
    except TraceFileError as exc:
        print(f"pydcop_tpu_torch trace: {exc}", file=sys.stderr)
        return None


def run_summary(args) -> int:
    from pydcop_tpu_torch.observability.trace import summarize_spans

    events = _load(args.trace_file)
    if events is None:
        return 2
    rows = summarize_spans(events, by=args.by, top=args.top)
    spans = sum(1 for e in events if e.get("ph") == "X")
    instants = sum(1 for e in events if e.get("ph") == "i")
    threads = len({e.get("tid") for e in events})
    if args.as_json:
        print(json.dumps({
            "file": args.trace_file,
            "spans": spans,
            "instants": instants,
            "threads": threads,
            "by": args.by,
            "rows": rows,
        }))
        return 0
    print(f"{args.trace_file}: {spans} spans, {instants} instants, "
          f"{threads} threads")
    if not rows:
        print("no span events")
        return 0
    key_width = max(len(str(r[args.by])) for r in rows)
    key_width = max(key_width, len(args.by))
    header = (f"{args.by:<{key_width}}  {'count':>8}  "
              f"{'total_ms':>12}  {'mean_ms':>10}  {'max_ms':>10}")
    print(header)
    print("-" * len(header))
    for r in rows:
        print(f"{str(r[args.by]):<{key_width}}  {r['count']:>8}  "
              f"{r['total_ms']:>12.3f}  {r['mean_ms']:>10.3f}  "
              f"{r['max_ms']:>10.3f}")
    return 0


def run_merge(args) -> int:
    from pydcop_tpu_torch.observability.trace import (
        TraceFileError,
        merge_traces,
    )

    try:
        info = merge_traces(args.trace_files, args.out_file)
    except TraceFileError as exc:
        print(f"pydcop_tpu_torch trace: {exc}", file=sys.stderr)
        return 2
    align_note = (
        "wall-clock aligned" if info["aligned"]
        else f"{info['anchored']}/{info['files']} anchored — "
             "NOT aligned, each file rebased to its own start"
    )
    print(
        f"{args.out_file}: merged {info['files']} traces "
        f"({align_note}) -> {info['events']} events on "
        f"{info['lanes']} lanes, {info['span_us'] / 1000.0:.1f} ms "
        "span"
    )
    return 0


def run_query(args) -> int:
    from pydcop_tpu_torch.observability.trace import (
        TraceFileError,
        load_events_aligned,
        query_request,
    )

    try:
        events = load_events_aligned(args.trace_files)
    except TraceFileError as exc:
        print(f"pydcop_tpu_torch trace: {exc}", file=sys.stderr)
        return 2
    tree = query_request(events, args.request)
    if args.as_json:
        print(json.dumps(tree))
        return 0 if tree["events"] else 1
    if not tree["events"]:
        print(f"no events tagged trace_id={args.request!r} in "
              f"{len(args.trace_files)} file(s)", file=sys.stderr)
        return 1
    nesting = ("well-nested" if tree["well_nested"]
               else "NOT WELL-NESTED (corrupt or mis-merged trace?)")
    print(f"request {args.request}: {tree['spans']} spans, "
          f"{tree['instants']} instants on {tree['lanes']} lane(s), "
          f"{nesting}")

    def _print(node, depth):
        indent = "  " * depth
        if node["ph"] == "X":
            head = f"{node['name']} {node['dur_ms']:.3f} ms"
        else:
            head = f"* {node['name']}"
        extras = {k: v for k, v in node["args"].items()
                  if k not in ("trace_id", "trace_ids")}
        detail = (" " + " ".join(f"{k}={v}" for k, v
                                 in sorted(extras.items()))
                  if extras else "")
        print(f"{indent}{head} [{node['cat']}] "
              f"@{node['ts_ms']:.3f} ms (lane {node['tid']})"
              f"{detail}")
        for child in node["children"]:
            _print(child, depth + 1)

    for root in tree["tree"]:
        _print(root, 0)
    return 0


def run_diff(args) -> int:
    from pydcop_tpu_torch.observability.trace import diff_trace_summaries

    events_a = _load(args.trace_a)
    if events_a is None:
        return 2
    events_b = _load(args.trace_b)
    if events_b is None:
        return 2
    rows = diff_trace_summaries(
        events_a, events_b, threshold=args.threshold,
        min_delta_ms=args.min_delta_ms,
    )
    regressions = [r for r in rows if r["regressed"]]
    if args.as_json:
        print(json.dumps({
            "a": args.trace_a, "b": args.trace_b,
            "threshold": args.threshold,
            "regressions": len(regressions),
            "rows": rows,
        }))
        return 1 if regressions else 0
    name_w = max([len(r["name"]) for r in rows] + [4])
    header = (f"{'name':<{name_w}}  {'count a>b':>11}  "
              f"{'total_ms a':>11}  {'total_ms b':>11}  "
              f"{'p50 a':>8}  {'p50 b':>8}  {'delta':>9}")
    print(f"{args.trace_a} -> {args.trace_b}")
    print(header)
    print("-" * len(header))
    for r in rows:
        flag = "  << REGRESSED" if r["regressed"] else ""
        print(
            f"{r['name']:<{name_w}}  "
            f"{r['count_a']:>5}>{r['count_b']:<5}  "
            f"{r['total_ms_a']:>11.3f}  {r['total_ms_b']:>11.3f}  "
            f"{r['p50_ms_a']:>8.3f}  {r['p50_ms_b']:>8.3f}  "
            f"{r['delta_total_ms']:>+9.3f}{flag}"
        )
    if regressions:
        print(f"{len(regressions)} span(s) regressed beyond "
              f"{args.threshold:.0%} (+{args.min_delta_ms} ms)")
        return 1
    return 0
