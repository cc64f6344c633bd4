"""``python -m pydcop_tpu_torch profile``: the where-the-time-went
analyzer (port of ``pydcop_tpu/commands/profile.py``, same report
shape, same JSON keys).

``profile report`` answers the efficiency question the raw
artifacts only hint at: of every second of wall clock, how much was
useful device work vs. padding, compile, queue wait and host glue —
and on which backend?  Two modes over the same report shape:

- ``--url http://HOST:PORT`` asks a RUNNING process (any
  ``--serve_metrics`` solve) for its live
  efficiency rollup over ``GET /profile`` (observability/efficiency.py
  — request time ledgers, per-structure attainment, waste by cause);
- offline, over artifacts: ``--trace FILE...`` aggregates an exported
  trace's spans into the time breakdown (``serve_queued`` /
  ``serve_dispatch`` / ``engine_segment`` / ``jit_compile`` — the
  span taxonomy maps onto the ledger components), ``--metrics
  FILE.jsonl`` reads the last registry snapshot's ledger counters.
  The reference's ``--bench`` table reads its TPU benchmark history
  and is not ported.

Output: a where-the-time-went breakdown (component seconds + share),
the top-N structures by device time, waste by cause (padding vs
compile vs queue), and the resolved-backend line; ``--json`` emits
the full document for tooling.  The trace and metrics files of
either package read the same.
"""

import json
import sys
from typing import Any, Dict, List, Optional

# Trace span name -> ledger-ish component for the offline breakdown.
# Spans overlap (engine_segment nests inside serve_dispatch), so the
# offline table reports each row as itself rather than forcing the
# disjoint ledger taxonomy — the mapping only orders/annotates them.
SPAN_COMPONENTS = (
    ("serve_submit", "submit"),
    ("serve_queued", "queue"),
    ("serve_dispatch", "dispatch (incl. engine)"),
    ("engine_segment", "device execute"),
    ("jit_compile", "cold compile"),
    ("engine_call", "device execute (warm)"),
    ("session_segment", "session segment"),
    ("session_events", "session events"),
    ("checkpoint_write", "checkpointing"),
)


def set_parser(subparsers):
    parser = subparsers.add_parser(
        "profile",
        help="device-efficiency analysis (where the time went)")
    profile_sub = parser.add_subparsers(
        title="profile commands", dest="profile_command")

    report = profile_sub.add_parser(
        "report",
        help="where-the-time-went breakdown, attainment, waste by "
             "cause")
    report.add_argument(
        "--url", default=None, metavar="URL",
        help="telemetry endpoint of a running process (e.g. "
             "http://127.0.0.1:8080): reads its live GET /profile "
             "rollup")
    report.add_argument(
        "--trace", nargs="*", default=None, metavar="FILE",
        help="exported trace file(s) (chrome or jsonl): offline span "
             "aggregation")
    report.add_argument(
        "--metrics", default=None, metavar="FILE",
        help="metrics snapshot JSONL (--metrics runs): ledger "
             "counters from the last snapshot")
    report.add_argument(
        "--top", type=int, default=10,
        help="structures to list by device time (default 10)")
    report.add_argument(
        "--timeout", type=float, default=10.0,
        help="HTTP timeout for --url (seconds, default 10)")
    report.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the full report as JSON")
    report.set_defaults(func=run_report)

    parser.set_defaults(func=_no_subcommand(parser))


def _no_subcommand(parser):
    def run(_args) -> int:
        parser.print_help(sys.stderr)
        return 2

    return run


# ------------------------------------------------------------------ #
# collectors
# ------------------------------------------------------------------ #

def fetch_live(url: str, timeout: float) -> Dict[str, Any]:
    from urllib.request import urlopen

    endpoint = url.rstrip("/") + "/profile"
    with urlopen(endpoint, timeout=timeout) as resp:  # noqa: S310
        return json.loads(resp.read())


def trace_breakdown(paths: List[str],
                    top: int = 10) -> Dict[str, Any]:
    """Offline where-the-time-went from exported trace spans: the
    known request/engine span families in taxonomy order, plus the
    top structures by ``engine_segment``/``serve_dispatch`` time
    (grouped by the bin/batch labels the spans already carry)."""
    from pydcop_tpu_torch.observability.trace import (
        load_trace_file,
        summarize_spans,
    )

    events: List[Dict[str, Any]] = []
    for path in paths:
        events.extend(load_trace_file(path))
    rows = {r["name"]: r for r in summarize_spans(events)}
    components = []
    for span, label in SPAN_COMPONENTS:
        row = rows.get(span)
        if row is None:
            continue
        components.append({
            "span": span, "component": label,
            "count": row["count"],
            "total_ms": round(row["total_ms"], 3),
            "mean_ms": round(row["mean_ms"], 3),
        })
    # Structure attribution: serve_dispatch spans carry their bin
    # label, engine_segment spans their batch shape args.
    by_structure: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("name") != "serve_dispatch":
            continue
        label = (ev.get("args") or {}).get("bin") or "?"
        by_structure.setdefault(label, [0, 0.0])
        by_structure[label][0] += 1
        by_structure[label][1] += float(ev.get("dur", 0.0)) / 1000.0
    structures = [
        {"structure": label, "dispatches": int(count),
         "total_ms": round(total, 3)}
        for label, (count, total) in by_structure.items()
    ]
    structures.sort(key=lambda r: -r["total_ms"])
    other = [
        {"span": r["name"], "count": r["count"],
         "total_ms": round(r["total_ms"], 3)}
        for r in summarize_spans(events, top=top)
        if r["name"] not in {s for s, _label in SPAN_COMPONENTS}
    ]
    return {
        "events": len(events),
        "components": components,
        "structures": structures[:top],
        "other_spans": other,
    }


def metrics_breakdown(path: str) -> Dict[str, Any]:
    """Ledger/efficiency series out of the LAST snapshot line of a
    metrics JSONL file (snapshots are cumulative, so the last line is
    the run's total)."""
    last: Optional[Dict[str, Any]] = None
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                last = json.loads(line)
            except ValueError:
                continue
    if not last:
        return {"error": f"no snapshot rows in {path}"}
    metrics = last.get("metrics") or {}
    out: Dict[str, Any] = {"snapshot_ts": last.get("ts")}
    ledger = metrics.get("pydcop_request_ledger_seconds_total")
    if ledger:
        out["ledger_components_s"] = {
            s["labels"].get("component", "?"): round(s["value"], 6)
            for s in ledger.get("samples", [])
        }
    for name, key in (
        ("pydcop_useful_work_fraction", "useful_work_fraction"),
        ("pydcop_efficiency_attainment", "attainment"),
        ("pydcop_device_execute_seconds_total", "device_execute_s"),
        ("pydcop_device_compile_seconds_total", "device_compile_s"),
    ):
        series = metrics.get(name)
        if series:
            out[key] = {
                ",".join(f"{k}={v}" for k, v in sorted(
                    s["labels"].items())) or "all": round(
                        s["value"], 6)
                for s in series.get("samples", [])
            }
    return out


# ------------------------------------------------------------------ #
# rendering
# ------------------------------------------------------------------ #

def _pct(part: float, whole: float) -> str:
    return f"{part / whole:6.1%}" if whole > 0 else "     -"


def render_live(doc: Dict[str, Any], out) -> None:
    backend = doc.get("backend") or {}
    probe = ("ok" if backend.get("probe_ok")
             else f"{backend.get('probe_failures', '?')} failure(s)")
    print(f"backend: {backend.get('backend', '?')} "
          f"({backend.get('n_devices', '?')} device(s), "
          f"accelerator probe {probe})", file=out)
    ledger = doc.get("ledger") or {}
    components = ledger.get("components_s") or {}
    total = ledger.get("total_s") or 0.0
    if components:
        print("\nwhere the time went (request ledgers):", file=out)
        for name, secs in sorted(components.items(),
                                 key=lambda kv: -kv[1]):
            print(f"  {name:<10} {secs:10.3f}s "
                  f"{_pct(secs, total)}", file=out)
        print(f"  {'total':<10} {total:10.3f}s over "
              f"{ledger.get('counts', {})}", file=out)
    waste = doc.get("waste_by_cause") or {}
    if waste:
        print("\nwaste by cause:", file=out)
        for name, secs in sorted(waste.items(),
                                 key=lambda kv: -kv[1]):
            print(f"  {name:<12} {secs:10.3f}s", file=out)
    for backend_name, agg in (doc.get("backends") or {}).items():
        att = agg.get("attainment")
        useful = agg.get("useful_work_fraction")
        print(f"\n[{backend_name}] execute {agg.get('execute_s', 0):.3f}s "
              f"over {agg.get('dispatches', 0)} dispatch(es), "
              f"attainment "
              f"{att if att is not None else 'n/a (no cost entries)'}"
              f", useful_work_fraction "
              f"{useful if useful is not None else 'n/a'} "
              f"(peak: {agg.get('peak_source', '?')})", file=out)
    structures = doc.get("structures") or []
    if structures:
        print("\ntop structures by device time:", file=out)
        for row in structures:
            att = row.get("attainment")
            print(f"  {row['structure']:<28} [{row['backend']}] "
                  f"{row['device_s']:8.3f}s "
                  f"{row['dispatches']:4d} dispatch(es) "
                  f"attainment "
                  f"{att if att is not None else 'n/a'}", file=out)


def render_trace(doc: Dict[str, Any], out) -> None:
    print(f"trace: {doc.get('events', 0)} event(s)", file=out)
    components = doc.get("components") or []
    if components:
        print("\nwhere the time went (spans; nested spans overlap):",
              file=out)
        for c in components:
            print(f"  {c['component']:<24} ({c['span']}) "
                  f"{c['total_ms']:10.3f}ms x{c['count']}", file=out)
    structures = doc.get("structures") or []
    if structures:
        print("\ntop bins by dispatch time:", file=out)
        for row in structures:
            print(f"  {row['structure']:<28} {row['total_ms']:10.3f}ms "
                  f"x{row['dispatches']}", file=out)


def run_report(args) -> int:
    report: Dict[str, Any] = {"mode": []}
    if args.url:
        try:
            report["live"] = fetch_live(args.url, args.timeout)
            report["mode"].append("live")
        except Exception as exc:  # noqa: BLE001 — CLI surface
            print(f"pydcop_tpu_torch profile: could not fetch {args.url}"
                  f"/profile: {exc}", file=sys.stderr)
            return 2
    if args.trace:
        try:
            report["trace"] = trace_breakdown(args.trace,
                                              top=args.top)
            report["mode"].append("trace")
        except Exception as exc:  # noqa: BLE001
            print(f"pydcop_tpu_torch profile: could not read trace(s): {exc}",
                  file=sys.stderr)
            return 2
    if args.metrics:
        try:
            report["metrics"] = metrics_breakdown(args.metrics)
        except Exception as exc:  # noqa: BLE001 — CLI surface
            print(f"pydcop_tpu_torch profile: could not read metrics file "
                  f"{args.metrics}: {exc}", file=sys.stderr)
            return 2
        report["mode"].append("metrics")
    if not report["mode"]:
        # No source named: report on THIS process's tracker (mostly a
        # plumbing self-test) so the command always answers.
        from pydcop_tpu_torch.observability.efficiency import tracker

        report["live"] = tracker.rollup(top_n=args.top)
        report["mode"].append("self")
    if args.as_json:
        print(json.dumps(report, default=str))
        return 0
    out = sys.stdout
    if "live" in report:
        render_live(report["live"], out)
    if "trace" in report:
        if "live" in report:
            print("", file=out)
        render_trace(report["trace"], out)
    if "metrics" in report:
        print(f"\nmetrics snapshot: "
              f"{json.dumps(report['metrics'], default=str)}",
              file=out)
    return 0
