"""``pydcop debug``: operational forensics commands.

``pydcop debug bundle`` cuts a postmortem bundle on demand — the same
document the always-on flight recorder (observability/flight.py)
dumps automatically on anomaly triggers: the trace-event ring tail,
a metrics-registry snapshot, the ``/healthz`` payload, env +
accelerator-probe diagnostics, the device-efficiency rollup
(backend-honest attainment + the where-the-time-went ledger — what
backend was the anomalous run actually executing on, and was it doing
useful work), the ``BENCH_TPU_PROBELOG.jsonl`` history tail, and the
pending-journal summary when a serve journal is active.

Two modes:

- ``pydcop debug bundle --url http://HOST:PORT`` asks a RUNNING
  process (a ``pydcop serve`` front end or any ``--serve_metrics``
  solve) for its bundle over ``GET /debug/bundle`` and saves the
  JSON locally — the mode an operator actually uses, since the
  interesting ring lives in the serving process, not in this CLI
  process;
- without ``--url``, the bundle is cut from THIS process's recorder
  (mostly a plumbing self-test: the ring holds only this command's
  own startup events).

``--out PATH`` names the output file (default: the recorder's bundle
directory / the server's reported path, printed either way).

A copy of ``pydcop_tpu/commands/debug.py``: ``python -m
pydcop_tpu_torch debug bundle [--url URL] [--out PATH]``.
"""

import json
import sys

import logging

logger = logging.getLogger("pydcop.cli.debug")


def set_parser(subparsers):
    parser = subparsers.add_parser(
        "debug", help="operational forensics (postmortem bundles)")
    debug_sub = parser.add_subparsers(
        title="debug commands", dest="debug_command")

    bundle = debug_sub.add_parser(
        "bundle", help="cut a postmortem bundle on demand")
    bundle.add_argument(
        "--url", default=None, metavar="URL",
        help="telemetry endpoint of a running process "
             "(e.g. http://127.0.0.1:8080): fetches GET /debug/bundle "
             "from IT instead of bundling this CLI process")
    bundle.add_argument(
        "--out", default=None, metavar="PATH",
        help="write the bundle JSON here (default: the recorder's "
             "bundle dir, path printed)")
    bundle.add_argument(
        "--timeout", type=float, default=10.0,
        help="HTTP timeout for --url (seconds, default 10)")
    bundle.set_defaults(func=run_bundle)

    parser.set_defaults(func=_no_subcommand(parser))


def _no_subcommand(parser):
    def run(_args) -> int:
        parser.print_help(sys.stderr)
        return 2

    return run


def _fetch_remote(url: str, timeout: float):
    from urllib.request import urlopen

    endpoint = url.rstrip("/") + "/debug/bundle"
    with urlopen(endpoint, timeout=timeout) as resp:  # noqa: S310
        return json.loads(resp.read())


def run_bundle(args) -> int:
    if args.url:
        try:
            doc = _fetch_remote(args.url, args.timeout)
        except Exception as exc:  # noqa: BLE001 — CLI surface
            print(f"pydcop debug: could not fetch a bundle from "
                  f"{args.url}: {exc}", file=sys.stderr)
            return 2
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            path = args.out
        else:
            path = doc.get("path", "(remote only)")
    else:
        from pydcop_tpu_torch.observability.flight import get_flight

        recorder = get_flight()
        if recorder is None:
            print("pydcop debug: flight recorder disabled "
                  "(PYDCOP_FLIGHT_RECORDER=0)", file=sys.stderr)
            return 2
        doc = recorder.make_bundle("on_demand", {"via": "cli"})
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                json.dump(doc, f, default=str)
            path = args.out
        else:
            path = recorder.write_bundle(doc)
    print(f"postmortem bundle ({doc.get('kind', '?')}, "
          f"{len(doc.get('events', []))} ring event(s), "
          f"pid {doc.get('pid', '?')}): {path}")
    return 0
