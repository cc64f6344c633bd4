"""Command-line interface of the port.

``python -m pydcop_tpu_torch solve --algo ALGO [--algo_params k:v]
[-c MAX_CYCLES] [--device cuda|cpu] [--collect_on MOMENT]
[--run_metrics FILE.csv] [--end_metrics FILE.csv] [--checkpoint_dir DIR
[--checkpoint_every N] [--[no-]checkpoint_async] [--checkpoint_keep N]
[--resume]] [--recovery [--recovery_max_restarts N] [--recovery_noise S]
[--recovery_damping_bump B]] [--trace FILE [--trace_format chrome|jsonl]]
[--metrics FILE.jsonl] [--metrics_every N] [--serve_metrics PORT]
FILE.yaml`` solves a DCOP on one torch device with ALGO (maxsum,
amaxsum, maxsum_dynamic, dsa, adsa, dsatuto, mgm, mgm2, dba, gdba,
mixeddsa) and prints the
JSON result ``pydcop solve`` prints for a device solve (status, assignment,
cost, violation, time, msg_count, msg_size, cycle, compile_time,
backend).  The resilience and observability flags are the reference's,
with its defaults (``--metrics_file`` is accepted for ``--metrics``).
With ``--device cuda`` the command first checks, in a child process,
that CUDA initialises and runs a tiny launch
(``utils/cleanenv.ensure_live_backend``), and exits with an error if
not.

``python -m pydcop_tpu_torch trace summary|query|merge|diff`` and
``python -m pydcop_tpu_torch profile report [--url URL] [--trace FILE]
[--metrics FILE]`` read trace and metrics files of either package
(``commands/trace.py``, ``commands/profile.py``).

The metrics files are the reference's CSV (``commands/metrics_io.py``):
with ``--collect_on cycle_change``, ``--run_metrics`` gets one row per
cycle of a cost-trace run of the same solve (``MaxSumEngine.run_trace``)
for a MaxSum (or A-MaxSum) solve without decimation; each metrics file
then gets the final summary row.
"""

import argparse
import json
import os
import sys
from typing import Dict, List, Optional


def parse_algo_params(param_strs: Optional[List[str]]) -> Dict[str, str]:
    """Parse repeated ``name:value`` CLI parameters."""
    params: Dict[str, str] = {}
    for p in param_strs or []:
        if ":" not in p:
            raise ValueError(
                f"Invalid algo parameter {p!r}: expected name:value"
            )
        name, value = p.split(":", 1)
        params[name.strip()] = value.strip()
    return params


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m pydcop_tpu_torch",
        description="DCOP solver on PyTorch/CUDA (port of pydcop_tpu)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    solve = sub.add_parser("solve", help="solve a static DCOP")
    solve.add_argument("dcop_files", nargs="+", help="dcop yaml file(s)")
    solve.add_argument("-a", "--algo", required=True,
                       help="algorithm name (maxsum, amaxsum, "
                            "maxsum_dynamic, dsa, adsa, dsatuto, mgm, "
                            "mgm2, dba, gdba, mixeddsa)")
    solve.add_argument("-p", "--algo_params", action="append",
                       help="algorithm parameter as name:value")
    solve.add_argument("-c", "--cycles", type=int, default=1000,
                       help="max cycles")
    solve.add_argument("--device", default="cuda",
                       choices=["cuda", "cpu"],
                       help="torch device (default cuda; there is no "
                            "silent CPU fallback)")
    solve.add_argument("--collect_on", default="value_change",
                       choices=["value_change", "cycle_change", "period"])
    solve.add_argument("--run_metrics", default=None,
                       help="csv file for run metrics")
    solve.add_argument("--end_metrics", default=None,
                       help="csv file for end metrics")
    solve.add_argument("--checkpoint_dir", default=None,
                       help="snapshot solver state to this directory "
                            "between segments")
    solve.add_argument("--checkpoint_every", type=int, default=100,
                       help="cycles per checkpoint segment")
    solve.add_argument("--checkpoint_async",
                       action=argparse.BooleanOptionalAction,
                       default=True,
                       help="write snapshots on a background thread "
                            "overlapping device compute (default; "
                            "--no-checkpoint_async restores the "
                            "synchronous write between segments)")
    solve.add_argument("--checkpoint_keep", type=int, default=2,
                       help="keep-last-N checkpoint retention (the "
                            "newest valid snapshot is never pruned)")
    solve.add_argument("--resume", action="store_true",
                       help="continue from the newest VALID checkpoint "
                            "in --checkpoint_dir (corrupt/truncated "
                            "snapshots are skipped with a warning)")
    solve.add_argument("--recovery", action="store_true",
                       help="arm segment-boundary guards (NaN/Inf "
                            "scan) with rollback-and-recover on a trip")
    solve.add_argument("--recovery_max_restarts", type=int, default=3,
                       help="restart budget before RecoveryExhausted")
    solve.add_argument("--recovery_noise", type=float, default=1e-3,
                       help="tie-break noise scale of the first "
                            "recovery escalation")
    solve.add_argument("--recovery_damping_bump", type=float,
                       default=0.2,
                       help="damping increase of the second recovery "
                            "escalation")
    solve.add_argument("--trace", default=None,
                       help="trace file for the run; format chosen by "
                            "--trace_format")
    solve.add_argument("--trace_format", "--trace-format",
                       default="chrome", choices=["chrome", "jsonl"],
                       help="chrome: trace_event JSON for "
                            "chrome://tracing / Perfetto; jsonl: one "
                            "event per line")
    solve.add_argument("--metrics", "--metrics_file", dest="metrics",
                       default=None,
                       help="JSONL metrics-snapshot file; a Prometheus "
                            "text dump is written next to it "
                            "(<file>.prom)")
    solve.add_argument("--metrics_every", "--metrics-every", type=int,
                       default=100,
                       help="cycles between metrics snapshots (also the "
                            "engine segment size)")
    solve.add_argument("--serve_metrics", "--serve-metrics", type=int,
                       default=None, metavar="PORT",
                       help="serve live telemetry over HTTP while the "
                            "solve runs (/metrics, /healthz, /events, "
                            "/profile; 0 = OS-assigned port)")
    from pydcop_tpu_torch.commands import profile as profile_cmd
    from pydcop_tpu_torch.commands import trace as trace_cmd

    trace_cmd.set_parser(sub)
    profile_cmd.set_parser(sub)
    return parser


def _guard_backend(args) -> None:
    """Before a solve on the card, check in a child process that CUDA
    initialises and one tiny launch completes, so a wedged card fails
    the command at once instead of hanging it; raises otherwise (there
    is no CPU fallback).  ``PYDCOP_CLI_PROBE_TIMEOUT`` (seconds,
    default 60) bounds the probe."""
    if args.command != "solve" or args.device != "cuda":
        return
    from pydcop_tpu_torch.utils.cleanenv import ensure_live_backend

    ensure_live_backend(tag="cli_solve", retries=1,
                        probe_timeout=float(os.environ.get(
                            "PYDCOP_CLI_PROBE_TIMEOUT", "60")))


def run_solve(args) -> int:
    from pydcop_tpu_torch.algorithms import AlgorithmDef
    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.commands.metrics_io import add_csvline
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

    dcop = load_dcop_from_file(args.dcop_files)
    algo_def = AlgorithmDef.build_with_default_param(
        args.algo, parse_algo_params(args.algo_params),
        mode=dcop.objective)
    recovery = None
    if args.recovery:
        from pydcop_tpu_torch.resilience.recovery import RecoveryPolicy

        recovery = RecoveryPolicy(
            max_restarts=args.recovery_max_restarts,
            noise_scale=args.recovery_noise,
            damping_bump=args.recovery_damping_bump,
        )
    res = solve(dcop, algo_def, max_cycles=args.cycles,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every,
                checkpoint_async=args.checkpoint_async,
                checkpoint_keep=args.checkpoint_keep,
                resume=args.resume, recovery=recovery,
                trace=args.trace, trace_format=args.trace_format,
                metrics_file=args.metrics,
                metrics_every=args.metrics_every,
                serve_metrics=args.serve_metrics,
                device=args.device)
    result = {
        "status": res["status"],
        "assignment": res["assignment"],
        "cost": res["cost"],
        "violation": res["violations"],
        "time": res["time"],
        "msg_count": res["metrics"].get("msg_count", 0),
        "msg_size": res["metrics"].get("msg_size", 0),
        "cycle": res["cycles"],
        "compile_time": res["compile_time"],
        "backend": "device",
    }
    params = algo_def.params
    if (args.run_metrics and args.collect_on == "cycle_change"
            and algo_def.algo in ("maxsum", "amaxsum")
            and not params.get("decimation")
            and not params.get("decimation_margin")):
        # The solve ran as one device loop, so the per-cycle rows come
        # from a cost-trace run of the same solve, written afterwards.
        from pydcop_tpu_torch.algorithms.maxsum import build_engine

        trace = build_engine(dcop, params, device=args.device).run_trace(
            max_cycles=max(res["cycles"], 1))
        for i, cost in enumerate(trace.metrics["cost_trace"]):
            add_csvline(args.run_metrics, "cycle_change", {
                "time": None, "cycle": i + 1, "cost": float(cost),
                "violation": None, "msg_count": None, "msg_size": None,
                "status": "RUNNING",
            })
    for path in (args.run_metrics, args.end_metrics):
        if path:
            add_csvline(path, args.collect_on, result)
    print(json.dumps(result, sort_keys=True, indent="  "))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    if args.command != "solve":
        return args.func(args)
    _guard_backend(args)
    return run_solve(args)


if __name__ == "__main__":
    sys.exit(main())
