"""Command-line interface of the port.

``python -m pydcop_tpu_torch solve --algo ALGO [--algo_params k:v]
[-c MAX_CYCLES] [--device cuda|cpu] [--collect_on MOMENT]
[--run_metrics FILE.csv] [--end_metrics FILE.csv] [--checkpoint_dir DIR
[--checkpoint_every N] [--[no-]checkpoint_async] [--checkpoint_keep N]
[--resume]] [--recovery [--recovery_max_restarts N] [--recovery_noise S]
[--recovery_damping_bump B]] [--trace FILE [--trace_format chrome|jsonl]]
[--metrics FILE.jsonl] [--metrics_every N] [--serve_metrics PORT]
[--scenario FILE [--scenario_event_cycles N]] FILE.yaml`` solves a DCOP
on one torch device with ALGO (maxsum, amaxsum, maxsum_dynamic, dsa,
adsa, dsatuto, mgm, mgm2, dba, gdba, mixeddsa, dpop, syncbb, ncbb, or
``auto``: the portfolio racer picks one, ``-p`` parameters the winner
does not take are dropped with a warning) and prints the
JSON result ``pydcop solve`` prints for a device solve (status, assignment,
cost, violation, time, msg_count, msg_size, cycle, compile_time,
backend).  ``--scenario`` replays a dynamic-DCOP event script
(``dcop/yamldcop.py::load_scenario``) through
``engine/dynamic.py::replay_scenario`` after the initial solve, for the
MaxSum family, and prints the reference's scenario JSON (``scenario``
block included).  The resilience and observability flags are the reference's,
with its defaults (``--metrics_file`` is accepted for ``--metrics``).
With ``--device cuda`` the command first checks, in a child process,
that CUDA initialises and runs a tiny launch
(``utils/cleanenv.ensure_live_backend``), and exits with an error if
not.

``python -m pydcop_tpu_torch trace summary|query|merge|diff`` and
``python -m pydcop_tpu_torch profile report [--url URL] [--trace FILE]
[--metrics FILE]`` read trace and metrics files of either package
(``commands/trace.py``, ``commands/profile.py``).  ``python -m
pydcop_tpu_torch batch [--simulate] FILE.yaml`` runs the sweep a batch
file defines, one ``python -m pydcop_tpu_torch`` process a job
(``commands/batch.py``).  ``python -m pydcop_tpu_torch serve
[--device cuda|cpu] [--port P] [--journal_dir D [--recover]] ...``
runs the solve service over HTTP (``commands/serve.py``,
``api.serve``); with ``--replicas N`` it spawns N worker processes on
that device behind the fleet router; without ``--device cpu`` and no
card it exits with an error.  ``python -m pydcop_tpu_torch fleet
forensics ID --url URL | --trace FILE...`` prints one request's causal
tree across the router and its replicas (``commands/fleet.py``).
``python -m pydcop_tpu_torch debug bundle [--url URL] [--out
PATH]`` cuts a flight-recorder postmortem bundle
(``commands/debug.py``).  ``python -m pydcop_tpu_torch generate
graph_coloring|ising|meetings|secp|agents|scenario|iot|small_world
... [--seed N]`` writes a generated problem (or agents, or a scenario)
as the reference's YAML (``commands/generate.py`` over
``generators/``), and ``python -m pydcop_tpu_torch graph -g MODEL | -a
ALGO FILE.yaml`` prints a problem's computation-graph metrics as JSON
(``commands/graph.py``); neither touches a device, and their errors
are the reference's one-line messages.

The global options are the reference's: ``-t/--timeout`` (accepted; a
device solve runs to its cycle budget, as the reference's device solve
does), ``--output FILE`` (the result JSON is also written there),
``-v/--verbosity 0..3`` and ``--version``.  ``solve`` also takes the
reference's ``--flight_recorder_events N`` (the flight-recorder ring,
``observability/flight.py``) and ``--profile DIR`` (a
``torch.profiler`` trace of the solve written to DIR, TensorBoard's
format, where the reference writes a JAX profiler trace).

The metrics files are the reference's CSV (``commands/metrics_io.py``):
with ``--collect_on cycle_change``, ``--run_metrics`` gets one row per
cycle of a cost-trace run of the same solve (``MaxSumEngine.run_trace``)
for a MaxSum (or A-MaxSum) solve without decimation; each metrics file
then gets the final summary row.
"""

import argparse
import contextlib
import logging
import os
import sys
from typing import List, Optional

from pydcop_tpu_torch.commands._utils import emit_result, parse_algo_params


def _configure_logs(level: int):
    if level >= 3:
        log_level = logging.DEBUG
    elif level == 2:
        log_level = logging.INFO
    elif level == 1:
        log_level = logging.WARNING
    else:
        log_level = logging.ERROR
    logging.basicConfig(
        level=log_level,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
        stream=sys.stderr,
    )


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m pydcop_tpu_torch",
        description="DCOP solver on PyTorch/CUDA (port of pydcop_tpu)",
    )
    parser.add_argument(
        "-t", "--timeout", type=float, default=None,
        help="global timeout in seconds",
    )
    parser.add_argument(
        "--output", default=None, help="output file for results"
    )
    parser.add_argument(
        "-v", "--verbosity", type=int, default=0,
        help="verbosity: 0 error, 1 warning, 2 info, 3 debug",
    )
    parser.add_argument(
        "--version", action="store_true", help="print version and exit"
    )
    sub = parser.add_subparsers(dest="command")
    solve = sub.add_parser("solve", help="solve a static DCOP")
    solve.add_argument("dcop_files", nargs="+", help="dcop yaml file(s)")
    solve.add_argument("-a", "--algo", required=True,
                       help="algorithm name (maxsum, amaxsum, "
                            "maxsum_dynamic, dsa, adsa, dsatuto, mgm, "
                            "mgm2, dba, gdba, mixeddsa, dpop, syncbb, "
                            "ncbb, or auto: the portfolio racer)")
    solve.add_argument("-p", "--algo_params", action="append",
                       help="algorithm parameter as name:value")
    solve.add_argument("-c", "--cycles", type=int, default=1000,
                       help="max cycles")
    solve.add_argument("--device", default="cuda",
                       choices=["cuda", "cpu"],
                       help="torch device (default cuda; there is no "
                            "silent CPU fallback)")
    solve.add_argument("--n_devices", type=int, default=None,
                       help="replicated-variable sharding (not ported "
                            "yet: above 1 it raises, ROADMAP.md Queue "
                            "A item 6(b))")
    solve.add_argument("--shards", type=int, default=None,
                       help="partitioned sharding (maxsum family): "
                            "min-edge-cut partition of the factor "
                            "graph over this many devices, per-shard "
                            "variable slices, halo-only exchange; "
                            "mutually exclusive with --n_devices")
    solve.add_argument("--scenario", default=None, metavar="FILE",
                       help="dynamic DCOP: replay this scenario yaml's "
                            "events through the incremental "
                            "DynamicMaxSumEngine after the initial "
                            "solve converges (maxsum family)")
    solve.add_argument("--scenario_event_cycles",
                       "--scenario-event-cycles", type=int,
                       default=None, metavar="CYCLES",
                       help="re-convergence cycle budget per scenario "
                            "event (default: --cycles)")
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
    solve.add_argument("--flight_recorder_events",
                       "--flight-recorder-events",
                       type=int, default=None, metavar="N",
                       help="size of the always-on flight-recorder "
                            "ring (trace events kept for postmortem "
                            "bundles; 0 disables; default: "
                            "PYDCOP_FLIGHT_RECORDER or 2048)")
    solve.add_argument("--profile", default=None,
                       help="write a torch.profiler trace of the solve "
                            "to this directory (TensorBoard format)")
    from pydcop_tpu_torch.commands import batch as batch_cmd
    from pydcop_tpu_torch.commands import profile as profile_cmd
    from pydcop_tpu_torch.commands import trace as trace_cmd

    trace_cmd.set_parser(sub)
    profile_cmd.set_parser(sub)
    batch_cmd.set_parser(sub)
    from pydcop_tpu_torch.commands import debug as debug_cmd
    from pydcop_tpu_torch.commands import fleet as fleet_cmd
    from pydcop_tpu_torch.commands import serve as serve_cmd

    serve_cmd.set_parser(sub)
    debug_cmd.set_parser(sub)
    fleet_cmd.set_parser(sub)
    from pydcop_tpu_torch.commands import generate as generate_cmd
    from pydcop_tpu_torch.commands import graph as graph_cmd

    graph_cmd.set_parser(sub)
    generate_cmd.set_parser(sub)
    return parser


def _guard_backend(args) -> None:
    """Before a solve on the card, check in a child process that CUDA
    initialises and one tiny launch completes, so a wedged card fails
    the command at once instead of hanging it; raises otherwise (there
    is no CPU fallback).  ``PYDCOP_CLI_PROBE_TIMEOUT`` (seconds,
    default 60) bounds the probe."""
    if args.command not in ("solve", "serve") or args.device != "cuda":
        return
    from pydcop_tpu_torch.utils.cleanenv import ensure_live_backend

    ensure_live_backend(tag=f"cli_{args.command}", retries=1,
                        probe_timeout=float(os.environ.get(
                            "PYDCOP_CLI_PROBE_TIMEOUT", "60")))


def run_solve(args) -> int:
    from pydcop_tpu_torch.algorithms import AlgorithmDef
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

    if args.flight_recorder_events is not None:
        from pydcop_tpu_torch.observability import flight

        flight.install(events=args.flight_recorder_events)
    dcop = load_dcop_from_file(args.dcop_files)
    auto_params = None
    if args.algo == "auto":
        # api.solve races the portfolio (or replays its decision) and
        # builds the winner's AlgorithmDef itself.
        algo_def = "auto"
        auto_params = parse_algo_params(args.algo_params)
    else:
        algo_def = AlgorithmDef.build_with_default_param(
            args.algo, parse_algo_params(args.algo_params),
            mode=dcop.objective)
    if args.scenario:
        return _run_scenario_cmd(args, dcop, algo_def)
    recovery = None
    if args.recovery:
        from pydcop_tpu_torch.resilience.recovery import RecoveryPolicy

        recovery = RecoveryPolicy(
            max_restarts=args.recovery_max_restarts,
            noise_scale=args.recovery_noise,
            damping_bump=args.recovery_damping_bump,
        )
    profile_ctx = contextlib.nullcontext()
    if args.profile:
        profile_ctx = _torch_profile(args.profile, args.device)
    with profile_ctx:
        res = _run_solve(args, dcop, algo_def, auto_params, recovery)
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
    _write_metrics(args, dcop, algo_def, res, result)
    emit_result(result, args.output)
    return 0


def _torch_profile(directory: str, device: str):
    """A ``torch.profiler`` session writing its trace to ``directory``
    (the reference's ``--profile`` writes a JAX profiler trace)."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(directory))


def _run_solve(args, dcop, algo_def, auto_params, recovery):
    from pydcop_tpu_torch.api import solve

    return solve(dcop, algo_def, max_cycles=args.cycles,
                algo_params=auto_params, n_devices=args.n_devices,
                shards=args.shards,
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


def _write_metrics(args, dcop, algo_def, res, result) -> None:
    from pydcop_tpu_torch.commands.metrics_io import add_csvline

    params = {} if isinstance(algo_def, str) else algo_def.params
    if (args.run_metrics and args.collect_on == "cycle_change"
            and not isinstance(algo_def, str)
            and algo_def.algo in ("maxsum", "amaxsum")
            and not params.get("decimation")
            and not params.get("decimation_margin")):
        # The solve ran as one device loop, so the per-cycle rows come
        # from a cost-trace run of the same solve, written afterwards.
        from pydcop_tpu_torch.algorithms.maxsum import build_engine

        trace = build_engine(
            dcop, params, n_devices=args.n_devices, shards=args.shards,
            device=args.device).run_trace(max_cycles=max(res["cycles"], 1))
        for i, cost in enumerate(trace.metrics["cost_trace"]):
            add_csvline(args.run_metrics, "cycle_change", {
                "time": None, "cycle": i + 1, "cost": float(cost),
                "violation": None, "msg_count": None, "msg_size": None,
                "status": "RUNNING",
            })
    for path in (args.run_metrics, args.end_metrics):
        if path:
            add_csvline(path, args.collect_on, result)


def _run_scenario_cmd(args, dcop, algo_def) -> int:
    """``solve --scenario FILE``: replay the events through the
    incremental engine on ``--device`` and print the reference's
    scenario JSON."""
    import time

    from pydcop_tpu_torch.dcop.yamldcop import load_scenario_from_file
    from pydcop_tpu_torch.engine.dynamic import replay_scenario

    if isinstance(algo_def, str) or algo_def.algo not in (
            "maxsum", "maxsum_dynamic", "amaxsum"):
        raise ValueError(
            "--scenario needs a maxsum-family algorithm (the "
            "incremental engine is MaxSum); got "
            f"{algo_def if isinstance(algo_def, str) else algo_def.algo!r}")
    scenario = load_scenario_from_file(args.scenario)
    params = dict(algo_def.params)
    # decimation_margin 0.0 is off, as in decimation_plan_from_params.
    margin = params.get("decimation_margin") or None
    t0 = time.perf_counter()
    out = replay_scenario(
        dcop, scenario, params=params, max_cycles=args.cycles,
        event_cycles=args.scenario_event_cycles,
        decimation_margin=margin, device=args.device,
    )
    result = {
        "status": "FINISHED" if out["converged"] else "TIMEOUT",
        "assignment": out["assignment"],
        # Cost and violations of the live (edited) factor set.
        "cost": out["cost"],
        "violation": out["violations"],
        "time": time.perf_counter() - t0,
        "cycle": out["cycles"],
        "backend": "device",
        "scenario": {
            "file": args.scenario,
            "events_applied": out["event_count"],
            "recompiles": out["recompiles"],
            "clamped": out["clamped"],
            "orphaned_computations": out["orphaned"],
            "events": out["events"],
        },
    }
    emit_result(result, args.output)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = make_parser()
    args = parser.parse_args(argv)
    _configure_logs(args.verbosity)
    if args.version:
        import pydcop_tpu_torch

        print(f"pydcop-tpu-torch {pydcop_tpu_torch.__version__}")
        return 0
    if args.command is None:
        parser.print_help()
        return 2
    _guard_backend(args)
    if args.command in _REPORTED_COMMANDS:
        return _run_reported(args)
    if args.command != "solve":
        return args.func(args)
    return run_solve(args)


# Commands whose failures print the reference CLI's one-line errors
# (``pydcop_tpu/dcop_cli.py`` main) instead of a traceback.
_REPORTED_COMMANDS = ("generate", "graph")


def _run_reported(args) -> int:
    """Run ``args.func`` as the reference's ``main`` does: an unknown
    algorithm or graph model names the valid ones (exit 2), a missing
    file exits 2, any other error prints one line (exit 1; ``-v 3``
    re-raises)."""
    try:
        return args.func(args) or 0
    except ModuleNotFoundError as e:
        name = str(e).rsplit(".", 1)[-1].rstrip("'")
        if "pydcop_tpu_torch.algorithms." in str(e):
            from pydcop_tpu_torch.algorithms import list_available_algorithms

            print(
                f"Error: unknown algorithm {name!r}; available: "
                f"{', '.join(list_available_algorithms())}",
                file=sys.stderr,
            )
            return 2
        if "pydcop_tpu_torch.computations_graph." in str(e):
            import pkgutil

            import pydcop_tpu_torch.computations_graph as cg_pkg

            models = sorted(
                n for _, n, ispkg in pkgutil.iter_modules(cg_pkg.__path__)
                if not ispkg and not n.startswith("_") and n != "objects"
            )
            print(
                f"Error: unknown graph model {name!r}; available: "
                f"{', '.join(models)}",
                file=sys.stderr,
            )
            return 2
        if args.verbosity >= 3:
            raise
        if "pydcop_tpu_torch" not in str(e):
            print(
                f"Error: missing dependency: {e}. This looks like a "
                "broken installation; rerun with -vvv for the full "
                "traceback.",
                file=sys.stderr,
            )
            return 3
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except FileNotFoundError as e:
        print(f"Error: file not found: {e.filename}", file=sys.stderr)
        return 2
    except Exception as e:
        if args.verbosity >= 3:
            raise
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
