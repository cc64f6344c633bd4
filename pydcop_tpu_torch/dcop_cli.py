"""Command-line interface of the port.

``python -m pydcop_tpu_torch solve --algo maxsum [--algo_params k:v]
[-c MAX_CYCLES] [--device cuda|cpu] [--collect_on MOMENT]
[--run_metrics FILE.csv] [--end_metrics FILE.csv] FILE.yaml`` solves a
DCOP on one torch device and prints the JSON result ``pydcop solve``
prints for a device solve (status, assignment, cost, violation, time,
msg_count, msg_size, cycle, compile_time, backend).

The metrics files are the reference's CSV (``commands/metrics_io.py``):
with ``--collect_on cycle_change``, ``--run_metrics`` gets one row per
cycle of a cost-trace run of the same solve (``MaxSumEngine.run_trace``)
for a MaxSum solve without decimation; each metrics file then gets the
final summary row.
"""

import argparse
import json
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
                       help="algorithm name (maxsum)")
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
    return parser


def run_solve(args) -> int:
    from pydcop_tpu_torch.algorithms import AlgorithmDef
    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.commands.metrics_io import add_csvline
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

    dcop = load_dcop_from_file(args.dcop_files)
    algo_def = AlgorithmDef.build_with_default_param(
        args.algo, parse_algo_params(args.algo_params),
        mode=dcop.objective)
    res = solve(dcop, algo_def, max_cycles=args.cycles, device=args.device)
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
            and algo_def.algo == "maxsum"
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
    return run_solve(args)


if __name__ == "__main__":
    sys.exit(main())
