#!/usr/bin/env python3
"""Time the card's per-edge update (``ops/var_update.py``: v2f_update
and send_update) of this checkout beside another checkout's, on the
same inputs, in turns.

    python3 chip_var_update_compare.py OTHER_CHECKOUT [--rounds 2]

Runs one worker process per checkout in turns (this, other, other,
this, ...).  Each worker imports the ``pydcop_tpu_torch`` of its
checkout (which builds that checkout's kernels) and builds, with this
checkout's ``chip_smoke.py`` functions, the flagship (the 10,000-
variable colouring), the 1M-variable scale graph and the D = 128
time-to-cost graph, each with ``chip_smoke.tiny_state_arrays``'s
cycle-3 state.  On the first bucket of each it times both entry points
at damping 0.5: ``reps`` calls captured in a CUDA graph, replayed five
times, median per call.  A wrapper gets the bucket's ``var_ids32`` and
``edge_valid`` where its signature takes them.  Each worker also
hashes the sent messages, counts and ``stable`` flag, so the summary
says whether both checkouts' kernels give the same bits.  The last
lines are one JSON object of device milliseconds per shape and
checkout and the card's name and power limit.  It needs one CUDA card
and exits 1 without one; it imports nothing of JAX and nothing of the
JAX package.
"""

import argparse
import functools
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


@functools.lru_cache(maxsize=None)
def this_chip_smoke():
    """This checkout's chip_smoke.py, imported by path (the package on
    ``sys.path`` may be another checkout's)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def graph_ms(torch, fn, reps: int) -> float:
    """Median device milliseconds per call over five replays of ``reps``
    calls captured in one CUDA graph."""
    return this_chip_smoke().graph_ms(torch, fn, reps)[2]


def digest(torch, tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def worker(root: str):
    """Time both entry points of the checkout at ``root``."""
    sys.path.insert(0, root)
    import torch

    from pydcop_tpu_torch.dcop import dcop as dcop_mod
    from pydcop_tpu_torch.dcop import objects, relations
    from pydcop_tpu_torch.engine.compile import compile_dcop
    from pydcop_tpu_torch.engine.convert import graph_from_numpy
    from pydcop_tpu_torch.ops import maxsum as ops
    from pydcop_tpu_torch.ops import var_update as vu

    cs = this_chip_smoke()
    flagship, _ = compile_dcop(cs.build_flagship(
        objects, relations, dcop_mod, cs.FLAGSHIP_VARS), noise_level=0.01)
    shapes = {
        "flagship": lambda: graph_from_numpy(
            flagship.var_costs, flagship.var_valid,
            [(b.costs, b.var_ids) for b in flagship.buckets], "cuda"),
        "scale": lambda: graph_from_numpy(
            *cs.scale_arrays(cs.SCALE_VARS), "cuda"),
        "ttc_D128": lambda: graph_from_numpy(
            *cs.ttc_arrays(cs.TTC_VARS), "cuda"),
    }
    takes = {name: "edge_valid" in inspect.signature(fn).parameters
             for name, fn in (("v2f", vu.v2f_update),
                              ("send", vu.send_update))}
    out = {}
    for label, build in shapes.items():
        graph = build()
        s = cs.tiny_state_arrays(graph, seed=0)
        f2v = [torch.tensor(m, device="cuda") for m in s["f2v"]]
        v2f = torch.tensor(s["v2f"][0], device="cuda")
        cnt = torch.tensor(s["v2f_count"][0], device="cuda")
        beliefs, sums = ops.aggregate_beliefs(graph, tuple(f2v))
        b = graph.buckets[0]
        cyc = torch.tensor(3, dtype=torch.int32, device="cuda")
        stable = torch.ones((), dtype=torch.bool, device="cuda")
        kw = dict(damping=0.5, stability=0.1)
        arrays = {}
        if takes["v2f"]:
            arrays = dict(var_ids32=b.var_ids32, edge_valid=b.edge_valid)
        calls = {
            "v2f": lambda: vu.v2f_update(
                beliefs, sums, f2v[0], v2f, cnt, b.var_ids, graph.var_valid,
                cyc, stable, fused=ops._sums_fused(graph), **kw, **arrays),
            "send": lambda: vu.send_update(
                f2v[0], v2f, cnt, b.var_ids, graph.var_valid, cyc, stable,
                **kw, **(arrays if takes["send"] else {})),
        }
        reps = 50 if label == "scale" else 200
        for side, fn in calls.items():
            stable.fill_(True)
            sent, counts = fn()
            out[f"{label}_{side}_bits"] = digest(torch, (sent, counts,
                                                         stable))
            out[f"{label}_{side}"] = graph_ms(torch, fn, reps)
        del graph, f2v, v2f, cnt, beliefs, sums
    print(json.dumps(out), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", nargs="?")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--worker", metavar="ROOT")
    opts = parser.parse_args()
    if opts.worker:
        worker(opts.worker)
        return 0
    import torch

    if not torch.cuda.is_available() or opts.other is None:
        print("chip_var_update_compare: needs a CUDA card and "
              "OTHER_CHECKOUT", file=sys.stderr)
        return 1
    roots = {"this": HERE, "other": os.path.abspath(opts.other)}
    order = []
    for r in range(opts.rounds):
        order += ["this", "other"] if r % 2 == 0 else ["other", "this"]
    times = {name: {} for name in roots}
    bits = {}
    for name in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             roots[name]], cwd=roots[name], capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        for label, value in json.loads(proc.stdout.splitlines()[-1]).items():
            if label.endswith("_bits"):
                bits.setdefault(label, set()).add(value)
            else:
                times[name].setdefault(label, []).append(value)
        print(json.dumps({"checkout": name, "ms": {
            k: v[-1] for k, v in times[name].items()}}), flush=True)
    same = {label: len(v) == 1 for label, v in bits.items()}
    print(json.dumps({"order": order, "ms": times,
                      "same_bits_in_every_run": same}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
