#!/usr/bin/env python3
"""Time the card's belief aggregation and whole MaxSum runs of this
checkout beside another checkout's, on the same inputs, in turns.

    python3 chip_compare.py OTHER_CHECKOUT [--rounds 2]

Builds chip_smoke.py's aggregation graphs from their seeds (the 1M-
variable scale graph, the scale-free graph of the same size, a hub of
degree 3,000 and a four-bucket graph with sentinel padding) and random
per-bucket messages, saves them under ``build/compare/``, then runs one
worker process per checkout in turns (this, other, other, this, ...).
Each worker imports the ``pydcop_tpu_torch`` of its checkout (which
builds that checkout's kernels), checks ``ops.aggregate_beliefs`` on
the card against the same call on the CPU bit for bit, and times it:
``reps`` calls captured in a CUDA graph, replayed five times, median
per call.  ``aggregate_beliefs(graph, f2v)`` is the one entry both
sides share whatever their kernel's own signature.  Each worker also
times whole fixed-cycle runs (``ops.run_maxsum``) on the flagship
(chip_smoke.py's 10,000-variable colouring, 200 cycles) and the
1M-variable scale graph (30 cycles): wall ms per cycle, best of three
after a warm-up, and the CUDA kernels per cycle that torch.profiler
counts over 20 (flagship) or 5 (scale) cycles.  The local-search leg
times, on the same arrays, DSA-B and MGM (lexic) runs (``ops.dsa.run_dsa``,
``ops.mgm.run_mgm``) at the flagship (200 cycles) and the scale graph
(30 cycles): wall ms per cycle (best of three), device ms per cycle and
kernels per cycle (torch.profiler over 20 or 5 cycles); and the kernels
both checkouts share an entry for: ``localsearch.candidate_costs`` (the
positional sum with its gathers) at both sizes, ``threefry.uniform``
and ``threefry.best_choice`` at [1,000,001 x 3] (40 % masked) and
``binary_factor_update`` at 1.5M factors, each in a CUDA graph as
above.  The last lines are one JSON object of milliseconds per shape
and checkout and the card's name and power limit.  It needs one CUDA card and exits 1
without one; it imports nothing of JAX and nothing of the JAX package.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
INPUTS = os.path.join(HERE, "build", "compare", "inputs.npz")
SHAPES = ("scale", "scale_free", "hub", "multi_bucket_padded")


def make_inputs():
    """chip_smoke.py's aggregation graphs, as arrays, with messages."""
    sys.path.insert(0, HERE)
    import chip_smoke

    arrays = {}
    graphs = chip_smoke.aggregation_graphs(
        lambda var_costs, var_valid, buckets, device: (
            var_costs, var_valid, buckets), None)
    for i, (label, graph) in enumerate(graphs):
        if label not in SHAPES:
            continue
        var_costs, var_valid, buckets = graph
        arrays[f"{label}/var_costs"] = var_costs
        arrays[f"{label}/var_valid"] = var_valid
        rng = np.random.default_rng(300 + i)
        d = var_costs.shape[1]
        for b, (costs, ids) in enumerate(buckets):
            shape = ids.shape + (d,)
            arrays[f"{label}/costs{b}"] = costs
            arrays[f"{label}/ids{b}"] = ids
            arrays[f"{label}/f2v{b}"] = (
                rng.normal(size=shape)
                * 10.0 ** rng.integers(-3, 4, size=shape)).astype(np.float32)
    os.makedirs(os.path.dirname(INPUTS), exist_ok=True)
    np.savez(INPUTS, **arrays)


def graph_ms(torch, fn, reps: int) -> float:
    """Median device milliseconds per call over five replays of ``reps``
    calls captured in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[2]


def worker(root: str):
    """Check and time aggregate_beliefs of the checkout at ``root``."""
    sys.path.insert(0, root)
    import torch

    from pydcop_tpu_torch.engine.convert import graph_from_numpy
    from pydcop_tpu_torch.ops import maxsum as ops

    data = np.load(INPUTS)
    out = {}
    for label in SHAPES:
        n_buckets = sum(k.startswith(f"{label}/ids") for k in data.files)
        buckets = [(data[f"{label}/costs{b}"], data[f"{label}/ids{b}"])
                   for b in range(n_buckets)]
        args = (data[f"{label}/var_costs"], data[f"{label}/var_valid"],
                buckets)
        f2v = [data[f"{label}/f2v{b}"] for b in range(n_buckets)]
        card = graph_from_numpy(*args, device="cuda")
        cpu = graph_from_numpy(*args, device="cpu")
        f2v_card = tuple(torch.tensor(m, device="cuda") for m in f2v)
        got = ops.aggregate_beliefs(card, f2v_card)
        want = ops.aggregate_beliefs(cpu, tuple(torch.tensor(m)
                                                for m in f2v))
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise SystemExit(f"{root}: card != CPU on {label}")
        reps = 50 if card.agg_perm.shape[0] > 1_000_000 else 200
        out[label] = graph_ms(
            torch, lambda: ops.aggregate_beliefs(card, f2v_card), reps)
        del card, cpu, f2v_card
    out.update(run_timings(torch, ops, graph_from_numpy))
    out.update(localsearch_timings(torch, graph_from_numpy))
    print(json.dumps(out), flush=True)


def kernels_per_cycle(torch, run, cycles: int) -> float:
    """CUDA kernels per cycle of ``run(cycles)`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(cycles)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / cycles


def run_timings(torch, ops, graph_from_numpy):
    """Whole-run ms/cycle and kernels/cycle at the flagship and scale
    shapes (chip_smoke.py's arrays, built by this checkout)."""
    import time

    sys.path.insert(0, HERE)
    import chip_smoke

    from pydcop_tpu_torch.engine.compile import compile_dcop
    from pydcop_tpu_torch.dcop import dcop as dcop_mod
    from pydcop_tpu_torch.dcop import objects, relations

    flagship, _ = compile_dcop(chip_smoke.build_flagship(
        objects, relations, dcop_mod, chip_smoke.FLAGSHIP_VARS),
        noise_level=0.01)
    graphs = {
        "flagship": (graph_from_numpy(
            flagship.var_costs, flagship.var_valid,
            [(b.costs, b.var_ids) for b in flagship.buckets], "cuda"),
            200, 20),
        "scale": (graph_from_numpy(
            *chip_smoke.scale_arrays(chip_smoke.SCALE_VARS), "cuda"),
            30, 5),
    }
    out = {}
    for label, (graph, cycles, prof_cycles) in graphs.items():
        def run(n, graph=graph):
            ops.run_maxsum(graph, n, stop_on_convergence=False)
            torch.cuda.synchronize()

        run(cycles)                                   # warm
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(cycles)
            times.append(time.perf_counter() - t0)
        out[f"{label}_run_ms_per_cycle"] = min(times) / cycles * 1e3
        out[f"{label}_kernels_per_cycle"] = kernels_per_cycle(
            torch, run, prof_cycles)
    return out


def localsearch_timings(torch, graph_from_numpy):
    """The local-search leg: DSA-B and MGM runs and the kernels both
    checkouts share an entry for, at the flagship and scale shapes."""
    import time

    sys.path.insert(0, HERE)
    import chip_smoke

    from pydcop_tpu_torch.algorithms.mgm import lexic_ranks
    from pydcop_tpu_torch.dcop import dcop as dcop_mod
    from pydcop_tpu_torch.dcop import objects, relations
    from pydcop_tpu_torch.engine.compile import compile_dcop
    from pydcop_tpu_torch.ops import localsearch, threefry
    from pydcop_tpu_torch.ops.binary_factor import binary_factor_update
    from pydcop_tpu_torch.ops.dsa import run_dsa
    from pydcop_tpu_torch.ops.mgm import run_mgm
    from pydcop_tpu_torch.utils import prng

    host, meta = compile_dcop(chip_smoke.build_flagship(
        objects, relations, dcop_mod, chip_smoke.FLAGSHIP_VARS))
    flagship = graph_from_numpy(host.var_costs, host.var_valid,
                                [(b.costs, b.var_ids) for b in host.buckets],
                                "cuda")
    scale = graph_from_numpy(
        *chip_smoke.scale_arrays(chip_smoke.SCALE_VARS), "cuda")
    n = scale.var_costs.shape[0]
    scale_ranks = torch.arange(n, dtype=torch.float32, device="cuda")
    scale_ranks[-1] = float("inf")
    sizes = {
        "flagship": (flagship, torch.tensor(lexic_ranks(meta),
                                            device="cuda"), 200, 20),
        "scale": (scale, scale_ranks, 30, 5),
    }
    out = {}
    for label, (graph, ranks, cycles, prof_cycles) in sizes.items():
        runs = {
            "dsa_B": lambda k, g=graph: run_dsa(g, k, variant="B"),
            "mgm": lambda k, g=graph, r=ranks: run_mgm(g, k, lexic_ranks=r),
        }
        for algo, fn in runs.items():
            def run(k, fn=fn):
                fn(k)
                torch.cuda.synchronize()

            run(cycles)                               # warm
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                run(cycles)
                times.append(time.perf_counter() - t0)
            prof = chip_smoke.profile_cycles(torch, run, prof_cycles)
            key = f"{algo}_{label}"
            out[f"{key}_ms_per_cycle"] = min(times) / cycles * 1e3
            out[f"{key}_device_ms_per_cycle"] = prof["device_ms_per_cycle"]
            out[f"{key}_kernels_per_cycle"] = prof[
                "device_kernels_per_cycle"]
        values = torch.tensor(np.random.default_rng(5).integers(
            0, graph.var_costs.shape[1], graph.var_costs.shape[0]).astype(
                np.int32), device="cuda")
        out[f"candidate_costs_{label}"] = graph_ms(
            torch, lambda g=graph: localsearch.candidate_costs(g, values),
            200 if label == "flagship" else 50)
    key = prng.key_words(12345)
    rng = np.random.default_rng(21)
    mask = torch.tensor(chip_smoke.best_choice_mask(rng, 1_000_001, 3),
                        device="cuda")
    out["uniform_f32_scale_D3"] = graph_ms(
        torch, lambda: threefry.uniform(key, (1_000_001, 3), "cuda"), 50)
    out["best_choice_scale"] = graph_ms(
        torch, lambda: threefry.best_choice(key, mask), 50)
    costs, v2f = chip_smoke.bucket_inputs(torch, 1_500_000, 3, seed=100)
    out["binary_factor_update_scale"] = graph_ms(
        torch, lambda: binary_factor_update(costs, v2f), 50)
    return out


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
        print("chip_compare: needs a CUDA card and OTHER_CHECKOUT",
              file=sys.stderr)
        return 1
    make_inputs()
    roots = {"this": HERE, "other": os.path.abspath(opts.other)}
    order = []
    for r in range(opts.rounds):
        order += ["this", "other"] if r % 2 == 0 else ["other", "this"]
    times = {name: {} for name in roots}
    for name in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             roots[name]], cwd=roots[name], capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        for label, ms in json.loads(proc.stdout.splitlines()[-1]).items():
            times[name].setdefault(label, []).append(ms)
        print(json.dumps({"checkout": name, "ms": {
            k: v[-1] for k, v in times[name].items()}}), flush=True)
    print(json.dumps({"order": order, "ms": times}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
