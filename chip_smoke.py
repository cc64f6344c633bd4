#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pydcop_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout,
holds each kernel against its plain PyTorch version on the card, times
it beside its memory/compute bound, then drives the port's main path —
a MaxSum solve of the 10,000-variable 3-colouring flagship problem
through ``pydcop_tpu_torch.api.solve`` with no ``device`` argument —
and checks that the path went through the kernels and that its answers
are right: the card's run equals the port's CPU run bit for bit, in
every assignment and every final message, and repeats itself exactly.
Each phase prints one JSON line; any failure raises and the
script exits non-zero without the final line.  On success the last
three lines are the kernel table (JSON), the card's name and power
limit as nvidia-smi prints them, and
``{"ok": true, "device": {...}}``.

It needs one CUDA card, ``nvcc`` (PATH or /usr/local/cuda) and the
repository beside it; without a card it exits 1 and prints no result.
It imports nothing of JAX and nothing of the JAX package.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12      # HBM3 rate of one H100 SXM
H100_F32_OPS_PER_S = 67e12      # f32 peak outside the tensor cores
BIG = np.float32(1e9)
FLAGSHIP_VARS = 10_000
N_COLORS = 3
SCALE_VARS = 1_000_000
SCALE_CYCLES = 50
FIXED_CYCLES = 200
# binary_factor_update shapes (F, D): one factor, blocks short of and
# past the kernel's 128-factor block, every templated D (1..8), two
# generic ones (D > 8), the flagship and the scale bucket.
CHECK_SHAPES = [(1, 3), (7, 3), (128, 3), (1_000, 3), (300, 5), (50, 8),
                (64, 1), (129, 2), (200, 4), (130, 6), (257, 7), (333, 8),
                (77, 11), (40, 16), (15_000, 3), (1_500_000, 3)]
# The same through views one factor into a larger tensor: contiguous
# but not 16-byte aligned, so the kernel's 4-byte staging path runs.
CHECK_VIEWS = [(129, 3), (200, 4), (100, 8)]


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call over ``iters`` back-to-back
    calls, timed with CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, reps: int) -> float:
    """Device milliseconds per call, sorted over five replays: ``reps``
    calls captured once in a CUDA graph and replayed, so the host's
    launch overhead between calls is out of the measurement."""
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
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return sorted(times)


def profile_cycles(torch, run, cycles: int):
    """torch.profiler over ``run(cycles)`` (a fixed-cycle run that ends
    synchronised): device busy time per cycle, the device's busy share
    of the wall time, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    run(cycles)   # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(cycles)
        wall = time.perf_counter() - t0

    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # Kernel rows only: an aten:: row repeats its kernels' device time.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_s = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:14]
    return {
        "cycles": cycles,
        "wall_ms_per_cycle": wall / cycles * 1e3,
        "device_ms_per_cycle": (busy_s / cycles * 1e3 if events
                                else "not measured"),
        "device_busy_share": busy_s / wall if events else "not measured",
        "device_kernels_per_cycle": (sum(e.count for e in events) / cycles
                                     if events else "not measured"),
        "top": [{"name": e.key[:100], "calls": e.count,
                 "device_us": dev_us(e)} for e in top],
    }


def bucket_inputs(torch, f: int, d: int, seed: int):
    """Random costs [F,D,D] and messages [F,2,D] on the card; every 7th
    factor is domain-padded (BIG on its last slot), as compiled graphs
    with mixed domain sizes are, and every 5th has integer costs."""
    rng = np.random.default_rng(seed)
    costs = rng.normal(size=(f, d, d)).astype(np.float32)
    costs[::5] = np.round(costs[::5] * 4)
    msgs = rng.normal(size=(f, 2, d)).astype(np.float32)
    costs[::7, d - 1, :] = BIG
    costs[::7, :, d - 1] = BIG
    msgs[::7, :, d - 1] = BIG
    return (torch.tensor(costs, device="cuda"),
            torch.tensor(msgs, device="cuda"))


def binary_bound(f: int, d: int):
    """(bound_ms, bound_by): bytes each input read once and the output
    written once, against the f32 operations (add, add, min per term,
    both directions)."""
    bytes_moved = 4 * f * (d * d + 2 * d) + 4 * f * 2 * d
    ops = 3 * 2 * d * d * f
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def segment_bound(n_edges: int, n_seg: int, d: int):
    """(bound_ms, bound_by) of segment_sum: messages, perm, offsets and
    var_costs read once, sums and beliefs written once, against one add
    per edge element and one per belief."""
    bytes_moved = 4 * (n_edges * d + n_edges + (n_seg + 1) + n_seg * d
                       + 2 * n_seg * d)
    ops = n_edges * d + n_seg * d
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def edge_messages(torch, n_edges: int, d: int, seed: int):
    """Random flat f2v messages [E, D] on the card, spread over seven
    decades with BIG on every 11th edge's last slot, so a sum taken in
    another order changes its last bits."""
    rng = np.random.default_rng(seed)
    msgs = (rng.normal(size=(n_edges, d))
            * 10.0 ** rng.integers(-3, 4, size=(n_edges, d))
            ).astype(np.float32)
    msgs[::11, d - 1] = BIG
    return torch.tensor(msgs, device="cuda")


def aggregation_graphs(graph_from_numpy, flagship_graph):
    """(label, graph on the card) for the segment_sum checks: the
    flagship, the scale graph, a four-bucket (arities 1-4) graph with
    sentinel padding rows, and a hub of degree 3,000."""
    rng = np.random.default_rng(11)
    yield "flagship", flagship_graph
    var_costs, var_valid, buckets = scale_arrays(SCALE_VARS)
    yield "scale", graph_from_numpy(var_costs, var_valid, buckets,
                                    device="cuda")
    n_vars, d = 500, 4
    var_costs = rng.normal(size=(n_vars + 1, d)).astype(np.float32)
    var_costs[::3, d - 1] = BIG
    var_costs[-1] = 0.0
    buckets = []
    for arity, f in ((1, 300), (2, 800), (3, 400), (4, 200)):
        ids = rng.integers(0, n_vars, size=(f, arity)).astype(np.int32)
        ids[-f // 10:] = n_vars                # padding rows -> sentinel
        buckets.append((np.zeros((f,) + (d,) * arity, np.float32), ids))
    yield "multi_bucket_padded", graph_from_numpy(
        var_costs, np.ones_like(var_costs, bool), buckets, device="cuda")
    n_vars, f = 2_000, 3_000
    ids = rng.integers(1, n_vars, size=(f, 2)).astype(np.int32)
    ids[:, 0] = 0                              # variable 0: degree 3,000
    var_costs = rng.normal(size=(n_vars + 1, N_COLORS)).astype(np.float32)
    yield "hub", graph_from_numpy(
        var_costs, np.ones_like(var_costs, bool),
        [(np.zeros((f, N_COLORS, N_COLORS), np.float32), ids)],
        device="cuda")


def final_run(ops, state_to_numpy, graph, cycles: int, **kw):
    """A fixed-cycle run from zero messages: (final state as numpy,
    selected values as numpy)."""
    state, values = ops.run_maxsum(graph, cycles, stop_on_convergence=False,
                                   **kw)
    return state_to_numpy(state), values.cpu().numpy()


def run_differences(a, b):
    """Names of the fields in which two final_run results differ."""
    (sa, va), (sb, vb) = a, b
    diff = [] if np.array_equal(va, vb) else ["values"]
    for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
        for i, (x, y) in enumerate(zip(sa[field], sb[field])):
            if not np.array_equal(x, y):
                diff.append(f"{field}[{i}]")
    for field in ("stable", "cycle"):
        if sa[field] != sb[field]:
            diff.append(field)
    return diff


def first_divergence(ops, state_to_numpy, graph_a, graph_b, cycles: int,
                     **kw):
    """Step two graphs side by side from zero messages; the first cycle
    after which their states differ, and in which fields (None if they
    never do)."""
    sa, sb = ops.init_state(graph_a), ops.init_state(graph_b)
    for c in range(1, cycles + 1):
        sa = ops.superstep(sa, graph_a, **kw)
        sb = ops.superstep(sb, graph_b, **kw)
        na, nb = state_to_numpy(sa), state_to_numpy(sb)
        diff = run_differences((na, np.zeros(0)), (nb, np.zeros(0)))
        if diff:
            return {"cycle": c, "fields": diff}
    return None


def build_flagship(objects, relations, dcop_mod, n_vars: int, seed: int = 0):
    """bench.py build_dcop: n_vars-variable 3-colouring, cost-1 equality
    penalty per edge, ~1.5 edges per variable, duplicates skipped."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("colors", "color", list(range(N_COLORS)))
    dcop = dcop_mod.DCOP(f"gc_{n_vars}", objective="min")
    variables = [objects.Variable(f"v{i}", dom) for i in range(n_vars)]
    for v in variables:
        dcop.add_variable(v)
    eq = np.eye(N_COLORS, dtype=np.float64)
    seen = set()
    k = 0
    for _ in range(int(n_vars * 1.5)):
        i, j = rng.choice(n_vars, size=2, replace=False)
        key = (min(i, j), max(i, j))
        if key in seen:
            continue
        seen.add(key)
        dcop.add_constraint(relations.NAryMatrixRelation(
            [variables[i], variables[j]], eq, f"c{k}"))
        k += 1
    dcop.add_agents([objects.AgentDef(f"a{a}") for a in range(8)])
    return dcop


def scale_arrays(n_vars: int, edge_factor: float = 1.5):
    """bench.py bench_scale's array-level 3-colouring (seed 7,
    self-loops redrawn), built directly as numpy."""
    rng = np.random.default_rng(7)
    n_factors = int(n_vars * edge_factor)
    var_ids = rng.integers(0, n_vars, size=(n_factors, 2)).astype(np.int32)
    loop = var_ids[:, 0] == var_ids[:, 1]
    while loop.any():
        var_ids[loop, 1] = rng.integers(
            0, n_vars, size=int(loop.sum())).astype(np.int32)
        loop = var_ids[:, 0] == var_ids[:, 1]
    eq = np.eye(N_COLORS, dtype=np.float32)
    costs = np.ascontiguousarray(
        np.broadcast_to(eq, (n_factors, N_COLORS, N_COLORS)))
    var_costs = np.full((n_vars + 1, N_COLORS), BIG, np.float32)
    var_costs[:-1] = rng.random((n_vars, N_COLORS)) * 0.01
    var_valid = np.zeros((n_vars + 1, N_COLORS), bool)
    var_valid[:-1] = True
    return var_costs, var_valid, [(costs, var_ids)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from pydcop_tpu_torch import api
    from pydcop_tpu_torch.algorithms import AlgorithmDef
    from pydcop_tpu_torch.algorithms.maxsum import build_engine
    from pydcop_tpu_torch.dcop import dcop as dcop_mod
    from pydcop_tpu_torch.dcop import objects, relations
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file
    from pydcop_tpu_torch.engine.convert import (
        graph_from_numpy,
        state_to_numpy,
    )
    from pydcop_tpu_torch.ops import _build
    from pydcop_tpu_torch.ops import maxsum as ops
    from pydcop_tpu_torch.ops.binary_factor import (
        binary_factor_update,
        binary_factor_update_reference,
    )
    from pydcop_tpu_torch.ops.segment_sum import (
        segment_sum,
        segment_sum_reference,
    )

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()

    # 1. Environment.
    emit("environment", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=kind,
         count=torch.cuda.device_count(), python=sys.version.split()[0])

    # 2. Build every kernel of the port, one nvcc per source, together.
    names = _build.kernel_names()
    build_s = _build.build(names)
    for name in names:
        _build.load(name)
    emit("build", kernels=names, seconds=build_s)

    # 3a. binary_factor_update vs its plain version on the card:
    # bit-equal (same add order, no multiply to contract into an FMA).
    max_err = {"binary_factor_update": 0.0, "segment_sum": 0.0}
    cases = [(f, d, False) for f, d in CHECK_SHAPES] + [
        (f, d, True) for f, d in CHECK_VIEWS]
    for idx, (f, d, view) in enumerate(cases):
        costs, v2f = bucket_inputs(torch, f + view, d, seed=idx)
        if view:
            costs, v2f = costs[1:], v2f[1:]
        out = binary_factor_update(costs, v2f)
        ref = binary_factor_update_reference(costs, v2f)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        max_err["binary_factor_update"] = max(
            max_err["binary_factor_update"], err)
        if not torch.equal(out, ref):
            fail(f"binary kernel != plain at F={f} D={d} view={view}: "
                 f"max |err| {err}")
        if not torch.isfinite(out).all():
            fail(f"non-finite kernel output at F={f} D={d}")
        del costs, v2f, out, ref
    emit("kernel_check", kernel="binary_factor_update", shapes=CHECK_SHAPES,
         unaligned_views=CHECK_VIEWS, tolerance="exact (torch.equal)",
         max_abs_err=max_err["binary_factor_update"])

    # 5a. Build the flagship problem (the main path's shapes come from it).
    t0 = time.perf_counter()
    dcop = build_flagship(objects, relations, dcop_mod, FLAGSHIP_VARS)
    n_constraints = len(dcop.constraints)
    build_dcop_s = time.perf_counter() - t0
    params = AlgorithmDef.build_with_default_param("maxsum").params
    engine = build_engine(dcop, params)

    # 3b. segment_sum on the card vs its plain version on CPU copies
    # (the CPU's index_add_ is the edge-order definition): bit-equal.
    agg = {}
    for idx, (label, graph) in enumerate(
            aggregation_graphs(graph_from_numpy, engine.graph)):
        n_edges = int(graph.agg_perm.shape[0])
        n_seg, d = graph.var_costs.shape
        msgs = edge_messages(torch, n_edges, d, seed=50 + idx)
        args = (msgs, graph.agg_perm, graph.agg_offsets, graph.agg_buckets,
                graph.var_costs)
        beliefs, sums = segment_sum(*args)
        ref_b, ref_s = segment_sum_reference(*(t.cpu() for t in args))
        err = max(float((beliefs.cpu() - ref_b).abs().max()),
                  float((sums.cpu() - ref_s).abs().max()))
        max_err["segment_sum"] = max(max_err["segment_sum"], err)
        if not (torch.equal(beliefs.cpu(), ref_b)
                and torch.equal(sums.cpu(), ref_s)):
            fail(f"segment_sum kernel != plain on {label}: max |err| {err}")
        degree = graph.agg_offsets[1:] - graph.agg_offsets[:-1]
        agg[label] = dict(V1=n_seg, E=n_edges, D=d,
                          buckets=len(graph.buckets),
                          max_degree=int(degree.max()))
        if label == "scale":
            scale_graph = graph
        del graph, msgs, args, beliefs, sums
    emit("kernel_check", kernel="segment_sum", graphs=agg,
         tolerance="exact (torch.equal, card vs CPU index_add_)",
         max_abs_err=max_err["segment_sum"])

    # 4. Kernel timing at the main path's shapes and the scale shapes.
    timing = {"binary_factor_update": {}, "segment_sum": {}}
    for label, f in (("flagship", n_constraints), ("scale", 1_500_000)):
        costs, v2f = bucket_inputs(torch, f, N_COLORS, seed=100)
        reps = 200 if label == "flagship" else 50

        def kernel():
            return binary_factor_update(costs, v2f)

        def plain():
            return binary_factor_update_reference(costs, v2f)

        bound_ms, bound_by = binary_bound(f, N_COLORS)
        k_ms, p_ms = graph_ms(torch, kernel, reps), graph_ms(torch, plain,
                                                             reps)
        timing["binary_factor_update"][label] = dict(
            F=f, D=N_COLORS, ms=k_ms[2], plain_ms=p_ms[2],
            ms_spread=[k_ms[0], k_ms[-1]],
            plain_ms_spread=[p_ms[0], p_ms[-1]],
            call_ms=cuda_ms(torch, kernel, reps),
            plain_call_ms=cuda_ms(torch, plain, reps),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        del costs, v2f
    emit("kernel_timing", kernel="binary_factor_update",
         **timing["binary_factor_update"])

    for label, graph in (("flagship", engine.graph), ("scale", scale_graph)):
        n_edges = int(graph.agg_perm.shape[0])
        n_seg, d = graph.var_costs.shape
        msgs = edge_messages(torch, n_edges, d, seed=100)
        args = (msgs, graph.agg_perm, graph.agg_offsets, graph.agg_buckets,
                graph.var_costs)
        seg = torch.cat([b.var_ids.reshape(-1) for b in graph.buckets])
        reps = 200 if label == "flagship" else 50

        def kernel():
            return segment_sum(*args)

        def plain():
            return segment_sum_reference(*args)

        def library():
            # The one-call form (atomics, no fixed order): yardstick only.
            sums = torch.zeros_like(graph.var_costs)
            sums.index_add_(0, seg, msgs)
            return graph.var_costs + sums

        bound_ms, bound_by = segment_bound(n_edges, n_seg, d)
        k_ms, p_ms, l_ms = (graph_ms(torch, fn, reps)
                            for fn in (kernel, plain, library))
        timing["segment_sum"][label] = dict(
            V1=n_seg, E=n_edges, D=d, ms=k_ms[2], plain_ms=p_ms[2],
            library_ms=l_ms[2], ms_spread=[k_ms[0], k_ms[-1]],
            plain_ms_spread=[p_ms[0], p_ms[-1]],
            library_ms_spread=[l_ms[0], l_ms[-1]],
            call_ms=cuda_ms(torch, kernel, reps),
            bound_ms=bound_ms, bound_by=bound_by)
        del msgs, args, seg
    emit("kernel_timing", kernel="segment_sum", **timing["segment_sum"])

    # 5. Main path, full size: api.solve with NO device argument.  Each
    # superstep launches each kernel once; the final value selection
    # launches segment_sum once more.
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    res = api.solve(dcop, "maxsum", max_cycles=FIXED_CYCLES)
    launches = dict(_build.launch_counts)
    want = {"binary_factor_update": res["cycles"],
            "segment_sum": res["cycles"] + 1}
    if launches != want:
        fail(f"main path launched {launches}, expected {want} for "
             f"{res['cycles']} supersteps")
    if not res["metrics"]["device"].startswith("cuda"):
        fail(f"main path ran on {res['metrics']['device']}")
    if not np.isfinite(res["cost"]):
        fail(f"non-finite cost {res['cost']}")
    emit("main_path_solve", n_vars=FLAGSHIP_VARS,
         n_constraints=n_constraints, build_dcop_s=build_dcop_s,
         status=res["status"], cycles=res["cycles"], time_s=res["time"],
         cycles_per_s=res["metrics"]["cycles_per_s"], cost=res["cost"],
         violations=res["violations"], total_time_s=res["total_time"],
         launches=launches,
         peak_mem_bytes=torch.cuda.max_memory_allocated())

    warm = api.solve(dcop, "maxsum", max_cycles=FIXED_CYCLES, warmup=True)
    if warm["assignment"] != res["assignment"] or warm["cost"] != res["cost"]:
        fail(f"warm api.solve (cost {warm['cost']}) differs from the cold "
             f"one (cost {res['cost']})")
    emit("main_path_solve_warm", status=warm["status"],
         cycles=warm["cycles"], time_s=warm["time"],
         cycles_per_s=warm["metrics"]["cycles_per_s"], cost=warm["cost"])

    state = engine.init_state()
    tensors = [engine.graph.var_costs, engine.graph.var_valid,
               engine.graph.agg_perm, engine.graph.agg_offsets,
               engine.graph.agg_buckets,
               *[t for b in engine.graph.buckets for t in b],
               *state.v2f, *state.f2v, *state.v2f_count, *state.f2v_count,
               state.stable, state.cycle]
    if not all(t.is_cuda for t in tensors):
        fail("engine graph/state not on the card")
    engine.run(FIXED_CYCLES, stop_on_convergence=False)          # warm-up
    torch.cuda.reset_peak_memory_stats()
    repeat_s = []
    for _ in range(3):
        before = dict(_build.launch_counts)
        fixed = engine.run(FIXED_CYCLES, stop_on_convergence=False)
        grew = {k: _build.launch_counts[k] - before.get(k, 0)
                for k in want}
        if (grew != {"binary_factor_update": FIXED_CYCLES,
                     "segment_sum": FIXED_CYCLES + 1}
                or fixed.cycles != FIXED_CYCLES):
            fail(f"fixed run: {fixed.cycles} cycles, launches {grew}")
        repeat_s.append(fixed.time_s)
    gpu_cost, _ = dcop.solution_cost(fixed.assignment)
    peak_fixed = torch.cuda.max_memory_allocated()
    cpu_engine = build_engine(dcop, params, device="cpu")
    cpu = cpu_engine.run(FIXED_CYCLES, stop_on_convergence=False)
    cpu_cost, _ = dcop.solution_cost(cpu.assignment)
    n_agree = sum(fixed.assignment[v] == cpu.assignment[v]
                  for v in fixed.assignment)
    if n_agree != FLAGSHIP_VARS or gpu_cost != cpu_cost:
        fail(f"card vs CPU after {FIXED_CYCLES} cycles: {n_agree} of "
             f"{FLAGSHIP_VARS} assignments agree, cost {gpu_cost} vs "
             f"{cpu_cost}")
    emit("main_path_fixed", cycles=fixed.cycles, time_s=fixed.time_s,
         repeat_time_s=repeat_s,
         cycles_per_s=fixed.metrics["cycles_per_s"], cost=gpu_cost,
         peak_mem_bytes=peak_fixed, cpu_cost=cpu_cost,
         cpu_time_s=cpu.time_s, assignments_equal=int(n_agree))

    # 5b. Bit-equality of the whole run: two card runs and the CPU run
    # give the same values and the same final state, every message.
    kw = dict(damping=engine.damping, damp_vars=engine.damp_vars,
              damp_factors=engine.damp_factors, stability=engine.stability)
    card = [final_run(ops, state_to_numpy, engine.graph, FIXED_CYCLES, **kw)
            for _ in range(2)]
    cpu_run = final_run(ops, state_to_numpy, cpu_engine.graph, FIXED_CYCLES,
                        **kw)
    for name, other in (("second card run", card[1]), ("CPU run", cpu_run)):
        diff = run_differences(card[0], other)
        if diff:
            div = first_divergence(ops, state_to_numpy, engine.graph,
                                   cpu_engine.graph, FIXED_CYCLES, **kw)
            fail(f"flagship card run != {name} in {diff}; card vs CPU "
                 f"first differ at {div}")
    emit("main_path_bit_equal", cycles=FIXED_CYCLES,
         compared=["card run 1", "card run 2", "CPU run"],
         fields=["values", "v2f", "f2v", "v2f_count", "f2v_count",
                 "stable", "cycle"],
         messages_per_field=int(sum(a.size for a in card[0][0]["f2v"])))
    del card, cpu_run

    emit("main_path_profile", **profile_cycles(
        torch, lambda n: engine.run(n, stop_on_convergence=False), 20))

    # 6. Scale leg: 1M variables / 1.5M factors built as arrays.
    graph = scale_graph
    ops.run_maxsum(graph, 3, stop_on_convergence=False)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    state, values = ops.run_maxsum(graph, SCALE_CYCLES,
                                   stop_on_convergence=False)
    torch.cuda.synchronize()
    scale_s = time.perf_counter() - t0
    grew = dict(_build.launch_counts)
    scale_cost = float(ops.assignment_constraint_cost(graph, values))
    if (grew != {"binary_factor_update": SCALE_CYCLES,
                 "segment_sum": SCALE_CYCLES + 1}
            or int(state.cycle) != SCALE_CYCLES):
        fail(f"scale leg: {int(state.cycle)} cycles, launches {grew}")
    if not (np.isfinite(scale_cost) and int(values.min()) >= 0
            and int(values.max()) < N_COLORS):
        fail(f"scale leg: bad result (cost {scale_cost})")
    peak_scale = torch.cuda.max_memory_allocated()
    first = (state_to_numpy(state), values.cpu().numpy())
    del state, values
    again = final_run(ops, state_to_numpy, graph, SCALE_CYCLES)
    diff = run_differences(first, again)
    if diff:
        fail(f"scale leg: two card runs differ in {diff}")
    del again
    var_costs, var_valid, buckets = scale_arrays(SCALE_VARS)
    t0 = time.perf_counter()
    cpu_scale = final_run(ops, state_to_numpy, graph_from_numpy(
        var_costs, var_valid, buckets, device="cpu"), SCALE_CYCLES)
    cpu_scale_s = time.perf_counter() - t0
    del var_costs, var_valid, buckets
    diff = run_differences(first, cpu_scale)
    if diff:
        fail(f"scale leg: card run != CPU run in {diff}")
    del first, cpu_scale
    emit("scale_leg", n_vars=SCALE_VARS, n_factors=graph.buckets[0]
         .costs.shape[0], cycles=SCALE_CYCLES,
         s_per_cycle=scale_s / SCALE_CYCLES, cost=scale_cost,
         launches=grew, peak_mem_bytes=peak_scale,
         bit_equal=["card run 1", "card run 2", "CPU run"],
         cpu_s=cpu_scale_s)

    def scale_run(n):
        ops.run_maxsum(graph, n, stop_on_convergence=False)
        torch.cuda.synchronize()

    emit("scale_profile", **profile_cycles(torch, scale_run, 5))
    del graph, scale_graph

    # 7. Fixture parity: the verify oracle.
    fixture = os.path.join(HERE, "tests", "instances", "coloring_12_3.yml")
    fres = api.solve(load_dcop_from_file(fixture), "maxsum", max_cycles=60)
    if fres["cost"] != 5000.0:
        fail(f"coloring_12_3.yml solved to {fres['cost']}, expected 5000.0")
    emit("fixture_parity", fixture="tests/instances/coloring_12_3.yml",
         cycles=fres["cycles"], cost=fres["cost"])

    emit("done", total_s=time.perf_counter() - t_start)
    sources = {
        "binary_factor_update": ("pydcop_tpu_torch/csrc/"
                                 "binary_factor_update.cu",
                                 "pydcop_tpu/ops/pallas_maxsum.py:54"),
        "segment_sum": ("pydcop_tpu_torch/csrc/segment_sum.cu",
                        "pydcop_tpu/ops/maxsum.py:389"),
    }
    rows = []
    for name, (source, replaces) in sources.items():
        flag = timing[name]["flagship"]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": flag["ms"],
            "plain_ms": flag["plain_ms"],
            "bound_ms": flag["bound_ms"],
            "bound_by": flag["bound_by"],
            "library_ms": flag["library_ms"],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
