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
Then it drives the other MaxSum paths the same way, each with the
launch counts zeroed just before it: branch-and-bound pruning and the
cost trace on bench.py's time-to-cost instance and at 20,000
variables, the sorted / ell / boundary aggregations, the aggregation
autotuner (``aggregation="auto"``), the CLI's per-cycle metrics, and
the segmented solve: checkpoint and resume at the flagship and the
1M-variable scale arrays (snapshots written by the card and by the
CPU, resumed on the card), guard-and-recover through the whole
escalation ladder, and decimation, each held equal to the plain or the
CPU run in every final message.  It also holds the fused
per-edge kernel ``csrc/var_update.cu`` against its plain version at
every shape (every D = 1..8 on buckets no tile divides, and on views
off a 16-byte boundary), times both its entry points against one bound
that counts the work, and its tile sizes at scale, holds the card's
run of a state full of subnormal-producing messages against the CPU's,
and drives the observability paths: a
traced, metered flagship solve equal to the plain one (with its
profiler entry: kernels per cycle and the three hand kernels), the
engine probe at the 1M-variable scale (with the roofline's
``hbm_util``), the live telemetry endpoint during a solve, and the
``trace summary`` / ``profile report`` commands.  The local-search
slice adds four phases: ``threefry_check`` (both entry points of
``csrc/threefry.cu`` bit for bit against their plain versions, timed
beside their integer-work bounds, and the plain key-tensor draw's
launches and host reads), ``positional_sum_check`` (``segment_sum.cu``'s
positional mode bit for bit against its plain version on four graphs,
timed beside its bound and ``index_add_``), ``localsearch_flagship``
(dsa, adsa, dsatuto, mgm and mgm2 with their options through
``api.solve`` on the flagship: card = CPU = second card run, the
launch counts, and the ops loop under
``torch.cuda.set_sync_debug_mode("error")``, timed and profiled) and
``localsearch_scale`` (DSA-B and MGM at 1M variables: card = CPU state
by state over 5 cycles, 30 timed cycles, the profile).  The breakout
slice adds DBA (the flagship's edges as a CSP, which stops on its
counters before the cycle budget; ``infinity: 1`` on the flagship as it
is), GDBA (three mode triples) and MixedDSA (variants A, B and C on
infinite equality costs with soft tables on half the edges) to
``localsearch_flagship`` — DBA's chunk of gated steps under the
synchronisation check, its host reads counted (at most ceil(cycles /
chunk) + 1) and its chunk sizes timed — and DBA, GDBA and MixedDSA-B to
``localsearch_scale`` (card = CPU state by state: values, keys,
weights, counters, modifiers); and the belief sum on graphs with
one-edge buckets (card = plain version, bit for bit) to the
``segment_sum`` kernel check.
Each phase prints one JSON line (with ``t_s``, the seconds since the
start); any failure raises and the
script exits non-zero without the final line.  On success the last
three lines are the kernel table (JSON), the card's name and power
limit as nvidia-smi prints them, and
``{"ok": true, "device": {...}}``.

It needs one CUDA card, ``nvcc`` (PATH or /usr/local/cuda) and the
repository beside it; without a card it exits 1 and prints no result.
It imports nothing of JAX and nothing of the JAX package.
"""

import collections
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
SCALE_CYCLES = 30
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
# bench.py's time-to-cost instance (build_ttc_graph, bench_time_to_cost):
# 240 variables, D = 128, seed 11, 160 fixed cycles, pruned.
TTC_VARS = 240
TTC_DOMAIN = 128
TTC_SEED = 11
TTC_CYCLES = 160
# The same recipe at a size that fills the card with tables (1.97 GB,
# and as much again for the pruned update's transposed copy).
PRUNE_SCALE_VARS = 20_000
PRUNE_SCALE_CYCLES = 40
# The segmented solve (checkpoints, recovery, decimation): the scale
# arrays' 60 cycles in three segments, and the flagship's decimated
# solves: 10 % of the variables clamped per 60-cycle round, and a
# threshold run clamping the variables whose belief margin exceeds
# 0.005 (the flagship's margins sit near its unary noise, 0.0005-0.015
# from 10 to 60 cycles, median 0.003).
CKPT_SCALE_VARS = SCALE_VARS
CKPT_SCALE_CYCLES = 60
DECIM_CYCLES = 1000
DECIM_MARGIN = 0.005
DECIM_MARGIN_CYCLES = 300


T_START = time.perf_counter()


def emit(phase: str, **fields):
    """One JSON line for a phase, with the seconds since the start."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - T_START}), flush=True)


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


def eager_ms(torch, fn, calls: int):
    """Milliseconds per call between CUDA events, sorted over five rounds
    of ``calls`` eager calls: for a plain version that reads the host
    (segment_sum's edge-rank walk reads the degrees), which a CUDA graph
    cannot capture; host gaps between its launches count."""
    return sorted(cuda_ms(torch, fn, calls, warmup=1) for _ in range(5))


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


def segment_args(torch, graph, msgs):
    """segment_sum's arguments for flat messages [E, D] on ``graph``:
    the buckets as views into ``msgs``, in bucket order."""
    sizes = [b.var_ids.numel() for b in graph.buckets]
    return (torch.split(msgs, sizes), graph.agg_perm, graph.agg_offsets,
            graph.agg_buckets, graph.var_costs, graph.agg_tiles)


def aggregation_graphs(graph_from_numpy, flagship_graph):
    """(label, graph on the card) for the segment_sum checks: the
    flagship, the scale graph, the scale-free graph of the same size, a
    four-bucket (arities 1-4) graph with sentinel padding rows, and a
    hub of degree 3,000 (two shared-memory passes at D = 3)."""
    rng = np.random.default_rng(11)
    yield "flagship", flagship_graph
    var_costs, var_valid, buckets = scale_arrays(SCALE_VARS)
    yield "scale", graph_from_numpy(var_costs, var_valid, buckets,
                                    device="cuda")
    var_costs, var_valid, buckets = scalefree_arrays(SCALE_VARS)
    yield "scale_free", graph_from_numpy(var_costs, var_valid, buckets,
                                         device="cuda")
    yield "multi_bucket_padded", graph_from_numpy(
        *multi_bucket_arrays(rng), device="cuda")
    n_vars, f = 2_000, 3_000
    ids = rng.integers(1, n_vars, size=(f, 2)).astype(np.int32)
    ids[:, 0] = 0                              # variable 0: degree 3,000
    var_costs = rng.normal(size=(n_vars + 1, N_COLORS)).astype(np.float32)
    yield "hub", graph_from_numpy(
        var_costs, np.ones_like(var_costs, bool),
        [(np.zeros((f, N_COLORS, N_COLORS), np.float32), ids)],
        device="cuda")


def multi_bucket_arrays(rng):
    """(var_costs, var_valid, buckets) of a 500-variable graph with
    buckets of arity 1-4, D = 4, a tenth of each bucket's rows padding
    (the sentinel row V)."""
    n_vars, d = 500, 4
    var_costs = rng.normal(size=(n_vars + 1, d)).astype(np.float32)
    var_costs[::3, d - 1] = BIG
    var_costs[-1] = 0.0
    buckets = []
    for arity, f in ((1, 300), (2, 800), (3, 400), (4, 200)):
        ids = rng.integers(0, n_vars, size=(f, arity)).astype(np.int32)
        ids[-f // 10:] = n_vars                # padding rows -> sentinel
        buckets.append((np.zeros((f,) + (d,) * arity, np.float32), ids))
    return var_costs, np.ones_like(var_costs, bool), buckets


# One-factor arity-1 buckets (one edge each) among buckets of more and
# of fewer than V + 1 edges, (arity, F) per bucket: XLA turns their
# one-row scatters into one-row updates and moves them
# (segment_sum.positional_fold; ROADMAP Queue C's belief-sum fault).
ONE_EDGE_LAYOUTS = [
    [(1, 1), (2, 30)], [(2, 30), (1, 1), (2, 25)], [(2, 30), (1, 1)],
    [(2, 30), (1, 1), (1, 1), (2, 30)], [(2, 2), (1, 1), (2, 30)],
    [(1, 60), (1, 1), (1, 50)],
]


def one_edge_arrays(layout, n_rows: int, d: int, seed: int):
    """(var_costs, var_valid, buckets) of a layout over real variables."""
    rng = np.random.default_rng(seed)
    buckets = []
    for arity, f in layout:
        ids = np.stack([rng.choice(n_rows - 1, size=arity, replace=False)
                        for _ in range(f)]).astype(np.int32)
        buckets.append((np.zeros((f,) + (d,) * arity, np.float32), ids))
    var_costs = (rng.normal(size=(n_rows, d)) * 10).astype(np.float32)
    return var_costs, np.ones_like(var_costs, bool), buckets


def one_edge_belief_check(torch, ops, graph_from_numpy, _build):
    """``ops.aggregate_beliefs`` on the card against the plain version
    on the CPU, bit for bit (int32 views), on every one-edge layout at
    V + 1 in {5, 21, 41} and D in {1, 3, 5}, under ``scatter`` (the
    fold moves the one-edge buckets) and ``sorted`` (one running sum:
    unaffected); each card call launches the kernel once."""
    n = moved = 0
    for i, layout in enumerate(ONE_EDGE_LAYOUTS):
        for n_rows in (5, 21, 41):
            for d in (1, 3, 5):
                arrays = one_edge_arrays(layout, n_rows, d, seed=i + n_rows)
                for strategy in ("scatter", "sorted"):
                    card, cpu = (graph_from_numpy(*arrays, device=dev,
                                                  aggregation=strategy)
                                 for dev in ("cuda", "cpu"))
                    rng = np.random.default_rng(7 * i + d)
                    f2v = [(rng.normal(size=tuple(b.var_ids.shape) + (d,))
                            * 10.0 ** rng.integers(
                                -3, 4, size=tuple(b.var_ids.shape) + (d,))
                            ).astype(np.float32) for b in cpu.buckets]
                    before = _build.launch_counts["segment_sum"]
                    got = ops.aggregate_beliefs(card, tuple(
                        torch.tensor(m, device="cuda") for m in f2v))
                    if _build.launch_counts["segment_sum"] != before + 1:
                        fail(f"one-edge layout {layout}: no kernel launch")
                    want = ops.aggregate_beliefs(cpu, tuple(
                        torch.tensor(m) for m in f2v))
                    for g, w in zip(got, want):
                        if not torch.equal(g.cpu().view(torch.int32),
                                           w.view(torch.int32)):
                            fail(f"belief sum card != plain on one-edge "
                                 f"layout {layout}, V+1 = {n_rows}, D = "
                                 f"{d}, {strategy}")
                    n += 1
                    moved += card.agg_order != tuple(range(len(layout)))
    return {"graphs": n, "moved_by_the_fold": moved,
            "layouts": ONE_EDGE_LAYOUTS, "V1": [5, 21, 41], "D": [1, 3, 5],
            "strategies": ["scatter", "sorted"],
            "tolerance": "exact (int32 views)"}


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


def build_flagship(objects, relations, dcop_mod, n_vars: int, seed: int = 0,
                   eq_cost: float = 1.0, extra_soft: bool = False):
    """bench.py build_dcop: n_vars-variable 3-colouring, cost-1 equality
    penalty per edge, ~1.5 edges per variable, duplicates skipped.
    ``eq_cost`` replaces the penalty (10000: the CSP of the reference's
    ``coloring_csp`` rule; inf: hard constraints); ``extra_soft`` adds,
    as that rule does, a random soft table (seed + 1) on each of the
    first half of the edges."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("colors", "color", list(range(N_COLORS)))
    dcop = dcop_mod.DCOP(f"gc_{n_vars}", objective="min")
    variables = [objects.Variable(f"v{i}", dom) for i in range(n_vars)]
    for v in variables:
        dcop.add_variable(v)
    eq = np.where(np.eye(N_COLORS) > 0, eq_cost, 0.0)
    seen = set()
    edges = []
    for _ in range(int(n_vars * 1.5)):
        i, j = rng.choice(n_vars, size=2, replace=False)
        key = (min(i, j), max(i, j))
        if key in seen:
            continue
        seen.add(key)
        dcop.add_constraint(relations.NAryMatrixRelation(
            [variables[i], variables[j]], eq, f"c{len(edges)}"))
        edges.append((i, j))
    if extra_soft:
        soft = np.random.default_rng(seed + 1)
        for k, (i, j) in enumerate(edges[:len(edges) // 2]):
            dcop.add_constraint(relations.NAryMatrixRelation(
                [variables[i], variables[j]],
                soft.random((N_COLORS, N_COLORS)), f"s{k}"))
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
    return coloring_arrays(rng, n_vars, var_ids)


def scalefree_arrays(n_vars: int, edge_factor: float = 1.5):
    """The scale graph's sizes with scale-free degrees: both endpoints
    of each factor drawn with weight (i + 1) ** -0.5 over a seeded
    random relabelling of the variables (seed 13, self-loops redrawn),
    so hubs of ~1,500 edges sit at random places and ~10 % of the
    variables have none."""
    rng = np.random.default_rng(13)
    n_factors = int(n_vars * edge_factor)
    weight = (np.arange(n_vars) + 1.0) ** -0.5
    weight /= weight.sum()
    relabel = rng.permutation(n_vars).astype(np.int32)

    def draw(k):
        return relabel[rng.choice(n_vars, size=k, p=weight)]

    var_ids = draw(2 * n_factors).reshape(n_factors, 2)
    loop = var_ids[:, 0] == var_ids[:, 1]
    while loop.any():
        var_ids[loop, 1] = draw(int(loop.sum()))
        loop = var_ids[:, 0] == var_ids[:, 1]
    return coloring_arrays(rng, n_vars, var_ids)


def ttc_arrays(n_vars: int, seed: int = TTC_SEED):
    """bench.py build_ttc_graph's time-to-cost instance at ``n_vars``
    variables, built directly as numpy: a loopy D = 128 colouring,
    1.5 equality factors (cost 1) per variable, self-loops moved to
    the next variable, integer unary costs in [0, 400), so pruned and
    dense runs stay bit-identical.  Returns (var_costs, var_valid,
    buckets)."""
    rng = np.random.default_rng(seed)
    n_factors = int(n_vars * 1.5)
    var_ids = rng.integers(0, n_vars, size=(n_factors, 2)).astype(np.int32)
    loop = var_ids[:, 0] == var_ids[:, 1]
    var_ids[loop, 1] = (var_ids[loop, 0] + 1) % n_vars
    eye = np.eye(TTC_DOMAIN, dtype=np.float32)
    costs = np.ascontiguousarray(np.broadcast_to(
        eye, (n_factors, TTC_DOMAIN, TTC_DOMAIN)))
    var_costs = np.full((n_vars + 1, TTC_DOMAIN), BIG, np.float32)
    var_costs[:-1] = rng.integers(
        0, 400, size=(n_vars, TTC_DOMAIN)).astype(np.float32)
    var_valid = np.zeros((n_vars + 1, TTC_DOMAIN), bool)
    var_valid[:-1] = True
    return var_costs, var_valid, [(costs, var_ids)]


def coloring_arrays(rng, n_vars: int, var_ids):
    """(var_costs, var_valid, buckets) of a 3-colouring with binary
    equality factors ``var_ids`` and small random unary costs."""
    n_factors = var_ids.shape[0]
    eq = np.eye(N_COLORS, dtype=np.float32)
    costs = np.ascontiguousarray(
        np.broadcast_to(eq, (n_factors, N_COLORS, N_COLORS)))
    var_costs = np.full((n_vars + 1, N_COLORS), BIG, np.float32)
    var_costs[:-1] = rng.random((n_vars, N_COLORS)) * 0.01
    var_valid = np.zeros((n_vars + 1, N_COLORS), bool)
    var_valid[:-1] = True
    return var_costs, var_valid, [(costs, var_ids)]


def trace_run(ctx, graph, cycles: int, prune: bool):
    """A fixed-cycle cost-trace run from zero messages: ((final state,
    values) as numpy, the cost curve as numpy, pruned-step cycles)."""
    stats = {}
    state, values, costs = ctx["ops"].run_maxsum_trace(
        graph, cycles, stop_on_convergence=False, prune=prune, stats=stats)
    return ((ctx["state_to_numpy"](state), values.cpu().numpy()),
            costs.cpu().numpy(), stats["prune_fast_cycles"])


def timed_run(ctx, graph, cycles: int, prune: bool):
    """Seconds of a fixed-cycle run (ended by a synchronise), its
    pruned-step cycles, its launches and its result as numpy."""
    torch, ops, _build = ctx["torch"], ctx["ops"], ctx["_build"]
    stats = {}
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    state, values = ops.run_maxsum(graph, cycles, stop_on_convergence=False,
                                   prune=prune, stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    return (seconds, stats["prune_fast_cycles"], launches,
            (ctx["state_to_numpy"](state), values.cpu().numpy()))


def phase_prune_ttc(ctx):
    """bench.py's time-to-cost instance, pruned: the card's pruned and
    dense traces and the CPU's pruned trace equal bit for bit in values,
    every final message and the cost curve."""
    torch, _build = ctx["torch"], ctx["_build"]
    t_phase = time.perf_counter()
    arrays = ttc_arrays(TTC_VARS)
    card = ctx["graph_from_numpy"](*arrays, device="cuda")
    cpu = ctx["graph_from_numpy"](*arrays, device="cpu")
    _build.launch_counts.clear()
    pruned = trace_run(ctx, card, TTC_CYCLES, True)
    launches = dict(_build.launch_counts)
    fast = pruned[2]
    want = {"binary_factor_update": TTC_CYCLES - fast,
            "segment_sum": 2 * TTC_CYCLES + 1,
            "var_update": 2 * TTC_CYCLES}
    if launches != want or fast == 0:
        fail(f"prune_ttc launched {launches}, expected {want} "
             f"({fast} pruned cycles)")
    dense = trace_run(ctx, card, TTC_CYCLES, False)
    on_cpu = trace_run(ctx, cpu, TTC_CYCLES, True)
    for name, other in (("dense card trace", dense),
                        ("pruned CPU trace", on_cpu)):
        diff = run_differences(pruned[0], other[0])
        if not np.array_equal(pruned[1], other[1]):
            diff.append("cost curve")
        if diff:
            fail(f"prune_ttc: pruned card trace != {name} in {diff}")
    if on_cpu[2] != fast:
        fail(f"prune_ttc: {fast} pruned cycles on the card, {on_cpu[2]} "
             "on the CPU")
    costs = pruned[1]
    ref = float(costs[-1])
    cycles_to_ref = int(np.nonzero(costs <= ref)[0][0]) + 1
    # bench_time_to_cost's timed quantity: warm untraced fixed runs.
    times = {}
    for prune in (True, False, False, True):
        seconds, _, _, _ = timed_run(ctx, card, TTC_CYCLES, prune)
        times.setdefault(prune, []).append(seconds)
    # binary_factor_update at this shape (F = 360, D = 128): the
    # generic D > 8 kernel.
    from pydcop_tpu_torch.ops.binary_factor import (
        binary_factor_update,
        binary_factor_update_reference,
    )

    table = card.buckets[0].costs
    v2f = torch.tensor(pruned[0][0]["v2f"][0], device="cuda")
    if not torch.equal(binary_factor_update(table, v2f),
                       binary_factor_update_reference(table, v2f)):
        fail("binary kernel != plain at the TTC shape")
    f, d = table.shape[0], table.shape[1]
    k_ms = graph_ms(torch, lambda: binary_factor_update(table, v2f), 200)
    p_ms = graph_ms(torch, lambda: binary_factor_update_reference(
        table, v2f), 50)
    bound_ms, bound_by = binary_bound(f, d)
    kernel = dict(F=f, D=d, ms=k_ms[2], ms_spread=[k_ms[0], k_ms[-1]],
                  plain_ms=p_ms[2], bound_ms=bound_ms, bound_by=bound_by,
                  library_ms=None,
                  launches=launches["binary_factor_update"])
    return dict(
        binary_factor_update=kernel,
        n_vars=TTC_VARS, n_factors=int(arrays[2][0][1].shape[0]),
        D=TTC_DOMAIN, cycles=TTC_CYCLES, seed=TTC_SEED,
        fast_phase_cycles=fast, launches=launches, ref_cost=ref,
        cycles_to_ref=cycles_to_ref,
        bit_equal=["pruned card trace", "dense card trace",
                   "pruned CPU trace"],
        pruned_ms_per_cycle=[t / TTC_CYCLES * 1e3 for t in times[True]],
        dense_ms_per_cycle=[t / TTC_CYCLES * 1e3 for t in times[False]],
        seconds=time.perf_counter() - t_phase)


def phase_prune_scale(ctx):
    """The time-to-cost recipe at 20,000 variables (1.97 GB of tables):
    pruned and dense runs equal bit for bit; ms per cycle of each, the
    pruned update's time per call, the prune tables' build (paid again
    by every segment of a segmented pruned run) and
    binary_factor_update's at F = 30,000, D = 128 beside its bound."""
    torch, ops = ctx["torch"], ctx["ops"]
    from pydcop_tpu_torch.ops.binary_factor import (
        binary_factor_update,
        binary_factor_update_reference,
    )

    t_phase = time.perf_counter()
    arrays = ttc_arrays(PRUNE_SCALE_VARS)
    graph = ctx["graph_from_numpy"](*arrays, device="cuda")
    del arrays
    ops.run_maxsum(graph, 2, stop_on_convergence=False, prune=True)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pruned_s, fast, launches, pruned = timed_run(
        ctx, graph, PRUNE_SCALE_CYCLES, True)
    peak_pruned = torch.cuda.max_memory_allocated()
    want = {"binary_factor_update": PRUNE_SCALE_CYCLES - fast,
            "segment_sum": PRUNE_SCALE_CYCLES + 1,
            "var_update": 2 * PRUNE_SCALE_CYCLES}
    if launches != want or fast == 0:
        fail(f"prune_scale launched {launches}, expected {want} "
             f"({fast} pruned cycles)")
    dense_s, _, dense_launches, dense = timed_run(
        ctx, graph, PRUNE_SCALE_CYCLES, False)
    diff = run_differences(pruned, dense)
    if diff:
        fail(f"prune_scale: pruned run != dense run in {diff}")
    del dense
    # Per call, on the messages of the final state.
    bucket = graph.buckets[0]
    pt = ops.prune_tables(graph)[0]
    # What each segment of a segmented pruned run pays to rebuild them.
    tables_ms = cuda_ms(torch, lambda: ops.prune_tables(graph), 3,
                        warmup=1)
    v2f = torch.tensor(pruned[0]["v2f"][0], device="cuda")
    fits = bool(ops.prune_fits((v2f,), (pt,)))
    f, d = bucket.costs.shape[0], bucket.costs.shape[1]
    pruned_ms = cuda_ms(torch, lambda: ops._pruned_binary_update(
        bucket, v2f, pt), 20)
    del pt
    k_ms = cuda_ms(torch, lambda: binary_factor_update(bucket.costs, v2f),
                   20)
    p_ms = cuda_ms(torch, lambda: binary_factor_update_reference(
        bucket.costs, v2f), 3, warmup=1)
    bound_ms, bound_by = binary_bound(f, d)
    out = binary_factor_update(bucket.costs, v2f)
    ref = binary_factor_update_reference(bucket.costs, v2f)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not torch.equal(out, ref):
        fail(f"binary kernel != plain at F={f} D={d}: max |err| {err}")
    del out, ref, v2f, graph, bucket
    return dict(
        n_vars=PRUNE_SCALE_VARS, n_factors=f, D=d,
        cycles=PRUNE_SCALE_CYCLES, fast_phase_cycles=fast,
        launches=launches, dense_launches=dense_launches,
        bit_equal=["pruned card run", "dense card run"],
        pruned_ms_per_cycle=pruned_s / PRUNE_SCALE_CYCLES * 1e3,
        dense_ms_per_cycle=dense_s / PRUNE_SCALE_CYCLES * 1e3,
        pruned_update_ms=pruned_ms, pruned_update_fits=fits,
        prune_tables_ms=tables_ms, peak_mem_bytes=peak_pruned,
        binary_factor_update=dict(
            F=f, D=d, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, max_abs_err=err,
            launches=launches["binary_factor_update"]),
        seconds=time.perf_counter() - t_phase)


def strategy_graph(ctx, arrays, strategy, device="cuda"):
    return ctx["graph_from_numpy"](*arrays, device=device,
                                   aggregation=strategy)


def phase_aggregation_options(ctx, flagship_scatter):
    """The flagship solved with sorted and with ell (card = CPU bit for
    bit; sorted = scatter, one bucket); the four-bucket graph run with
    sorted (the kernel's one-running-sum mode, card = CPU); the mode
    against its plain version at scale on two buckets; one
    aggregate_beliefs call per strategy timed at the flagship and scale
    shapes; boundary held within the reference's tolerance on the
    reference's own check."""
    torch, ops, api, _build = (ctx["torch"], ctx["ops"], ctx["api"],
                               ctx["_build"])
    from pydcop_tpu_torch.ops.segment_sum import (
        segment_sum,
        segment_sum_reference,
    )

    from pydcop_tpu_torch.dcop import dcop as dcop_mod
    from pydcop_tpu_torch.dcop import objects, relations

    t_phase = time.perf_counter()
    dcop, params, kw = ctx["dcop"], ctx["params"], ctx["kw"]
    out = {"solves": {}}
    for strategy in ("sorted", "ell"):
        _build.launch_counts.clear()
        res = api.solve(dcop, "maxsum", max_cycles=FIXED_CYCLES,
                        algo_params={"aggregation": strategy})
        launches = dict(_build.launch_counts)
        uses_kernel = strategy == "sorted"
        if (launches.get("binary_factor_update", 0) != res["cycles"]
                or (launches.get("segment_sum", 0) > 0) != uses_kernel):
            fail(f"{strategy} solve launched {launches}")
        p = dict(params, aggregation=strategy)
        card = final_run(ops, ctx["state_to_numpy"], ctx["build_engine"](
            dcop, p).graph, FIXED_CYCLES, **kw)
        cpu = final_run(ops, ctx["state_to_numpy"], ctx["build_engine"](
            dcop, p, device="cpu").graph, FIXED_CYCLES, **kw)
        diff = run_differences(card, cpu)
        if diff:
            fail(f"flagship {strategy}: card run != CPU run in {diff}")
        same_as_scatter = not run_differences(card, flagship_scatter)
        if strategy == "sorted" and not same_as_scatter:
            fail("flagship sorted run != scatter run (one bucket)")
        out["solves"][strategy] = dict(
            cycles=res["cycles"], cost=res["cost"], status=res["status"],
            time_s=res["time"], launches=launches,
            card_equals_cpu=True, equals_scatter=same_as_scatter)

    # The four-bucket graph with sorted: the kernel's one-running-sum
    # mode on a path, card = CPU.
    arrays = multi_bucket_arrays(np.random.default_rng(11))
    graph = strategy_graph(ctx, arrays, "sorted")
    _build.launch_counts.clear()
    card = final_run(ops, ctx["state_to_numpy"], graph, 50)
    launches = dict(_build.launch_counts)
    if launches.get("segment_sum", 0) != 51:
        fail(f"four-bucket sorted run launched {launches}")
    cpu = final_run(ops, ctx["state_to_numpy"],
                    strategy_graph(ctx, arrays, "sorted", "cpu"), 50)
    diff = run_differences(card, cpu)
    if diff:
        fail(f"four-bucket sorted run: card != CPU in {diff}")
    out["multi_bucket_sorted_run"] = dict(
        cycles=50, buckets=len(arrays[2]), launches=launches,
        card_equals_cpu=True)

    # The sorted mode against its plain version, and timed, at the scale
    # shape with a unary bucket beside the binary one (two buckets).
    var_costs, var_valid, scale_buckets = scale_arrays(SCALE_VARS)
    unary = np.arange(SCALE_VARS, dtype=np.int32)[:, None]
    two = ctx["graph_from_numpy"](
        var_costs, var_valid,
        [(np.zeros((SCALE_VARS, N_COLORS), np.float32), unary)]
        + scale_buckets, device="cuda", aggregation="sorted")
    n_edges = int(two.agg_perm.shape[0])
    n_seg, d = two.var_costs.shape
    msgs = edge_messages(torch, n_edges, d, seed=300)
    args = segment_args(torch, two, msgs)
    flat_args = (msgs,) + args[1:5]
    beliefs, sums = segment_sum(*args, one_sum=True)
    ref_b, ref_s = segment_sum_reference(
        msgs.cpu(), *(t.cpu() for t in args[1:5]), one_sum=True)
    err = max(float((beliefs.cpu() - ref_b).abs().max()),
              float((sums.cpu() - ref_s).abs().max()))
    if not (torch.equal(beliefs.cpu(), ref_b)
            and torch.equal(sums.cpu(), ref_s)):
        fail(f"segment_sum sorted mode != plain at scale: max |err| {err}")
    seg = torch.cat([b.var_ids.reshape(-1) for b in two.buckets])

    def library():
        s = torch.zeros_like(two.var_costs)
        s.index_add_(0, seg, msgs)
        return two.var_costs + s

    k_ms = graph_ms(torch, lambda: segment_sum(*args, one_sum=True), 50)
    split_ms = graph_ms(torch, lambda: segment_sum(*args), 50)
    p_ms = eager_ms(torch, lambda: segment_sum_reference(
        *flat_args, one_sum=True), 2)
    l_ms = graph_ms(torch, library, 50)
    bound_ms, bound_by = segment_bound(n_edges, n_seg, d)
    sorted_timing = {"sorted_scale_two_buckets": dict(
        V1=n_seg, E=n_edges, D=d, buckets=2, ms=k_ms[2],
        ms_spread=[k_ms[0], k_ms[-1]], odd_even_ms=split_ms[2],
        plain_ms=p_ms[2], library_ms=l_ms[2], bound_ms=bound_ms,
        bound_by=bound_by, max_abs_err=err,
        launches=out["solves"]["sorted"]["launches"]["segment_sum"])}
    del msgs, args, flat_args, seg, two, beliefs, sums, ref_b, ref_s

    # One aggregate_beliefs call per strategy, flagship and scale.
    from pydcop_tpu_torch.engine.compile import compile_dcop

    compiled, _ = compile_dcop(dcop, noise_level=0.01)
    flag_arrays = (compiled.var_costs, compiled.var_valid,
                   [(b.costs, b.var_ids) for b in compiled.buckets])
    # boundary within the reference's tolerance, on the reference's own
    # check (tests/unit/test_aggregation.py: a 300-variable colouring,
    # messages after 3 supersteps); its f32 prefix sum grows with E, so
    # at the flagship it is reported, not held.
    small = ctx["build_engine"](build_flagship(
        objects, relations, dcop_mod, 300, seed=5), params)
    f2v = ops.run_maxsum(small.graph, 3, stop_on_convergence=False)[0].f2v
    small_arrays = (small.graph.var_costs.cpu().numpy(),
                    small.graph.var_valid.cpu().numpy(),
                    [(b.costs.cpu().numpy(), b.var_ids.cpu().numpy())
                     for b in small.graph.buckets])
    got = ops.aggregate_beliefs(
        strategy_graph(ctx, small_arrays, "boundary"), f2v)
    want = ops.aggregate_beliefs(small.graph, f2v)
    boundary_err = max(float((a - b).abs().max())
                       for a, b in zip(got, want))
    if not all(torch.allclose(a, b, rtol=1e-5, atol=1e-5)
               for a, b in zip(got, want)):
        fail(f"boundary outside rtol = atol = 1e-5 of scatter: max |err| "
             f"{boundary_err}")
    out["boundary_check"] = dict(
        n_vars=300, supersteps=3, tolerance="rtol = atol = 1e-5",
        max_abs_err=boundary_err)
    del small, f2v, got, want

    per_call = {}
    for label, arrays in (("flagship", flag_arrays),
                          ("scale", (var_costs, var_valid, scale_buckets))):
        sums = {}
        row = {}
        for strategy in ("scatter", "sorted", "ell", "boundary"):
            graph = strategy_graph(ctx, arrays, strategy)
            f2v = tuple(
                edge_messages(torch, b.var_ids.numel(), d, seed=400)
                .reshape(tuple(b.var_ids.shape) + (d,))
                for b in graph.buckets)
            reps = 200 if label == "flagship" else (
                50 if strategy in ("scatter", "sorted") else 10)
            t = graph_ms(torch, lambda: ops.aggregate_beliefs(graph, f2v),
                         reps)
            row[strategy] = dict(ms=t[2], ms_spread=[t[0], t[-1]])
            if label == "flagship":
                normal = tuple(torch.randn(m.shape, device="cuda",
                                           generator=torch.Generator(
                                               "cuda").manual_seed(5))
                               for m in f2v)
                first = ops.aggregate_beliefs(graph, normal)[1]
                again = ops.aggregate_beliefs(graph, normal)[1]
                if not torch.equal(first, again):
                    fail(f"{strategy} aggregation does not repeat itself")
                sums[strategy] = first
            del graph, f2v
        per_call[label] = row
        if label == "flagship":
            per_call["flagship_boundary_max_abs_err"] = float(
                (sums["boundary"] - sums["scatter"]).abs().max())
            for strategy in ("sorted", "ell"):
                if not torch.equal(sums[strategy][:-1],
                                   sums["scatter"][:-1]):
                    fail(f"flagship {strategy} sums != scatter sums")
    out["aggregate_beliefs_ms"] = per_call
    out["sorted_mode_timing"] = sorted_timing
    out["seconds"] = time.perf_counter() - t_phase
    return out


def phase_auto(ctx):
    """api.solve(aggregation="auto") on the card: measured, recorded in
    the metrics, then replayed from the stored decision (a file under
    build/, never under the home directory)."""
    api, _build = ctx["api"], ctx["_build"]
    t_phase = time.perf_counter()
    cache = os.path.join(HERE, "build", "chip_smoke_agg_autotune.json")
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    if os.path.exists(cache):
        os.remove(cache)
    os.environ["PYDCOP_AGG_AUTOTUNE_CACHE"] = cache
    dcop = ctx["dcop"]
    _build.launch_counts.clear()
    first = api.solve(dcop, "maxsum", max_cycles=FIXED_CYCLES,
                      algo_params={"aggregation": "auto"})
    launches = dict(_build.launch_counts)
    second = api.solve(dcop, "maxsum", max_cycles=FIXED_CYCLES,
                       algo_params={"aggregation": "auto"})
    m1, m2 = first["metrics"], second["metrics"]
    if m1.get("aggregation_source") != "measured" or not all(
            m1["aggregation_timings_ms"].get(s) for s in
            ("scatter", "sorted", "ell", "boundary")):
        fail(f"auto did not measure: {m1}")
    if (m2.get("aggregation_source") != "cache"
            or m2["aggregation"] != m1["aggregation"]):
        fail(f"auto did not replay the decision: {m2}")
    if (second["assignment"] != first["assignment"]
            or second["cost"] != first["cost"]):
        fail("auto: the replayed solve differs from the measured one")
    if launches.get("binary_factor_update", 0) != first["cycles"]:
        fail(f"auto solve launched {launches}")
    return dict(decision=m1["aggregation"],
                timings_ms=m1["aggregation_timings_ms"],
                key=m1["aggregation_key"], replay=m2["aggregation_source"],
                cycles=first["cycles"], cost=first["cost"],
                launches=launches, seconds=time.perf_counter() - t_phase)


def phase_cli_trace(ctx):
    """``python -m pydcop_tpu_torch solve --collect_on cycle_change
    --run_metrics F`` on coloring_12_3.yml, 60 cycles, run in this
    process through the CLI's own main(): one CSV row per cycle, then
    the summary row, final cost 5000.0."""
    import contextlib
    import csv
    import io

    from pydcop_tpu_torch import dcop_cli

    _build = ctx["_build"]
    t_phase = time.perf_counter()
    path = os.path.join(HERE, "build", "chip_smoke_cycle_metrics.csv")
    if os.path.exists(path):
        os.remove(path)
    fixture = os.path.join(HERE, "tests", "instances", "coloring_12_3.yml")
    out = io.StringIO()
    _build.launch_counts.clear()
    with contextlib.redirect_stdout(out):
        rc = dcop_cli.main(["solve", "--algo", "maxsum", "-c", "60",
                            "--collect_on", "cycle_change", "--run_metrics",
                            path, fixture])
    launches = dict(_build.launch_counts)
    result = json.loads(out.getvalue())
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    trace, summary = rows[:-1], rows[-1]
    if (rc != 0 or len(trace) != result["cycle"] or result["cycle"] != 60
            or result["cost"] != 5000.0
            or float(trace[-1]["cost"]) != 5000.0
            or float(summary["cost"]) != 5000.0):
        fail(f"cli_trace: rc {rc}, {len(trace)} trace rows, result "
             f"{result['cost']} after {result['cycle']} cycles")
    if not launches.get("binary_factor_update") or not launches.get(
            "segment_sum"):
        fail(f"cli_trace launched {launches}")
    return dict(fixture="tests/instances/coloring_12_3.yml",
                cycles=result["cycle"], rows=len(rows),
                final_cost=result["cost"],
                first_costs=[float(r["cost"]) for r in trace[:5]],
                launches=launches, seconds=time.perf_counter() - t_phase)


def snapshot_differences(ctx, path, engine, plain):
    """Fields in which the solver state of the snapshot at ``path``
    (loaded onto ``engine``'s device) differs from ``plain``
    (state_to_numpy form)."""
    state, _ = ctx["load_state"](path, engine.init_state())
    got = ctx["state_to_numpy"](state)
    return run_differences((got, np.zeros(0)), (plain, np.zeros(0)))


def checksum(ctx, path):
    return ctx["read_meta"](path)["checksum"]


def phase_checkpoint_flagship(ctx):
    """The flagship's segmented solve (200 fixed cycles, a snapshot
    every 50) on the card: with the asynchronous writer it equals the
    card's plain run in values and every final message; a run stopped
    after 2 segments and resumed from disk equals it too; so does a
    snapshot written by a CPU run of the port, resumed on the card, and
    the card's cycle-100 snapshot has the CPU's checksum.  Times the
    plain, segmented-sync and segmented-async runs."""
    import tempfile

    _build = ctx["_build"]
    engine, cpu_engine = ctx["engine"], ctx["cpu_engine"]
    plain_state, plain_values = ctx["flagship_scatter"]
    plain_assignment = engine.meta.assignment_from_indices(plain_values)
    every = 50
    kw = dict(max_cycles=FIXED_CYCLES, segment_cycles=every,
              stop_on_convergence=False)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        mgr = ctx["CheckpointManager"](os.path.join(tmp, "async"),
                                       every=every, keep=FIXED_CYCLES)
        _build.launch_counts.clear()
        res = engine.run_checkpointed(manager=mgr, checkpoint_async=True,
                                      **kw)
        launches = dict(_build.launch_counts)
        want = {"binary_factor_update": FIXED_CYCLES,
                "segment_sum": FIXED_CYCLES + FIXED_CYCLES // every,
                "var_update": 2 * FIXED_CYCLES}
        if launches != want:
            fail(f"checkpoint_flagship launched {launches}, want {want}")
        if res.assignment != plain_assignment or res.cycles != FIXED_CYCLES:
            fail("checkpoint_flagship: segmented run != plain run")
        diff = snapshot_differences(ctx, mgr.path_for(FIXED_CYCLES),
                                    engine, plain_state)
        if diff or res.metrics["checkpoints_written"] != 4:
            fail(f"checkpoint_flagship: final snapshot != plain run in "
                 f"{diff}")

        # Stopped after 2 segments, resumed from disk on the card.
        part_mgr = ctx["CheckpointManager"](os.path.join(tmp, "part"),
                                            every=every, keep=2)
        part = engine.run_checkpointed(manager=part_mgr, max_segments=2,
                                       **kw)
        resumed = ctx["resume_from_checkpoint"](
            engine, part_mgr, max_cycles=FIXED_CYCLES,
            segment_cycles=every, stop_on_convergence=False)
        diff = snapshot_differences(ctx, part_mgr.path_for(FIXED_CYCLES),
                                    engine, plain_state)
        if (not part.metrics["interrupted"] or part.cycles != 100
                or resumed.metrics["resumed_from_cycle"] != 100
                or resumed.assignment != plain_assignment or diff):
            fail(f"checkpoint_flagship: resumed run != plain run ({diff})")

        # Written by a CPU run of the port, resumed on the card.
        cpu_mgr = ctx["CheckpointManager"](os.path.join(tmp, "cpu"),
                                           every=every, keep=2)
        cpu_engine.run_checkpointed(manager=cpu_mgr, max_segments=2,
                                    checkpoint_async=False, **kw)
        cpu_sum = checksum(ctx, cpu_mgr.path_for(100))
        card_sum = checksum(ctx, mgr.path_for(100))
        if cpu_sum != card_sum:
            fail("checkpoint_flagship: cycle-100 snapshot checksums differ "
                 "between the CPU and the card")
        from_cpu = ctx["resume_from_checkpoint"](
            engine, cpu_mgr, max_cycles=FIXED_CYCLES, segment_cycles=every,
            stop_on_convergence=False)
        diff = snapshot_differences(ctx, cpu_mgr.path_for(FIXED_CYCLES),
                                    engine, plain_state)
        if from_cpu.assignment != plain_assignment or diff:
            fail(f"checkpoint_flagship: CPU snapshot resumed on the card "
                 f"!= plain run ({diff})")

        # Timing, warm, in turns.
        times = {"plain": [], "segmented_sync": [], "segmented_async": []}
        snapshot_bytes = mgr.writes[-1]["bytes"]
        for rep in range(2):
            times["plain"].append(engine.run(
                FIXED_CYCLES, stop_on_convergence=False).time_s)
            for mode, is_async in (("segmented_sync", False),
                                   ("segmented_async", True)):
                m = ctx["CheckpointManager"](
                    os.path.join(tmp, f"{mode}{rep}"), every=every, keep=2)
                times[mode].append(engine.run_checkpointed(
                    manager=m, checkpoint_async=is_async, **kw).time_s)
    return dict(
        n_vars=len(engine.meta.var_names), cycles=FIXED_CYCLES, every=every,
        bit_equal=["segmented async = plain", "stopped at 100 + resumed "
                   "= plain", "CPU-written snapshot resumed on the card = "
                   "plain", "cycle-100 checksum card = CPU"],
        checksum_100=card_sum, snapshot_bytes=snapshot_bytes,
        ms_per_cycle={k: [t / FIXED_CYCLES * 1e3 for t in v]
                      for k, v in times.items()},
        launches=launches, seconds=time.perf_counter() - t_phase)


def scale_engine(ctx, n_vars: int):
    """A MaxSumEngine on the card over bench.py's 1M-variable scale
    arrays (seed 7), built as arrays: meta names the variables v<i>."""
    from pydcop_tpu_torch.engine.compile import (
        CompiledFactorGraph,
        FactorBucket,
        FactorGraphMeta,
    )

    var_costs, var_valid, buckets = scale_arrays(n_vars)
    graph = CompiledFactorGraph(
        var_costs=var_costs, var_valid=var_valid,
        buckets=tuple(FactorBucket(c, ids) for c, ids in buckets))
    meta = FactorGraphMeta(
        var_names=tuple(f"v{i}" for i in range(n_vars)),
        domains=(tuple(range(N_COLORS)),) * n_vars, factor_names=(),
        bucket_sizes=tuple(ids.shape[0] for _, ids in buckets), mode="min")
    return ctx["MaxSumEngine"](graph, meta, device=ctx["dev"])


def phase_checkpoint_scale(ctx):
    """The 1M-variable scale arrays, 60 fixed cycles: unsegmented, and
    segmented every 20 cycles with the synchronous writer and with the
    asynchronous one; the snapshot's bytes and each write's host copy,
    checksum and file seconds; how often the writer's queue blocked the
    loop.  A resume from the cycle-40 snapshot equals the unsegmented
    run in every final message (card against card)."""
    import tempfile

    _build, ops, sync = ctx["_build"], ctx["ops"], ctx["sync"]
    t_phase = time.perf_counter()
    engine = scale_engine(ctx, CKPT_SCALE_VARS)
    every = CKPT_SCALE_CYCLES // 3
    kw = dict(max_cycles=CKPT_SCALE_CYCLES, segment_cycles=every,
              stop_on_convergence=False)
    engine.run_checkpointed(**kw)     # warm
    sync()
    t0 = time.perf_counter()
    state, values = ops.run_maxsum(engine.graph, CKPT_SCALE_CYCLES,
                                   stop_on_convergence=False)
    sync()
    plain_s = time.perf_counter() - t0
    plain = ctx["state_to_numpy"](state)
    plain_assignment = engine.meta.assignment_from_indices(
        values.cpu().numpy())
    del state, values
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scale_") as tmp:
        for mode, is_async in (("sync", False), ("async", True)):
            mgr = ctx["CheckpointManager"](os.path.join(tmp, mode),
                                           every=every, keep=3)
            _build.launch_counts.clear()
            res = engine.run_checkpointed(manager=mgr,
                                          checkpoint_async=is_async, **kw)
            launches = dict(_build.launch_counts)
            want = {"binary_factor_update": CKPT_SCALE_CYCLES,
                    "segment_sum": CKPT_SCALE_CYCLES + 3,
                    "var_update": 2 * CKPT_SCALE_CYCLES}
            if launches != want:
                fail(f"checkpoint_scale {mode} launched {launches}")
            if res.assignment != plain_assignment:
                fail(f"checkpoint_scale: {mode} run != unsegmented run")
            out[mode] = dict(
                ms_per_cycle=res.time_s / CKPT_SCALE_CYCLES * 1e3,
                writes=mgr.writes, queue_blocked=mgr.blocked,
                queue_blocked_s=mgr.blocked_s, launches=launches)
        # Resume from the async run's cycle-40 snapshot.
        mgr = ctx["CheckpointManager"](os.path.join(tmp, "async"),
                                       every=every, keep=3)
        os.remove(mgr.path_for(CKPT_SCALE_CYCLES))
        resumed = ctx["resume_from_checkpoint"](engine, mgr, **kw)
        diff = snapshot_differences(
            ctx, mgr.path_for(CKPT_SCALE_CYCLES), engine, plain)
        if (resumed.metrics["resumed_from_cycle"] != 2 * every or diff
                or resumed.assignment != plain_assignment):
            fail(f"checkpoint_scale: resumed run != unsegmented run "
                 f"({diff})")
    return dict(
        n_vars=CKPT_SCALE_VARS, cycles=CKPT_SCALE_CYCLES, every=every,
        unsegmented_ms_per_cycle=plain_s / CKPT_SCALE_CYCLES * 1e3,
        snapshot_bytes=out["sync"]["writes"][0]["bytes"], **out,
        bit_equal=["resumed from cycle 40 = unsegmented (card)"],
        seconds=time.perf_counter() - t_phase)


def phase_recovery(ctx):
    """The flagship under RecoveryPolicy(trip_cycles=(50, 100, 150)),
    which walks reseed, damping bump, then both: the card's run equals
    the CPU's in values, every final message and the actions.  A
    guarded run with no trips equals the plain run; a NaN planted in
    one f2v entry trips the guard as "nonfinite" on the card, and the
    run recovers."""
    import tempfile

    _build = ctx["_build"]
    engine, cpu_engine = ctx["engine"], ctx["cpu_engine"]
    plain_state, plain_values = ctx["flagship_scatter"]
    policy = ctx["RecoveryPolicy"]
    every = 50
    kw = dict(max_cycles=FIXED_CYCLES, segment_cycles=every,
              stop_on_convergence=False)
    t_phase = time.perf_counter()
    base_damping = engine.damping
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rec_") as tmp:
        runs = {}
        for label, eng in (("card", engine), ("cpu", cpu_engine)):
            eng.damping = base_damping
            mgr = ctx["CheckpointManager"](os.path.join(tmp, label),
                                           every=every, keep=1)
            _build.launch_counts.clear()
            t0 = time.perf_counter()
            res = eng.run_checkpointed(
                manager=mgr, checkpoint_async=False,
                recovery=policy(trip_cycles=(50, 100, 150)), **kw)
            runs[label] = (res, checksum(ctx, mgr.path_for(FIXED_CYCLES)),
                           dict(_build.launch_counts),
                           time.perf_counter() - t0, eng.damping)
        (card, card_sum, launches, card_s, card_damping) = runs["card"]
        cpu, cpu_sum, _, cpu_s, cpu_damping = runs["cpu"]
        stepped = card.metrics["segments"] * every
        if launches != {"binary_factor_update": stepped,
                        "segment_sum": stepped + card.metrics["segments"],
                        "var_update": 2 * stepped}:
            fail(f"recovery launched {launches} for {stepped} cycles")
        if (card.assignment != cpu.assignment or card_sum != cpu_sum
                or card.metrics["recovery_actions"]
                != cpu.metrics["recovery_actions"]
                or card_damping != cpu_damping):
            fail("recovery: card run != CPU run")
        if card.metrics["recovery_actions"] != [
                "reseed_noise", "damping_bump",
                "reseed_noise+damping_bump"]:
            fail(f"recovery actions {card.metrics['recovery_actions']}")
        engine.damping = cpu_engine.damping = base_damping

        # Guarded, nothing injected: equal to the plain run.
        mgr = ctx["CheckpointManager"](os.path.join(tmp, "guarded"),
                                       every=every, keep=1)
        guarded = engine.run_checkpointed(manager=mgr, recovery=policy(),
                                          **kw)
        diff = snapshot_differences(ctx, mgr.path_for(FIXED_CYCLES),
                                    engine, plain_state)
        if (guarded.metrics["guard_trips"] != 0 or diff
                or guarded.assignment
                != engine.meta.assignment_from_indices(plain_values)):
            fail(f"recovery: guarded run != plain run ({diff})")

    # A NaN planted in one f2v entry after the segment ending at 100.
    ops = ctx["ops"]
    real = ops.run_maxsum_from
    planted = []

    def poisoned(graph, state, extra, **kwargs):
        state, values = real(graph, state, extra, **kwargs)
        if not planted and int(state.cycle) == 100:
            f2v = list(state.f2v)
            f2v[0] = f2v[0].clone()
            f2v[0][0, 0, 0] = float("nan")
            state = state._replace(f2v=tuple(f2v))
            planted.append(int(state.cycle))
        return state, values

    ops.run_maxsum_from = poisoned
    try:
        healed = engine.run_checkpointed(recovery=policy(), **kw)
    finally:
        ops.run_maxsum_from = real
        engine.damping = base_damping
    kinds = [v["kind"] for v in healed.metrics["guard_violations"]]
    if kinds != ["nonfinite"] or healed.cycles != FIXED_CYCLES:
        fail(f"recovery: planted NaN gave trips {kinds}")
    return dict(
        n_vars=len(engine.meta.var_names), cycles=FIXED_CYCLES, every=every,
        trip_cycles=[50, 100, 150],
        actions=card.metrics["recovery_actions"],
        final_damping=card_damping, checksum_200=card_sum,
        card_s=card_s, cpu_s=cpu_s, stepped_cycles=stepped,
        nan_trip={"planted_at_cycle": planted[0], "kinds": kinds,
                  "actions": healed.metrics["recovery_actions"]},
        bit_equal=["card = CPU (values, every message, actions, damping)",
                   "guarded, no trips = plain"],
        launches=launches, seconds=time.perf_counter() - t_phase)


def phase_decimation(ctx):
    """api.solve on the card with decimation:10, and with
    decimation_margin: each equals the CPU run in assignment, cycles,
    converged, decimated_vars, decimation_rounds and active_edges (and
    the decimation:10 run in every final message and clamp: its last
    snapshots' checksums).  A run stopped after 3 rounds and resumed
    from disk equals the uninterrupted one.  Times a round, split into
    device (segment and margin) and host clamp."""
    import tempfile

    from pydcop_tpu_torch.engine import runner

    api, _build = ctx["api"], ctx["_build"]
    dcop, engine = ctx["dcop"], ctx["engine"]
    keys = ("decimated_vars", "decimation_rounds", "active_edges",
            "decimated_fraction")
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_decim_") as tmp:
        for label, params, cycles in (
                ("decimation_10", {"decimation": 10}, DECIM_CYCLES),
                ("decimation_margin", {"decimation_margin": DECIM_MARGIN},
                 DECIM_MARGIN_CYCLES)):
            results = {}
            for device in (ctx["dev"], "cpu"):
                ck = os.path.join(tmp, f"{label}_{device}")
                _build.launch_counts.clear()
                results[device] = api.solve(
                    dcop, "maxsum", max_cycles=cycles, algo_params=params,
                    checkpoint_dir=ck, checkpoint_every=60,
                    checkpoint_keep=1, device=device)
                if device == ctx["dev"]:
                    launches = dict(_build.launch_counts)
                last = ctx["CheckpointManager"](ck).latest()
                results[device]["checksum"] = checksum(ctx, last)
            card, cpu = results[ctx["dev"]], results["cpu"]
            m = card["metrics"]
            if (card["assignment"] != cpu["assignment"]
                    or card["cycles"] != cpu["cycles"]
                    or card["status"] != cpu["status"]
                    or card["checksum"] != cpu["checksum"]
                    or any(m[k] != cpu["metrics"][k] for k in keys)):
                fail(f"decimation {label}: card run != CPU run")
            if launches != {
                    "binary_factor_update": card["cycles"],
                    "segment_sum": card["cycles"] + 2 * m["segments"],
                    "var_update": 2 * card["cycles"]}:
                fail(f"decimation {label} launched {launches}")
            out[label] = dict(
                params=params, max_cycles=cycles, cycles=card["cycles"],
                status=card["status"], cost=card["cost"],
                segments=m["segments"], launches=launches,
                checksum=card["checksum"], **{k: m[k] for k in keys})

        # Stopped after 3 rounds and resumed from disk, on the card.
        plan = ctx["decimation_plan_from_params"]({"decimation": 10})
        mgr = ctx["CheckpointManager"](os.path.join(tmp, "part"),
                                       every=60, keep=2)
        part = engine.run_checkpointed(
            max_cycles=DECIM_CYCLES, manager=mgr, segment_cycles=60,
            decimation=plan, max_segments=3)
        resumed = ctx["resume_from_checkpoint"](
            engine, mgr, max_cycles=DECIM_CYCLES, segment_cycles=60,
            decimation=plan)
        ref = out["decimation_10"]
        if (not part.metrics["interrupted"]
                or resumed.metrics["resumed_from_cycle"] != 180
                or resumed.cycles != ref["cycles"]
                # decimation_rounds counts this call's rounds only.
                or any(resumed.metrics[k] != ref[k] for k in keys
                       if k != "decimation_rounds")
                or checksum(ctx, mgr.latest()) != ref["checksum"]):
            fail(f"decimation: resumed run (from cycle "
                 f"{resumed.metrics['resumed_from_cycle']}, "
                 f"{resumed.cycles} cycles) != uninterrupted run "
                 f"({ref['cycles']} cycles)")

    # A round's device time and host clamp time, without a writer.
    real = runner._DecimationRun.clamp
    host = []

    def timed_clamp(self, *args):
        ctx["sync"]()
        t0 = time.perf_counter()
        result = real(self, *args)
        host.append(time.perf_counter() - t0)
        return result

    runner._DecimationRun.clamp = timed_clamp
    try:
        timed = api.solve(dcop, "maxsum", max_cycles=DECIM_CYCLES,
                          algo_params={"decimation": 10},
                          device=ctx["dev"])
    finally:
        runner._DecimationRun.clamp = real
    rounds = timed["metrics"]["segments"]
    out["round_ms"] = timed["time"] / rounds * 1e3
    out["host_clamp_ms"] = sum(host) / len(host) * 1e3
    out["device_ms_per_round"] = (timed["time"] - sum(host)) / rounds * 1e3
    out["seconds"] = time.perf_counter() - t_phase
    return out

FLT_MIN = float(np.finfo(np.float32).tiny)


def tiny_messages(rng, shape, valid):
    """Messages of ``shape`` with about half of the slots of magnitude
    1.2e-38 .. 1e-36 (normal numbers whose sums, differences and means
    are subnormal), the rest of order 1, some exact zeros, BIG where
    ``valid`` is false: ROADMAP Queue C's state."""
    m = rng.normal(size=shape)
    tiny = rng.random(shape) < 0.5
    m[tiny] = np.sign(m[tiny]) * 10.0 ** rng.uniform(
        np.log10(FLT_MIN), -36, int(tiny.sum()))
    m[rng.random(shape) < 0.05] = 0.0
    return np.where(valid, m.astype(np.float32), BIG)


def tiny_state_arrays(graph, seed: int):
    """A cycle-3 state of ``graph`` (on any device) as numpy: tiny
    messages (:func:`tiny_messages`) and random SAME_COUNT counts."""
    rng = np.random.default_rng(seed)
    valid = graph.var_valid.cpu().numpy()
    d = valid.shape[1]
    out = {"v2f": [], "f2v": [], "v2f_count": [], "f2v_count": []}
    for b in graph.buckets:
        ids = b.var_ids.cpu().numpy()
        for field in ("v2f", "f2v"):
            out[field].append(tiny_messages(rng, ids.shape + (d,),
                                            valid[ids]))
        for field in ("v2f_count", "f2v_count"):
            out[field].append(rng.integers(0, 6, size=ids.shape)
                              .astype(np.int8))
    return dict(out, stable=False, cycle=3)


def fold_arrays(d: int, n_vars: int = 200, seed: int = 17):
    """(var_costs, var_valid, buckets) of a graph whose domain mean the
    reference vectorises or windows: a unary bucket beside a binary one
    with more edges than V + 1, so the second bucket's belief sum is
    taken on its own (``_sums_fused``); integer costs, D = ``d``."""
    rng = np.random.default_rng(seed)
    unary = rng.integers(0, 40, size=(n_vars, d)).astype(np.float32)
    ids1 = np.arange(n_vars, dtype=np.int32)[:, None]
    f2 = 2 * n_vars
    ids2 = rng.integers(0, n_vars, size=(f2, 2)).astype(np.int32)
    ids2[ids2[:, 0] == ids2[:, 1], 1] = (
        ids2[ids2[:, 0] == ids2[:, 1], 0] + 1) % n_vars
    eye = np.ascontiguousarray(np.broadcast_to(
        np.eye(d, dtype=np.float32), (f2, d, d)))
    var_costs = np.zeros((n_vars + 1, d), np.float32)
    var_costs[-1] = BIG
    var_valid = np.ones((n_vars + 1, d), bool)
    var_valid[-1] = False
    return var_costs, var_valid, [(unary, ids1), (eye, ids2)]


def var_update_bound(n_edges: int, n_rows: int, d: int, var_side: bool):
    """(bound_ms, bound_by) of one var_update call, counting the work,
    not an implementation: per edge its message row and last sent row
    read (2 * 4D bytes), the sent row written (4D), its count read and
    written (2), its validity (1) and, for v2f_update, its variable's
    index (4); per variable row, for v2f_update, beliefs and sums read
    once (2 * 4D); against ~16 f32 operations per edge slot."""
    per_edge = 3 * 4 * d + 2 + 1 + (4 if var_side else 0)
    bytes_moved = n_edges * per_edge + (n_rows * 2 * 4 * d if var_side
                                        else 0)
    ops = 16 * n_edges * d
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def random_validity_arrays(d: int, seed: int, n_vars: int = 700):
    """(var_costs, var_valid, buckets): buckets of arity 1-3 whose edge
    counts (333, 3,002 and 771) are no multiple of any tile of the
    var_update kernel, over variables with random valid slots (any
    subset), a tenth of each bucket padding (the sentinel row)."""
    rng = np.random.default_rng(seed)
    var_valid = rng.random((n_vars + 1, d)) < 0.7
    var_valid[-1] = False
    var_costs = rng.normal(size=(n_vars + 1, d)).astype(np.float32)
    buckets = []
    for arity, f in ((1, 333), (2, 1_501), (3, 257)):
        ids = rng.integers(0, n_vars, size=(f, arity)).astype(np.int32)
        ids[-f // 10:] = n_vars
        buckets.append((np.zeros((f,) + (d,) * arity, np.float32), ids))
    return var_costs, var_valid, buckets


def var_update_graphs(ctx, flagship_graph, scale_graph):
    """(label, graph on the card) at the shapes var_update is checked
    at: the flagship, the scale graph, the four-bucket arity 1-4 graph,
    random valid slots at every D = 1..8 on ragged buckets, the fold
    graphs at D = 28..33 and the D = 128 time-to-cost graph."""
    g = ctx["graph_from_numpy"]
    yield "flagship", flagship_graph
    yield "scale", scale_graph
    yield "multi_bucket_arity_1_4", g(
        *multi_bucket_arrays(np.random.default_rng(11)), device="cuda")
    for d in range(1, 9):
        yield f"ragged_D{d}", g(*random_validity_arrays(d, 90 + d),
                                device="cuda")
    for d in (28, 29, 30, 31, 32, 33):
        yield f"fold_D{d}", g(*fold_arrays(d), device="cuda")
    yield "ttc_D128", g(*ttc_arrays(TTC_VARS), device="cuda")


def unaligned_copy(torch, t):
    """A copy of ``t`` as a contiguous view one element into a larger
    buffer: its base off a 16-byte boundary."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def var_update_calls(vu, graph, beliefs, sums, f2v, v2f, cnt, i, cyc,
                     stable, damping, fused, arrays=None):
    """{side: (kernel call, plain call)} of bucket ``i``: zero-argument
    functions, the kernel's with the bucket's arrays (or ``arrays``)."""
    b = graph.buckets[i]
    arrays = arrays or dict(var_ids32=b.var_ids32, edge_valid=b.edge_valid)
    v_args = (beliefs, sums, f2v, v2f, cnt, b.var_ids, graph.var_valid,
              cyc, stable)
    s_args = (f2v, v2f, cnt, b.var_ids, graph.var_valid, cyc, stable)
    kw = dict(damping=damping, stability=0.1)
    return {
        "v2f": (lambda: vu.v2f_update(*v_args, fused=fused, **kw, **arrays),
                lambda: vu.v2f_update_reference(*v_args, fused=fused, **kw)),
        "send": (lambda: vu.send_update(*s_args, **kw, **arrays),
                 lambda: vu.send_update_reference(*s_args, **kw)),
    }


def phase_var_update(ctx, flagship_graph, scale_graph):
    """var_update.cu against its plain version on the card, bit for
    bit (messages as int32 bit patterns, counts, the stable flag), at
    every shape of :func:`var_update_graphs`, from Queue C's tiny-
    message state, at cycles 0 and 3 and damping 0, 0.5 and 0.7, with
    the bucket's inputs as they are and (D <= 8) as views off a 16-byte
    boundary; then both entry points timed at the flagship, scale and
    D = 128 shapes against their bounds, and the scale shape at every
    tile size the D <= 8 kernel has."""
    torch, ops = ctx["torch"], ctx["ops"]
    from pydcop_tpu_torch.ops import var_update as vu

    t_phase = time.perf_counter()
    checked, max_err = {}, 0.0
    timing = {}
    for label, graph in var_update_graphs(ctx, flagship_graph, scale_graph):
        s = tiny_state_arrays(graph, seed=len(checked))
        dev = graph.var_costs.device
        d = int(graph.var_costs.shape[1])
        f2v = [torch.tensor(m, device=dev) for m in s["f2v"]]
        v2f = [torch.tensor(m, device=dev) for m in s["v2f"]]
        cnt = [torch.tensor(c, device=dev) for c in s["v2f_count"]]
        beliefs, sums = ops.aggregate_beliefs(graph, tuple(f2v))
        fused = ops._sums_fused(graph)
        n = 0
        for i, b in enumerate(graph.buckets):
            layouts = [("as placed", f2v[i], v2f[i], cnt[i], None)]
            if b.edge_valid is not None:
                layouts.append(("unaligned", *(
                    unaligned_copy(torch, t) for t in (f2v[i], v2f[i],
                                                       cnt[i])),
                    {k: unaligned_copy(torch, getattr(b, k))
                     for k in ("var_ids32", "edge_valid")}))
            for layout, m, o, c, arrays in layouts:
                for cycle in (0, 3):
                    cyc = torch.tensor(cycle, dtype=torch.int32, device=dev)
                    for damping in (0.0, 0.5, 0.7):
                        flags = [cyc != 0, cyc != 0]
                        calls = [var_update_calls(
                            vu, graph, beliefs, sums, m, o, c, i, cyc, flag,
                            damping, fused, arrays) for flag in flags]
                        for side in ("v2f", "send"):
                            out_k, cnt_k = calls[0][side][0]()
                            out_p, cnt_p = calls[1][side][1]()
                            torch.cuda.synchronize()
                            err = float((out_k - out_p).abs().max())
                            max_err = max(max_err, err)
                            if not (torch.equal(out_k.view(torch.int32),
                                                out_p.view(torch.int32))
                                    and torch.equal(cnt_k, cnt_p)
                                    and bool(flags[0]) == bool(flags[1])):
                                fail(f"var_update {side} != plain on {label}"
                                     f" bucket {i} ({layout}) cycle {cycle} "
                                     f"damping {damping}: max |err| {err}")
                            if not torch.isfinite(out_k).all():
                                fail(f"var_update: non-finite output on "
                                     f"{label}")
                            n += 1
        checked[label] = dict(
            V1=int(graph.var_costs.shape[0]), D=d,
            buckets=[list(b.var_ids.shape) for b in graph.buckets],
            fused=fused, calls_compared=n)
        if label in ("flagship", "scale", "ttc_D128"):
            stable = torch.ones((), dtype=torch.bool, device=dev)
            cyc = torch.tensor(3, dtype=torch.int32, device=dev)
            calls = var_update_calls(vu, graph, beliefs, sums, f2v[0],
                                     v2f[0], cnt[0], 0, cyc, stable, 0.5,
                                     fused)
            reps = 50 if label == "scale" else 200
            n_edges = graph.buckets[0].var_ids.numel()
            for side in ("v2f", "send"):
                k_ms, p_ms = (graph_ms(torch, fn, reps)
                              for fn in calls[side])
                bound_ms, bound_by = var_update_bound(
                    n_edges, int(graph.var_costs.shape[0]), d, side == "v2f")
                key = label if side == "v2f" else f"send_{label}"
                timing[key] = dict(
                    entry=f"{side}_update", E=n_edges, D=d, ms=k_ms[2],
                    plain_ms=p_ms[2], ms_spread=[k_ms[0], k_ms[-1]],
                    plain_ms_spread=[p_ms[0], p_ms[-1]],
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
            if label == "scale":
                timing["scale_tile_items"] = tile_items_sweep(
                    torch, vu, calls, d, reps)
        del graph, f2v, v2f, cnt, beliefs, sums
    return dict(shapes=checked, tolerance="exact (int32 bit patterns)",
                max_abs_err=max_err, timing=timing,
                phase_s=time.perf_counter() - t_phase)


def tile_items_sweep(torch, vu, calls, d: int, reps: int):
    """Device ms (median of five replays) of both entry points at every
    tile size of the D <= 8 kernel: {side: {edges a thread: ms}}."""
    chosen = vu.TILE_ITEMS[d]
    out = {"chosen": chosen}
    try:
        for side in ("v2f", "send"):
            out[side] = {}
            for items in (1, 2, 4, 8):
                vu.TILE_ITEMS[d] = items
                out[side][items] = graph_ms(torch, calls[side][0], reps)[2]
    finally:
        vu.TILE_ITEMS[d] = chosen
    return out


def phase_subnormal_state(ctx):
    """ROADMAP Queue C's state (half of all messages 1.2e-38 .. 1e-36):
    60 cycles on the card from it equal 60 on the CPU, every message,
    count and value, bit for bit, on the 300-variable colouring (D = 3),
    the four-bucket arity 1-4 graph and the D = 30 fold graph, at
    damping 0.5 and 0.7."""
    torch, ops = ctx["torch"], ctx["ops"]
    from pydcop_tpu_torch.algorithms.maxsum import build_engine
    from pydcop_tpu_torch.dcop import dcop as dcop_mod
    from pydcop_tpu_torch.dcop import objects, relations
    from pydcop_tpu_torch.engine.convert import state_from_numpy

    t_phase = time.perf_counter()
    colouring = build_flagship(objects, relations, dcop_mod, 300)
    params = ctx["params"]
    cases = {
        "colouring_300": (build_engine(colouring, params).graph,
                          build_engine(colouring, params,
                                       device="cpu").graph),
        "multi_bucket_arity_1_4": tuple(
            ctx["graph_from_numpy"](*multi_bucket_arrays(
                np.random.default_rng(11)), device=dev)
            for dev in ("cuda", "cpu")),
        "fold_D30": tuple(ctx["graph_from_numpy"](*fold_arrays(30),
                                                  device=dev)
                          for dev in ("cuda", "cpu")),
    }
    out = {}
    for label, (card, cpu) in cases.items():
        s = tiny_state_arrays(cpu, seed=40)
        for damping in (0.5, 0.7):
            kw = dict(damping=damping, stop_on_convergence=False)
            runs = []
            for graph, dev in ((card, "cuda"), (cpu, "cpu")):
                state, values = ops.run_maxsum_from(
                    graph, state_from_numpy(**s, device=dev), 60, **kw)
                runs.append((ctx["state_to_numpy"](state),
                             values.cpu().numpy()))
            (a, va), (b, vb) = runs
            for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
                for x, y in zip(a[field], b[field]):
                    if not np.array_equal(x.view(np.int32) if x.dtype ==
                                          np.float32 else x,
                                          y.view(np.int32) if y.dtype ==
                                          np.float32 else y):
                        fail(f"subnormal state {label} damping {damping}:"
                             f" card != CPU in {field}")
            if not np.array_equal(va, vb) or a["stable"] != b["stable"]:
                fail(f"subnormal state {label}: card != CPU in values")
            zeros = int(sum(int(np.sum(m == 0)) for m in a["f2v"]))
            out[f"{label}_damping_{damping}"] = dict(
                cycles=60, card_equals_cpu=True, f2v_zeros=zeros)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def run_segmented_phases(ctx):
    """Emit the four phases of the segmented solve.  ``ctx`` holds the
    card's device name (``dev``) and synchronise, the flagship's DCOP,
    engines on the card and the CPU, and the card's plain 200-cycle
    run (``flagship_scatter``)."""
    from pydcop_tpu_torch.algorithms.maxsum import (
        decimation_plan_from_params,
    )
    from pydcop_tpu_torch.engine.runner import MaxSumEngine
    from pydcop_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
        load_state,
        read_meta,
        resume_from_checkpoint,
    )
    from pydcop_tpu_torch.resilience.recovery import RecoveryPolicy

    ctx.update(decimation_plan_from_params=decimation_plan_from_params,
               MaxSumEngine=MaxSumEngine,
               CheckpointManager=CheckpointManager, load_state=load_state,
               read_meta=read_meta,
               resume_from_checkpoint=resume_from_checkpoint,
               RecoveryPolicy=RecoveryPolicy)
    emit("checkpoint_flagship", **phase_checkpoint_flagship(ctx))
    emit("checkpoint_scale", **phase_checkpoint_scale(ctx))
    emit("recovery", **phase_recovery(ctx))
    emit("decimation", **phase_decimation(ctx))


HAND_KERNELS = ("binary_factor_update", "segment_sum", "var_update")


def kernel_profile(entry):
    """Kernels per cycle and the device time and count of each hand
    kernel (matched by name) in a profiler entry of the port."""
    if not entry.get("available"):
        fail(f"profiler entry unavailable on the card: {entry}")
    out = {"kernels_per_cycle": entry["kernels_per_cycle"],
           "device_ms_per_cycle": entry["device_ms_per_cycle"],
           "cycles": entry["cycles"], "peak_bytes": entry["peak_bytes"],
           "source": entry["source"], "hand_kernels": {}}
    for name in HAND_KERNELS:
        rows = [v for k, v in entry["kernels"].items() if name in k]
        if not rows:
            fail(f"profiler saw no {name} kernel: {sorted(entry['kernels'])}")
        out["hand_kernels"][name] = {
            "count": sum(r["count"] for r in rows),
            "device_us": sum(r["device_us"] for r in rows)}
    return out


def phase_observed_flagship(ctx, tmp):
    """api.solve on the flagship, 200 cycles, with trace, metrics_file
    and metrics_every=50: the same assignment, cost and cycles as the
    unobserved solve; the cost curve ends at the cost; the trace
    parses and nests; four JSONL snapshots and a .prom file; the
    profiler's entry of the first segment (kernels per cycle, the three
    hand kernels by name).  ms/cycle observed against plain (warm)."""
    from pydcop_tpu_torch.observability.trace import (
        check_well_nested,
        load_trace_file,
    )

    api, dcop = ctx["api"], ctx["dcop"]
    t_phase = time.perf_counter()
    plain = api.solve(dcop, "maxsum", max_cycles=FIXED_CYCLES)
    trace = os.path.join(tmp, "flagship_trace.json")
    metrics = os.path.join(tmp, "flagship_metrics.jsonl")
    observed = api.solve(dcop, "maxsum", max_cycles=FIXED_CYCLES,
                         trace=trace, metrics_file=metrics,
                         metrics_every=50)
    for key in ("assignment", "cost", "cycles", "status"):
        if observed[key] != plain[key]:
            fail(f"observed flagship solve differs from the plain one in "
                 f"{key}: {observed[key]!r} vs {plain[key]!r}"[:300])
    m = observed["metrics"]
    if m["cost_curve"][-1] != (observed["cycles"], observed["cost"]):
        fail(f"cost curve ends at {m['cost_curve'][-1]}, solve "
             f"{observed['cycles']}, {observed['cost']}")
    events = load_trace_file(trace)
    check_well_nested(events)
    names = collections.Counter(e["name"] for e in events)
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    want_rows = -(-observed["cycles"] // 50)
    if len(rows) != want_rows or not os.path.exists(metrics + ".prom"):
        fail(f"observed flagship: {len(rows)} snapshots (want "
             f"{want_rows}), .prom exists: "
             f"{os.path.exists(metrics + '.prom')}")
    entries = list(m["xla_cost"].values())
    profile = kernel_profile(entries[0])
    # Warm timings, plain then observed (trace only: no profiler run).
    plain_w = api.solve(dcop, "maxsum", max_cycles=FIXED_CYCLES)
    obs_w = api.solve(dcop, "maxsum", max_cycles=FIXED_CYCLES,
                      trace=os.path.join(tmp, "warm_trace.json"),
                      metrics_every=50)
    return dict(
        cycles=observed["cycles"], cost=observed["cost"],
        equals_plain=["assignment", "cost", "cycles", "status"],
        cost_curve=m["cost_curve"],
        convergence_curve=m["convergence_curve"],
        trace_events=dict(names), snapshots=len(rows),
        ms_per_cycle_plain=plain_w["time"] / plain_w["cycles"] * 1e3,
        ms_per_cycle_observed=obs_w["time"] / obs_w["cycles"] * 1e3,
        total_s_plain=plain_w["total_time"],
        total_s_observed=obs_w["total_time"],
        profiler=profile, seconds=time.perf_counter() - t_phase)


def phase_observed_scale(ctx):
    """The 1M-variable engine, 60 cycles in segments of 20, with the
    engine probe: its final messages equal the unprobed (unsegmented)
    run's bit for bit; per segment the residual, flip rate and the
    probe's host ms; the roofline's hbm_util at the measured rate
    (fails above 1.0)."""
    torch, ops = ctx["torch"], ctx["ops"]
    from pydcop_tpu_torch.engine.roofline import roofline_report
    from pydcop_tpu_torch.observability.engine_probe import EngineProbe
    from pydcop_tpu_torch.observability.metrics import MetricsRegistry

    t_phase = time.perf_counter()
    engine = scale_engine(ctx, CKPT_SCALE_VARS)

    class FinalState(EngineProbe):
        def on_segment(self, state, values, seconds, compile_s):
            super().on_segment(state, values, seconds, compile_s)
            self.final = state

    engine.run_checkpointed(max_cycles=20, segment_cycles=20,
                            stop_on_convergence=False)        # warm keys
    probe = FinalState(engine, registry=MetricsRegistry())
    torch.cuda.synchronize()
    res = engine.run_checkpointed(max_cycles=60, segment_cycles=20,
                                  stop_on_convergence=False, probe=probe)
    plain, _ = ops.run_maxsum(engine.graph, 60, stop_on_convergence=False)
    a, b = ctx["state_to_numpy"](probe.final), ctx["state_to_numpy"](plain)
    for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
        for x, y in zip(a[field], b[field]):
            if not np.array_equal(x, y):
                fail(f"observed scale: final {field} != unprobed run's")
    ms_per_cycle = res.time_s / res.cycles * 1e3
    roof = roofline_report(engine.graph, res.cycles / res.time_s, "cuda")
    if roof["hbm_util"] is None or roof["hbm_util"] > 1.0:
        fail(f"observed scale: hbm_util {roof['hbm_util']}")
    return dict(
        cycles=res.cycles, segments=res.metrics["segments"],
        final_messages_equal_unprobed=True,
        residual_flip_rate=[list(p) for p in probe.convergence],
        probe_host_ms=[s * 1e3 for s in probe.host_seconds],
        ms_per_cycle=ms_per_cycle, roofline=roof,
        seconds=time.perf_counter() - t_phase)


def phase_serve_metrics(ctx):
    """During a flagship solve with serve_metrics=0, GET /metrics and
    /healthz on localhost (from the probe's first segment boundary)."""
    import urllib.request

    from pydcop_tpu_torch.observability.engine_probe import EngineProbe
    from pydcop_tpu_torch.observability.server import TelemetryServer

    api, dcop = ctx["api"], ctx["dcop"]
    t_phase = time.perf_counter()
    seen, servers = {}, []
    real_segment, real_start = EngineProbe.on_segment, TelemetryServer.start

    def start(self):
        servers.append(self)
        return real_start(self)

    def scrape(self, *a, **k):
        real_segment(self, *a, **k)
        if seen:
            return
        for route in ("metrics", "healthz"):
            with urllib.request.urlopen(f"{servers[0].url}/{route}",
                                        timeout=30) as resp:
                seen[route] = (resp.status, resp.read().decode())

    EngineProbe.on_segment, TelemetryServer.start = scrape, start
    try:
        res = api.solve(dcop, "maxsum", max_cycles=FIXED_CYCLES,
                        metrics_every=50, serve_metrics=0)
    finally:
        EngineProbe.on_segment, TelemetryServer.start = (real_segment,
                                                         real_start)
    status, text = seen.get("metrics", (None, ""))
    hstatus, hbody = seen.get("healthz", (None, "{}"))
    if status != 200 or "pydcop_cycles_total" not in text:
        fail(f"serve_metrics: /metrics answered {status}")
    if hstatus != 200 or json.loads(hbody).get("status") != "ok":
        fail(f"serve_metrics: /healthz answered {hstatus} {hbody[:200]}")
    return dict(cycles=res["cycles"], metrics_status=status,
                metrics_lines=len(text.splitlines()),
                healthz=json.loads(hbody),
                seconds=time.perf_counter() - t_phase)


def phase_trace_cli(tmp):
    """``python -m pydcop_tpu_torch trace summary`` and ``profile
    report --trace`` on the observed flagship's trace, as a user runs
    them (child processes)."""
    t_phase = time.perf_counter()
    trace = os.path.join(tmp, "flagship_trace.json")
    env = dict(os.environ, PYTHONPATH=HERE)
    out = {}
    for label, argv in (
            ("trace_summary", ["trace", "summary", "--json", trace]),
            ("profile_report", ["profile", "report", "--json", "--trace",
                                trace])):
        proc = subprocess.run(
            [sys.executable, "-m", "pydcop_tpu_torch", *argv], cwd=HERE,
            env=env, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            fail(f"{label}: rc {proc.returncode}: {proc.stderr[-500:]}")
        out[label] = json.loads(proc.stdout)
    rows = {r["name"]: r["count"] for r in out["trace_summary"]["rows"]}
    if not rows.get("engine_segment") or not rows.get("solve"):
        fail(f"trace summary rows: {rows}")
    spans = {c["span"] for c in out["profile_report"]["trace"]["components"]}
    if not {"engine_segment", "jit_compile"} <= spans:
        fail(f"profile report components: {spans}")
    return dict(summary_rows=rows,
                profile_components=sorted(spans),
                seconds=time.perf_counter() - t_phase)


def run_observability_phases(ctx):
    """Emit this slice's observability phases (temp files under
    TMPDIR, removed)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
        flagship = phase_observed_flagship(ctx, tmp)
        profile = flagship.pop("profiler")
        emit("observed_flagship", **flagship)
        emit("profiler", **profile)
        emit("observed_scale", **phase_observed_scale(ctx))
        emit("serve_metrics", **phase_serve_metrics(ctx))
        emit("trace_cli", **phase_trace_cli(tmp))



# --------------------------------------------------------------------------
# The local-search slice: the threefry kernel, the positional sum, and
# the dsa / adsa / dsatuto / mgm / mgm2 solves.

# H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz (the Hopper white paper's
# SM; the f32 peak above counts 128 FP32 lanes and two operations an FMA).
H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit integer operations of one threefry-2x32 draw on the INT32
# pipe: 20 rounds of add, funnel shift and xor (60), 5 key injections of
# two adds (10) of which 5 merge with the next round's add into one
# three-input add, the 2 initial adds, the final xor, and the shift and
# or of the float conversion (2).  The subtract, fused multiply-add and
# max run on the FP32 pipe beside it.
THREEFRY_OPS = 60 + 10 - 5 + 2 + 1 + 2
UNIFORM_SHAPES = [(1,), (7,), (10_001,), (10_001, 3), (1_000_001,),
                  (1_000_001, 3), (241, 128)]
BEST_CHOICE_KS = [1, 2, 3, 5, 8, 9, 33, 128]
BEST_CHOICE_DENSITIES = [0.0, 0.1, 0.4, 0.9, 1.0]
LS_CYCLES = 200
LS_SCALE_CYCLES = 30
LS_SCALE_COMPARE = 5
# (label, algorithm, params, problem) of the flagship solves; the first
# is the slice's main path (api.solve(dcop, "dsa"), the default variant
# B).  Problems: "flagship" (bench.py build_dcop), "csp" (its edges with
# equality cost 10000, the reference's coloring_csp rule: DBA stops on
# its counters there) and "hard_soft" (infinite equality costs and a
# soft table on half the edges, for MixedDSA).
LS_CASES = [
    ("dsa_B", "dsa", {}, "flagship"),
    ("dsa_A", "dsa", {"variant": "A"}, "flagship"),
    ("dsa_C_arity", "dsa", {"variant": "C", "p_mode": "arity"}, "flagship"),
    ("dsa_B_arity", "dsa", {"p_mode": "arity"}, "flagship"),
    ("adsa_staggered", "adsa", {"schedule": "staggered"}, "flagship"),
    ("dsatuto", "dsatuto", {}, "flagship"),
    ("mgm_lexic", "mgm", {}, "flagship"),
    ("mgm_random", "mgm", {"break_mode": "random"}, "flagship"),
    ("mgm2_unilateral", "mgm2", {}, "flagship"),
    ("mgm2_no", "mgm2", {"favor": "no"}, "flagship"),
    ("mgm2_coordinated", "mgm2", {"favor": "coordinated"}, "flagship"),
    ("dsa_B_ell", "dsa", {"aggregation": "ell"}, "flagship"),
    ("dba_csp", "dba", {}, "csp"),
    ("dba_infinity_1", "dba", {"infinity": 1}, "flagship"),
    ("gdba_A_NZ_E", "gdba", {}, "flagship"),
    ("gdba_M_NM_R", "gdba", {"modifier": "M", "violation": "NM",
                             "increase_mode": "R"}, "flagship"),
    ("gdba_A_MX_T", "gdba", {"violation": "MX", "increase_mode": "T"},
     "flagship"),
    ("mixeddsa_A", "mixeddsa", {"variant": "A"}, "hard_soft"),
    ("mixeddsa_B", "mixeddsa", {}, "hard_soft"),
    ("mixeddsa_C", "mixeddsa", {"variant": "C"}, "hard_soft"),
]
# The breakout algorithms: their candidate sums are the positional sum's
# contributions entry (segment_sum:positional), not the fused entry.
BREAKOUT = ("dba", "gdba", "mixeddsa")
# The DBA case that must stop on its counters before LS_CYCLES (chosen
# on the CPU: 121 cycles), and the chunk sizes timed beside ops/dba.py's.
DBA_EARLY_STOP = "dba_csp"
DBA_CHUNKS = [1, 4, 16, 64]


def threefry_bound(n_draws: int, bytes_moved: int):
    """(bound_ms, bound_by): the draws' integer operations at the int32
    rate against the bytes at the memory rate."""
    ops_ms = n_draws * THREEFRY_OPS / H100_INT32_OPS_PER_S * 1e3
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def positional_bound(n_edges: int, n_seg: int, d: int):
    """(bound_ms, bound_by) of the positional sum's contributions entry:
    contributions, perm, offsets and init read once, the sums written
    once, against one add per edge element."""
    bytes_moved = 4 * (n_edges * d + n_edges + (n_seg + 1) + 2 * n_seg * d)
    ops = n_edges * d
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def positional_table_bound(graph):
    """(bound_ms, bound_by) of the fused entry on ``graph``: each binary
    bucket's cost table read once (both its units read it), the other
    units' rows, pos_perm, pos_other, values, offsets, pos_mid and init
    read once, the sums written once, against one add per edge element.
    At the scale graph: tables 54 MB, pos_perm and pos_other 12 MB each,
    values, offsets and pos_mid 4 MB each, init and sums 12 MB each:
    ~114 MB."""
    n_seg, d = graph.var_costs.shape
    n_edges = int(graph.pos_perm.shape[0])
    floats = sum(b.costs.numel() if b.var_ids.shape[1] == 2
                 else b.var_ids.numel() * d for b in graph.buckets)
    ints = (2 * n_edges + n_seg + (n_seg + 1)
            + (n_seg if graph.pos_mid is not None else 0))
    bytes_moved = 4 * (floats + ints + 2 * n_seg * d)
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_ms = n_edges * d / H100_F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def best_choice_mask(rng, n: int, k: int, density: float = 0.4):
    """[n, k] bool with ``density`` True, and an empty, a full and a
    single-slot row first."""
    mask = rng.random((n, k)) < density
    mask[0] = False
    mask[1] = True
    mask[2] = False
    mask[2, k - 1] = True
    return mask


def best_choice_timing(torch, threefry, key, mask):
    """The kernel, its plain version and its bound on ``mask``."""
    n, k = mask.shape
    n_true = int(mask.sum())
    reps = 200 if n < 100_000 else 50
    k_ms = graph_ms(torch, lambda: threefry.best_choice(key, mask), reps)
    p_ms = graph_ms(torch, lambda: threefry.best_choice_reference(
        key, mask), reps)
    bound_ms, bound_by = threefry_bound(n_true, n * k + 4 * n)
    return dict(N=n, K=k, masked=n_true, ms=k_ms[2],
                ms_spread=[k_ms[0], k_ms[-1]], plain_ms=p_ms[2],
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                bound_share=bound_ms / k_ms[2])


def phase_threefry(ctx):
    """Both entry points of csrc/threefry.cu against their plain
    versions bit for bit, timed beside their bounds; the plain draw of a
    straight translation (key tensor, int64 torch ops) timed once with
    its launches and host reads counted."""
    torch, threefry, prng = ctx["torch"], ctx["threefry"], ctx["prng"]
    keys = [prng.key_words(0), prng.key_words(12345),
            prng.fold_in_words(prng.key_words(2 ** 63 - 1), 7)]
    for shape in UNIFORM_SHAPES:
        for key in keys:
            out = threefry.uniform(key, shape, "cuda")
            ref = threefry.uniform_reference(key, shape, "cuda")
            if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
                fail(f"threefry uniform != plain at {shape} key {key}")
            del out, ref
    rng = np.random.default_rng(21)
    masked = {}
    for k in BEST_CHOICE_KS:
        for density in BEST_CHOICE_DENSITIES:
            # One byte past an aligned word: the kernel's first and last
            # words hold bytes outside the mask.
            big = torch.tensor(best_choice_mask(rng, 10_002, k, density),
                               device="cuda").reshape(-1)
            mask = big[1:1 + 10_001 * k].reshape(10_001, k)
            for key in keys:
                out = threefry.best_choice(key, mask)
                ref = threefry.best_choice_reference(key, mask)
                if not torch.equal(out, ref):
                    fail(f"threefry best_choice != plain at K={k} "
                         f"density {density} key {key}")
            masked[f"K{k}_d{density}"] = int(mask.sum())
    key = keys[1]
    timing = {"uniform_f32": {}, "best_choice": {}}
    for label, shape in (("flagship", (10_001,)),
                         ("flagship_D3", (10_001, 3)),
                         ("scale", (1_000_001,)),
                         ("scale_D3", (1_000_001, 3))):
        n = int(np.prod(shape))
        reps = 200 if n < 100_000 else 50
        k_ms = graph_ms(torch, lambda: threefry.uniform(key, shape, "cuda"),
                        reps)
        p_ms = graph_ms(torch, lambda: threefry.uniform_reference(
            key, shape, "cuda"), reps)
        lib = cuda_ms(torch, lambda: torch.rand(shape, device="cuda"), reps)
        bound_ms, bound_by = threefry_bound(n, 4 * n)
        timing["uniform_f32"][label] = dict(
            shape=list(shape), ms=k_ms[2], ms_spread=[k_ms[0], k_ms[-1]],
            plain_ms=p_ms[2], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, philox_torch_rand_ms=lib)
    for label, (n, k) in (("flagship", (10_001, 3)),
                          ("scale", (1_000_001, 3)),
                          ("mgm2_flagship_pairs", (15_000, 9))):
        mask = torch.tensor(best_choice_mask(rng, n, k), device="cuda")
        timing["best_choice"][label] = best_choice_timing(
            torch, threefry, key, mask)
    # The straight translation: jax.random.uniform on a key tensor
    # (utils/prng.py's uniform), which reads the key on the host.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tkey = prng.PRNGKey(12345, device="cuda")
    shape = (1_000_001, 3)
    plain_ms = eager_ms(torch, lambda: prng.uniform(tkey, shape), 3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prng.uniform(tkey, shape)
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events
                   if e.device_type == DeviceType.CUDA)
    host_reads = sum(e.count for e in events
                     if e.key == "aten::_local_scalar_dense")
    aten_calls = sum(e.count for e in events if e.key.startswith("aten::")
                     and e.device_type == DeviceType.CPU)
    return {
        "uniform_shapes": [list(s) for s in UNIFORM_SHAPES],
        "best_choice_K": BEST_CHOICE_KS,
        "best_choice_densities": BEST_CHOICE_DENSITIES,
        "best_choice_masked": masked,
        "keys": [list(k) for k in keys],
        "tolerance": "exact (int32 views / torch.equal)",
        "max_abs_err": 0.0, "timing": timing,
        "plain_key_tensor_uniform_1000001x3": {
            "ms": plain_ms[2], "ms_spread": [plain_ms[0], plain_ms[-1]],
            "device_kernel_launches": launches, "host_reads": host_reads,
            "aten_calls_nested_included": aten_calls},
    }


def random_units(torch, seg, graph, seed: int):
    """(units, variables): order-sensitive units of ``graph`` on the card
    in its positional order — a binary bucket's two positions as
    TableUnits of a random [F, D, D] table (spread over seven decades),
    any other bucket's positions as random [F, D] contributions — and
    each unit's variable ids."""
    rng = np.random.default_rng(seed)
    d = graph.var_costs.shape[1]
    units, cols = [], []
    for i, b in enumerate(graph.buckets):
        n_f, arity = b.var_ids.shape
        cols += [b.var_ids[:, p] for p in range(arity)]
        if arity == 2:
            table = (rng.normal(size=(n_f, d, d))
                     * 10.0 ** rng.integers(-3, 4, size=(n_f, d, d))
                     ).astype(np.float32)
            table = torch.tensor(table, device="cuda")
            units += [seg.TableUnit(table, b.var_ids, p) for p in (0, 1)]
        else:
            units += [edge_messages(torch, n_f, d, seed + 10 * i + p)
                      for p in range(arity)]
    order = graph.pos_order
    return [units[u] for u in order], [cols[u] for u in order]


def on_cpu(torch, seg, units):
    return [seg.TableUnit(u.costs.cpu(), u.var_ids.cpu(), u.position)
            if isinstance(u, seg.TableUnit) else u.cpu() for u in units]


def one_factor_arrays(rng, n_vars: int, d: int, sizes):
    """(var_costs, var_valid, buckets): ``sizes`` (arity, F) per bucket,
    one-factor buckets real factors (ROADMAP Queue C item 1's shapes)."""
    var_costs = rng.normal(size=(n_vars + 1, d)).astype(np.float32)
    buckets = []
    for arity, f in sizes:
        ids = np.stack([rng.choice(n_vars, size=arity, replace=False)
                        for _ in range(f)]).astype(np.int32)
        buckets.append((np.zeros((f,) + (d,) * arity, np.float32), ids))
    return var_costs, np.ones_like(var_costs, bool), buckets


# (label, V, D, sizes) of the one-factor graphs of
# tests/test_torch_positional_one_factor.py, and a mixed arity-2/3/4 one.
POSITIONAL_SMALL = [
    ("one_factor_after_large", 20, 3, [(1, 60), (2, 1)]),
    ("one_factor_two_apart", 20, 3, [(1, 30), (1, 1), (1, 30), (1, 1)]),
    ("one_factor_binary", 24, 4, [(2, 1), (2, 40), (1, 1), (2, 1)]),
    ("one_factor_first", 20, 5, [(2, 1), (1, 40)]),
    ("mixed_arity_2_3_4", 3_000, 3, [(2, 4_000), (3, 900), (4, 300)]),
]


def ternary_dcop(objects, relations, dcop_mod, n_vars: int, seed: int):
    """Real-cost ternary constraints only (no binary bucket): the path
    on which candidate_costs runs the contributions entry."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("d3", "", [0, 1, 2])
    dcop = dcop_mod.DCOP(f"ternary_{n_vars}", objective="min")
    vs = [objects.Variable(f"v{i:05d}", dom) for i in range(n_vars)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(n_vars // 2):
        a, b, c = rng.choice(n_vars, size=3, replace=False)
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[a], vs[b], vs[c]], np.round(rng.normal(size=(3, 3, 3)), 3),
            f"t{i}"))
    dcop.add_agents([objects.AgentDef("a0")])
    return dcop


def phase_positional_sum(ctx, graphs):
    """Both positional entries of segment_sum.cu against their plain
    version bit for bit (card vs CPU copies) on the flagship, scale,
    scale-free, arity 1-4, mixed arity-2/3/4 and one-factor graphs: the
    contributions entry (positional_sum) on random contributions, the
    fused entry (positional_table_sum) on random cost tables, and the
    two equal to each other.  Timed beside their bounds: the
    contributions entry against clone + index_add_, the fused one
    against the torch ops it replaces (the rows gathered out of the
    tables, cat, clone, index_add_) and the unfused path (the same rows,
    then the contributions entry).  Then a ternary-only DSA solve, the
    path that runs the contributions entry, card = CPU."""
    torch, seg = ctx["torch"], ctx["segment_sum_mod"]
    out = {"graphs": {}, "timing": {}}
    for idx, (label, graph) in enumerate(graphs):
        n_seg, d = graph.var_costs.shape
        units, cols = random_units(torch, seg, graph, 300 + idx)
        values = torch.tensor(np.random.default_rng(idx).integers(
            0, d, n_seg).astype(np.int32), device="cuda")
        args = (graph.pos_perm, graph.agg_offsets, graph.pos_units,
                graph.var_costs, graph.agg_tiles, graph.pos_sep,
                graph.pos_mid)
        cpu_args = tuple(t.cpu() if isinstance(t, torch.Tensor) else t
                         for t in args)
        rows = [seg.unit_rows(u, values) for u in units]
        flat = torch.cat(rows)
        got = seg.positional_sum(rows, *args)
        ref = seg.positional_sum_reference(flat.cpu(), *cpu_args[:4],
                                           graph.pos_sep)
        if not torch.equal(got.cpu().view(torch.int32),
                           ref.view(torch.int32)):
            err = float((got.cpu() - ref).abs().max())
            fail(f"positional sum kernel != plain on {label}: {err}")
        fused = None
        if graph.pos_other is not None:
            fused = seg.positional_table_sum(units, values, graph.pos_other,
                                             *args)
            plain = seg.positional_table_sum(
                on_cpu(torch, seg, units), values.cpu(),
                graph.pos_other.cpu(), *cpu_args)
            if not (torch.equal(fused.cpu().view(torch.int32),
                                plain.view(torch.int32))
                    and torch.equal(plain.view(torch.int32),
                                    ref.view(torch.int32))):
                err = float((fused.cpu() - plain).abs().max())
                fail(f"fused positional sum != plain on {label}: {err}")
        n_edges = int(flat.shape[0])
        out["graphs"][label] = dict(
            V1=n_seg, E=n_edges, D=d, units=len(units),
            order=list(graph.pos_order), sep=graph.pos_sep,
            fused=fused is not None,
            tables=sum(isinstance(u, seg.TableUnit) for u in units))
        if label not in ("flagship", "scale", "scale_free"):
            continue
        pos_seg = torch.cat(cols)
        reps = 50 if n_edges > 1_000_000 else 200

        def library():
            res = graph.var_costs.clone()
            res.index_add_(0, pos_seg, flat)
            return res

        def torch_ops():
            res = graph.var_costs.clone()
            res.index_add_(0, pos_seg, torch.cat(
                [seg.unit_rows(u, values) for u in units]))
            return res

        def unfused():
            return seg.positional_sum(
                [seg.unit_rows(u, values) for u in units], *args)

        c_ms = graph_ms(torch, lambda: seg.positional_sum(rows, *args),
                        reps)
        f_ms = graph_ms(torch, lambda: seg.positional_table_sum(
            units, values, graph.pos_other, *args), reps)
        l_ms = graph_ms(torch, library, reps)
        t_ms = graph_ms(torch, torch_ops, reps)
        u_ms = graph_ms(torch, unfused, reps)
        p_ms = eager_ms(torch, lambda: seg.positional_sum_reference(
            flat, *args[:4], graph.pos_sep), 2)
        bound_ms, bound_by = positional_bound(n_edges, n_seg, d)
        out["timing"][f"positional_{label}"] = dict(
            V1=n_seg, E=n_edges, D=d, ms=c_ms[2],
            ms_spread=[c_ms[0], c_ms[-1]], plain_ms=p_ms[2],
            library_ms=l_ms[2], bound_ms=bound_ms, bound_by=bound_by)
        bound_ms, bound_by = positional_table_bound(graph)
        out["timing"][f"positional_table_{label}"] = dict(
            V1=n_seg, E=n_edges, D=d, ms=f_ms[2],
            ms_spread=[f_ms[0], f_ms[-1]], plain_ms=p_ms[2],
            library_ms=None, torch_ops_ms=t_ms[2], unfused_ms=u_ms[2],
            bound_ms=bound_ms, bound_by=bound_by)
        del units, cols, rows, flat, pos_seg
    out["tolerance"] = "exact (int32 views, card vs CPU plain)"
    out["max_abs_err"] = 0.0
    # The contributions entry's path: candidate_costs without a binary
    # bucket, through api.solve, the launch counts zeroed just before.
    _build, api = ctx["_build"], ctx["api"]
    dcop = ternary_dcop(ctx["objects"], ctx["relations"], ctx["dcop_mod"],
                        2_000, seed=19)
    _build.launch_counts.clear()
    card = api.solve(dcop, "dsa", max_cycles=40)
    launches = ls_launch_counts(_build)
    cpu = api.solve(dcop, "dsa", max_cycles=40, device="cpu")
    if (card["assignment"] != cpu["assignment"] or card["cost"] != cpu["cost"]
            or launches[seg.POSITIONAL] == 0):
        fail(f"ternary dsa: card != CPU or no contributions launch "
             f"({launches})")
    out["ternary_dsa"] = dict(n_vars=2_000, cycles=40, cost=card["cost"],
                              launches=launches, equal=["CPU run"])
    return out


def ls_launch_counts(_build):
    from pydcop_tpu_torch.ops import segment_sum, threefry

    return {k: _build.launch_counts.get(k, 0)
            for k in (segment_sum.POSITIONAL, segment_sum.POSITIONAL_TABLE,
                      threefry.UNIFORM, threefry.BEST_CHOICE)}


def ls_runner(ctx, algo: str, params: dict, graph, meta, host):
    """``run(n)``: ``n`` supersteps of the algorithm's ops loop on a
    placed graph, its tensors placed first (so the loop itself reads
    nothing from the card; DBA's reads its stop flag once a chunk,
    ``run(n, chunk)``)."""
    torch = ctx["torch"]
    from pydcop_tpu_torch.algorithms.dsa import _arity_probabilities
    from pydcop_tpu_torch.algorithms.mgm import lexic_ranks
    from pydcop_tpu_torch.ops.dsa import greedy_classes, run_dsa
    from pydcop_tpu_torch.ops.dba import CHUNK as dba_chunk
    from pydcop_tpu_torch.ops.dba import run_dba
    from pydcop_tpu_torch.ops.gdba import run_gdba
    from pydcop_tpu_torch.ops.mgm import run_mgm
    from pydcop_tpu_torch.ops.mgm2 import run_mgm2
    from pydcop_tpu_torch.ops.mixeddsa import run_mixeddsa

    dev = graph.var_costs.device
    if algo in ("dsa", "adsa", "dsatuto"):
        prob = params.get("probability", 0.7)
        if params.get("p_mode") == "arity":
            prob = torch.tensor(_arity_probabilities(host, prob), device=dev)
        variant = "A" if algo == "dsatuto" else params.get("variant", "B")
        classes, n_classes = None, 1
        if params.get("schedule") == "staggered":
            classes, n_classes = greedy_classes(host)
            classes = torch.tensor(classes, device=dev)
        return lambda n: run_dsa(graph, n, variant=variant,
                                 probability=prob, classes=classes,
                                 n_classes=n_classes,
                                 seed=params.get("seed", 0))
    if algo == "mixeddsa":
        return lambda n: run_mixeddsa(
            graph, n, variant=params.get("variant", "B"),
            proba_hard=params.get("proba_hard", 0.7),
            proba_soft=params.get("proba_soft", 0.5),
            seed=params.get("seed", 0))
    ranks = torch.tensor(lexic_ranks(meta), device=dev)
    if algo == "dba":
        return lambda n, chunk=dba_chunk: run_dba(
            graph, n, infinity=float(params.get("infinity", 10000)),
            max_distance=int(params.get("max_distance", 50)),
            lexic_ranks=ranks, seed=params.get("seed", 0), chunk=chunk)
    if algo == "gdba":
        return lambda n: run_gdba(
            graph, n, modifier_mode=params.get("modifier", "A"),
            violation_mode=params.get("violation", "NZ"),
            increase_mode=params.get("increase_mode", "E"),
            lexic_ranks=ranks, seed=params.get("seed", 0))
    if algo == "mgm":
        return lambda n: run_mgm(graph, n, lexic_ranks=ranks,
                                 break_mode=params.get("break_mode", "lexic"))
    return lambda n: run_mgm2(graph, n, lexic_ranks=ranks,
                              favor=params.get("favor", "unilateral"),
                              threshold=params.get("threshold", 0.5))


def sync_free(torch, fn):
    """``fn()`` with torch's synchronisation check set to raise, then a
    synchronise: a host read of a device value inside fails the run."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


def sync_count(torch, fn):
    """(``fn()``, the number of synchronising calls it made): torch's
    synchronisation check set to warn, each warning counted."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in seen)


def dba_host_reads(ctx, graph, meta, params, cycles: int):
    """DBA's loop on the card: one chunk of gated steps under the
    synchronisation check (no read), the whole ``run_dba`` counted
    (at most ceil(cycles / chunk) + 1 reads), and the run's wall time
    at each of ``DBA_CHUNKS`` beside ops/dba.py's chunk, all giving the
    same values and cycles."""
    import math

    torch = ctx["torch"]
    from pydcop_tpu_torch.algorithms.mgm import lexic_ranks
    from pydcop_tpu_torch.ops import dba

    ranks = torch.tensor(lexic_ranks(meta), device="cuda")
    kw = dict(infinity=float(params.get("infinity", 10000)),
              max_distance=int(params.get("max_distance", 50)),
              lexic_ranks=ranks)
    state = dba.init_state(graph, params.get("seed", 0))
    sync_free(torch, lambda: dba.run_chunk(state, graph, dba.CHUNK,
                                           max_cycles=cycles, **kw))
    out, reads = sync_count(torch, lambda: dba.run_dba(
        graph, cycles, seed=params.get("seed", 0), **kw))
    bound = math.ceil(out[2] / dba.CHUNK) + 1
    if not 1 <= reads <= bound:
        fail(f"DBA read the card {reads} times in {out[2]} cycles "
             f"(chunk {dba.CHUNK}, at most {bound})")
    chunks = {}
    for chunk in DBA_CHUNKS:
        dba.run_dba(graph, cycles, chunk=chunk, **kw)       # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = dba.run_dba(graph, cycles, chunk=chunk, **kw)
        torch.cuda.synchronize()
        chunks[chunk] = (time.perf_counter() - t0) * 1e3
        if got[2] != out[2] or not torch.equal(got[0], out[0]):
            fail(f"DBA at chunk {chunk}: {got[2]} cycles, not {out[2]}")
    return {"chunk": dba.CHUNK, "cycles": out[2], "host_reads": reads,
            "host_reads_bound": bound, "chunk_sync_free": True,
            "run_ms_by_chunk": chunks}


def phase_localsearch_flagship(ctx):
    """Every local-search algorithm on the 10k flagship (DBA on its CSP
    form, MixedDSA on its hard/soft form) through api.solve with no
    device argument: card = CPU = second card run; the launch counts;
    then the ops loop on the placed graph under the synchronisation
    check (DBA: one chunk, its reads counted), timed and profiled."""
    torch, api, _build = ctx["torch"], ctx["api"], ctx["_build"]
    from pydcop_tpu_torch.device import to_device_graph
    from pydcop_tpu_torch.engine.compile import compile_dcop
    from pydcop_tpu_torch.ops import segment_sum

    objects, relations, dcop_mod = (ctx["objects"], ctx["relations"],
                                    ctx["dcop_mod"])
    problems = {
        "flagship": ctx["dcop"],
        "csp": build_flagship(objects, relations, dcop_mod, FLAGSHIP_VARS,
                              eq_cost=10000.0),
        "hard_soft": build_flagship(objects, relations, dcop_mod,
                                    FLAGSHIP_VARS, eq_cost=float("inf"),
                                    extra_soft=True),
    }
    rows = {}
    main_launches = None
    for label, algo, params, problem in LS_CASES:
        dcop = problems[problem]
        _build.launch_counts.clear()
        res = api.solve(dcop, algo, max_cycles=LS_CYCLES,
                        algo_params=params)
        launches = ls_launch_counts(_build)
        if main_launches is None:
            main_launches = dict(launches)
        if not res["metrics"]["device"].startswith("cuda"):
            fail(f"{label} ran on {res['metrics']['device']}")
        again = api.solve(dcop, algo, max_cycles=LS_CYCLES,
                          algo_params=params)
        cpu = api.solve(dcop, algo, max_cycles=LS_CYCLES,
                        algo_params=params, device="cpu")
        for name, other in (("second card run", again), ("CPU run", cpu)):
            if (other["assignment"] != res["assignment"]
                    or other["cycles"] != res["cycles"]
                    or other["cost"] != res["cost"]):
                fail(f"{label}: card run != {name} (cost {res['cost']} vs "
                     f"{other['cost']})")
        entry = (segment_sum.POSITIONAL if algo in BREAKOUT
                 else segment_sum.POSITIONAL_TABLE)
        if launches["threefry:best_choice"] == 0 or (
                (params.get("aggregation") != "ell" or algo == "mixeddsa")
                and launches[entry] == 0):
            fail(f"{label}: launches {launches}")
        if label == DBA_EARLY_STOP and res["cycles"] >= LS_CYCLES:
            fail(f"{label} ran {res['cycles']} cycles: no early stop")
        host, meta = compile_dcop(dcop, aggregation=params.get(
            "aggregation", "scatter"))
        graph = to_device_graph(host, "cuda")
        run = ls_runner(ctx, algo, params, graph, meta, host)
        extra = {}
        if algo == "dba":
            extra["dba_loop"] = dba_host_reads(ctx, graph, meta, params,
                                               LS_CYCLES)
            timed = run
        else:
            sync_free(torch, lambda: run(5))             # warm, checked
            timed = lambda n: sync_free(torch, lambda: run(n))  # noqa: E731
        t0 = time.perf_counter()
        timed(LS_CYCLES)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        prof = profile_cycles(torch, lambda n: (run(n),
                                                torch.cuda.synchronize()),
                              20)
        # A DBA run that stops early runs to the end of its chunk: its
        # time is per cycle of the solve, the gated steps included.
        per = res["cycles"] if algo == "dba" else LS_CYCLES
        rows[label] = dict(
            algo=algo, params=params, problem=problem, cycles=res["cycles"],
            cost=res["cost"], cpu_cost=cpu["cost"],
            violations=res["violations"], launches=launches,
            solve_time_s=res["time"], cpu_time_s=cpu["time"],
            loop_ms_per_cycle=loop_s / max(per, 1) * 1e3,
            device_ms_per_cycle=prof["device_ms_per_cycle"],
            kernels_per_cycle=prof["device_kernels_per_cycle"],
            device_busy_share=prof["device_busy_share"],
            top=prof["top"][:6], sync_free=True,
            equal=["second card run", "CPU run"], **extra)
        if "n_classes" in res["metrics"]:
            rows[label]["n_classes"] = res["metrics"]["n_classes"]
        del graph
    return {"n_vars": FLAGSHIP_VARS, "cycles": LS_CYCLES, "runs": rows,
            "main_path_launches": main_launches}


def states_equal(a, b) -> bool:
    """Two local-search states as ``localsearch_state_to_numpy`` gives
    them: every field equal (tuples of per-bucket arrays element-wise)."""
    if a.keys() != b.keys():
        return False
    for name in a:
        x, y = a[name], b[name]
        pairs = zip(x, y) if isinstance(x, tuple) else [(x, y)]
        if (isinstance(x, tuple) and len(x) != len(y)) or not all(
                np.array_equal(p, q) for p, q in pairs):
            return False
    return True


def hard_scale_arrays(n_vars: int):
    """The scale arrays with infinite equality costs (hard constraints;
    the small unary costs are the soft part), for MixedDSA."""
    var_costs, var_valid, [(costs, var_ids)] = scale_arrays(n_vars)
    hard = np.where(np.eye(N_COLORS) > 0, np.inf, 0.0).astype(np.float32)
    costs = np.ascontiguousarray(np.broadcast_to(hard, costs.shape))
    return var_costs, var_valid, [(costs, var_ids)]


def phase_localsearch_scale(ctx, scale_graph):
    """DSA-B, MGM, DBA (infinity 1: the equality cost counts as a
    violation), GDBA (defaults) and MixedDSA-B (infinite equality costs)
    on the 1M-variable scale arrays: 30 cycles timed (under the
    synchronisation check; DBA reads its flag once a chunk) and
    profiled; the card's state (values, key, DBA's weights and counters,
    GDBA's modifiers) equal to the CPU's after each of the first 5
    cycles."""
    torch = ctx["torch"]
    from pydcop_tpu_torch.engine.convert import localsearch_state_to_numpy
    from pydcop_tpu_torch.ops import dba, dsa, gdba, mgm, mixeddsa
    from pydcop_tpu_torch.ops.localsearch import candidate_costs

    ctx["candidate_costs"] = candidate_costs
    graph_from_numpy = ctx["graph_from_numpy"]
    var_costs, var_valid, buckets = scale_arrays(SCALE_VARS)
    cpu_graph = graph_from_numpy(var_costs, var_valid, buckets, device="cpu")
    hard_arrays = hard_scale_arrays(SCALE_VARS)
    hard = {"cuda": graph_from_numpy(*hard_arrays, device="cuda"),
            "cpu": graph_from_numpy(*hard_arrays, device="cpu")}
    del hard_arrays
    n = var_costs.shape[0]
    ranks_np = np.arange(n, dtype=np.float32)
    ranks_np[-1] = np.inf
    ranks = torch.tensor(ranks_np, device="cuda")
    gdba_kw = dict(modifier_mode="A", violation_mode="NZ",
                   increase_mode="E")
    # label: (step(graph, state, ranks), init(graph, seed), run(n),
    #         card graph, CPU graph)
    runs = {
        "dsa_B": (lambda g, s, r: dsa.dsa_step(s, g, variant="B",
                                               probability=0.7),
                  dsa.init_state,
                  lambda n_: dsa.run_dsa(scale_graph, n_, variant="B"),
                  scale_graph, cpu_graph),
        "mgm_lexic": (lambda g, s, r: mgm.mgm_step(
            s, g, lexic_ranks=r, break_mode="lexic"), mgm.init_state,
            lambda n_: mgm.run_mgm(scale_graph, n_, lexic_ranks=ranks),
            scale_graph, cpu_graph),
        "dba_infinity_1": (lambda g, s, r: dba.dba_step(
            s, g, infinity=1.0, lexic_ranks=r), dba.init_state,
            lambda n_, chunk=dba.CHUNK: dba.run_dba(
                scale_graph, n_, infinity=1.0, lexic_ranks=ranks,
                chunk=chunk),
            scale_graph, cpu_graph),
        "gdba_A_NZ_E": (lambda g, s, r: gdba.gdba_step(
            s, g, minmax=gdba.factor_min_max(g), lexic_ranks=r, **gdba_kw),
            gdba.init_state,
            lambda n_: gdba.run_gdba(scale_graph, n_, lexic_ranks=ranks,
                                     **gdba_kw),
            scale_graph, cpu_graph),
        "mixeddsa_B_hard": (lambda g, s, r: mixeddsa.mixeddsa_step(
            s, g, variant="B", proba_hard=0.7, proba_soft=0.5,
            classes=mixeddsa.classify_factors(g)), mixeddsa.init_state,
            lambda n_: mixeddsa.run_mixeddsa(hard["cuda"], n_),
            hard["cuda"], hard["cpu"]),
    }
    out = {"n_vars": SCALE_VARS, "cycles": LS_SCALE_CYCLES}
    _build = ctx["_build"]
    for label, (step, init, run, card_g, cpu_g) in runs.items():
        card, cpu = init(card_g, 0), init(cpu_g, 0)
        for c in range(LS_SCALE_COMPARE):
            card = step(card_g, card, ranks)
            cpu = step(cpu_g, cpu, torch.tensor(ranks_np))
            if not states_equal(localsearch_state_to_numpy(card),
                                localsearch_state_to_numpy(cpu)):
                fail(f"scale {label}: card != CPU after cycle {c + 1}")
        del card, cpu
        if label.startswith("dba"):
            chunks = {}
            for chunk in DBA_CHUNKS:
                run(3, chunk)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(LS_SCALE_CYCLES, chunk)
                torch.cuda.synchronize()
                chunks[chunk] = (time.perf_counter() - t0) * 1e3
            timed = run
        else:
            sync_free(torch, lambda: run(3))
            timed = lambda n_: sync_free(torch, lambda: run(n_))  # noqa
        _build.launch_counts.clear()
        t0 = time.perf_counter()
        values, cost, _ = timed(LS_SCALE_CYCLES)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        launches = ls_launch_counts(_build)
        if label != "mixeddsa_B_hard" and not np.isfinite(float(cost)):
            fail(f"scale {label}: cost {float(cost)}")
        prof = profile_cycles(torch, lambda n_: (run(n_),
                                                 torch.cuda.synchronize()),
                              5)
        if label == "dsa_B":
            # best_choice on the choice mask of a real DSA-B cycle: the
            # final values' candidates (ops/dsa.py choice_mask).
            mask = dsa.dsa_choices(
                scale_graph, torch.cat([values, values.new_zeros(1)]),
                "B")[1]
            out["best_choice_dsa_B_mask"] = best_choice_timing(
                torch, ctx["threefry"], ctx["prng"].key_words(3), mask)
            del mask
        out[label] = dict(
            ms_per_cycle=loop_s / LS_SCALE_CYCLES * 1e3,
            device_ms_per_cycle=prof["device_ms_per_cycle"],
            kernels_per_cycle=prof["device_kernels_per_cycle"],
            device_busy_share=prof["device_busy_share"],
            top=prof["top"][:8], device_cost=float(cost),
            launches=launches,
            card_equals_cpu_cycles=LS_SCALE_COMPARE,
            sync_free=not label.startswith("dba"))
        if label.startswith("dba"):
            out[label]["run_ms_by_chunk"] = chunks
        if label.startswith("gdba"):
            # The candidate's share: GDBA's effective-cost sum (two row
            # gathers and an add a position, then the contributions
            # entry) beside the fused entry that reads only the cost
            # table (ROADMAP Queue B: a modifier-reading table mode).
            state = gdba.init_state(scale_graph)
            eff_ms = graph_ms(torch, lambda: gdba.candidate_eff_costs(
                scale_graph, state.modifiers, state.values, "A"), 50)
            fused_ms = graph_ms(torch, lambda: ctx["candidate_costs"](
                scale_graph, state.values), 50)
            out[label]["candidate_eff_costs_ms"] = eff_ms[2]
            dev_ms = prof["device_ms_per_cycle"]
            out[label]["candidate_eff_costs_share"] = (
                eff_ms[2] / dev_ms if isinstance(dev_ms, float) and dev_ms
                else "not measured")
            out[label]["fused_candidate_costs_ms"] = fused_ms[2]
            del state
    del hard
    return out


def run_localsearch_phases(ctx, scale_graph):
    """Emit the local-search slice's four phases; returns the kernel
    timings and errors for the final kernels line."""
    from pydcop_tpu_torch.ops import segment_sum as segment_sum_mod
    from pydcop_tpu_torch.ops import threefry
    from pydcop_tpu_torch.utils import prng

    ctx.update(threefry=threefry, prng=prng,
               segment_sum_mod=segment_sum_mod)
    tf = phase_threefry(ctx)
    emit("threefry_check", **tf)
    rng = np.random.default_rng(11)
    graphs = [("flagship", ctx["ls_flagship_graph"]),
              ("scale", scale_graph)]
    var_costs, var_valid, buckets = scalefree_arrays(SCALE_VARS)
    graphs.append(("scale_free", ctx["graph_from_numpy"](
        var_costs, var_valid, buckets, device="cuda")))
    graphs.append(("multi_bucket_padded", ctx["graph_from_numpy"](
        *multi_bucket_arrays(rng), device="cuda")))
    for label, n_vars, d, sizes in POSITIONAL_SMALL:
        graphs.append((label, ctx["graph_from_numpy"](
            *one_factor_arrays(rng, n_vars, d, sizes), device="cuda")))
    pos = phase_positional_sum(ctx, graphs)
    emit("positional_sum_check", **pos)
    del graphs
    flag = phase_localsearch_flagship(ctx)
    emit("localsearch_flagship", **flag)
    scale = phase_localsearch_scale(ctx, scale_graph)
    emit("localsearch_scale", **scale)
    # Launches of the paths that run each kernel at the timed shapes.
    from pydcop_tpu_torch.ops import threefry

    at_scale = scale["dsa_B"]["launches"]
    main = flag["main_path_launches"]
    table = pos["timing"]
    table["positional_table_flagship"]["launches"] = main[
        segment_sum_mod.POSITIONAL_TABLE]
    table["positional_table_scale"]["launches"] = at_scale[
        segment_sum_mod.POSITIONAL_TABLE]
    # The contributions entry's path is the ternary solve (candidate_costs
    # without a binary bucket): its launches stand beside its rows.
    for label in ("flagship", "scale", "scale_free"):
        table[f"positional_{label}"]["launches_ternary_dsa"] = pos[
            "ternary_dsa"]["launches"][segment_sum_mod.POSITIONAL]
    tf["timing"]["uniform_f32"]["scale"]["launches"] = at_scale[
        threefry.UNIFORM]
    tf["timing"]["best_choice"]["scale"]["launches"] = at_scale[
        threefry.BEST_CHOICE]
    tf["timing"]["best_choice"]["scale_dsa_B_mask"] = scale.pop(
        "best_choice_dsa_B_mask")
    # Every flagship path's and scale path's launches, for the kernels
    # line.
    main["by_path"] = {label: row["launches"]
                       for label, row in flag["runs"].items()}
    main["by_path"].update({f"scale_{label}": row["launches"]
                            for label, row in scale.items()
                            if isinstance(row, dict) and "launches" in row})
    return tf, pos, main


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
        HEAVY_DEGREE,
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
    max_err = {"binary_factor_update": 0.0, "segment_sum": 0.0,
               "var_update": 0.0}
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
    # The kernel reads each bucket where it lies: here as views into
    # one [E, D] tensor, which the plain version takes whole.
    agg, graphs = {}, {}
    for idx, (label, graph) in enumerate(
            aggregation_graphs(graph_from_numpy, engine.graph)):
        n_edges = int(graph.agg_perm.shape[0])
        n_seg, d = graph.var_costs.shape
        msgs = edge_messages(torch, n_edges, d, seed=50 + idx)
        args = segment_args(torch, graph, msgs)
        beliefs, sums = segment_sum(*args)
        ref_b, ref_s = segment_sum_reference(
            msgs.cpu(), *(t.cpu() for t in args[1:5]))
        err = max(float((beliefs.cpu() - ref_b).abs().max()),
                  float((sums.cpu() - ref_s).abs().max()))
        max_err["segment_sum"] = max(max_err["segment_sum"], err)
        if not (torch.equal(beliefs.cpu(), ref_b)
                and torch.equal(sums.cpu(), ref_s)):
            fail(f"segment_sum kernel != plain on {label}: max |err| {err}")
        degree = graph.agg_offsets[1:] - graph.agg_offsets[:-1]
        agg[label] = dict(V1=n_seg, E=n_edges, D=d,
                          buckets=len(graph.buckets),
                          max_degree=int(degree.max()),
                          heavy=int((degree > HEAVY_DEGREE).sum()),
                          tiles=int(graph.agg_tiles.shape[0]))
        graphs[label] = graph
        del graph, msgs, args, beliefs, sums
    one_edge = one_edge_belief_check(torch, ops, graph_from_numpy, _build)
    emit("kernel_check", kernel="segment_sum", graphs=agg,
         one_edge_buckets=one_edge,
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

    for label in ("flagship", "scale", "scale_free", "hub"):
        graph = graphs[label]
        n_edges = int(graph.agg_perm.shape[0])
        n_seg, d = graph.var_costs.shape
        msgs = edge_messages(torch, n_edges, d, seed=100)
        args = segment_args(torch, graph, msgs)
        flat_args = (msgs,) + args[1:5]
        seg = torch.cat([b.var_ids.reshape(-1) for b in graph.buckets])
        reps = 50 if n_edges > 1_000_000 else 200

        def kernel():
            return segment_sum(*args)

        def plain():
            return segment_sum_reference(*flat_args)

        def library():
            # The one-call form (atomics, no fixed order): yardstick only.
            sums = torch.zeros_like(graph.var_costs)
            sums.index_add_(0, seg, msgs)
            return graph.var_costs + sums

        bound_ms, bound_by = segment_bound(n_edges, n_seg, d)
        k_ms, l_ms = (graph_ms(torch, fn, reps) for fn in (kernel, library))
        p_ms = eager_ms(torch, plain, 2)
        timing["segment_sum"][label] = dict(
            V1=n_seg, E=n_edges, D=d, max_degree=agg[label]["max_degree"],
            ms=k_ms[2], plain_ms=p_ms[2],
            library_ms=l_ms[2], ms_spread=[k_ms[0], k_ms[-1]],
            plain_ms_spread=[p_ms[0], p_ms[-1]],
            library_ms_spread=[l_ms[0], l_ms[-1]],
            call_ms=cuda_ms(torch, kernel, reps),
            bound_ms=bound_ms, bound_by=bound_by)
        del msgs, args, flat_args, seg

    # The whole aggregate_beliefs call on a graph of four buckets, which
    # the kernel reads in place, beside the form that first concatenated
    # them (one copy of the messages per call) and then ran the kernel.
    graph = graphs["multi_bucket_padded"]
    n_seg, d = graph.var_costs.shape
    f2v = tuple(
        edge_messages(torch, b.var_ids.numel(), d, seed=200 + i)
        .reshape(tuple(b.var_ids.shape) + (d,))
        for i, b in enumerate(graph.buckets))
    sizes = [b.var_ids.numel() for b in graph.buckets]

    def in_place():
        return ops.aggregate_beliefs(graph, f2v)

    def cat_then_kernel():
        flat = torch.cat([m.reshape(-1, d) for m in f2v])
        return segment_sum(torch.split(flat, sizes), *segment_args(
            torch, graph, flat)[1:])

    real_cat = torch.cat

    def no_cat(*args, **kwargs):
        raise RuntimeError("torch.cat on the card's aggregation path")

    torch.cat = no_cat
    try:
        got = in_place()
    finally:
        torch.cat = real_cat
    if not all(torch.equal(a, b) for a, b in zip(got, cat_then_kernel())):
        fail("aggregate_beliefs in place != concatenated messages")
    a_ms, c_ms = (graph_ms(torch, fn, 200)
                  for fn in (in_place, cat_then_kernel))
    bound_ms, bound_by = segment_bound(sum(sizes), n_seg, d)
    timing["segment_sum"]["multi_bucket_padded"] = dict(
        V1=n_seg, E=sum(sizes), D=d, buckets=len(sizes), torch_cat_calls=0,
        aggregate_beliefs_ms=a_ms[2], cat_then_kernel_ms=c_ms[2],
        aggregate_beliefs_ms_spread=[a_ms[0], a_ms[-1]],
        cat_then_kernel_ms_spread=[c_ms[0], c_ms[-1]],
        bound_ms=bound_ms, bound_by=bound_by)
    emit("kernel_timing", kernel="segment_sum", **timing["segment_sum"])
    scale_graph = graphs["scale"]
    del graphs, graph, f2v

    # 4b. var_update: kernel vs plain bit for bit at every shape, both
    # entry points timed at the flagship, scale and D = 128 shapes; then
    # the card against the CPU on ROADMAP Queue C's subnormal state.
    ctx = dict(torch=torch, ops=ops, api=api, _build=_build,
               graph_from_numpy=graph_from_numpy,
               state_to_numpy=state_to_numpy, build_engine=build_engine,
               dcop=dcop, params=params, objects=objects,
               relations=relations, dcop_mod=dcop_mod)
    vu = phase_var_update(ctx, engine.graph, scale_graph)
    max_err["var_update"] = vu["max_abs_err"]
    timing["var_update"] = vu.pop("timing")
    emit("kernel_check", kernel="var_update", **vu)
    emit("kernel_timing", kernel="var_update", **timing["var_update"])
    emit("subnormal_state", **phase_subnormal_state(ctx))

    # 5. Main path, full size: api.solve with NO device argument.  Each
    # superstep launches each kernel once; the final value selection
    # launches segment_sum once more.
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    res = api.solve(dcop, "maxsum", max_cycles=FIXED_CYCLES)
    launches = dict(_build.launch_counts)
    want = {"binary_factor_update": res["cycles"],
            "segment_sum": res["cycles"] + 1,
            "var_update": 2 * res["cycles"]}
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
               *[t for b in engine.graph.buckets for t in b
                 if t is not None],
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
                     "segment_sum": FIXED_CYCLES + 1,
                     "var_update": 2 * FIXED_CYCLES}
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
    flagship_scatter = card[0]
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
                 "segment_sum": SCALE_CYCLES + 1,
                 "var_update": 2 * SCALE_CYCLES}
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

    # 6b. The local-search slice: the threefry kernel and the positional
    # sum against their plain versions, then every local-search solve of
    # the flagship (each with the launch counts set to 0 just before it)
    # and DSA / MGM at scale.
    ctx["ls_flagship_graph"] = engine.graph
    ls_tf, ls_pos, ls_launches = run_localsearch_phases(ctx, graph)
    del graph, scale_graph

    # 8. This slice's paths: pruning, the cost trace, the sorted / ell /
    # boundary aggregations, aggregation="auto" and the CLI's per-cycle
    # metrics.  Each path is driven with the launch counts set to 0
    # just before it and read just after.
    ctx["kw"] = kw
    ttc = phase_prune_ttc(ctx)
    timing["binary_factor_update"]["ttc_D128"] = ttc.pop(
        "binary_factor_update")
    emit("prune_ttc", **ttc)
    scale_prune = phase_prune_scale(ctx)
    timing["binary_factor_update"]["ttc_scale_D128"] = scale_prune.pop(
        "binary_factor_update")
    emit("prune_scale", **scale_prune)
    options = phase_aggregation_options(ctx, flagship_scatter)
    timing["segment_sum"].update(options.pop("sorted_mode_timing"))
    emit("aggregation_options", **options)
    emit("auto", **phase_auto(ctx))
    emit("cli_trace", **phase_cli_trace(ctx))

    # 9. The segmented solve: checkpoint and resume (flagship and
    # scale), guard-and-recover, and decimation.
    ctx.update(dev="cuda", sync=torch.cuda.synchronize, engine=engine,
               cpu_engine=cpu_engine, flagship_scatter=flagship_scatter)
    run_segmented_phases(ctx)

    # 10. This slice's observability: observed solves equal the plain
    # ones, the probe at scale, the profiler, the live endpoint and the
    # trace/profile commands.
    run_observability_phases(ctx)

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
        "var_update": ("pydcop_tpu_torch/csrc/var_update.cu",
                       "pydcop_tpu/ops/maxsum.py:463"),
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
            # The same keys at the other shapes timed above (with the
            # launches of the path that runs the kernel at that shape).
            "shapes": {
                label: {key: row[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "launches") if key in row}
                for label, row in timing[name].items()
                if label != "flagship" and "ms" in row},
        })
    from pydcop_tpu_torch.ops import segment_sum as seg_mod
    from pydcop_tpu_torch.ops import threefry

    # The positional sum's two entries (the fused one is the local
    # search's main path; the contributions entry runs on graphs without
    # a binary bucket: its launches are the ternary solve's).
    for entry, key, prefix in (
            ("positional_table", seg_mod.POSITIONAL_TABLE,
             "positional_table_"),
            ("positional", seg_mod.POSITIONAL, "positional_")):
        rows_p = {label[len(prefix):]: row
                  for label, row in ls_pos["timing"].items()
                  if label.startswith(prefix)
                  and not label[len(prefix):].startswith("table_")}
        flag = rows_p["flagship"]
        rows.append({
            "name": f"segment_sum: {entry}", "route": "cuda",
            "source": "pydcop_tpu_torch/csrc/segment_sum.cu",
            "replaces": "pydcop_tpu/ops/localsearch.py:57",
            "launches": (ls_launches[key] if entry == "positional_table"
                         else ls_pos["ternary_dsa"]["launches"][key]),
            "launches_by_path": {label: n[key] for label, n in
                                 ls_launches["by_path"].items() if n[key]},
            "max_abs_err": ls_pos["max_abs_err"], "ms": flag["ms"],
            "plain_ms": flag["plain_ms"], "bound_ms": flag["bound_ms"],
            "bound_by": flag["bound_by"], "library_ms": flag["library_ms"],
            "shapes": {label: {k: row[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "torch_ops_ms", "unfused_ms", "launches") if k in row}
                for label, row in rows_p.items() if label != "flagship"},
        })
    for entry, key, replaces in (
            ("uniform_f32", threefry.UNIFORM, "pydcop_tpu/ops/dsa.py:164"),
            ("best_choice", threefry.BEST_CHOICE,
             "pydcop_tpu/ops/localsearch.py:316")):
        rows_t = ls_tf["timing"][entry]
        flag = rows_t["flagship"]
        rows.append({
            "name": f"threefry: {entry}", "route": "cuda",
            "source": "pydcop_tpu_torch/csrc/threefry.cu",
            "replaces": replaces, "launches": ls_launches[key],
            "launches_by_path": {label: n[key] for label, n in
                                 ls_launches["by_path"].items() if n[key]},
            "max_abs_err": ls_tf["max_abs_err"], "ms": flag["ms"],
            "plain_ms": flag["plain_ms"], "bound_ms": flag["bound_ms"],
            "bound_by": flag["bound_by"], "library_ms": None,
            "shapes": {label: {k: row[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "launches") if k in row}
                for label, row in rows_t.items() if label != "flagship"},
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run() -> int:
    """:func:`main` with the flight recorder's postmortem bundles (the
    recovery phase trips guards on purpose) in a temporary directory
    under TMPDIR, removed on the way out."""
    import shutil
    import tempfile

    bundles = tempfile.mkdtemp(prefix="chip_smoke_bundles_")
    os.environ["PYDCOP_FLIGHT_DIR"] = bundles
    try:
        return main()
    finally:
        shutil.rmtree(bundles, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(run())
