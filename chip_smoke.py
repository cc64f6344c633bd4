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
``segment_sum`` kernel check.  The portfolio and dynamic slice adds
``portfolio`` (``api.solve(flagship, "auto")``: every race leg's cost
equal to the same leg on the CPU, the replay of the stored decision
without a race, the domino chain resolved to DPOP at cost 1.0) and
``dynamic`` (``replay_scenario`` on the flagship: the card equal to the
CPU after every run, every message tensor; the patched graph equal to
its placement; a card checkpoint restored and run on the CPU).  The
batch and lane slice adds ``lane_kernel_check`` (the lane entry of
``binary_factor_update.cu`` and ``lane_sum.cu`` bit for bit against
their plain versions, timed beside their bounds and ``index_add_``),
``lane_layout`` (``api.solve(flagship, layout lane)``: card = CPU =
second card run over 200 cycles, the cost trace, the 1M-variable scale
arrays card = CPU, ms a cycle lane against edge), ``batch_stacked``
(``solve_maxsum_batch`` over 32 instances of 10,000 variables as one
disjoint union: each member equal to its solo card solve, the stack
card = CPU, ``launch_stacked`` under the sync-debug check) and
``batch_envelope_lane`` (24 structures envelope-padded and lane-packed,
each member equal to its solo solve and to the CPU).  The lane kernels
slice extends ``lane_kernel_check`` (the redesigned ``lane_sum.cu``, its
from-costs mode and both entries of ``lane_var_update.cu`` bit for bit
against their plain versions at D = 1..8, 11 and 33, timed beside their
bounds) and ``lane_layout`` (the new launch counts, kernels a cycle and
device time from the profiler, lane against edge in the same call; the
profiles are taken in a fresh process, ``python3 chip_smoke.py
--lane-profiles``, which this phase starts, each held to the launch
counters of its run).  The serving slice adds ``serve``:
``api.serve(port=0, device="cuda")`` with its HTTP front end, driven
through five legs — 16 instances of 10,000 variables as one flush (the
warm flush pipelined and held to one stacked dispatch's launches),
bench.py's zipf mixed stream from 8 clients with lane-packed and
envelope-padded bursts, a session of 16 PATCHed event batches read over
SSE, journal recovery after a stop without drain, and a dpop request —
every answer equal to its solo card solve (the mixed stream's to the
CPU's too, the session to a CPU session's), the pipelined, envelope and
lane dispatch counts and the kernels' launches non-zero, and
problems/s, p50/p99 and seconds on lines of their own.  The
partitioned slice adds ``sharded``: ``ShardedMaxSumEngine`` on meshes
naming the card 2, 4 and 8 times, each equal to the same engine on the
CPU after every cycle (every message, count, the halo slot and the
values), the S = 4 flagship run with its launch counts, ms a cycle
beside the unsharded engine, the 1M-variable scale arrays at S = 4
card = CPU, ``csrc/halo_sum.cu`` and ``segment_sum.cu``'s subset entry
bit for bit against their plain versions (subnormals included) timed
beside their bounds and ``torch.sum`` / ``index_add_``, one
``trip_shard`` recovery card = CPU, and ``api.solve(shards=)`` above
the card count refused; its S = 4 profile is taken in a fresh process,
``python3 chip_smoke.py --shard-profile``, held to the launch counters
of its run.  The fleet slice adds ``fleet``: ``api.serve(port=0,
replicas=2, device="cuda")``, two worker processes sharing the card
behind the router, started with the kernel libraries the earlier
phases built, driven with the serve phase's mixed stream and one bin
of flagship problems; one worker is killed with SIGKILL mid-burst and
every acknowledged request is answered after its restart (the restarted
worker replaying its journal segment on the card); every answer equals
its solo solve on the card and on the CPU, each worker's own
``/profile`` names the card and the kernel libraries it loaded and
launched, and problems/s, p50/p99 and the start and restart seconds
print beside the serve phase's figures.  The generators slice adds
``generated``: the port's generators make six problem families in this
process (a soft 3-colouring of 10,000 variables on a scale-free graph,
a 100 x 100 Ising torus, PEAV meeting scheduling, a SECP of 3,600
variables with arities 1-4, IoT and a small world of 10,000 variables,
D = 10), each solved through ``api.solve`` with maxsum, dsa and mgm on
the card and on the CPU (every answer equal; the MaxSum messages bit
for bit on the problems of unary and binary factors), the launch counts
set to 0 before each card solve; ``factor_to_var`` timed on SECP's
arity-3 and arity-4 buckets beside the binary kernel; and the CLI's
``generate``, ``graph`` and ``solve --device cuda`` on a small
generated file.
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
H100_L2_BYTES = 50 * 2 ** 20     # one H100 SXM's L2
BIG = np.float32(1e9)
FLAGSHIP_VARS = 10_000
N_COLORS = 3
SCALE_VARS = 1_000_000
# The scale leg's cycles (30 until the portfolio and dynamic phases were
# added, 15 until the batch and lane slice's, 10 until the generators
# slice's: cut to make room for them; its CPU run is ~1 s a cycle).
SCALE_CYCLES = 5
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
    with torch.cuda.graph(graph, stream=side):
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


def profile_cycles(torch, run, cycles: int, counts=None):
    """torch.profiler over ``run(cycles)`` (a fixed-cycle run that ends
    synchronised): device busy time per cycle, the device's busy share
    of the wall time, and the kernels that take the most device time.
    With ``counts`` (``_build.launch_counts``), the counts are set to 0
    after the warm run and the profiled run's are returned too, beside
    the launches the profile saw of the port's own kernels (the CUDA
    rows of kernels declared in an anonymous namespace: ``void
    (anonymous namespace)::name<...>(...)`` for a template, ``(anonymous
    namespace)::name(...)``, with no return type, for a plain function;
    torch's kernels are ``at::native`` ones, whose template arguments may
    name anonymous namespaces)."""
    from torch.profiler import ProfilerActivity, profile

    run(cycles)   # warm
    if counts is not None:
        counts.clear()
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
    extra = {} if counts is None else {
        "launches": dict(counts),
        "own_kernel_launches": sum(
            e.count for e in events
            if e.key.startswith(("void (anonymous namespace)::",
                                 "(anonymous namespace)::")))}
    return extra | {
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
    from pydcop_tpu_torch.ops import window_sum

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
            "var_update": 2 * TTC_CYCLES,
            window_sum.COUNTER: TTC_CYCLES}
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
# The flagship local-search solves' cycles (200 until the portfolio and
# dynamic phases were added: cut to make room for them; their CPU runs
# are most of the phase).  DBA's CSP must stop before it (at 121).
LS_CYCLES = 130
# ... and those of the other algorithms' solves (LS_CYCLES until the
# partitioned slice's phase was added, 60 until the generators slice's:
# cut to keep the script well inside its time limit on a slow host;
# their CPU runs were 33 s of the phase's 74 s at 60 cycles).
LS_CHECK_CYCLES = 30
# The flagship ops loop is timed over this many cycles and profiled over
# LS_PROFILE_CYCLES (200 and 20 before the exact slice's phases were
# added: cut to make room for them); the solves run LS_CHECK_CYCLES
# (DBA LS_CYCLES), and a second card solve repeats the first case of
# each algorithm only.
LS_TIMED_CYCLES = 50
LS_PROFILE_CYCLES = 10
# 30 until the batch and lane slice, 20 until the lane kernels slice.
LS_SCALE_CYCLES = 10
# Card = CPU state by state at scale (5 until the generators slice).
LS_SCALE_COMPARE = 2
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
    from pydcop_tpu_torch.ops import segment_sum, threefry, window_sum

    return {k: _build.launch_counts.get(k, 0)
            for k in (segment_sum.POSITIONAL, segment_sum.POSITIONAL_TABLE,
                      threefry.UNIFORM, threefry.BEST_CHOICE,
                      window_sum.COUNTER)}


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
    from pydcop_tpu_torch.ops.window_sum import COUNTER as WINDOW_COUNTER

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
    repeated = set()
    for label, algo, params, problem in LS_CASES:
        dcop = problems[problem]
        cycles = LS_CYCLES if algo == "dba" else LS_CHECK_CYCLES
        _build.launch_counts.clear()
        res = api.solve(dcop, algo, max_cycles=cycles, algo_params=params)
        launches = ls_launch_counts(_build)
        if main_launches is None:
            main_launches = dict(launches)
        if not res["metrics"]["device"].startswith("cuda"):
            fail(f"{label} ran on {res['metrics']['device']}")
        others = []
        if algo not in repeated:
            repeated.add(algo)
            others.append(("second card run", api.solve(
                dcop, algo, max_cycles=cycles, algo_params=params)))
        cpu = api.solve(dcop, algo, max_cycles=cycles, algo_params=params,
                        device="cpu")
        others.append(("CPU run", cpu))
        for name, other in others:
            if (other["assignment"] != res["assignment"]
                    or other["cycles"] != res["cycles"]
                    or other["cost"] != res["cost"]):
                fail(f"{label}: card run != {name} (cost {res['cost']} vs "
                     f"{other['cost']})")
        entry = (segment_sum.POSITIONAL if algo in BREAKOUT
                 else segment_sum.POSITIONAL_TABLE)
        # DBA's cost is a violation count (integer, exact in any
        # order): it sums no float total.
        if (launches["threefry:best_choice"] == 0
                or (algo != "dba"
                    and launches[WINDOW_COUNTER] == 0) or (
                    (params.get("aggregation") != "ell"
                     or algo == "mixeddsa") and launches[entry] == 0)):
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
        timed_cycles = LS_CYCLES if algo == "dba" else LS_TIMED_CYCLES
        t0 = time.perf_counter()
        timed(timed_cycles)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        prof = profile_cycles(torch, lambda n: (run(n),
                                                torch.cuda.synchronize()),
                              LS_PROFILE_CYCLES)
        # A DBA run that stops early runs to the end of its chunk: its
        # time is per cycle of the solve, the gated steps included.
        per = res["cycles"] if algo == "dba" else timed_cycles
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
            equal=[name for name, _ in others], **extra)
        if "n_classes" in res["metrics"]:
            rows[label]["n_classes"] = res["metrics"]["n_classes"]
        del graph
    return {"n_vars": FLAGSHIP_VARS, "cycles": LS_CHECK_CYCLES,
            "dba_cycles": LS_CYCLES, "runs": rows,
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


# ----------------------------------------------------------------------
# The exact slice: whole-graph totals in XLA's order (window_sum.cu),
# then DPOP, SyncBB and NCBB.

WINDOW_SIZES = [1, 31, 32, 33, 1_025, 15_000, 1_000_001, 1_500_000]
WINDOW_TIMED = 1_500_000
WINDOW_TRACE_CYCLES = 30
# The residual shapes [F, arity, D] checked on the card: row lanes over
# axis 1 (direct and windowed), rows in lanes over axis 0 (unit inner
# axis: direct, windows of 32 rows, windows ending on padding), an axis
# longer than 32 inside (boxes over two axes), arity 16 (row lanes 8
# and 4, each lane two or four of the row's slots).
WINDOW_RESIDUALS = [(14_999, 2, 3), (1_500_000, 2, 3), (17, 4, 3),
                    (17, 8, 12), (20, 4, 9), (64, 1, 3), (1_024, 1, 8),
                    (63, 2, 1), (95, 1, 5), (23, 1, 2), (8, 12, 1),
                    (100, 1, 16), (300, 2, 128), (5, 40, 50),
                    (40, 16, 2), (17, 16, 8), (40, 16, 7)]
# Graphs of the fused cost totals: (label, variables, D, factors of
# arity 1, 2, ...): unary to 5-ary buckets, a one-factor bucket, a unit
# domain, and buckets of 8..32 factors (every head form's neighbours).
WINDOW_GRAPHS = [("mixed_arity", 300, 3, (40, 500, 60, 20, 9)),
                 ("one_factor", 200, 3, (0, 300, 1)),
                 ("unit_domain", 120, 1, (0, 22, 17, 30, 8)),
                 ("heads", 60, 2, (23, 20, 24, 32, 16, 8)),
                 ("scale_mixed", 100_000, 4, (5_000, 150_000, 30_000))]
# Warm DPOP solves timed an instance (5 until the portfolio and dynamic
# phases were added, 3 until the batch and lane slice's, 2 until the
# lane kernels slice's).
DPOP_WARM_REPS = 1
# benchmarks/bench_dpop.py's trees (n, D), seed 0 — BASELINE.md config
# #3 — and bench.py build_dpop_exact_dcop's (n, D, seed).
DPOP_TREES = [(3_000, 3), (10_000, 8)]
DPOP_EXACT = (300, 8, 1709)
# The band: n variables, each tied to its previous W ones, D values: the
# largest UTIL table holds D ** (W + 1) = 2 ** 24 elements (n was 20
# until the generators slice: its CPU solve took 20.5 s, most of it the
# 13 nodes at full width; 10 keeps 3 of them, two of which join a
# child's message: the largest call still has 8 components).
DPOP_WIDE = (10, 8, 7)
TREE_SEARCH_FIXTURES = [
    "coloring_3agents_10vars.yaml", "coloring_4agents_10vars.yaml",
    "coloring_chain.yaml", "coloring_chain_func.yaml",
    "coloring_chain_init.yaml", "coloring_ext_costs.yaml",
    "coloring_int_costs.yaml", "coloring_ring_hard.yaml", "pref_ring.yaml",
    "pref_ring_max.yaml", "secp_lamps.yaml"]


def np_window_sum(x, head=()):
    """An independent numpy float32 model of XLA:CPU's ``jnp.sum`` of a
    vector: subnormal inputs read as zeros, every add flushed; windows
    of 32 (zero padding, half in front) while more than 32 values are
    left; then ``head``'s lane stages (only for a direct sum of <= 32
    values) and the rest left to right; one value is a copy."""
    x = np.asarray(x, np.float32).reshape(-1)
    if x.size == 1:
        return x[0]

    def ftz(a):
        with np.errstate(invalid="ignore"):
            return np.where(np.abs(a) < FLT_MIN, a * np.float32(0.0),
                            a).astype(np.float32)

    x = ftz(x)
    if x.size > 32:
        head = ()
    while x.size > 32:
        pad = (-x.size) % 32
        w = np.concatenate([np.zeros(pad // 2, np.float32), x,
                            np.zeros(pad - pad // 2, np.float32)])
        w = w.reshape(-1, 32)
        acc = np.zeros(w.shape[0], np.float32)
        for j in range(32):
            acc = ftz(acc + w[:, j])
        x = acc
    acc, start = np.float32(0.0), 0
    for lanes, end in head:
        end = min(end, x.size)
        sums = [acc] + [np.float32(0.0)] * (lanes - 1)
        for i in range(start, end):
            sums[(i - start) % lanes] = ftz(sums[(i - start) % lanes] + x[i])
        while len(sums) > 1:
            half = len(sums) // 2
            sums = [ftz(sums[i] + sums[i + half]) for i in range(half)]
        acc, start = sums[0], end
    for i in range(start, x.size):
        acc = ftz(acc + x[i])
    return np.float32(acc)


def window_inputs(size: int, kind: str, seed: int):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(size)
         * 10.0 ** rng.uniform(-4, 4, size)).astype(np.float32)
    if kind == "subnormal":
        x[rng.random(size) < 0.3] = np.float32(-1e-39)
        x[rng.random(size) < 0.1] = np.float32(1.3e-38)
    elif kind == "inf":
        x[rng.integers(0, size)] = np.inf
        x[rng.integers(0, size)] = -np.inf
    elif kind == "posinf":
        x[rng.integers(0, size)] = np.inf
    return x


def gather_bound(table, ids, values):
    """Bytes the card must move for the total of one cost gather
    (``table[f, flat(values[ids[f]])]``): every id, each 32-byte sector
    of the values and of the table that this assignment reads (counted
    from the data: a sector serves every entry in it), and the result."""
    ids = np.asarray(ids, np.int64)
    vals = np.concatenate([np.asarray(values, np.int64), [0]])
    f, arity = ids.shape
    d = int(round(table.shape[1] ** (1.0 / arity))) if arity else 0
    flat = np.zeros(f, np.int64)
    for p in range(arity):
        flat = flat * d + vals[np.minimum(ids[:, p], len(vals) - 1)]
    entries = np.arange(f, dtype=np.int64) * table.shape[1] + flat
    used = np.unique(ids[ids < len(values)])
    return (ids.size * 4 + np.unique(used * 4 // 32).size * 32
            + np.unique(entries * 4 // 32).size * 32 + 4)


def window_gather_timing(torch, ops, _build, graph, cpu_buckets, values):
    """The fused total of the scale graph's cost gathers (1.5M binary
    factors) at ``values`` on the card: its launches in one call (it
    fails unless one), timed in a CUDA graph beside its bound in sectors
    and the unfused torch ops (gather, then ``torch.sum``: other bits, a
    yardstick only)."""
    from pydcop_tpu_torch.ops import window_sum as ws

    launches = one_call_launches(
        _build, ws.COUNTER,
        lambda: ops.assignment_constraint_cost(graph, values))
    if launches != 1:
        fail(f"window_sum: the scale graph's cost took {launches} "
             "launches, not 1")
    k_ms = graph_ms(torch, lambda: ops.assignment_constraint_cost(
        graph, values), 100)
    vals = torch.cat([values.long(), torch.zeros(1, dtype=torch.int64,
                                                 device=values.device)])

    def torch_ops():
        total = None
        d = graph.var_costs.shape[1]
        for b in graph.buckets:
            f, arity = b.var_ids.shape
            idx = vals[b.var_ids]
            flat = idx[:, 0]
            for p in range(1, arity):
                flat = flat * d + idx[:, p]
            part = torch.sum(torch.gather(b.costs.reshape(f, -1), 1,
                                          flat[:, None]))
            total = part if total is None else total + part
        return total

    t_ms = graph_ms(torch, torch_ops, 20)
    plain = ops.constraint_operands(graph)
    p_ms = graph_ms(torch, lambda: ws.window_total_plain(plain, values), 3)
    host_vals = values.cpu().numpy()
    moved = sum(gather_bound(c.reshape(c.shape[0], -1), i, host_vals)
                for c, i in cpu_buckets)
    return dict(n_factors=int(sum(i.shape[0] for _, i in cpu_buckets)),
                ms=k_ms[2], ms_spread=[k_ms[0], k_ms[-1]],
                plain_ms=p_ms[2], torch_ops_ms=t_ms[2], bytes=int(moved),
                bound_ms=moved / H100_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=None, launches_per_call=launches,
                note="bound counts every id, the 32-byte sectors of values "
                "and table this assignment reads, and the result")


def one_call_launches(_build, counter: str, fn) -> int:
    """The launches ``counter`` counts in one call of ``fn`` (set to 0
    just before it and read just after)."""
    _build.launch_counts[counter] = 0
    fn()
    return _build.launch_counts[counter]


def mixed_arrays(rng, n_vars: int, d: int, counts):
    """A graph of ``counts[k]`` random factors of arity k + 1 (unary
    included) over ``n_vars`` variables of domain ``d``, with real costs
    over eight decades, as (var_costs, var_valid, buckets) arrays."""
    var_costs = (rng.standard_normal((n_vars + 1, d))
                 * 10.0 ** rng.uniform(-4, 4, (n_vars + 1, d))).astype(
                     np.float32)
    var_costs[-1] = 0.0
    buckets = []
    for arity, count in enumerate(counts, start=1):
        if not count:
            continue
        ids = np.stack([rng.choice(n_vars, arity, replace=False)
                        for _ in range(count)]).astype(np.int32)
        shape = (count,) + (d,) * arity
        costs = (rng.standard_normal(shape)
                 * 10.0 ** rng.uniform(-4, 4, shape)).astype(np.float32)
        buckets.append((costs, ids))
    return var_costs, np.ones((n_vars + 1, d), bool), buckets


def window_heads(ws):
    """Every head form ``gather_stages`` gives (arity 0-8, D 1-5)."""
    return sorted({ws.gather_stages(site, arity, d, n, widest)
                   for site in ("localsearch", "maxsum", "probe")
                   for arity in range(9) for d in range(1, 6)
                   for n in range(2, 33) for widest in (2, 3)})


def phase_window_sum(ctx, ls_main_launches):
    """``csrc/window_sum.cu`` bit for bit against its plain version on the
    card and the numpy model (every size, subnormal and +-inf inputs,
    every head form); the residual's row forms against the plain
    version; the fused cost totals (the flagship's, multi-bucket graphs
    with unary to 5-ary buckets and a one-factor bucket, a unit domain)
    card = CPU; timed at 1.5M values beside its bound and
    ``torch.sum``; its launches per local-search solve and per traced
    MaxSum cycle, and of one traced cycle's cost (it fails unless one);
    and the flagship's ``device_cost`` and cost trace on the card equal
    the CPU's."""
    torch, api, _build = ctx["torch"], ctx["api"], ctx["_build"]
    ops = ctx["ops"]
    from pydcop_tpu_torch.ops import localsearch
    from pydcop_tpu_torch.ops import window_sum as ws

    t_phase = time.perf_counter()
    checked = []
    cases = [(n, "signed") for n in WINDOW_SIZES] + [
        (1_025, "subnormal"), (1_000_001, "subnormal"), (31, "subnormal"),
        (1_025, "inf"), (15_000, "inf"), (33, "posinf"),
        (1_500_000, "posinf")]
    heads = window_heads(ws)
    cases += [(n, head) for head in heads for n in (4, 8, 20, 23, 31, 32)]
    for idx, (n, how) in enumerate(cases):
        head = () if isinstance(how, str) else how
        x = window_inputs(n, how if isinstance(how, str) else "signed",
                          seed=idx)
        xc = torch.from_numpy(x).cuda()
        out = ws.window_tree_sum(xc, head)
        plain = ws.window_tree_sum_plain(xc, head)
        model = np_window_sum(x, head)
        torch.cuda.synchronize()
        vals = [np.asarray(v, np.float32) for v in (
            out.cpu().numpy(), plain.cpu().numpy(), model)]
        # Any two NaNs agree: an invalid add makes 0x7FFFFFFF on the
        # card and 0xFFC00000 in numpy on an x86 CPU.
        if not (all(np.isnan(v) for v in vals) or len(
                {int(v.view(np.uint32)) for v in vals}) == 1):
            fail(f"window_sum n={n} {how}: kernel {out.item()} plain "
                 f"{plain.item()} numpy {model}")
        checked.append([n, how if isinstance(how, str) else list(head)])
    # The residual's row forms: lanes over axis 1, rows in lanes over
    # axis 0 (direct, windows of 32 rows, windows ending on padding), a
    # long inner axis (boxes over two axes), several operands from +0.0.
    for shape in WINDOW_RESIDUALS:
        x = torch.from_numpy(np.abs(window_inputs(
            int(np.prod(shape)), "signed", 7)).reshape(shape)).cuda()
        lanes, rows = ws.residual_lanes(shape), ws.residual_rows(shape)
        part = x[: max(1, shape[0] // 3)].contiguous()
        both = [ws.Plain(x, (), lanes, rows),
                ws.Plain(part, (), ws.residual_lanes(part.shape),
                         ws.residual_rows(part.shape))]
        for operands in (both[:1], both):
            card = ws.window_total(operands, from_zero=True)
            plain = ws.window_total_plain(
                [o._replace(x=o.x.cpu()) for o in operands], None, True)
            if card.cpu().view(torch.int32) != plain.view(torch.int32):
                fail(f"window_sum residual {shape} ({len(operands)} "
                     f"operands): kernel {card.item()} != plain "
                     f"{plain.item()}")
        checked.append([list(shape), f"residual lanes {lanes} rows {rows}"])
    # The fused cost gathers: whole totals card = CPU at every site.
    rng = np.random.default_rng(29)
    graphs = [("flagship", ctx["ls_flagship_graph"], None)]
    for label, n_vars, d, counts in WINDOW_GRAPHS:
        arrays = mixed_arrays(rng, n_vars, d, counts)
        graphs.append((label, ctx["graph_from_numpy"](*arrays,
                                                      device="cuda"),
                       arrays))
    for label, graph, arrays in graphs:
        if arrays is None:
            arrays = (graph.var_costs.cpu().numpy(),
                      graph.var_valid.cpu().numpy(),
                      [(b.costs.cpu().numpy(), b.var_ids.cpu().numpy())
                       for b in graph.buckets])
        cpu = ctx["graph_from_numpy"](*arrays, device="cpu")
        n_vars, d = arrays[0].shape[0] - 1, arrays[0].shape[1]
        values = rng.integers(0, d, n_vars + 1).astype(np.int32)
        base = (rng.standard_normal((n_vars, d))).astype(np.float32)
        full = torch.from_numpy(values)
        for site in ("maxsum", "probe"):
            card = ops.assignment_total(graph, full[:-1].cuda(),
                                        torch.from_numpy(base).cuda(),
                                        site=site)
            plain = ops.assignment_total(cpu, full[:-1],
                                         torch.from_numpy(base), site=site)
            if card.cpu().view(torch.int32) != plain.view(torch.int32):
                fail(f"window_sum {label} cost_of at {site}: card "
                     f"{card.item()} != CPU {plain.item()}")
        card = localsearch.assignment_cost(graph, full.cuda())
        plain = localsearch.assignment_cost(cpu, full)
        if card.cpu().view(torch.int32) != plain.view(torch.int32):
            fail(f"window_sum {label} assignment_cost: card {card.item()} "
                 f"!= CPU {plain.item()}")
        checked.append([label, "cost totals at maxsum, probe, localsearch"])

    x = torch.from_numpy(window_inputs(WINDOW_TIMED, "signed", 1)).cuda()
    k_ms = graph_ms(torch, lambda: ws.window_tree_sum(x), 200)
    p_ms = graph_ms(torch, lambda: ws.window_tree_sum_plain(x), 5)
    l_ms = graph_ms(torch, lambda: torch.sum(x), 200)
    bound_ms = WINDOW_TIMED * 4 / H100_BYTES_PER_S * 1e3
    timing = dict(N=WINDOW_TIMED, ms=k_ms[2], ms_spread=[k_ms[0], k_ms[-1]],
                  plain_ms=p_ms[2], library_ms=l_ms[2],
                  library_ms_spread=[l_ms[0], l_ms[-1]], bound_ms=bound_ms,
                  bound_by="bytes", library="torch.sum (other bits)",
                  launches_per_call=one_call_launches(
                      _build, ws.COUNTER, lambda: ws.window_tree_sum(x)))
    if timing["launches_per_call"] != 1:
        fail(f"window_sum at {WINDOW_TIMED} values took "
             f"{timing['launches_per_call']} launches, not 1")

    # The flagship with real soft tables on half its edges: the local
    # search's device_cost and MaxSum's cost trace, card = CPU.
    objects, relations, dcop_mod = (ctx["objects"], ctx["relations"],
                                    ctx["dcop_mod"])
    real = build_flagship(objects, relations, dcop_mod, FLAGSHIP_VARS,
                          extra_soft=True)
    _build.launch_counts.clear()
    card = api.solve(real, "dsa", max_cycles=LS_CYCLES)
    per_solve = _build.launch_counts[ws.COUNTER]
    cpu = api.solve(real, "dsa", max_cycles=LS_CYCLES, device="cpu")
    if (card["assignment"] != cpu["assignment"] or
            card["metrics"]["device_cost"] != cpu["metrics"]["device_cost"]):
        fail(f"real flagship dsa: card device_cost "
             f"{card['metrics']['device_cost']} != CPU "
             f"{cpu['metrics']['device_cost']}")
    eng = ctx["build_engine"](real, ctx["params"])
    cpu_eng = ctx["build_engine"](real, ctx["params"], device="cpu")
    _build.launch_counts.clear()
    trace = eng.run_trace(WINDOW_TRACE_CYCLES, stop_on_convergence=False)
    per_cycle = _build.launch_counts[ws.COUNTER] / WINDOW_TRACE_CYCLES
    cpu_trace = cpu_eng.run_trace(WINDOW_TRACE_CYCLES,
                                  stop_on_convergence=False)
    if (trace.metrics["cost_trace"].tobytes()
            != cpu_trace.metrics["cost_trace"].tobytes()):
        fail("real flagship: the card's cost trace != the CPU's")
    if per_solve == 0 or per_cycle == 0 or ls_main_launches == 0:
        fail(f"window_sum launched {per_solve} a DSA solve, {per_cycle} a "
             f"traced cycle, {ls_main_launches} on the main local-search "
             "path")
    # One traced cycle's cost (constraint + variable costs) in device
    # kernels: the whole cost_of of run_maxsum_trace.
    base = torch.as_tensor(eng.meta.var_base_costs, dtype=torch.float32,
                           device="cuda")
    values = ops.select_values(eng.graph, ops.aggregate_beliefs(
        eng.graph, ops.init_state(eng.graph).f2v)[0])
    slot = torch.zeros((1,), dtype=torch.float32, device="cuda")
    cost_of = one_call_launches(_build, ws.COUNTER, lambda: (
        ops.assignment_total(eng.graph, values, base, out=slot[0])))
    if cost_of != 1:
        fail(f"one traced cycle's cost took {cost_of} window_sum "
             "launches, not 1")
    cost_ms = graph_ms(torch, lambda: ops.assignment_total(
        eng.graph, values, base, out=slot[0]), 100)
    return dict(
        checked=checked, tolerance="exact (uint32 views: kernel = plain on "
        "the card = numpy model; a NaN sum is NaN in all three)",
        max_abs_err=0.0, timing=timing,
        scale_gather=ctx.get("window_scale_gather"),
        traced_cycle_cost=dict(
            shape=[[int(b.var_ids.shape[0]), int(b.var_ids.shape[1])]
                   for b in eng.graph.buckets] + [list(base.shape)],
            launches=cost_of, ms=cost_ms[2],
            ms_spread=[cost_ms[0], cost_ms[-1]]),
        launches_main_localsearch_path=ls_main_launches,
        launches_per_dsa_solve=per_solve,
        launches_per_traced_maxsum_cycle=per_cycle,
        real_flagship=dict(
            dsa_device_cost=card["metrics"]["device_cost"],
            cpu_device_cost=cpu["metrics"]["device_cost"],
            trace_cycles=WINDOW_TRACE_CYCLES,
            trace_last=float(trace.metrics["cost_trace"][-1]),
            card_equals_cpu=["dsa device_cost", "maxsum cost_trace"]),
        seconds=time.perf_counter() - t_phase)


def dpop_tree(objects, relations, dcop_mod, n: int, d: int, seed: int = 0):
    """benchmarks/bench_dpop.py make_tree_dcop: a random tree, each
    variable tied to an earlier one by a rng.random((D, D)) table."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("c", "", list(range(d)))
    dcop = dcop_mod.DCOP("bench", objective="min")
    vs = [objects.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(1, n):
        p = rng.integers(0, i)
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[p], vs[i]], rng.random((d, d)), f"c{i}"))
    return dcop


def dpop_exact_dcop(objects, relations, dcop_mod, n: int, d: int,
                    seed: int):
    """bench.py build_dpop_exact_dcop: a random spanning tree over short
    ranges plus a short-range cross edge every 5 variables."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("c", "", list(range(d)))
    dcop = dcop_mod.DCOP("dpop_exact", objective="min")
    vs = [objects.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(1, n):
        p = int(rng.integers(max(0, i - 3), i))
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[p], vs[i]], rng.random((d, d)), f"c{i}"))
    for k in range(5, n, 5):
        q = int(rng.integers(max(0, k - 4), k))
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[q], vs[k]], rng.random((d, d)), f"x{k}"))
    dcop.add_agents([objects.AgentDef("a0")])
    return dcop


def dpop_band(objects, relations, dcop_mod, n: int, d: int, w: int,
              seed: int = 0):
    """Each variable tied to its previous ``w`` by rng.random((D, D))
    tables: the pseudo-tree is a chain whose separators hold ``w``
    variables."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("c", "", list(range(d)))
    dcop = dcop_mod.DCOP("band", objective="min")
    vs = [objects.Variable(f"v{i:03d}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(1, n):
        for j in range(max(0, i - w), i):
            dcop.add_constraint(relations.NAryMatrixRelation(
                [vs[j], vs[i]], rng.random((d, d)), f"c{j}_{i}"))
    return dcop


def dpop_solves_equal(label, card, others):
    """Fail unless ``card`` (a DPOP api.solve result) equals each of
    ``others`` ((name, result, keys of metrics to compare)) in
    assignment, cost and cycles and in those metrics."""
    for name, other, keys in others:
        if (other["assignment"] != card["assignment"]
                or other["cost"] != card["cost"]
                or other["cycles"] != card["cycles"]
                or any(other["metrics"][k] != card["metrics"][k]
                       for k in keys)):
            fail(f"{label}: card solve != {name} (cost {card['cost']} vs "
                 f"{other['cost']}, metrics {card['metrics']} vs "
                 f"{other['metrics']})")


def phase_dpop_exact(ctx):
    """DPOP through api.solve(dcop, "dpop", engine jit) on the card, on
    benchmarks/bench_dpop.py's trees and bench.py's exact instance:
    equal to the CPU's jit solve (every metric) and to the numpy sweep
    (assignment, cost, cycles, msg_count; msg_size against the jit solve
    without CEC, whose tables are not pruned); cold and warm (best of
    DPOP_WARM_REPS)
    times, the tree's sizes and the card's busy share."""
    torch, api = ctx["torch"], ctx["api"]
    from pydcop_tpu_torch.computations_graph import pseudotree as pt
    from pydcop_tpu_torch.ops.dpop import tree_stats

    objects, relations, dcop_mod = (ctx["objects"], ctx["relations"],
                                    ctx["dcop_mod"])
    t_phase = time.perf_counter()
    instances = [(f"tree_{n}_D{d}", dpop_tree(objects, relations, dcop_mod,
                                              n, d), n, d)
                 for n, d in DPOP_TREES]
    n, d, seed = DPOP_EXACT
    instances.append((f"exact_{n}_D{d}", dpop_exact_dcop(
        objects, relations, dcop_mod, n, d, seed), n, d))
    jit = {"engine": "jit"}
    keys = ("msg_count", "msg_size", "kernel_calls", "levels",
            "cec_rounds", "cec_pruned", "engine", "optimal")
    out = {}
    for label, dcop, n, d in instances:
        torch.cuda.synchronize()
        cold = api.solve(dcop, "dpop", algo_params=jit)
        warm = []
        for _ in range(DPOP_WARM_REPS):
            res = api.solve(dcop, "dpop", algo_params=jit)
            warm.append(res["total_time"])
        if res["metrics"]["engine"] != "jit":
            fail(f"{label}: ran {res['metrics']['engine']}, not the card")
        cpu = api.solve(dcop, "dpop", algo_params=jit, device="cpu")
        no_cec = api.solve(dcop, "dpop", algo_params={
            "engine": "jit", "cec": "off"})
        numpy_res = api.solve(dcop, "dpop", algo_params={"engine": "numpy"})
        dpop_solves_equal(label, res, [
            ("the CPU solve", cpu, keys), ("the cold card solve", cold, keys),
            ("the numpy sweep", numpy_res, ("msg_count",))])
        if (no_cec["metrics"]["msg_size"] != numpy_res["metrics"]["msg_size"]
                or no_cec["assignment"] != res["assignment"]):
            fail(f"{label}: the card solve without CEC != the numpy sweep")
        prof = profile_cycles(torch, lambda _n: api.solve(
            dcop, "dpop", algo_params=jit), 1)
        stats = tree_stats(pt.build_computation_graph(dcop))
        out[label] = dict(
            n_vars=n, D=d, cost=res["cost"], cycles=res["cycles"],
            cold_ms=cold["total_time"] * 1e3,
            cold_engine_ms=cold["time"] * 1e3,
            warm_ms=min(warm) * 1e3, warm_ms_all=[t * 1e3 for t in warm],
            warm_engine_ms=res["time"] * 1e3,
            cpu_ms=cpu["total_time"] * 1e3,
            numpy_ms=numpy_res["total_time"] * 1e3,
            kernel_calls=res["metrics"]["kernel_calls"],
            cec_pruned=res["metrics"]["cec_pruned"],
            msg_count=res["metrics"]["msg_count"],
            msg_size=res["metrics"]["msg_size"], tree_stats=stats,
            device_busy_share=prof["device_busy_share"],
            device_ms_per_solve=prof["device_ms_per_cycle"],
            device_kernels_per_solve=prof["device_kernels_per_cycle"],
            top=prof["top"][:5],
            equal=["CPU jit solve", "cold card solve", "numpy sweep",
                   "card solve without CEC (msg_size)"])
    out["seconds"] = time.perf_counter() - t_phase
    return out


def phase_dpop_wide(ctx):
    """The band instance, where the UTIL step is real work for the card:
    the card's solve equals the CPU's; the largest UTIL call's device
    time beside its bound (components read, acc and util written, over
    the HBM rate) and the device-to-host copy of its acc."""
    torch, api = ctx["torch"], ctx["api"]
    from pydcop_tpu_torch.computations_graph import pseudotree as pt
    from pydcop_tpu_torch.engine.dpop import DpopEngine
    from pydcop_tpu_torch.ops.dpop import tree_stats

    t_phase = time.perf_counter()
    n, d, w = DPOP_WIDE
    dcop = dpop_band(ctx["objects"], ctx["relations"], ctx["dcop_mod"],
                     n, d, w)
    graph = pt.build_computation_graph(dcop)
    stats = tree_stats(graph)
    if not (2 ** 24 <= stats["max_elements"] <= 2 ** 26
            and stats["total_elements"] <= 2 ** 30):
        fail(f"dpop_wide: tree sizes {stats}")
    jit = {"engine": "jit"}
    torch.cuda.synchronize()
    res = api.solve(dcop, "dpop", algo_params=jit)
    cpu = api.solve(dcop, "dpop", algo_params=jit, device="cpu")
    keys = ("msg_count", "msg_size", "kernel_calls", "levels",
            "cec_rounds", "cec_pruned", "engine")
    dpop_solves_equal("dpop_wide", res, [("the CPU solve", cpu, keys)])

    # The largest UTIL call of a card sweep, captured through the
    # engine's dispatch hook, then timed on its own.
    calls = []
    engine = DpopEngine(graph, mode="min")
    real_call = engine._call

    def capture(key, fn):
        calls.append((int(np.prod(key[0])) * fn.stacked[0].shape[0], key,
                      fn))
        return real_call(key, fn)

    engine._call = capture
    engine.run()
    _, key, fn = max(calls, key=lambda c: c[0])
    comps = [torch.from_numpy(a).cuda() for a in fn.stacked]
    acc, util = fn.kernel(*comps)
    util_ms = cuda_ms(torch, lambda: fn.kernel(*comps), 10)
    torch.cuda.synchronize()
    d2h = []
    for _ in range(5):
        t0 = time.perf_counter()
        acc.cpu()
        d2h.append((time.perf_counter() - t0) * 1e3)
    h2d = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        [torch.from_numpy(a).cuda() for a in fn.stacked]
        torch.cuda.synchronize()
        h2d.append((time.perf_counter() - t0) * 1e3)
    bytes_moved = (sum(c.numel() for c in comps) + acc.numel()
                   + (util.numel() if util is not None else 0)) * 4
    out = dict(
        n_vars=n, D=d, band=w, tree_stats=stats, cost=res["cost"],
        card_ms=res["total_time"] * 1e3, cpu_ms=cpu["total_time"] * 1e3,
        kernel_calls=res["metrics"]["kernel_calls"],
        msg_size=res["metrics"]["msg_size"],
        equal=["CPU jit solve"],
        largest_util=dict(
            shape=list(key[0]), nodes=int(acc.shape[0]),
            components=len(comps), elements=int(acc.numel()),
            ms=util_ms, bound_ms=bytes_moved / H100_BYTES_PER_S * 1e3,
            bound_by="bytes", bytes=bytes_moved,
            d2h_acc_ms=min(d2h), d2h_acc_ms_all=d2h,
            h2d_components_ms=min(h2d),
            d2h_gb_per_s=acc.numel() * 4 / (min(d2h) / 1e3) / 1e9),
        seconds=time.perf_counter() - t_phase)
    del acc, util, comps
    return out


def phase_tree_search(ctx):
    """SyncBB and NCBB through api.solve on ``cuda`` (host searches: they
    touch no tensor) on the repository's tractable fixtures: equal to
    the CPU run; on minimisation fixtures the cost equals DPOP's
    optimum; NCBB refuses the fixture with a constraint of arity 4."""
    api = ctx["api"]
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file
    from pydcop_tpu_torch.infrastructure.computations import (
        ComputationException,
    )

    t_phase = time.perf_counter()
    rows = {}
    for fixture in TREE_SEARCH_FIXTURES:
        dcop = load_dcop_from_file(os.path.join(
            HERE, "tests", "instances", fixture))
        dpop = api.solve(dcop, "dpop")
        row = {"dpop_cost": dpop["cost"]}
        for algo in ("syncbb", "ncbb"):
            try:
                card = api.solve(dcop, algo)
            except ComputationException:
                if algo != "ncbb" or all(
                        c.arity <= 2 for c in dcop.constraints.values()):
                    raise
                row[algo] = "refused (arity > 2)"
                continue
            cpu = api.solve(dcop, algo, device="cpu")
            if any(card[k] != cpu[k] for k in ("assignment", "cost",
                                                "cycles", "metrics")):
                fail(f"{algo} on {fixture}: cuda run != CPU run")
            if dcop.objective == "min" and abs(
                    card["cost"] - dpop["cost"]) > 1e-9:
                fail(f"{algo} on {fixture}: cost {card['cost']} != DPOP's "
                     f"{dpop['cost']}")
            row[algo] = dict(cost=card["cost"], cycles=card["cycles"],
                             msg_count=card["metrics"]["msg_count"])
        rows[fixture] = row
    return dict(fixtures=rows, tensors_touched=0,
                seconds=time.perf_counter() - t_phase)


def phase_dpop_cli(ctx):
    """``python -m pydcop_tpu_torch solve --algo dpop`` on the card (a
    child process, waited for) against the same solve on the CPU through
    ``api.solve``."""
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

    fixture = os.path.join(HERE, "tests", "instances", "coloring_12_3.yml")
    proc = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "--algo",
         "dpop", fixture], cwd=HERE, capture_output=True, text=True,
        timeout=300)
    if proc.returncode != 0:
        fail(f"dpop CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    card = json.loads(proc.stdout)
    cpu = ctx["api"].solve(load_dcop_from_file(fixture), "dpop",
                           device="cpu")
    if (card["assignment"] != cpu["assignment"] or card["cost"] != cpu["cost"]
            or card["cycle"] != cpu["cycles"]
            or card["msg_count"] != cpu["metrics"]["msg_count"]
            or card["msg_size"] != cpu["metrics"]["msg_size"]
            or card["status"] != "FINISHED"):
        fail(f"dpop CLI: card {card} != CPU {cpu}")
    return dict(fixture="tests/instances/coloring_12_3.yml",
                cost=card["cost"], cycle=card["cycle"],
                msg_count=card["msg_count"], msg_size=card["msg_size"],
                keys=sorted(card))


# The portfolio and dynamic slice.
DYN_SLACK = 0.02
# 200 and 100 until the batch and lane slice's phases were added, 120
# and 60 until the lane kernels slice (cut to keep the script's time;
# the CPU replay is most of the phase).
DYN_CYCLES = 80
DYN_EVENT_CYCLES = 40
DYN_MARGIN = 0.1
DYN_AFTER_RESTORE = 50
DOMINO_VARS = 140


def f32_bits(x) -> int:
    return int(np.float32(x).view(np.uint32))


def domino_chain(objects, relations, dcop_mod, n: int = DOMINO_VARS):
    """The reference's exact-inference battery's agreement chain
    (tests/unit/test_exact_inference_battery.py): one weak link in the
    middle, opposing biases at the ends; only DPOP reaches its optimum,
    cost 1, in a race leg."""
    weak_at = n // 2
    dom = objects.Domain("b", "", [0, 1])
    dcop = dcop_mod.DCOP("domino", objective="min")
    vs = [objects.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(n - 1):
        m = (np.array([[0.0, 1.0], [1.0, 0.0]]) if i == weak_at
             else np.array([[0.0, 5.0], [5.0, 0.0]]))
        if i == 0:
            m = m + np.array([[0.0, 0.0], [3.0, 3.0]])
        if i == n - 2:
            m = m + np.array([[3.0, 0.0], [3.0, 0.0]])
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[i], vs[i + 1]], m, f"m{i}"))
    dcop.add_agents([objects.AgentDef(f"a{i}") for i in range(n)])
    return dcop


def portfolio_legs_equal_cpu(label, dcop, info):
    """Each raced leg's cost on the card against the same leg run once
    on the CPU: bit for bit."""
    from pydcop_tpu_torch.engine import autotune
    from pydcop_tpu_torch.engine.compile import compile_dcop

    graph, meta = compile_dcop(dcop, noise_level=0.01)
    cpu = autotune._portfolio_runners(
        graph, autotune.PORTFOLIO_RACE_CYCLES, meta=meta, device="cpu")
    if info["portfolio_costs"].get("dpop") is not None:
        cpu["dpop"] = autotune.dpop_portfolio_runner(dcop, graph, meta,
                                                     "cpu")
    legs = {}
    for name, cost in info["portfolio_costs"].items():
        if cost is None:
            continue
        t0 = time.perf_counter()
        cpu_cost = cpu[name]()
        if f32_bits(cpu_cost) != f32_bits(cost):
            fail(f"portfolio {label}: leg {name} costs {cost} on the card, "
                 f"{cpu_cost} on the CPU")
        legs[name] = dict(race_ms=info["portfolio_timings_ms"][name],
                          cost=cost, cpu_s=time.perf_counter() - t0)
    return legs


def phase_portfolio(ctx, card="cuda"):
    """``api.solve(flagship, "auto")`` on the card with a fresh cache
    file: the race of every leg (each leg's cost equal to the CPU run
    of the same leg, bit for bit), the DPOP gate's verdict, the winner's
    solve; a second solve replays the decision without building a leg;
    the domino chain resolves to DPOP at cost 1.0."""
    api, _build = ctx["api"], ctx["_build"]
    from pydcop_tpu_torch.engine import autotune

    t_phase = time.perf_counter()
    cache = os.path.join(HERE, "build", "chip_smoke_portfolio.json")
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    if os.path.exists(cache):
        os.remove(cache)
    os.environ["PYDCOP_AGG_AUTOTUNE_CACHE"] = cache
    dcop = ctx["dcop"]
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    first = api.solve(dcop, "auto", max_cycles=FIXED_CYCLES, device=card)
    first_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    info = first["metrics"]["portfolio"]
    raced = {n for n, c in info["portfolio_costs"].items() if c is not None}
    # The flagship is far past DPOP's race gate (its pseudo-tree's
    # separators reach ~2,000 variables): every leg but DPOP's races.
    want = set(autotune.PORTFOLIO_CANDIDATES) - {"dpop"}
    if info["portfolio_source"] != "measured" or raced != want:
        fail(f"portfolio: raced {sorted(raced)}, expected {sorted(want)}")
    if not np.isfinite(first["cost"]):
        fail(f"portfolio: non-finite cost {first['cost']}")
    legs = portfolio_legs_equal_cpu("flagship", dcop, info)

    built = [0]
    runners = autotune._portfolio_runners

    def counting(*args, **kwargs):
        built[0] += 1
        return runners(*args, **kwargs)

    autotune._portfolio_runners = counting
    try:
        _build.launch_counts.clear()
        t0 = time.perf_counter()
        second = api.solve(dcop, "auto", max_cycles=FIXED_CYCLES,
                           device=card)
        second_s = time.perf_counter() - t0
        replay_launches = dict(_build.launch_counts)
    finally:
        autotune._portfolio_runners = runners
    info2 = second["metrics"]["portfolio"]
    if (info2["portfolio_source"] != "cache" or built[0]
            or info2["algo"] != info["algo"]
            or second["assignment"] != first["assignment"]):
        fail(f"portfolio: the second solve did not replay ({info2}, "
             f"{built[0]} races)")

    domino = domino_chain(ctx["objects"], ctx["relations"], ctx["dcop_mod"])
    _build.launch_counts.clear()
    dres = api.solve(domino, "auto", device=card)
    domino_launches = dict(_build.launch_counts)
    dinfo = dres["metrics"]["portfolio"]
    if dinfo["algo"] != "dpop" or dres["cost"] != 1.0:
        fail(f"portfolio: the domino chain resolved to {dinfo['algo']} "
             f"at cost {dres['cost']}")
    domino_legs = portfolio_legs_equal_cpu("domino", domino, dinfo)
    os.remove(cache)
    return dict(
        winner=info["algo"], target_cost=info["portfolio_target_cost"],
        legs=legs, dpop_gate=dict(
            feasible="dpop" in raced, gate=autotune.DPOP_RACE_MAX_ELEMENTS),
        race_cycles=autotune.PORTFOLIO_RACE_CYCLES,
        solve=dict(cycles=first["cycles"], cost=first["cost"],
                   status=first["status"], total_s=first_s),
        launches=launches,
        replay=dict(source=info2["portfolio_source"], races=built[0],
                    total_s=second_s, launches=replay_launches),
        domino=dict(winner=dinfo["algo"], cost=dres["cost"],
                    legs=domino_legs, launches=domino_launches),
        seconds=time.perf_counter() - t_phase)


def dynamic_scenario(scenario_mod, dcop, seed: int = 5):
    """Events on the flagship: a cost-only change of 100 factors; 50
    factors removed and 50 added on new scopes (inside the slack); a
    delay; 400 factors added (beyond the slack: a recompile that
    carries the messages); a new variable with a factor on it."""
    E, A = scenario_mod.DcopEvent, scenario_mod.EventAction
    rng = np.random.default_rng(seed)
    names = list(dcop.constraints)
    var_names = list(dcop.variables)

    def table():
        return rng.integers(0, 4, (N_COLORS, N_COLORS)).astype(
            float).tolist()

    def pairs(k):
        out = set()
        while len(out) < k:
            i, j = rng.choice(len(var_names), 2, replace=False)
            out.add((var_names[min(i, j)], var_names[max(i, j)]))
        return sorted(out)

    changed = rng.choice(len(names), 100, replace=False)
    removed = rng.choice(len(names), 50, replace=False)
    return scenario_mod.Scenario([
        E("change", actions=[A("change_factor", name=names[k],
                               table=table()) for k in changed]),
        E("move", actions=[A("remove_factor", name=names[k])
                           for k in removed]
          + [A("add_factor", name=f"m{k}", variables=list(p),
               table=table()) for k, p in enumerate(pairs(50))]),
        E("settle", delay=1.0),
        E("grow", actions=[A("add_factor", name=f"g{k}", variables=list(p),
                             table=table())
                           for k, p in enumerate(pairs(400))]),
        E("new_variable", actions=[
            A("add_variable", name="w0", domain=list(range(N_COLORS))),
            A("add_factor", name="cw", variables=["w0", var_names[0]],
              table=table())]),
    ])


def engine_state(engine):
    """Host copies of a dynamic engine's state (copies also of a CPU
    engine's: its edits zero message rows in place)."""
    st = engine._state
    return {f: [t.cpu().numpy().copy() for t in getattr(st, f)]
            for f in ("v2f", "f2v", "v2f_count", "f2v_count")} | {
                "stable": bool(st.stable), "cycle": int(st.cycle)}


def state_difference(a, b, graph):
    """None when two ``engine_state`` snapshots are equal bit for bit,
    else where they first differ (field, bucket, the rows and whether
    they are slack rows of ``graph``, the host copy)."""
    for f in a:
        if not isinstance(a[f], list):
            if a[f] != b[f]:
                return f"{f}: {a[f]} vs {b[f]}"
            continue
        for bi, (x, y) in enumerate(zip(a[f], b[f])):
            if x.tobytes() == y.tobytes():
                continue
            bad = np.nonzero((x.view(np.uint8) != y.view(np.uint8)).reshape(
                x.shape[0], -1).any(axis=1))[0]
            ids = np.asarray(graph.buckets[bi].var_ids)[bad[:4]]
            return (f"{f}[{bi}]: {bad.size} rows differ, first {bad[:4]} "
                    f"(var ids {ids.tolist()}, slack id "
                    f"{graph.var_costs.shape[0] - 1}): "
                    f"{x[bad[0]].tolist()} vs {y[bad[0]].tolist()}")
    return None


def same_placed(a, b) -> bool:
    """Two TorchFactorGraphs equal field by field (tensors bit for bit,
    compared on the host)."""
    for x, y in zip(a, b):
        if isinstance(x, tuple) and x and hasattr(x[0], "_fields"):
            if len(x) != len(y) or not all(same_placed(p, q)
                                           for p, q in zip(x, y)):
                return False
        elif hasattr(x, "dtype") or hasattr(y, "dtype"):
            if (x is None) != (y is None):
                return False
            if x is not None and (x.dtype != y.dtype or not np.array_equal(
                    x.cpu().numpy(), y.cpu().numpy())):
                return False
        elif x != y:
            return False
    return True


def phase_dynamic(ctx, card="cuda"):
    """``replay_scenario`` on the flagship on the card and on the CPU:
    after every event the assignment, cycles, convergence, cost and
    every message tensor equal, and the card's patched graph equals
    ``to_device_graph`` of its host arrays; then a card checkpoint
    restored into a CPU engine runs on to the card's result."""
    _build, dcop = ctx["_build"], ctx["dcop"]
    from pydcop_tpu_torch.dcop import scenario as scenario_mod
    from pydcop_tpu_torch.device import to_device_graph
    from pydcop_tpu_torch.engine import dynamic

    t_phase = time.perf_counter()
    scenario = dynamic_scenario(scenario_mod, dcop)
    params = {"noise": 0.01, "slack": DYN_SLACK}

    def replay(device):
        engine = dynamic.build_dynamic_engine(dcop, params, device=device)
        run = engine.run
        results, per_event = [], []
        last = {"rows_s": 0.0, "scope_s": 0.0, "row_patches": 0,
                "scope_rebuilds": 0}

        def recording_run(*args, **kwargs):
            res = run(*args, **kwargs)
            results.append((res, engine_state(engine), engine.graph))
            return res

        def on_event(rec):
            stats = dict(engine.edit_stats)
            entry = dict(
                id=rec["id"],
                rec={k: v for k, v in rec.items() if k != "wall_s"},
                patch_ms=(stats["rows_s"] - last["rows_s"]) * 1e3,
                scope_ms=(stats["scope_s"] - last["scope_s"]) * 1e3,
                patches=stats["row_patches"] - last["row_patches"],
                scope_rebuilds=(stats["scope_rebuilds"]
                                - last["scope_rebuilds"]),
                run_ms_per_cycle=(engine.last_run_s * 1e3
                                  / max(engine.last_run_cycles, 1)),
                cycles_run=engine.last_run_cycles,
                placed_equal=same_placed(
                    engine.placed, to_device_graph(engine.graph, device)))
            last.update(stats)
            per_event.append(entry)

        engine.run = recording_run
        t0 = time.perf_counter()
        out = dynamic.replay_scenario(
            dcop, scenario, params=params, max_cycles=DYN_CYCLES,
            event_cycles=DYN_EVENT_CYCLES, decimation_margin=DYN_MARGIN,
            on_event=on_event, device=device, engine=engine)
        engine.run = run
        return engine, out, per_event, results, time.perf_counter() - t0

    _build.launch_counts.clear()
    card_engine, card_out, card_events, card_runs, card_s = replay(card)
    launches = dict(_build.launch_counts)
    for kernel in ("binary_factor_update", "segment_sum", "var_update"):
        if card != "cpu" and not launches.get(kernel):
            fail(f"dynamic: {kernel} never launched ({launches})")
    cpu_engine, cpu_out, cpu_events, cpu_runs, cpu_s = replay("cpu")
    if len(card_events) != len(cpu_events) or len(card_runs) != len(
            cpu_runs):
        fail("dynamic: the replays saw different events")
    for a, b in zip(card_events, cpu_events):
        if not a["placed_equal"]:
            fail(f"dynamic: after {a['id']} the card's patched graph != "
                 "to_device_graph of its host arrays")
        if a["rec"] != b["rec"]:
            fail(f"dynamic: after {a['id']} the card's record != the CPU's")
    # Every run (the initial solve, each event's and the delay's): the
    # same assignment, cycles, convergence and state, bit for bit.
    for k, ((ra, sa, ga), (rb, sb, _)) in enumerate(zip(card_runs,
                                                        cpu_runs)):
        diff = state_difference(sa, sb, ga)
        if (diff or ra.assignment != rb.assignment or ra.cycles != rb.cycles
                or ra.converged != rb.converged):
            fail(f"dynamic: run {k} (cycle {ra.cycles}) card != CPU: "
                 f"{diff or 'assignment/cycles/converged'}")
    if any(card_out[k] != cpu_out[k] for k in card_out if k != "events"):
        fail("dynamic: the final results differ")
    if card_out["recompiles"] < 2 or not any(
            e["scope_rebuilds"] for e in card_events):
        fail(f"dynamic: {card_out['recompiles']} recompiles")

    # Checkpoint on the card, restore into a CPU engine built from the
    # final factor set (its rows laid out anew), run on: equal.
    import tempfile

    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_dyn_"),
                        "state.npz")
    card_engine.checkpoint(path)
    fresh = dynamic.DynamicMaxSumEngine(
        card_engine.variables, list(card_engine.factors.values()),
        mode=dcop.objective, noise_level=0.01, slack=DYN_SLACK,
        device="cpu")
    fresh.clamp_variables(dict(card_engine.clamps))
    fresh.restore(path)
    os.remove(path)
    os.rmdir(os.path.dirname(path))
    r_card = card_engine.run(DYN_AFTER_RESTORE, stop_on_convergence=False)
    r_cpu = fresh.run(DYN_AFTER_RESTORE, stop_on_convergence=False)
    by_name = {}
    for eng in (card_engine, fresh):
        by_name[id(eng)] = {
            n: eng._state.f2v[bi][row].cpu().numpy().tobytes()
            for n, (bi, row) in eng.slots.items()}
    if (r_card.assignment != r_cpu.assignment
            or r_card.cycles != r_cpu.cycles
            or r_card.converged != r_cpu.converged
            or by_name[id(card_engine)] != by_name[id(fresh)]):
        fail("dynamic: the CPU engine restored from the card's checkpoint "
             "ran to another result")
    events = [{k: e[k] for k in (
        "id", "patch_ms", "scope_ms", "patches", "scope_rebuilds",
        "run_ms_per_cycle", "cycles_run")} | {
            "recompiles": e["rec"]["recompiles"], "cost": e["rec"]["cost"],
            "converged": e["rec"].get("converged")}
        for e in card_events]
    return dict(n_vars=len(card_engine.variables),
                n_factors=len(card_engine.factors),
                events=events, cost=card_out["cost"],
                cycles=card_out["cycles"], converged=card_out["converged"],
                recompiles=card_out["recompiles"],
                clamped=len(card_out["clamped"]), launches=launches,
                card_replay_s=card_s, cpu_replay_s=cpu_s,
                restored_on_cpu=dict(cycles=r_cpu.cycles,
                                     assignment_equal=True),
                seconds=time.perf_counter() - t_phase)


# The batch and lane slice.
LANE_CHECK_D = [1, 2, 3, 4, 5, 6, 7, 8, 9, 33]
LANE_CHECK_F = [1, 257, 1_000, 15_001]
# Domains of the lane_sum and lane_var_update checks.
LANE_SUM_D = [1, 2, 3, 4, 5, 6, 7, 8, 11, 33]
LANE_SCALE_COMPARE = 3       # card = CPU cycles at scale, lane layout
                             # (5 until the generators slice)
LANE_TRACE_CYCLES = 30
# Stacked instances of build_dcop_small (64 until the lane kernels
# slice, 32 until the elastic fleet's: cut to keep the script's time;
# the compiles and solo solves are most of the phase).
BATCH_MEMBERS = 16
BATCH_VARS = 10_000
BATCH_CPU_CYCLES = 20        # the stack's card = CPU comparison
MIXED_STRUCTS = 24           # build_dcop_mixed structures
MIXED_CYCLES = 60


def build_dcop_small(objects, relations, dcop_mod, n_vars: int, seed: int):
    """bench.py build_dcop_small: ring + chord 3-colouring with random
    integer tables (the same topology per n_vars, tables per seed)."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("colors", "color", list(range(N_COLORS)))
    dcop = dcop_mod.DCOP(f"serve_{n_vars}_{seed}", objective="min")
    vs = [objects.Variable(f"v{i}", dom) for i in range(n_vars)]
    for v in vs:
        dcop.add_variable(v)
    edges = [(i, (i + 1) % n_vars) for i in range(n_vars)]
    edges += [(i, (i + n_vars // 2) % n_vars) for i in range(0, n_vars, 3)]
    for k, (i, j) in enumerate(edges):
        table = rng.integers(0, 10, size=(N_COLORS, N_COLORS))
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[i], vs[j]], table.astype(float), f"c{k}"))
    dcop.add_agents([objects.AgentDef("a0")])
    return dcop


def build_dcop_mixed(objects, relations, dcop_mod, struct_idx: int,
                     seed: int):
    """bench.py build_dcop_mixed: one of 24 structurally distinct small
    colorings (ring of 14 + 3 * struct_idx, struct_idx % 4 chords)."""
    rng = np.random.default_rng(seed)
    n_vars = 14 + 3 * struct_idx
    dom = objects.Domain("colors", "color", list(range(N_COLORS)))
    dcop = dcop_mod.DCOP(f"mix{struct_idx}_{seed}", objective="min")
    vs = [objects.Variable(f"v{i}", dom) for i in range(n_vars)]
    for v in vs:
        dcop.add_variable(v)
    edges = [(i, (i + 1) % n_vars) for i in range(n_vars)]
    edges += [(i, (i + n_vars // 2) % n_vars)
              for i in range(struct_idx % 4)]
    seen = set()
    for k, (i, j) in enumerate(edges):
        if i == j or (min(i, j), max(i, j)) in seen:
            continue
        seen.add((min(i, j), max(i, j)))
        table = rng.integers(0, 10, size=(N_COLORS, N_COLORS))
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[i], vs[j]], table.astype(float), f"c{k}"))
    dcop.add_agents([objects.AgentDef("a0")])
    return dcop


def lane_bucket_inputs(torch, d: int, f: int, seed: int, unaligned: bool):
    """Lane-major costs [D, D, F] and messages [D, 2, F] on the card,
    over six decades with BIG on every 7th factor's last slot; with
    ``unaligned`` each a view one float into a larger buffer."""
    rng = np.random.default_rng(seed)
    costs = (rng.normal(size=(d, d, f))
             * 10.0 ** rng.integers(-3, 4, size=(d, d, f))).astype(
                 np.float32)
    msgs = (rng.normal(size=(d, 2, f))
            * 10.0 ** rng.integers(-3, 4, size=(d, 2, f))).astype(
                np.float32)
    costs[d - 1, :, ::7] = BIG
    msgs[d - 1, :, ::7] = BIG
    out = [torch.tensor(costs, device="cuda"),
           torch.tensor(msgs, device="cuda")]
    return [unaligned_copy(torch, t) for t in out] if unaligned else out


def lane_graph_of(ctx, compiled, device):
    """The placed lane graph of a host CompiledFactorGraph."""
    from pydcop_tpu_torch.device import to_lane_device_graph
    from pydcop_tpu_torch.ops import maxsum_lane

    return to_lane_device_graph(maxsum_lane.to_lane_graph(compiled), device)


def lane_state_numpy(state):
    return {f: tuple(t.cpu().numpy() for t in getattr(state, f))
            for f in ("v2f", "f2v", "v2f_count", "f2v_count")} | {
        "stable": bool(state.stable), "cycle": int(state.cycle)}


def lane_run(lane_ops, graph, cycles: int):
    state, values = lane_ops.run_maxsum(graph, cycles,
                                        stop_on_convergence=False)
    return lane_state_numpy(state), values.cpu().numpy()


def ms_per_cycle(torch, run, cycles: int) -> float:
    """Milliseconds a cycle of ``run(cycles)`` (a fixed-cycle run),
    between CUDA events after a warm run."""
    run(cycles)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(cycles)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / cycles


def phase_lane_kernel_check(ctx, flagship_lane, scale_lane):
    """The lane entry of binary_factor_update.cu, lane_sum.cu and both
    entries of lane_var_update.cu against their plain versions bit for
    bit (the binary entry at every D = 1..8, two generic D, ragged F,
    views off a 16-byte boundary; the belief sum, its from-costs mode
    included, on the flagship's and the scale's lane graphs, on graphs
    of one-edge buckets and at D = 1..8, 11 and 33 with a hub above
    HEAVY_DEGREE, subnormal messages and unaligned views; the variable
    side at the same D, damping 0, 0.5 and 0.7, cycle 0 and 3, a
    subnormal state and unaligned views), each timed at the flagship and
    scale shapes beside its bound (lane_sum also beside zeros +
    index_add_)."""
    torch = ctx["torch"]
    from pydcop_tpu_torch.ops.binary_factor import (
        binary_factor_update_lane,
        binary_factor_update_lane_reference,
    )
    from pydcop_tpu_torch.ops.lane_sum import (
        lane_beliefs,
        lane_beliefs_reference,
        heavy_variables,
        lane_order,
        lane_sum_reference,
        lane_sum_table,
        padded_table,
    )

    err_a = 0.0
    checked = 0
    for d in LANE_CHECK_D:
        for f in LANE_CHECK_F:
            if d > 9 and f > 1_000:
                continue
            for unaligned in (False, True):
                costs, msgs = lane_bucket_inputs(torch, d, f, d * 7 + f,
                                                 unaligned)
                out = binary_factor_update_lane(costs, msgs)
                ref = binary_factor_update_lane_reference(costs.cpu(),
                                                          msgs.cpu())
                err_a = max(err_a, float((out.cpu() - ref).abs().max()))
                if not torch.equal(out.cpu(), ref):
                    fail(f"binary lane entry != plain at D={d} F={f} "
                         f"unaligned={unaligned}")
                checked += 1
    timing = {"binary_factor_update: lane": {}, "lane_sum": {},
              "lane_var_update: v2f": {}, "lane_var_update: send": {}}
    for label, f in (("flagship", flagship_lane.buckets[0].costs.shape[-1]),
                     ("scale", scale_lane.buckets[0].costs.shape[-1])):
        costs, msgs = lane_bucket_inputs(torch, N_COLORS, f, 300, False)
        reps = 200 if label == "flagship" else 50
        k_ms = graph_ms(torch, lambda: binary_factor_update_lane(costs, msgs),
                        reps)
        p_ms = graph_ms(torch, lambda: binary_factor_update_lane_reference(
            costs, msgs), reps)
        bound_ms, bound_by = binary_bound(f, N_COLORS)
        timing["binary_factor_update: lane"][label] = dict(
            F=f, D=N_COLORS, ms=k_ms[2], plain_ms=p_ms[2],
            ms_spread=[k_ms[0], k_ms[-1]], bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None)
        del costs, msgs

    # lane_sum: the flagship and scale lane graphs, one-edge buckets and
    # random graphs with a hub at every D of LANE_SUM_D.
    rng = np.random.default_rng(5)
    err_b = 0.0
    sums_checked = {}
    graphs = [("flagship", flagship_lane, 3, False),
              ("scale", scale_lane, 3, False)]
    for layout in ONE_EDGE_LAYOUTS:
        ids = [rng.integers(0, 301, size=(a, f)) for a, f in layout]
        graphs.append((f"one_edge_{layout}", ids, 3, False))
    for d in LANE_SUM_D:
        ids = [rng.integers(0, 301, size=(a, f))
               for a, f in ((1, 3), (2, 900), (3, 40))]
        ids[1][0, :450] = 7             # a hub: a warp of its own
        for unaligned in (False, True):
            graphs.append((f"hub_D{d}" + ("_unaligned" if unaligned else ""),
                           ids, d, unaligned))
    for label, graph, d, unaligned in graphs:
        if isinstance(graph, list):
            ids = graph
            host = lane_order(ids, 301)
            perm, offsets, starts = (torch.tensor(x, device="cuda")
                                     for x in host)
            heavy = torch.tensor(heavy_variables(host[1]), device="cuda")
            var_costs = torch.tensor(rng.normal(size=(d, 301)).astype(
                np.float32), device="cuda")
            shapes = [(d,) + x.shape for x in ids]
        else:
            perm, offsets, starts = (graph.agg_perm, graph.agg_offsets,
                                     graph.agg_buckets)
            heavy = graph.agg_heavy
            var_costs = graph.var_costs
            d = var_costs.shape[0]
            shapes = [(d,) + tuple(b.var_ids.shape) for b in graph.buckets]
        host_msgs = [(rng.normal(size=sh) * 10.0 ** rng.integers(
            -3, 4, size=sh)).astype(np.float32) for sh in shapes]
        if label.startswith("hub_D") and unaligned:
            host_msgs = [tiny_messages(rng, sh, np.ones(sh, bool))
                         for sh in shapes]
        msgs = [torch.tensor(m, device="cuda") for m in host_msgs]
        if unaligned:
            msgs = [unaligned_copy(torch, m) for m in msgs]
        args = (perm, offsets, starts, var_costs)
        table = lane_sum_table(msgs, *args, heavy)
        own = lane_beliefs(msgs, *args, heavy)
        cpu_args = [m.cpu() for m in msgs] + [t.cpu() for t in args]
        ref_b, ref_s = lane_sum_reference(cpu_args[:len(msgs)],
                                          *cpu_args[len(msgs):])
        ref_t = padded_table(ref_b, ref_s)
        ref_o = lane_beliefs_reference(cpu_args[:len(msgs)],
                                       *cpu_args[len(msgs):])
        err_b = max(err_b, float((table.cpu() - ref_t).abs().max()),
                    float((own.cpu() - ref_o).abs().max()))
        if not (torch.equal(table.cpu(), ref_t)
                and torch.equal(own.cpu(), ref_o)):
            fail(f"lane_sum kernel != plain on {label}")
        sums_checked[label] = dict(E=int(perm.shape[0]),
                                   V1=int(var_costs.shape[1]), D=d,
                                   buckets=len(shapes),
                                   heavy=int(heavy.shape[0]))
        if label in ("flagship", "scale"):
            seg = torch.cat([b.var_ids.reshape(-1) for b in graph.buckets])
            reps = 200 if label == "flagship" else 50

            def kernel():
                return lane_sum_table(msgs, *args, heavy)

            def library():
                flat = torch.cat([m.reshape(d, -1) for m in msgs], dim=1)
                out = torch.zeros_like(var_costs)
                out.index_add_(1, seg, flat)
                return var_costs + out

            def plain():
                return lane_sum_reference(msgs, *args)

            k_ms, l_ms = (graph_ms(torch, fn, reps)
                          for fn in (kernel, library))
            p_ms = eager_ms(torch, plain, 2)
            # The same bytes and adds as the edge layout's belief sum.
            bound_ms, bound_by = segment_bound(int(perm.shape[0]),
                                               int(var_costs.shape[1]), d)
            timing["lane_sum"][label] = dict(
                E=int(perm.shape[0]), V1=int(var_costs.shape[1]), D=d,
                ms=k_ms[2], plain_ms=p_ms[2], library_ms=l_ms[2],
                ms_spread=[k_ms[0], k_ms[-1]],
                library_ms_spread=[l_ms[0], l_ms[-1]],
                bound_ms=bound_ms, bound_by=bound_by)
            timed_bucket = timing_var_entries(
                ctx, graph, msgs, table, label, timing)
            sums_checked[label]["var_entries_timed"] = timed_bucket
        del msgs, table, own
    var_cases, err_c = check_lane_var_entries(torch)
    return dict(binary_lane_cases=checked, lane_sum_graphs=sums_checked,
                lane_var_cases=var_cases,
                tolerance="exact (torch.equal)",
                max_abs_err={"binary_factor_update: lane": err_a,
                             "lane_sum": err_b,
                             "lane_var_update: v2f": err_c,
                             "lane_var_update: send": err_c},
                timing=timing)



def lane_var_inputs(torch, graph, bucket, seed: int, unaligned: bool,
                    tiny: bool):
    """A bucket's f2v, prev [D, a, F] and counts [a, F] on the card, BIG
    on invalid slots, half the edges' prev within 5e-4 of their f2v (so
    the send entry's approx-match fires); ``tiny``: half the messages
    subnormal-scale; ``unaligned``: views one float off."""
    rng = np.random.default_rng(seed)
    d = graph.var_costs.shape[0]
    shape = (d,) + tuple(bucket.var_ids.shape)
    valid = graph.var_valid[:, bucket.var_ids].cpu().numpy()
    f2v = (rng.normal(size=shape) * 10.0 ** rng.integers(
        -3, 4, size=shape)).astype(np.float32)
    prev = (rng.normal(size=shape)).astype(np.float32)
    close = rng.random(shape[1:]) < 0.5
    prev = np.where(close[None], f2v * np.float32(1.0005), prev)
    if tiny:
        f2v = np.where(rng.random(shape) < 0.5,
                       tiny_messages(rng, shape, valid), f2v)
        prev = np.where(rng.random(shape) < 0.5,
                        tiny_messages(rng, shape, valid), prev)
    f2v = np.where(valid, f2v, BIG).astype(np.float32)
    prev = np.where(valid, prev, BIG).astype(np.float32)
    count = rng.integers(0, 6, size=shape[1:]).astype(np.int8)
    out = [torch.tensor(x, device="cuda") for x in (f2v, prev, count)]
    if unaligned:
        out[:2] = [unaligned_copy(torch, t) for t in out[:2]]
    return out


def lane_var_calls(torch, graph, bucket, table, f2v, prev, count, cycle,
                   damping):
    """Both entries on the card and their plain versions on the CPU:
    ((card v2f, card send), (plain v2f, plain send)), each (messages,
    counts, stable)."""
    from pydcop_tpu_torch.ops.lane_var_update import (
        lane_send_update,
        lane_send_update_reference,
        lane_v2f_update,
        lane_v2f_update_reference,
    )

    cyc = torch.tensor(cycle, dtype=torch.int32)
    host = [t.cpu() for t in (table, f2v, prev, count, bucket.var_ids,
                              graph.var_valid)]
    out = []
    for entries, dev in (((lane_v2f_update, lane_send_update), "cuda"),
                         ((lane_v2f_update_reference,
                           lane_send_update_reference), "cpu")):
        t = (table, f2v, prev, count, bucket.var_ids, graph.var_valid) \
            if dev == "cuda" else host
        extra = dict(var_ids32=bucket.var_ids32,
                     edge_valid=bucket.edge_valid) if dev == "cuda" else {}
        res = []
        for which, entry in zip(("v2f", "send"), entries):
            stable = torch.tensor(cycle != 0, device=dev)
            lead = t[:2] if which == "v2f" else t[1:2]
            sent, cnt = entry(*lead, *t[2:], cyc.to(dev), stable,
                              damping=damping, stability=0.1, **extra)
            res.append((sent.cpu(), cnt.cpu(), bool(stable)))
        out.append(res)
    return out


def check_lane_var_entries(torch):
    """Both lane_var_update.cu entries against their plain versions at
    every D of LANE_SUM_D on a lane graph of three buckets with padding
    factors on the sentinel, damping 0 / 0.5 / 0.7, cycle 0 and 3, a
    subnormal state, aligned and unaligned views."""
    from pydcop_tpu_torch.device import to_lane_device_graph
    from pydcop_tpu_torch.engine.compile import (
        CompiledFactorGraph,
        FactorBucket,
    )
    from pydcop_tpu_torch.ops import maxsum_lane
    from pydcop_tpu_torch.ops.lane_sum import lane_sum_table

    cases, err = 0, 0.0
    for d in LANE_SUM_D:
        rng = np.random.default_rng(d)
        n_vars = 301
        var_valid = rng.random((n_vars + 1, d)) < 0.8
        var_valid[:, 0] = True
        var_valid[-1] = False
        buckets = []
        for a, f in ((1, 5), (2, 700), (3, 33)):
            ids = rng.integers(0, n_vars, size=(f, a)).astype(np.int32)
            ids[-2:] = n_vars                 # padding on the sentinel
            buckets.append(FactorBucket(
                rng.normal(size=(f,) + (d,) * a).astype(np.float32), ids))
        host = CompiledFactorGraph(
            rng.normal(size=(n_vars + 1, d)).astype(np.float32), var_valid,
            tuple(buckets))
        graph = to_lane_device_graph(maxsum_lane.to_lane_graph(host), "cuda")
        for i, bucket in enumerate(graph.buckets):
            for damping in (0.0, 0.5, 0.7):
                for cycle, tiny, unaligned in ((0, False, False),
                                               (3, False, True),
                                               (3, True, False)):
                    seed = d * 1000 + i * 100 + int(damping * 10) + cycle
                    f2v, prev, count = lane_var_inputs(
                        torch, graph, bucket, seed, unaligned, tiny)
                    msgs = [lane_var_inputs(torch, graph, b, seed + 7, False,
                                            tiny)[0] for b in graph.buckets]
                    table = lane_sum_table(
                        msgs, graph.agg_perm, graph.agg_offsets,
                        graph.agg_buckets, graph.var_costs, graph.agg_heavy)
                    card, plain = lane_var_calls(
                        torch, graph, bucket, table, f2v, prev, count,
                        cycle, damping)
                    for which, c, p in zip(("v2f", "send"), card, plain):
                        err = max(err, float((c[0] - p[0]).abs().max()))
                        if not (torch.equal(c[0], p[0])
                                and torch.equal(c[1], p[1]) and c[2] == p[2]):
                            fail(f"lane_var_update {which} != plain at D={d}"
                                 f" bucket {i} damping={damping} "
                                 f"cycle={cycle} tiny={tiny} "
                                 f"unaligned={unaligned}")
                    cases += 2
    return cases, err


def timing_var_entries(ctx, graph, msgs, table, label, timing):
    """Both lane_var_update.cu entries on the first bucket of a lane
    graph (the flagship's or the scale's), timed beside their plain
    versions and bounds; they are also held to the plain versions
    there.  Returns the bucket's (F, a)."""
    torch = ctx["torch"]
    from pydcop_tpu_torch.ops.lane_var_update import (
        lane_send_update,
        lane_send_update_reference,
        lane_v2f_update,
        lane_v2f_update_reference,
    )

    bucket = graph.buckets[0]
    d = graph.var_costs.shape[0]
    f2v, prev, count = lane_var_inputs(torch, graph, bucket, 41, False,
                                       False)
    card, plain = lane_var_calls(torch, graph, bucket, table, f2v, prev,
                                 count, 3, 0.5)
    for which, c, p in zip(("v2f", "send"), card, plain):
        if not (torch.equal(c[0], p[0]) and torch.equal(c[1], p[1])
                and c[2] == p[2]):
            fail(f"lane_var_update {which} != plain on {label}")
    cyc = torch.tensor(3, dtype=torch.int32, device="cuda")
    stable = torch.ones((), dtype=torch.bool, device="cuda")
    common = (prev, count, bucket.var_ids, graph.var_valid, cyc, stable)
    extra = dict(var_ids32=bucket.var_ids32, edge_valid=bucket.edge_valid)
    reps = 200 if label == "flagship" else 50
    n_edges = int(bucket.var_ids.numel())
    n_rows = int(graph.var_costs.shape[1])
    for which, kernel, ref, lead in (
            ("v2f", lane_v2f_update, lane_v2f_update_reference, (table, f2v)),
            ("send", lane_send_update, lane_send_update_reference, (f2v,))):
        k_ms = graph_ms(torch, lambda: kernel(
            *lead, *common, damping=0.5, stability=0.1, **extra), reps)
        p_ms = eager_ms(torch, lambda: ref(
            *lead, *common, damping=0.5, stability=0.1), 3)
        bound_ms, bound_by = var_update_bound(n_edges, n_rows, d,
                                              which == "v2f")
        timing[f"lane_var_update: {which}"][label] = dict(
            E=n_edges, V1=n_rows, D=d, ms=k_ms[2], plain_ms=p_ms[2],
            ms_spread=[k_ms[0], k_ms[-1]], bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None)
    return list(bucket.var_ids.shape)


def phase_lane_layout(ctx, engine, scale_host, scale_lane, scale_edge):
    """MaxSum with layout="lane": api.solve on the flagship (launch
    counts zeroed just before), the card = CPU = second card run over
    200 fixed cycles (every message), the cost trace card = CPU, the
    1M-variable scale arrays card = CPU over 5 cycles, and ms a cycle
    lane against edge at both sizes in this call."""
    torch, api, _build = ctx["torch"], ctx["api"], ctx["_build"]
    from pydcop_tpu_torch.ops import maxsum_lane as lane_ops
    from pydcop_tpu_torch.ops.binary_factor import LANE
    from pydcop_tpu_torch.ops.lane_sum import KERNEL as LANE_SUM
    from pydcop_tpu_torch.ops.lane_var_update import SEND, V2F

    dcop = ctx["dcop"]
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    res = api.solve(dcop, "maxsum", max_cycles=FIXED_CYCLES,
                    algo_params={"layout": "lane"})
    launches = dict(_build.launch_counts)
    n_buckets = len(engine.graph.buckets)
    # Each cycle: the binary bucket's factor side, one belief table, and
    # both variable-side entries for each bucket; then the final
    # selection's beliefs (lane_sum from the costs).
    want = {LANE: res["cycles"], LANE_SUM: res["cycles"] + 1,
            V2F: n_buckets * res["cycles"], SEND: n_buckets * res["cycles"]}
    if launches != want:
        fail(f"lane solve launched {launches}, expected {want}")
    if not np.isfinite(res["cost"]):
        fail(f"lane solve: non-finite cost {res['cost']}")
    cpu_engine = ctx["build_engine"](dcop, dict(ctx["params"],
                                                layout="lane"),
                                     device="cpu")
    card = [lane_run(lane_ops, engine.graph, FIXED_CYCLES)
            for _ in range(2)]
    t0 = time.perf_counter()
    cpu = lane_run(lane_ops, cpu_engine.graph, FIXED_CYCLES)
    cpu_s = time.perf_counter() - t0
    for name, other in (("second card run", card[1]), ("CPU run", cpu)):
        diff = run_differences(card[0], other)
        if diff:
            fail(f"lane flagship: card run != {name} in {diff}")
    del card, cpu
    edge_flagship = ctx["engine"].graph
    flagship_ms = {
        "lane": ms_per_cycle(torch, lambda n: lane_ops.run_maxsum(
            engine.graph, n, stop_on_convergence=False), 50),
        "edge": ms_per_cycle(torch, lambda n: ctx["ops"].run_maxsum(
            edge_flagship, n, stop_on_convergence=False), 50)}
    tr_card = engine.run_trace(LANE_TRACE_CYCLES)
    tr_cpu = cpu_engine.run_trace(LANE_TRACE_CYCLES)
    if not np.array_equal(
            np.asarray(tr_card.metrics["cost_trace"], np.float64),
            np.asarray(tr_cpu.metrics["cost_trace"], np.float64)):
        fail("lane run_trace: card costs != CPU costs")

    # Scale: bench.py bench_scale's arrays in the lane layout.
    scale_cpu = lane_graph_of(ctx, scale_host, "cpu")
    first = lane_run(lane_ops, scale_lane, LANE_SCALE_COMPARE)
    t0 = time.perf_counter()
    on_cpu = lane_run(lane_ops, scale_cpu, LANE_SCALE_COMPARE)
    scale_cpu_s = time.perf_counter() - t0
    diff = run_differences(first, on_cpu)
    if diff:
        fail(f"lane scale: card != CPU after {LANE_SCALE_COMPARE} cycles "
             f"in {diff}")
    del scale_cpu, on_cpu, first
    scale_ms = {
        "lane": ms_per_cycle(torch, lambda n: lane_ops.run_maxsum(
            scale_lane, n, stop_on_convergence=False), SCALE_CYCLES),
        "edge": ms_per_cycle(torch, lambda n: ctx["ops"].run_maxsum(
            scale_edge, n, stop_on_convergence=False), SCALE_CYCLES)}

    # The profiles, in a fresh process: a profiler session late in this
    # long one dropped device events.  The child checks each profile's
    # hand-kernel launches against the launch counters.
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--lane-profiles"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"lane profiles (exit {proc.returncode}): "
             f"{proc.stderr[-2000:]}")
    profiles = json.loads(proc.stdout.strip().splitlines()[-1])
    lane_kpc = profiles["flagship_lane"]["device_kernels_per_cycle"]
    scale_dev = profiles["scale_lane"]["device_ms_per_cycle"]
    targets = {
        "flagship_lane_kernels_per_cycle": [lane_kpc, "<= 10"],
        "scale_lane_device_ms_per_cycle": [scale_dev, "<= 0.6"],
        "scale_lane_over_edge_ms_per_cycle": [
            scale_ms["lane"] / scale_ms["edge"], "<= 1.5"],
        "flagship_lane_over_edge_ms_per_cycle": [
            flagship_ms["lane"] / flagship_ms["edge"], None]}

    return dict(
        solve=dict(status=res["status"], cycles=res["cycles"],
                   cost=res["cost"], time_s=res["time"]),
        launches=launches,
        flagship_bit_equal=["card run 1", "card run 2", "CPU run"],
        flagship_cycles=FIXED_CYCLES, flagship_cpu_s=cpu_s,
        trace_card_equal_cpu_cycles=LANE_TRACE_CYCLES,
        scale_bit_equal_cycles=LANE_SCALE_COMPARE, scale_cpu_s=scale_cpu_s,
        ms_per_cycle={"flagship": flagship_ms, "scale": scale_ms},
        profiles=profiles, targets=targets)


# Device launches of one counted call, where a wrapper's call is more
# than one launch: lane_sum's row stage and walk.
DEVICE_LAUNCHES = {"lane_sum": 2}


def lane_profiles() -> int:
    """``--lane-profiles``: the lane_layout phase's profiles, run by it
    in a fresh process (a profiler session late in the long one dropped
    device events).  torch.profiler over 20 fixed cycles of the flagship
    and 5 of the 1M-variable scale arrays, lane and edge layouts, each
    profile's launches of the port's kernels held equal to the launch
    counters of the same run (a profile that missed one fails).  Prints
    the four profiles as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from pydcop_tpu_torch.algorithms import AlgorithmDef
    from pydcop_tpu_torch.algorithms.maxsum import build_engine
    from pydcop_tpu_torch.dcop import dcop as dcop_mod
    from pydcop_tpu_torch.dcop import objects, relations
    from pydcop_tpu_torch.engine.compile import (
        CompiledFactorGraph,
        FactorBucket,
    )
    from pydcop_tpu_torch.engine.convert import graph_from_numpy
    from pydcop_tpu_torch.ops import _build
    from pydcop_tpu_torch.ops import maxsum as ops
    from pydcop_tpu_torch.ops import maxsum_lane as lane_ops

    _build.build(_build.kernel_names())   # built by the parent already
    dcop = build_flagship(objects, relations, dcop_mod, FLAGSHIP_VARS)
    params = AlgorithmDef.build_with_default_param("maxsum").params
    var_costs, var_valid, buckets = scale_arrays(SCALE_VARS)
    scale_lane = lane_graph_of(None, CompiledFactorGraph(
        var_costs, var_valid, tuple(FactorBucket(c, ids)
                                    for c, ids in buckets)), "cuda")
    graphs = {
        "flagship_lane": (lane_ops, build_engine(
            dcop, dict(params, layout="lane")).graph, 20),
        "flagship_edge": (ops, build_engine(dcop, params).graph, 20),
        "scale_lane": (lane_ops, scale_lane, 5),
        "scale_edge": (ops, graph_from_numpy(
            var_costs, var_valid, buckets, "cuda"), 5)}
    del var_costs, var_valid, buckets
    profiles = {}
    for label, (mod, graph, cycles) in graphs.items():
        def run(n, mod=mod, graph=graph):
            mod.run_maxsum(graph, n, stop_on_convergence=False)
            torch.cuda.synchronize()

        prof = profile_cycles(torch, run, cycles, _build.launch_counts)
        want = sum(n * DEVICE_LAUNCHES.get(k, 1)
                   for k, n in prof["launches"].items())
        if prof["own_kernel_launches"] != want:
            fail(f"{label} profile saw {prof['own_kernel_launches']} "
                 f"launches of the port's kernels, the counters "
                 f"{prof['launches']} make {want}")
        profiles[label] = prof
    print(json.dumps(profiles), flush=True)
    return 0


def shard_profile() -> int:
    """``--shard-profile``: the sharded phase's profile, run by it in a
    fresh process.  torch.profiler over SHARD_PROFILE_CYCLES fixed
    cycles of the flagship through ShardedMaxSumEngine on a mesh naming
    the card SHARD_MAIN times; the profile's launches of the port's
    kernels held equal to the launch counters of the same run (a profile
    that missed one fails).  Prints the profile as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from pydcop_tpu_torch.algorithms import AlgorithmDef
    from pydcop_tpu_torch.dcop import dcop as dcop_mod
    from pydcop_tpu_torch.dcop import objects, relations
    from pydcop_tpu_torch.engine.compile import compile_dcop
    from pydcop_tpu_torch.engine.runner import ShardedMaxSumEngine
    from pydcop_tpu_torch.engine.sharding import make_mesh
    from pydcop_tpu_torch.ops import _build

    _build.build(_build.kernel_names())   # built by the parent already
    dcop = build_flagship(objects, relations, dcop_mod, FLAGSHIP_VARS)
    params = AlgorithmDef.build_with_default_param("maxsum").params
    graph, meta = compile_dcop(dcop, noise_level=params.get("noise", 0.01))
    eng = ShardedMaxSumEngine(
        graph, meta, mesh=make_mesh(devices=["cuda"] * SHARD_MAIN),
        device="cuda", damping=params.get("damping", 0.5),
        damping_nodes=params.get("damping_nodes", "both"),
        stability=params.get("stability", 0.1))

    def run(n):
        eng.run(n, stop_on_convergence=False)
        torch.cuda.synchronize()

    prof = profile_cycles(torch, run, SHARD_PROFILE_CYCLES,
                          _build.launch_counts)
    want = sum(n * DEVICE_LAUNCHES.get(k, 1)
               for k, n in prof["launches"].items())
    if prof["own_kernel_launches"] != want:
        fail(f"shard profile saw {prof['own_kernel_launches']} launches "
             f"of the port's kernels, the counters {prof['launches']} "
             f"make {want}")
    print(json.dumps(prof), flush=True)
    return 0


def phase_batch_stacked(ctx):
    """solve_maxsum_batch over BATCH_MEMBERS instances of
    build_dcop_small(10_000, seed), seeds from 0, 200 cycles, as ONE
    disjoint union: each member equal to its solo card solve (values,
    cycles, converged), the
    stack's messages equal to the CPU stack's after 20 cycles,
    binary_factor_update launched once a cycle for the whole stack, the
    stack timed against the solo solves, and launch_stacked /
    collect_stacked under the sync-debug check equal to run_stacked."""
    torch, _build = ctx["torch"], ctx["_build"]
    from pydcop_tpu_torch.device import to_device_graph
    from pydcop_tpu_torch.engine import batch
    from pydcop_tpu_torch.engine.compile import compile_dcop

    t0 = time.perf_counter()
    dcops = [build_dcop_small(ctx["objects"], ctx["relations"],
                              ctx["dcop_mod"], BATCH_VARS, seed)
             for seed in range(BATCH_MEMBERS)]
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    results = batch.solve_maxsum_batch(dcops, max_cycles=FIXED_CYCLES)
    solve_s = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    want = {"binary_factor_update": FIXED_CYCLES,
            "segment_sum": FIXED_CYCLES + 1,
            "var_update": 2 * FIXED_CYCLES}
    if launches != want:
        fail(f"stacked solve launched {launches}, expected {want}")
    metrics = results[0]["batch"]
    t0 = time.perf_counter()
    compiled = [compile_dcop(d, noise_level=0.01) for d in dcops]
    graphs = [g for g, _ in compiled]
    compile_s = time.perf_counter() - t0
    values, cycles, run = batch.run_stacked(graphs, max_cycles=FIXED_CYCLES)
    for i, r in enumerate(results):
        if r["cycles"] != FIXED_CYCLES or int(cycles[i]) != FIXED_CYCLES:
            fail(f"stacked member {i}: {r['cycles']} cycles")
    t0 = time.perf_counter()
    for i, g in enumerate(graphs):
        sv, sc, sres = batch.run_stacked([g], max_cycles=FIXED_CYCLES)
        if (not np.array_equal(sv[0], values[i]) or int(sc[0]) != cycles[i]
                or sres.metrics["converged_lanes"][0]
                != run.metrics["converged_lanes"][i]):
            fail(f"stacked member {i} != its solo card solve")
        if (results[i]["assignment"]
                != compiled[i][1].assignment_from_indices(values[i])):
            fail(f"stacked member {i}: solve_maxsum_batch's assignment "
                 f"!= run_stacked's values")
    # The solos above (wall clock: each call places its graph and
    # ends synchronised, the comparisons are host reads of a few KB)
    # against the stack's warm call.
    solos_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batch.run_stacked(graphs, max_cycles=FIXED_CYCLES)
    stack_ms = (time.perf_counter() - t0) * 1e3
    # Card = CPU on the whole stack's messages after 20 cycles.
    fold = batch.stacked_fold(graphs[0])
    union = batch.stack_union(graphs)
    runs = []
    for device in ("cuda", "cpu"):
        placed = to_device_graph(union, device, fold=fold)
        t0 = time.perf_counter()
        runs.append(final_run(ctx["ops"], ctx["state_to_numpy"], placed,
                              BATCH_CPU_CYCLES))
        del placed
    stack_cpu_s = time.perf_counter() - t0
    diff = run_differences(*runs)
    if diff:
        fail(f"stacked union: card != CPU after {BATCH_CPU_CYCLES} cycles "
             f"in {diff}")
    del runs, union
    # launch / collect: nothing in between synchronises the host.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        pending = batch.launch_stacked(graphs, max_cycles=FIXED_CYCLES)
        launch_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if pending is None:
        fail("launch_stacked of a warm stack returned None (cold)")
    lv, lc, lres = batch.collect_stacked(pending)
    if not (np.array_equal(lv, values) and np.array_equal(lc, cycles)
            and lres.metrics["converged_lanes"]
            == run.metrics["converged_lanes"]):
        fail("launch_stacked/collect_stacked != run_stacked")
    n_factors = int(graphs[0].buckets[0].var_ids.shape[0]) * BATCH_MEMBERS
    return dict(
        members=BATCH_MEMBERS, n_vars=BATCH_VARS * BATCH_MEMBERS,
        n_binary_factors=n_factors, cycles=FIXED_CYCLES,
        launches=launches, build_dcops_s=build_s, compile_s=compile_s,
        solve_maxsum_batch_s=solve_s,
        converged_lanes=sum(run.metrics["converged_lanes"]),
        metrics_keys=sorted(metrics),
        members_equal_solo_card=BATCH_MEMBERS,
        stack_card_equal_cpu_cycles=BATCH_CPU_CYCLES,
        stack_cpu_s=stack_cpu_s,
        stack_ms=stack_ms, solos_ms=solos_ms,
        launch_host_s=launch_s, pipelined=lres.metrics.get("pipelined"),
        run_time_s=run.metrics["run_time_s"],
        pack_host_s=run.metrics["pack_host_s"])


def phase_batch_envelope_lane(ctx):
    """run_stacked(envelope=...) and run_lane_packed over the 24
    structures of build_dcop_mixed, 60 cycles: each member equal to its
    solo card solve and to the CPU, with converged_lanes and
    envelope_waste."""
    torch, _build = ctx["torch"], ctx["_build"]
    from pydcop_tpu_torch.engine import batch
    from pydcop_tpu_torch.engine.compile import compile_dcop
    from pydcop_tpu_torch.serving import binning

    graphs = [compile_dcop(build_dcop_mixed(
        ctx["objects"], ctx["relations"], ctx["dcop_mod"], s, 100 + s),
        noise_level=0.01)[0] for s in range(MIXED_STRUCTS)]
    envs = [binning.envelope_key(g) for g in graphs]
    env = binning.Envelope(
        max(e.v_env for e in envs), max(e.d_env for e in envs),
        tuple((a, max(dict(e.rows)[a] for e in envs))
              for a in sorted(dict(envs[0].rows))))
    out = {}
    for label, fn, kw in (
            ("envelope", batch.run_stacked, {"envelope": env}),
            ("lane", batch.run_lane_packed,
             {"ladder": binning.UNION_LADDER})):
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        values, cycles, res = fn(graphs, max_cycles=MIXED_CYCLES, **kw)
        launches = dict(_build.launch_counts)
        cpu_values, cpu_cycles, cpu_res = fn(graphs, max_cycles=MIXED_CYCLES,
                                             device="cpu", **kw)
        for i, g in enumerate(graphs):
            solo = batch.run_stacked([g], max_cycles=MIXED_CYCLES)
            got = np.asarray(values[i])[:g.n_vars]
            if not (np.array_equal(got, solo[0][0][:g.n_vars])
                    and np.array_equal(got, np.asarray(
                        cpu_values[i])[:g.n_vars])):
                fail(f"{label} member {i} != its solo card solve / CPU")
            if (res.metrics["converged_lanes"][i]
                    != solo[2].metrics["converged_lanes"][0]):
                fail(f"{label} member {i}: converged flag != solo")
        if (res.metrics["converged_lanes"]
                != cpu_res.metrics["converged_lanes"]
                or not np.array_equal(cycles, cpu_cycles)):
            fail(f"{label}: card flags/cycles != CPU")
        out[label] = dict(
            launches=launches,
            converged_lanes=res.metrics["converged_lanes"],
            envelope_waste=res.metrics["envelope_waste"],
            run_time_s=res.metrics["run_time_s"],
            cells_total=res.metrics["cells_total"])
    return dict(structures=MIXED_STRUCTS, cycles=MIXED_CYCLES,
                members_equal_solo_and_cpu=MIXED_STRUCTS, **out)



# The serving slice: api.serve on the card.
SERVE_BIN_VARS = 10_000       # the batch phase's width
SERVE_BIN_MEMBERS = 8         # 16 until the elastic fleet's legs: time
SERVE_BIN_CYCLES = 200
SERVE_MIXED_CYCLES = 60       # bench.py's mixed serving leg
SERVE_MIXED_REQUESTS = 64
SERVE_MIXED_CLIENTS = 8
SERVE_MIXED_ZIPF_A = 1.05
SERVE_MIXED_WINDOW_S = 0.5
SERVE_SESSION_VARS = 48       # bench.py's session leg
SERVE_SESSION_EVENTS = 16
SERVE_SESSION_CYCLES = 50
SERVE_RECOVER_REQUESTS = 24


def serve_http(url: str, method: str = "GET", body=None,
               timeout: float = 600.0):
    """``(status, JSON body)`` of one request to the serve front end."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def run_clients(work, n_threads: int, timeout: float = 900.0):
    """Run ``work(k)`` for k in range(n_threads) on that many threads;
    every thread is joined, and the first error raised."""
    import threading

    errors = []

    def one(k):
        try:
            work(k)
        except BaseException as exc:   # re-raised on the caller
            errors.append(exc)

    threads = [threading.Thread(target=one, args=(k,), daemon=True)
               for k in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout)
    if any(th.is_alive() for th in threads):
        fail("serve: a client thread did not finish")
    if errors:
        raise errors[0]


def _served_equal(label, got, want):
    if got is None or got.get("status") != "FINISHED":
        fail(f"serve {label}: not finished: {got}")
    if got["assignment"] != want["assignment"] or got["cost"] != \
            want["cost"]:
        fail(f"serve {label}: cost {got['cost']} != solo "
             f"{want['cost']} (or the assignment differs)")


def _percentile(values, q):
    return float(np.percentile(np.asarray(values, dtype=float), q))


def _mean_ledger(results):
    """Each time-ledger component (seconds) averaged over served
    results: where a request's wall went (submit, queue, plan, prep,
    compile, execute, decode)."""
    keys = sorted({k for r in results for k in r["ledger"]})
    return {k: float(np.mean([r["ledger"].get(k, 0.0) for r in results]))
            for k in keys}


def mixed_stream_draws():
    """bench.py's mixed serving stream: SERVE_MIXED_REQUESTS
    (structure, seed) pairs drawn zipf(SERVE_MIXED_ZIPF_A) over the
    MIXED_STRUCTS build_dcop_mixed structures, seeds 0..3."""
    rng = np.random.default_rng(965)
    ranks = np.arange(1, MIXED_STRUCTS + 1, dtype=float)
    probs = ranks ** -SERVE_MIXED_ZIPF_A
    probs /= probs.sum()
    return [(int(s), int(rng.integers(4))) for s in rng.choice(
        MIXED_STRUCTS, size=SERVE_MIXED_REQUESTS, p=probs)]


def phase_serve(ctx):
    """The serving plane on the card, through ``api.serve(port=0,
    device="cuda")`` and its HTTP front end, in five legs:

    1. the flagship bin: 16 instances of build_dcop_small(10,000) at
       200 cycles as one flush of 16 (submitted in-process from 16
       threads: a 10,000-variable problem's yaml takes tens of seconds
       to parse), twice — the second flush warm, pipelined, and held to
       exactly one stacked dispatch's launches;
    2. bench.py's mixed stream over HTTP: 64 requests drawn zipf(1.05)
       over the 24 build_dcop_mixed structures from 8 client threads at
       60 cycles, then a burst of 12 structures (lane-packed, twice:
       the second warm and pipelined) and one of pruned structures of
       one envelope (envelope-padded, synchronous);
    3. one session (build_dcop_small(48, 0)) with 16 PATCHed
       change_factor batches, read over SSE, closed by DELETE;
    4. journal recovery: 24 requests accepted, the first flush's
       device call held, the service stopped without draining, a
       recover=True service finishing every one;
    5. one dpop request.

    Every served answer equals the card's solo api.solve of the same
    instance; leg 2's also the CPU's; the session equals the same
    session on a CPU service.  The launch counts are set to 0 at the
    start and read after leg 4 (the solo solves come after).
    ``ctx["serve_device"]`` (default ``"cuda"``) lets a development run
    drive the phase on the CPU at reduced sizes."""
    import shutil
    import tempfile
    import threading

    torch, _build = ctx["torch"], ctx["_build"]
    objects, relations, dcop_mod = (ctx["objects"], ctx["relations"],
                                    ctx["dcop_mod"])
    from pydcop_tpu_torch import api
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml
    from pydcop_tpu_torch.engine.compile import compile_dcop
    from pydcop_tpu_torch.serving import binning
    from pydcop_tpu_torch.serving.service import SolveService

    dev = ctx.get("serve_device", "cuda")

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    t_phase = time.perf_counter()
    legs_s = {}
    stats = {}
    sync()
    _build.launch_counts.clear()
    try:
        # Leg 1: the flagship bin.
        t_leg = time.perf_counter()
        bin_dcops = [build_dcop_small(objects, relations, dcop_mod,
                                      SERVE_BIN_VARS, seed)
                     for seed in range(SERVE_BIN_MEMBERS)]
        bin_params = {"max_cycles": SERVE_BIN_CYCLES}
        handle = api.serve(port=0, device=dev, batch_window_s=120.0,
                           max_batch=SERVE_BIN_MEMBERS)
        bin_rounds, bin_walls = [], []
        try:
            if handle.service.device.type != dev:
                fail(f"api.serve ran on {handle.service.device}")
            for rnd in range(2):
                results = [None] * SERVE_BIN_MEMBERS
                if rnd == 1:
                    sync()
                    before = dict(_build.launch_counts)

                def submit(k):
                    rid = handle.service.submit(bin_dcops[k],
                                                params=bin_params)
                    results[k] = handle.service.result(rid, wait=600)

                t0 = time.perf_counter()
                run_clients(submit, SERVE_BIN_MEMBERS)
                bin_walls.append(time.perf_counter() - t0)
                bin_rounds.append(results)
            grew = {k: _build.launch_counts[k] - before.get(k, 0)
                    for k in _build.launch_counts
                    if _build.launch_counts[k] != before.get(k, 0)}
            want = {"binary_factor_update": SERVE_BIN_CYCLES,
                    "segment_sum": SERVE_BIN_CYCLES + 1,
                    "var_update": 2 * SERVE_BIN_CYCLES}
            if grew != want and dev == "cuda":
                fail(f"serve leg 1: the warm flush launched {grew}, "
                     f"expected one stacked dispatch's {want}")
            for res in bin_rounds[1]:
                if (res["batch"]["n_real"] != SERVE_BIN_MEMBERS
                        or res["batch"]["cold_start"]):
                    fail(f"serve leg 1: warm flush record {res['batch']}")
            stats["bin"] = handle.service.stats()
        finally:
            handle.stop(drain=False)
        legs_s["bin"] = time.perf_counter() - t_leg

        # Legs 2, 3 and 5 on one journaled service.
        t_leg = time.perf_counter()
        mixed = {}

        def mixed_dcop(s, seed):
            key = (s, seed)
            if key not in mixed:
                mixed[key] = build_dcop_mixed(objects, relations,
                                              dcop_mod, s, seed)
            return mixed[key]

        draws = mixed_stream_draws()
        bodies = [dcop_yaml(mixed_dcop(s, seed)) for s, seed in draws]
        mixed_params = {"max_cycles": SERVE_MIXED_CYCLES}
        handle = api.serve(port=0, device=dev,
                           journal_dir=os.path.join(tmp, "journal"),
                           batch_window_s=SERVE_MIXED_WINDOW_S,
                           max_batch=16, envelope_overhead_ms=1e6)
        served = {}          # (structure, seed, prune) -> result
        latencies = []
        try:
            url = handle.url

            def client(k):
                for i in range(k, SERVE_MIXED_REQUESTS,
                               SERVE_MIXED_CLIENTS):
                    t0 = time.perf_counter()
                    code, body = serve_http(url + "/solve", "POST", {
                        "dcop": bodies[i], "params": mixed_params,
                        "wait": True, "timeout": 600})
                    latencies.append(time.perf_counter() - t0)
                    if code != 200:
                        fail(f"serve leg 2: POST /solve {code}: {body}")
                    served[draws[i] + (0,)] = body

            t0 = time.perf_counter()
            run_clients(client, SERVE_MIXED_CLIENTS)
            stream_s = time.perf_counter() - t0
            # A lane burst (twice: the second on warm shapes) and a
            # pruned envelope burst, each submitted in one go so it
            # lands in one flush.
            burst = [(s, 7) for s in range(0, MIXED_STRUCTS, 2)]
            for _ in range(2):
                ids = [(key, handle.service.submit(
                    mixed_dcop(*key), params=mixed_params))
                    for key in burst]
                for key, rid in ids:
                    served[key + (0,)] = handle.service.result(
                        rid, wait=600)
            envs = {}
            for s in range(MIXED_STRUCTS):
                g, _ = compile_dcop(mixed_dcop(s, 9), noise_level=0.01)
                envs.setdefault(binning.envelope_key(g), []).append(s)
            group = max(envs.values(), key=len)
            if len(group) < 2:
                fail("serve leg 2: no two mixed structures share an "
                     "envelope")
            pruned = dict(mixed_params, prune=1)
            ids = [((s, 9), handle.service.submit(mixed_dcop(s, 9),
                                                  params=pruned))
                   for s in group]
            for key, rid in ids:
                served[key + (1,)] = handle.service.result(rid, wait=600)
            legs_s["mixed"] = time.perf_counter() - t_leg

            # Leg 3: one session over HTTP, read over SSE.
            t_leg = time.perf_counter()
            session_dcop = build_dcop_small(objects, relations, dcop_mod,
                                            SERVE_SESSION_VARS, 0)
            names = sorted(session_dcop.constraints)
            srng = np.random.default_rng(1306)
            batches = []
            for _ in range(SERVE_SESSION_EVENTS):
                name = names[int(srng.integers(len(names)))]
                table = srng.integers(0, 10, size=(N_COLORS, N_COLORS))
                batches.append([{"type": "change_factor", "name": name,
                                 "table": table.astype(float).tolist()}])
            session_params = {"max_cycles": SERVE_SESSION_CYCLES,
                              "segment_cycles": SERVE_SESSION_CYCLES,
                              "noise": 0.0}
            code, opened = serve_http(url + "/session", "POST", {
                "dcop": dcop_yaml(session_dcop),
                "params": session_params})
            if code != 201:
                fail(f"serve leg 3: POST /session {code}: {opened}")
            sid = opened["session_id"]
            sse, first, ended = [], threading.Event(), threading.Event()

            def read_sse():
                import urllib.request

                try:
                    with urllib.request.urlopen(
                            url + f"/session/{sid}/events",
                            timeout=600) as resp:
                        for raw in resp:
                            line = raw.decode().strip()
                            if line.startswith("data:"):
                                sse.append(json.loads(line[5:]))
                                first.set()
                finally:
                    first.set()
                    ended.set()

            reader = threading.Thread(target=read_sse, daemon=True)
            reader.start()
            if not first.wait(600):
                fail("serve leg 3: no SSE event")
            patches = []
            for batch in batches:
                code, out = serve_http(
                    url + f"/session/{sid}/events", "PATCH",
                    {"events": batch, "wait": True, "timeout": 600})
                if code != 200 or not out.get("applied"):
                    fail(f"serve leg 3: PATCH {code}: {out}")
                patches.append(out["result"])
            code, final = serve_http(url + f"/session/{sid}", "DELETE")
            if code != 200 or final.get("status") != "CLOSED":
                fail(f"serve leg 3: DELETE {code}: {final}")
            if not ended.wait(600):
                fail("serve leg 3: the SSE stream did not end")
            reader.join(10)
            legs_s["session"] = time.perf_counter() - t_leg

            # Leg 5: one exact request.
            t_leg = time.perf_counter()
            dpop_dcop = mixed_dcop(0, 3)
            code, dpop_body = serve_http(url + "/solve", "POST", {
                "dcop": dcop_yaml(dpop_dcop), "params": {"algo": "dpop"},
                "wait": True, "timeout": 600})
            if code != 200 or not dpop_body.get("optimal"):
                fail(f"serve leg 5: dpop {code}: {dpop_body}")
            legs_s["dpop"] = time.perf_counter() - t_leg
            code, stats["serve"] = serve_http(url + "/stats")
            if code != 200:
                fail(f"serve: GET /stats {code}")
        finally:
            handle.stop(drain=False)

        # Leg 4: journal recovery.  The first flush's device call is
        # held until the service has stopped (a crash mid-flush), so
        # the stop without drain finds every request accepted and
        # unfinished, whatever the host's speed.
        t_leg = time.perf_counter()
        journal = os.path.join(tmp, "recover")
        recover_keys = [(s, 200 + s) for s in range(SERVE_RECOVER_REQUESTS)]
        handle = api.serve(port=0, device=dev, journal_dir=journal,
                           batch_window_s=0.05, max_batch=4)
        gate, entered = threading.Event(), threading.Event()
        real_run = handle.service._run_batch

        def held(reqs, params, **kw):
            entered.set()
            gate.wait(600)
            return real_run(reqs, params, **kw)

        handle.service._run_batch = held
        ids = []
        scheduler = handle.service._scheduler._thread
        try:
            for key in recover_keys:
                code, ack = serve_http(handle.url + "/solve", "POST", {
                    "dcop": dcop_yaml(mixed_dcop(*key)),
                    "params": mixed_params})
                if code != 202:
                    fail(f"serve leg 4: POST /solve {code}: {ack}")
                ids.append(ack["id"])
            if not entered.wait(600):
                fail("serve leg 4: no flush reached the device call")
        finally:
            handle.front_end.stop()
            summary = handle.service.stop(drain=False, timeout=0.01)
            # The held flush then runs on its own thread: wait for it
            # before the card is shared again.
            gate.set()
            scheduler.join(600)
        if scheduler.is_alive():
            fail("serve leg 4: the stopped scheduler did not end")
        if summary["replayable"] != SERVE_RECOVER_REQUESTS:
            fail(f"serve leg 4: {summary} at the stop, expected "
                 f"{SERVE_RECOVER_REQUESTS} replayable")
        handle = api.serve(port=0, device=dev, journal_dir=journal,
                           recover=True, batch_window_s=0.05)
        recovered = {}
        try:
            for key, rid in zip(recover_keys, ids):
                code, body = serve_http(handle.url + f"/result/{rid}")
                deadline = time.perf_counter() + 600
                while code == 202 and time.perf_counter() < deadline:
                    body = handle.service.result(rid, wait=10)
                    code = 202 if body is None else 200
                if code != 200:
                    fail(f"serve leg 4: {rid} did not finish: {body}")
                recovered[key] = body
            stats["recover"] = handle.service.stats()
        finally:
            handle.stop(drain=False)
        legs_s["recover"] = time.perf_counter() - t_leg
        sync()
        launches = dict(_build.launch_counts)
        served_s = time.perf_counter() - t_phase

        # The answers: every one against the card's solo api.solve;
        # leg 2 also against the CPU's; the session against a CPU
        # service's.
        t_check = time.perf_counter()
        for k, dcop in enumerate(bin_dcops):
            solo = api.solve(dcop, "maxsum", max_cycles=SERVE_BIN_CYCLES,
                             device=dev)
            for rnd in bin_rounds:
                _served_equal(f"bin member {k}", rnd[k], solo)
        for (s, seed, _), res in served.items():
            dcop = mixed_dcop(s, seed)
            for where in (dev, "cpu"):
                solo = api.solve(dcop, "maxsum",
                                 max_cycles=SERVE_MIXED_CYCLES, device=where)
                _served_equal(f"mixed {(s, seed)} vs {where}", res, solo)
        for key, res in recovered.items():
            solo = api.solve(mixed_dcop(*key), "maxsum",
                             max_cycles=SERVE_MIXED_CYCLES, device=dev)
            _served_equal(f"recovered {key}", res, solo)
        exact = api.solve(dpop_dcop, "dpop", device=dev)
        if (dpop_body["assignment"] != exact["assignment"]
                or dpop_body["cost"] != exact["cost"]):
            fail(f"serve leg 5: dpop cost {dpop_body['cost']} != solo "
                 f"{exact['cost']}")
        cpu = SolveService(device="cpu", batch_window_s=0.01,
                           speculate=False).start()
        try:
            sess = cpu.sessions.open(session_dcop, params=session_params)
            cpu_patches = [cpu.sessions.apply_events(
                sess.id, b, wait=600)["result"] for b in batches]
            cpu_final = cpu.sessions.close(sess.id, wait=600)
        finally:
            cpu.stop(drain=False)
        keys = ("cycle", "cost", "converged", "assignment")
        for i, (a, b) in enumerate(zip(patches, cpu_patches)):
            if any(a[k] != b[k] for k in keys):
                fail(f"serve leg 3: event batch {i}: card segment != CPU")
        for k in ("assignment", "cost", "cycles", "converged",
                  "events_applied"):
            if final[k] != cpu_final[k]:
                fail(f"serve leg 3: final {k} card != CPU")
        segments = [e for e in sse if e.get("phase") == "segment"]
        if (len(segments) != SERVE_SESSION_EVENTS + 1
                or sse[-1].get("phase") != "closed"
                or [e["cost"] for e in segments[1:]]
                != [p["cost"] for p in patches]):
            fail(f"serve leg 3: SSE stream {[e.get('phase') for e in sse]}")
        check_s = time.perf_counter() - t_check
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    serve_stats = stats["serve"]
    dispatches = {
        "pipelined": (stats["bin"]["pipeline"]["pipelined_dispatches"]
                      + serve_stats["pipeline"]["pipelined_dispatches"]),
        "envelope": serve_stats["envelope_dispatches"],
        "lane": serve_stats["lane_dispatches"],
        "total": stats["bin"]["dispatches"] + serve_stats["dispatches"],
    }
    if not (dispatches["pipelined"] and dispatches["envelope"]
            and dispatches["lane"]):
        fail(f"serve: pipelined/envelope/lane dispatches {dispatches}")
    from pydcop_tpu_torch.ops.binary_factor import LANE
    from pydcop_tpu_torch.ops.lane_sum import KERNEL as LANE_SUM
    from pydcop_tpu_torch.ops.lane_var_update import SEND, V2F

    for name in ("binary_factor_update", "segment_sum", "var_update",
                 LANE, LANE_SUM, V2F, SEND):
        if not launches.get(name) and dev == "cuda":
            fail(f"serve: {name} was not launched ({launches})")
    problems_per_s = SERVE_MIXED_REQUESTS / stream_s
    return dict(
        launches=launches, legs_s=legs_s, served_s=served_s,
        check_s=check_s, dispatches=dispatches,
        pipelined_share=dispatches["pipelined"] / dispatches["total"],
        mixed=dict(requests=SERVE_MIXED_REQUESTS,
                   clients=SERVE_MIXED_CLIENTS, stream_s=stream_s,
                   problems_per_s=problems_per_s,
                   p50_ms=_percentile(latencies, 50) * 1e3,
                   p99_ms=_percentile(latencies, 99) * 1e3,
                   distinct_instances=len(served),
                   envelope_group=len(group),
                   ledger_mean_s=_mean_ledger(list(served.values()))),
        bin=dict(members=SERVE_BIN_MEMBERS, n_vars=SERVE_BIN_VARS,
                 cycles=SERVE_BIN_CYCLES, flush_s=bin_walls,
                 warm_problems_per_s=SERVE_BIN_MEMBERS / bin_walls[1],
                 warm_flush_launches=grew,
                 warm_ledger_mean_s=_mean_ledger(bin_rounds[1])),
        session=dict(events=SERVE_SESSION_EVENTS,
                     sse_events=len(sse), final_cost=final["cost"]),
        recover=dict(requests=SERVE_RECOVER_REQUESTS,
                     replayable_at_stop=summary["replayable"],
                     replayed=stats["recover"]["replayed"]),
        stats={k: {key: v[key] for key in (
            "dispatches", "batched_dispatches", "envelope_dispatches",
            "lane_dispatches", "dpop_dispatches", "completed", "failed")}
            for k, v in stats.items()})


SHARD_COUNTS = (2, 4, 8)     # meshes naming the one card S times
SHARD_MAIN = 4               # the sharded path the kernel line reports
SHARD_COMPARE_CYCLES = 8     # flagship: card = CPU after every cycle
SHARD_TIMED_CYCLES = 40      # ms a cycle, sharded and unsharded
SHARD_PROFILE_CYCLES = 10
SHARD_SCALE = 4              # the 1M-variable scale arrays' shard count
SHARD_SCALE_CYCLES = 3       # scale: card = CPU after every cycle
SHARD_TRIP = ((20, 1),)      # trip_shard: lose shard 1 at cycle 20
SHARD_TRIP_CYCLES = 60
SHARD_TRIP_SEGMENT = 10


def halo_sum_bound(s: int, b: int, d: int):
    """(bound_ms, bound_by) of halo_sum: the S partials read once and
    the totals written once, against one add per partial element."""
    bytes_moved = 4 * (s * b * d + b * d)
    ops = s * b * d
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def subset_bound(n_edges: int, n_seg: int, d: int):
    """(bound_ms, bound_by) of a shard's boundary partial: the gathered
    edges' messages, perm and offsets read once, the [B, D] sums written
    once, against one add per edge element.  The reused segment_sum
    entry also reads a [B, D] zero cost operand and writes a [B, D]
    beliefs output that subset_sum drops; neither is the function's
    work, so neither is in the bound."""
    bytes_moved = 4 * (n_edges * d + n_edges + (n_seg + 1) + n_seg * d)
    ops = n_edges * d
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def halo_partials(torch, s: int, b: int, d: int, seed: int,
                  subnormal: bool = False, card: str = "cuda"):
    """Drawn [S, B, D] partials on the card: seven decades, signed zeros
    on every 13th row, or (``subnormal``) values around float32's
    smallest normal, half of them subnormal."""
    rng = np.random.default_rng(seed)
    if subnormal:
        x = (rng.choice([-1.0, 1.0], size=(s, b, d))
             * rng.uniform(0.25, 2.0, size=(s, b, d)) * FLT_MIN)
    else:
        x = rng.normal(size=(s, b, d)) * 10.0 ** rng.integers(
            -3, 4, size=(s, b, d))
    x = x.astype(np.float32)
    x[:, ::13] = -0.0
    return torch.tensor(x, device=card)


def halo_sum_check(torch, hs, label: str, s: int, b: int, d: int,
                   seed: int, card: str = "cuda"):
    """halo_sum on the card bit for bit against its plain version at one
    [S, B, D] shape (drawn and subnormal partials; the stacked tensor
    and the S separate tensors), then timed beside its bound and
    ``torch.sum(stacked, 0)`` (not on the CPU rehearsal)."""
    err = 0.0
    for sub in (False, True):
        parts = halo_partials(torch, s, b, d, seed, sub, card)
        got = hs.halo_sum(parts)
        want = hs.halo_sum_reference(parts)
        listed = hs.halo_sum(list(parts.unbind(0)))
        for out in (got, listed):
            if b:
                err = max(err, float((out - want).abs().max()))
            if not np.array_equal(out.cpu().numpy().view(np.int32),
                                  want.cpu().numpy().view(np.int32)):
                fail(f"halo_sum kernel != plain at {label} [S={s}, "
                     f"B={b}, D={d}] subnormal={sub}")
    bound_ms, bound_by = halo_sum_bound(s, b, d)
    if card != "cuda":
        return dict(S=s, B=b, D=d, max_abs_err=err, ms="not measured",
                    bound_ms=bound_ms, bound_by=bound_by)
    # The bound is HBM's, so the timed calls rotate over enough input
    # sets to spill the L2 (at least 4x its size where ``reps`` calls
    # allow): one set replayed would be read from the L2.
    reps = 200 if b < 100_000 else 50
    set_bytes = 4 * s * b * d
    n_sets = min(reps, max(1, -(-4 * H100_L2_BYTES // set_bytes)))
    sets = [halo_partials(torch, s, b, d, seed + 1 + i)
            for i in range(n_sets)]

    def rotating(fn):
        turn = [0]

        def call():
            parts = sets[turn[0] % n_sets]
            turn[0] += 1
            return fn(parts)
        return call

    k_ms, p_ms, l_ms = (graph_ms(torch, rotating(fn), reps) for fn in (
        hs.halo_sum, hs.halo_sum_reference, lambda p: torch.sum(p, 0)))
    del sets
    return dict(S=s, B=b, D=d, ms=k_ms[2], plain_ms=p_ms[2],
                library_ms=l_ms[2], ms_spread=[k_ms[0], k_ms[-1]],
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                timed_input_sets=n_sets,
                timed_input_mb=n_sets * set_bytes / 2 ** 20,
                tolerance="exact (int32 views equal)")


def subset_sum_check(torch, seg_mod, sh, f2v, n_bnd: int, d: int,
                     card: str = "cuda", label: str = "the flagship shard"):
    """The boundary partial (segment_sum.cu's subset entry) of one shard
    bit for bit against its plain version on CPU copies, timed beside its
    bound and ``index_add_`` over the gathered edges."""
    args = (sh.part_perm, sh.part_offsets, sh.part_tiles, sh.part_zeros)
    got = seg_mod.subset_sum(f2v, *args)
    want = seg_mod.subset_sum([m.cpu() for m in f2v],
                              *(a.cpu() for a in args))
    err = float((got.cpu() - want).abs().max()) if n_bnd else 0.0
    if not np.array_equal(got.cpu().numpy().view(np.int32),
                          want.numpy().view(np.int32)):
        fail(f"segment_sum subset entry != plain on {label}")
    if card != "cuda":
        return dict(B=n_bnd, D=d, max_abs_err=err, ms="not measured")
    flat = torch.cat([m.reshape(-1, d) for m in f2v])
    edges = sh.part_perm.to(torch.int64)
    counts = sh.part_offsets[1:] - sh.part_offsets[:-1]
    seg = torch.repeat_interleave(torch.arange(n_bnd, device="cuda"),
                                  counts.to(torch.int64))

    def library():
        # One call, atomics in no fixed order: yardstick only.
        return torch.zeros((n_bnd, d), device="cuda").index_add_(
            0, seg, flat[edges])

    k_ms, l_ms = (graph_ms(torch, fn, 200) for fn in (
        lambda: seg_mod.subset_sum(f2v, *args), library))
    cpu_f2v = [m.cpu() for m in f2v]
    cpu_args = tuple(a.cpu() for a in args)
    t0 = time.perf_counter()
    for _ in range(3):
        seg_mod.subset_sum(cpu_f2v, *cpu_args)
    plain_ms = (time.perf_counter() - t0) / 3 * 1e3
    n_edges = int(edges.shape[0])
    bound_ms, bound_by = subset_bound(n_edges, n_bnd, d)
    return dict(Eb=n_edges, B=n_bnd, D=d, ms=k_ms[2], max_abs_err=err,
                tolerance="exact (int32 views equal)",
                ms_spread=[k_ms[0], k_ms[-1]], plain_ms=plain_ms,
                plain_on="cpu (the plain walk reads the host)",
                library_ms=l_ms[2], bound_ms=bound_ms, bound_by=bound_by,
                beyond_bound="the kernel also reads [B, D] zeros and "
                "writes [B, D] beliefs that subset_sum drops")


def sharded_compare(ctx, card_ops, card_graph, cpu_ops, cpu_graph,
                    cycles: int, label: str, card: str = "cuda"):
    """Run the card's and the CPU's partitioned layouts one cycle at a
    time from zero messages; every leaf of the state (messages, counts,
    the halo slot, stable, cycle) and the values equal bit for bit after
    each cycle.  Returns the card's final state."""
    from pydcop_tpu_torch.utils.tree import tree_leaves

    kw = dict(ctx["kw"], stop_on_convergence=False)
    cs, ps = card_ops.init_state(card_graph), cpu_ops.init_state(cpu_graph)
    for c in range(cycles):
        cs, cv = card_ops.run_maxsum_from(card_graph, cs, 1, **kw)
        ps, pv = cpu_ops.run_maxsum_from(cpu_graph, ps, 1, **kw)
        if cs.f2v[0].device.type != card:
            fail(f"{label}: the card's state is not on the card")
        for i, (a, b) in enumerate(zip(tree_leaves(cs), tree_leaves(ps))):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            if (a.dtype != b.dtype or a.shape != b.shape
                    or a.tobytes() != b.tobytes()):
                fail(f"{label}: card != CPU after cycle {c + 1} in leaf "
                     f"{i} of the state")
        if not np.array_equal(cv.cpu().numpy(), pv.numpy()):
            fail(f"{label}: card values != CPU after cycle {c + 1}")
    return cs


def phase_sharded(ctx, card="cuda"):
    """The partitioned engine on the card: ``ShardedMaxSumEngine`` on a
    mesh naming the one card 2, 4 and 8 times (the entry point a user
    calls on one card; ``api.solve(shards=)`` counts real cards and
    raises here, as the reference does past its device count), each
    equal to the same engine on the CPU after every cycle; the S = 4
    flagship run with the launch counts set to 0 just before it; ms a
    cycle beside the unsharded edge engine; the 1M-variable scale arrays
    at S = 4, card = CPU after every cycle; halo_sum.cu and the
    boundary partial against their plain versions, timed; one
    trip_shard recovery, card = CPU.  ``card="cpu"`` rehearses the phase
    on the CPU (the CPU against itself, nothing timed)."""
    torch, _build = ctx["torch"], ctx["_build"]
    from pydcop_tpu_torch.engine.compile import (
        CompiledFactorGraph,
        FactorBucket,
        compile_dcop,
    )
    from pydcop_tpu_torch.engine.partition import partition_compiled
    from pydcop_tpu_torch.engine.runner import ShardedMaxSumEngine
    from pydcop_tpu_torch.engine.sharding import (
        ShardOps,
        make_mesh,
        partitioned_layout,
        place_partitioned,
    )
    from pydcop_tpu_torch.ops import halo_sum as hs
    from pydcop_tpu_torch.ops import segment_sum as seg_mod
    from pydcop_tpu_torch.resilience.recovery import RecoveryPolicy

    t_phase = time.perf_counter()
    dcop, params = ctx["dcop"], ctx["params"]
    graph, meta = compile_dcop(dcop, noise_level=params.get("noise", 0.01))
    kw = dict(damping=params.get("damping", 0.5),
              damping_nodes=params.get("damping_nodes", "both"),
              stability=params.get("stability", 0.1))
    out = {"flagship": {}, "halo_sum_timing": {}}
    engines = {}
    timed = card == "cuda"
    sync = torch.cuda.synchronize if timed else (lambda: None)
    for s in SHARD_COUNTS:
        eng = ShardedMaxSumEngine(
            graph, meta, mesh=make_mesh(devices=[card] * s), device=card,
            **kw)
        cpu = ShardedMaxSumEngine(
            graph, meta, mesh=make_mesh(devices=["cpu"] * s),
            device="cpu", **kw)
        if eng.graph.n_boundary == 0:
            fail(f"flagship at S={s} has no boundary to exchange")
        sharded_compare(ctx, eng._ops, eng.graph, cpu._ops, cpu.graph,
                        SHARD_COMPARE_CYCLES, f"flagship S={s}", card)
        m = eng.extra_metrics
        out["flagship"][f"S{s}"] = dict(
            bit_equal_cycles=SHARD_COMPARE_CYCLES,
            boundary_vars=m["boundary_vars"],
            edge_cut_fraction=m["edge_cut_fraction"],
            halo_exchange_bytes_per_superstep=m[
                "halo_exchange_bytes_per_superstep"],
            replicated_allreduce_bytes_per_superstep=m[
                "replicated_allreduce_bytes_per_superstep"],
            local_rows=list(eng.graph.var_costs.shape[:2]))
        out["halo_sum_timing"][f"flagship_S{s}"] = halo_sum_check(
            torch, hs, f"flagship S={s}", s, eng.graph.n_boundary,
            N_COLORS, seed=300 + s, card=card)
        engines[s] = (eng, cpu)

    # The main path of this slice: the S = 4 flagship run, the launch
    # counts set to 0 just before it and read just after.
    eng, cpu = engines[SHARD_MAIN]
    eng.run(3, stop_on_convergence=False)
    sync()
    _build.launch_counts.clear()
    res = eng.run(SHARD_TIMED_CYCLES, stop_on_convergence=False)
    launches = dict(_build.launch_counts)
    n, s = SHARD_TIMED_CYCLES, SHARD_MAIN
    want = {"binary_factor_update": s * n, "segment_sum": s * (n + 1),
            "var_update": 2 * s * n, seg_mod.HALO: s * n, "halo_sum": n}
    if timed and launches != want:
        fail(f"sharded path launched {launches}, expected {want}")
    ref = cpu.run(SHARD_TIMED_CYCLES, stop_on_convergence=False)
    if (res.assignment, res.cycles, res.converged) != (
            ref.assignment, ref.cycles, ref.converged):
        fail("sharded flagship run: card != CPU")
    cost, _ = dcop.solution_cost(res.assignment)
    if not np.isfinite(cost):
        fail(f"sharded flagship run: non-finite cost {cost}")
    out["main"] = dict(shards=s, cycles=res.cycles, cost=cost,
                       cpu_equal=True, launches=launches,
                       launches_per_cycle={k: v / n for k, v in
                                           launches.items()})

    # ms a cycle: every mesh beside the unsharded edge engine, one call.
    ms = {}
    if timed:
        plain = ctx["engine"]
        ms["unsharded"] = ms_per_cycle(
            torch, lambda c: plain.run(c, stop_on_convergence=False),
            SHARD_TIMED_CYCLES)
        for s_, (e_, _) in engines.items():
            ms[f"S{s_}"] = ms_per_cycle(
                torch, lambda c, e=e_: e.run(c, stop_on_convergence=False),
                SHARD_TIMED_CYCLES)
        # The profile, in a fresh process (a profiler session late in
        # this long one drops device events); the child holds its
        # launches of the port's kernels to the launch counters.
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--shard-profile"],
            cwd=HERE, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            fail(f"shard profile (exit {proc.returncode}): "
                 f"{proc.stderr[-2000:]}")
        out["profile_S4"] = json.loads(
            proc.stdout.strip().splitlines()[-1])
    out["ms_per_cycle"] = ms

    # The boundary partial of shard 0 at the main path's shapes.
    state, _ = eng._ops.run_maxsum_from(
        eng.graph, eng.init_state(), 5, stop_on_convergence=False,
        damping=eng.damping)
    sh = eng.graph.shards[0]
    out["subset_sum_timing"] = subset_sum_check(
        torch, seg_mod, sh, tuple(m[0] for m in state.f2v),
        eng.graph.n_boundary, N_COLORS, card)
    del state

    # One shard loss on the card: the same assignment and cost as the
    # CPU's recovery.
    trip = {}
    for label, eng_dev in (("card", card), ("cpu", "cpu")):
        tripped = ShardedMaxSumEngine(
            graph, meta, mesh=make_mesh(devices=[eng_dev] * SHARD_MAIN),
            device=eng_dev, **kw)
        r = tripped.run_checkpointed(
            max_cycles=SHARD_TRIP_CYCLES, segment_cycles=SHARD_TRIP_SEGMENT,
            recovery=RecoveryPolicy(trip_shard=SHARD_TRIP))
        trip[label] = (r.assignment, r.cycles, r.metrics["n_shards"],
                       r.metrics["lost_shards"], r.metrics["shard_losses"])
        if label == "card":
            trip_s = r.time_s
            trip_recovery_s = r.metrics["shard_recovery_s"]
            layout_dev = tripped.graph.shards[0].graph.var_costs.device
            if layout_dev.type != card:
                fail("trip_shard: the surviving layout is not on the card")
    if trip["card"] != trip["cpu"]:
        fail(f"trip_shard on the card != CPU: {trip['card'][1:]} vs "
             f"{trip['cpu'][1:]}")
    trip_cost, _ = dcop.solution_cost(trip["card"][0])
    out["trip_shard"] = dict(
        trips=[list(t) for t in SHARD_TRIP], cycles=trip["card"][1],
        n_shards_after=trip["card"][2], lost_shards=trip["card"][3],
        cost=trip_cost, cpu_equal=True, time_s=trip_s,
        shard_recovery_s=trip_recovery_s)

    # api.solve(shards=) counts the machine's cards, as the reference
    # counts its devices: above that it raises, never falls back.
    n_cards = torch.cuda.device_count() if timed else 8
    try:
        ctx["api"].solve(dcop, "maxsum", max_cycles=5, shards=n_cards + 1,
                         device=card)
    except ValueError as exc:
        out["api_solve_above_card_count"] = f"raises: {str(exc)[:80]}"
    else:
        fail(f"api.solve(shards={n_cards + 1}) ran on {n_cards} card(s)")
    del engines, eng, cpu, tripped

    # The scale arrays at S = 4: one partition, placed on the card and on
    # the CPU, equal after every cycle.
    var_costs, var_valid, buckets = scale_arrays(SCALE_VARS)
    host = CompiledFactorGraph(var_costs, var_valid, tuple(
        FactorBucket(c, ids) for c, ids in buckets))
    del var_costs, var_valid, buckets
    t0 = time.perf_counter()
    part = partition_compiled(host, SHARD_SCALE, use_cache=False)
    layout, metrics = partitioned_layout(host, part, SHARD_SCALE)
    partition_s = time.perf_counter() - t0
    meshes = {dev: make_mesh(devices=[dev] * SHARD_SCALE)
              for dev in (card, "cpu")}
    card_graph = place_partitioned(layout, meshes[card])
    cpu_graph = place_partitioned(layout, meshes["cpu"])
    card_ops = ShardOps(meshes[card], SCALE_VARS)
    cpu_ops = ShardOps(meshes["cpu"], SCALE_VARS)
    t0 = time.perf_counter()
    sharded_compare(ctx, card_ops, card_graph, cpu_ops, cpu_graph,
                    SHARD_SCALE_CYCLES, f"scale S={SHARD_SCALE}", card)
    compare_s = time.perf_counter() - t0
    scale_kw = dict(ctx["kw"], stop_on_convergence=False)
    scale_ms = ms_per_cycle(torch, lambda c: card_ops.run_maxsum(
        card_graph, c, **scale_kw), SHARD_SCALE_CYCLES) if timed \
        else "not measured"
    out["scale"] = dict(
        n_vars=SCALE_VARS, shards=SHARD_SCALE,
        bit_equal_cycles=SHARD_SCALE_CYCLES,
        boundary_vars=metrics["boundary_vars"],
        edge_cut_fraction=metrics["edge_cut_fraction"],
        halo_exchange_bytes_per_superstep=metrics[
            "halo_exchange_bytes_per_superstep"],
        local_rows=list(layout.var_costs.shape[:2]),
        partition_s=partition_s, compare_s=compare_s,
        ms_per_cycle=scale_ms,
        unsharded_ms_per_cycle=ctx.get("scale_ms_per_cycle"))
    # The boundary partial of shard 0 at the scale shape.
    state, _ = card_ops.run_maxsum_from(
        card_graph, card_ops.init_state(card_graph), 2, **scale_kw)
    out["subset_sum_timing_scale"] = subset_sum_check(
        torch, seg_mod, card_graph.shards[0],
        tuple(m[0] for m in state.f2v), layout.n_boundary, N_COLORS, card,
        label=f"shard 0 of the scale arrays at S={SHARD_SCALE}")
    del state
    out["halo_sum_timing"][f"scale_S{SHARD_SCALE}"] = halo_sum_check(
        torch, hs, f"scale S={SHARD_SCALE}", SHARD_SCALE,
        layout.n_boundary, N_COLORS, seed=400, card=card)
    del card_graph, cpu_graph, layout, host
    out["seconds"] = time.perf_counter() - t_phase
    return out


FLEET_REPLICAS = 2           # worker processes sharing the one card
FLEET_HEARTBEAT_S = 0.25
# Copies of the flagship as one structure bin (2 until the elastic
# legs, whose prewarm replays the flagship at the same width).
FLEET_BIN_MEMBERS = 1
FLEET_BIN_CYCLES = 60
FLEET_KILL_REQUESTS = 16     # the burst the SIGKILL lands in
FLEET_KILL_SEED = 300
# The elastic legs (bench.py bench_fleet_elastic's phases B-D) on the
# fleet phase's router: built with FLEET_REPLICAS as its floor and one
# more as its ceiling, the SLO armed only at run time.
FLEET_MAX_REPLICAS = 3
ELASTIC_SLO_UP_MS = 1.0      # below every flush: the armed check scales up
ELASTIC_SLO_QUIET_MS = 1e9   # above every latency: quiet checks accrue
ELASTIC_INTERVAL_S = 0.25    # the autoscale check's period in the legs
ELASTIC_QUIET_CHECKS = 2     # quiet checks in a row before a scale-down
ELASTIC_SESSION_PARAMS = {"noise": 0.01, "stability": 0.001,
                          "max_cycles": 500}
ELASTIC_REMOTE_BURST = 8     # acknowledged requests the joined worker owns
ELASTIC_REMOTE_SEED = 700
ELASTIC_DEADLINE_S = 300.0


def await_served(url: str, rid: str, timeout: float = 600.0):
    """The result of router-minted request ``rid``, polled through the
    router until it is done: 202 (pending) and 503 (its replica is
    restarting) are waited out, anything else is returned."""
    deadline = time.perf_counter() + timeout
    while True:
        code, body = serve_http(url + f"/result/{rid}", timeout=60)
        if code not in (202, 503):
            return code, body
        if time.perf_counter() > deadline:
            fail(f"fleet: {rid} still {code} after {timeout} s: {body}")
        time.sleep(0.05)


def fleet_backends(url: str):
    """Each live worker's own backend report (``/profile`` through the
    router's ``/fleet/profile``): backend, card name, kernel libraries
    loaded and kernels launched in that process."""
    code, doc = serve_http(url + "/fleet/profile")
    if code != 200:
        fail(f"fleet: GET /fleet/profile {code}: {doc}")
    return {source: rep["backend"] for source, rep in
            doc["replicas"].items()}


def elastic_session_problem(objects, relations, dcop_mod, seed: int,
                            n_batches: int, params=None):
    """bench.py ``_elastic_session_problem`` on the port: a 10-variable
    path with integer tables, ``n_batches`` event batches, and the cost
    the same session reaches UNINTERRUPTED (one engine on the CPU, every
    batch applied in process, under ``params``; None without
    ``params``) — a migrated or adopted session must end at exactly
    this cost."""
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml
    from pydcop_tpu_torch.engine.dynamic import build_dynamic_engine
    from pydcop_tpu_torch.serving.sessions import apply_event_batch

    rng = np.random.default_rng(seed)
    dom = objects.Domain("c", "", [0, 1, 2])
    dcop = dcop_mod.DCOP(f"elastic{seed}", objective="min")
    vs = [objects.Variable(f"v{i}", dom) for i in range(10)]
    for v in vs:
        dcop.add_variable(v)
    for k in range(9):
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[k], vs[k + 1]],
            rng.integers(0, 10, size=(3, 3)).astype(float), f"c{k}"))
    dcop.add_agents([objects.AgentDef("a0")])
    batches = [[{"type": "change_factor",
                 "name": f"c{int(rng.integers(9))}",
                 "table": rng.integers(0, 10, size=(3, 3))
                 .astype(float).tolist()}] for _ in range(n_batches)]
    if params is None:
        return dcop_yaml(dcop), batches, None
    ref = build_dynamic_engine(dcop, params, device="cpu")
    ref.run(max_cycles=params["max_cycles"])
    for batch in batches:
        _asg, _touched, err = apply_event_batch(ref, batch)
        if err is not None:
            fail(f"elastic session {seed}: reference event failed: {err}")
        ref.run(max_cycles=params["max_cycles"])
    expected = ref.cost(ref.run(max_cycles=params["max_cycles"]).assignment)
    return dcop_yaml(dcop), batches, expected


def rendezvous_owner(router, yaml_src: str, params) -> int:
    """The replica the router's own rendezvous pick gives a request of
    ``yaml_src`` under ``params`` among its candidates now (idle, so no
    spillover)."""
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop
    from pydcop_tpu_torch.serving import binning
    from pydcop_tpu_torch.serving.router import _rendezvous_score

    merged = dict(router.default_params)
    merged.update(params)
    digest = binning.affinity_key(load_dcop(yaml_src), merged)
    return max(router.candidates(),
               key=lambda r: _rendezvous_score(digest, r.index)).index


def session_params_for(router, yaml_src: str, target: int):
    """ELASTIC_SESSION_PARAMS with the first ``max_cycles`` from 500
    whose rendezvous pick is replica ``target``: the router's structure
    key ignores the tables, so a seed cannot steer a session, and its
    solver parameters are part of the key."""
    for extra in range(64):
        params = dict(ELASTIC_SESSION_PARAMS,
                      max_cycles=ELASTIC_SESSION_PARAMS["max_cycles"]
                      + extra)
        if rendezvous_owner(router, yaml_src, params) == target:
            return params
    fail(f"elastic: no session key lands on replica {target}")


def elastic_patch_acked(url: str, sid: str, batch, deadline_s=120.0):
    """PATCH one event batch until it is acknowledged: 409 (frozen
    mid-migration) and 503 (its owner recovering) mean retry."""
    deadline = time.perf_counter() + deadline_s
    while True:
        code, out = serve_http(url + f"/session/{sid}/events", "PATCH", {
            "events": batch, "wait": True, "timeout": 30.0})
        if code == 200:
            return out
        if code not in (409, 503) or time.perf_counter() > deadline:
            fail(f"elastic: PATCH {sid} not acknowledged: {code} {out}")
        time.sleep(0.2)


def elastic_close_session(url: str, sid: str, deadline_s=120.0):
    """Wait for the session's last segment to converge, then close it;
    returns the close document (its final ``cost``)."""
    deadline = time.perf_counter() + deadline_s
    while time.perf_counter() < deadline:
        code, doc = serve_http(url + f"/session/{sid}")
        if code == 200 and (doc.get("last") or {}).get("converged"):
            break
        time.sleep(0.05)
    code, final = serve_http(url + f"/session/{sid}", "DELETE")
    if code != 200:
        fail(f"elastic: closing {sid}: {code} {final}")
    return final


def elastic_session(url: str, router, yaml_src: str, params, batches,
                    target: int, label: str):
    """Open a session (its pick must be replica ``target``) and apply
    its first two batches; returns the session id."""
    code, opened = serve_http(url + "/session", "POST",
                              {"dcop": yaml_src, "params": params})
    if code != 201:
        fail(f"elastic {label}: session open {code}: {opened}")
    sid = opened["session_id"]
    owner = router.pinned(sid, router._session_pins)
    if owner is None or owner.index != target:
        fail(f"elastic {label}: session on {owner and owner.index}, "
             f"not replica {target}")
    for seq, batch in enumerate(batches[:2], 1):
        ack = elastic_patch_acked(url, sid, batch)
        if ack.get("seq") != seq:
            fail(f"elastic {label}: batch {seq} acknowledged as {ack}")
    return sid


def worker_profile(url: str):
    """One worker's own ``/profile`` backend block."""
    code, doc = serve_http(url + "/profile")
    if code != 200:
        fail(f"elastic: GET {url}/profile {code}: {doc}")
    return doc["backend"]


def _wait_for(what: str, cond, deadline_s=ELASTIC_DEADLINE_S, every=0.02,
              alive=None):
    """Poll ``cond`` until it is true; fail after ``deadline_s`` or as
    soon as ``alive()`` is false (a worker that died)."""
    t0 = time.perf_counter()
    while not cond():
        if alive is not None and not alive():
            fail(f"elastic: {what}: the worker died")
        if time.perf_counter() - t0 > deadline_s:
            fail(f"elastic: {what}: not within {deadline_s} s")
        time.sleep(every)
    return time.perf_counter() - t0


def _check_backend(label, backend, card, kind, built_none=False):
    """A worker's backend block: it ran on ``card``; on the card it
    names the card and launched binary_factor_update.cu (its edge or
    its lane entry), and with ``built_none`` it loaded libraries from
    the shared directory and built none."""
    if backend.get("backend") != card:
        fail(f"elastic: {label} ran on {backend}")
    if card != "cuda":
        return
    counts = backend.get("kernel_launches", {})
    if backend.get("device_name") != kind or not any(
            n for name, n in counts.items()
            if name.startswith("binary_factor_update")):
        fail(f"elastic: {label} reports {backend}")
    cache = backend.get("compile_cache") or {}
    if built_none and not (cache.get("hits", 0) > 0
                           and cache.get("misses", 0) == 0):
        fail(f"elastic: {label} built kernel libraries: {cache}")


def fleet_elastic_legs(ctx, handle, card, flagship_yaml, mixed_dcop,
                       tmp):
    """The elastic fleet on a running fleet's router (``handle``, built
    with ``min_replicas=FLEET_REPLICAS`` and ``max_replicas=
    FLEET_MAX_REPLICAS`` and no SLO, so its autoscaler is unarmed until
    here): bench.py bench_fleet_elastic's phases B-D at the port's
    shapes.

    1. Scale up: admit a flagship problem (FLEET_BIN_CYCLES cycles), arm
       an SLO every flush breaches: exactly one worker is spawned on
       ``card``, prewarmed by replaying the last four admission
       exemplars (the flagship among them) before it takes traffic —
       its ``/profile`` shows the card and kernel launches while the
       router has routed it nothing, its compile-cache counts libraries
       loaded and none built — and the serve phase's mixed stream then
       runs through the three workers.
    2. Join: ``serve --join <router> --device <card>`` in a process the
       router did not spawn; it shows ``up`` with ``managed: false``,
       is given a session (two batches) and ELASTIC_REMOTE_BURST
       acknowledged requests it owns, every one answered, its
       ``/profile`` naming the card.  With four workers up the card's
       memory in use is read.
    3. Scale down: a session with two batches applied on the scaled-up
       worker, then an SLO far above every latency: the worker is
       drained (its session migrated to a survivor) and retired; the
       session's next batches land in sequence and its final cost is
       the uninterrupted cost exactly.
    4. Remote death: SIGKILL of the joined worker: the router marks it
       down, never restarts it, and adopts its session onto a survivor
       from the journal it announced; the session's next batch lands as
       seq 3 and its final cost is the uninterrupted cost exactly.

    Returns the legs' timings and counts, the answers (keyed like the
    fleet phase's, for the solo comparisons) and the two new workers'
    kernel launches.  Every failed check raises."""
    import signal

    torch = ctx["torch"]
    objects, relations, dcop_mod = (ctx["objects"], ctx["relations"],
                                    ctx["dcop_mod"])
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

    router, url = handle.router, handle.url
    kind = torch.cuda.get_device_name(0) if card == "cuda" else None
    params = {"max_cycles": SERVE_MIXED_CYCLES}
    answers = collections.defaultdict(list)
    out = {}
    t_legs = time.perf_counter()

    # Leg 1: scale up.
    code, flagship_answer = serve_http(url + "/solve", "POST", {
        "dcop": flagship_yaml, "params": {"max_cycles": FLEET_BIN_CYCLES},
        "wait": True, "timeout": 600})
    if code != 200:
        fail(f"elastic leg 1: flagship POST /solve {code}")
    with router._lock:
        exemplars = list(router._exemplars)[-4:]
    p99, n_before = router.rolling_p99(), len(router.replicas)
    live = [r for r in router.replicas if r.status == "up"]
    depth = sum(r.queue_depth for r in live)
    trigger = ("p99" if p99 is not None and p99 > ELASTIC_SLO_UP_MS
               else "queue_depth" if depth > 2 * max(len(live), 1)
               else None)
    if trigger is None:
        fail(f"elastic leg 1: nothing to scale on (p99 {p99})")
    router.autoscale_interval_s = ELASTIC_INTERVAL_S
    t_arm = time.perf_counter()
    router.slo_p99_ms = ELASTIC_SLO_UP_MS
    try:
        _wait_for("the scale-up's spawn",
                  lambda: len(router.replicas) > n_before)
        new = router.replicas[n_before]
        alive = lambda: new.proc is None or new.proc.poll() is None  # noqa: E731
        _wait_for("the scaled-up worker's start",
                  lambda: new.port is not None, alive=alive)
        spawn_s = time.perf_counter() - t_arm
        _wait_for("the scale-up's prewarm", lambda: router.scale_ups == 1,
                  alive=alive)
        up_s = time.perf_counter() - t_arm
    finally:
        router.slo_p99_ms = None     # the fleet's size holds from here
    if router.scale_ups != 1 or len(router.replicas) != n_before + 1:
        fail(f"elastic leg 1: {router.scale_ups} scale-ups")
    if not new.managed or new.status != "up" or new.forwarded != 0 \
            or new.warm != set(exemplars):
        fail(f"elastic leg 1: replica {new.index} after the prewarm: "
             f"{new.summary()}")
    code, new_stats = serve_http(new.url + "/stats")
    prewarm_backend = worker_profile(new.url)
    if new_stats.get("completed") != len(exemplars):
        fail(f"elastic leg 1: the prewarm ran {new_stats.get('completed')} "
             f"of {len(exemplars)} exemplars")
    _check_backend("the scaled-up worker's prewarm", prewarm_backend, card,
                   kind, built_none=True)

    draws = mixed_stream_draws()
    bodies = {key: dcop_yaml(mixed_dcop(*key)) for key in set(draws)}
    stream = []

    def client(k):
        for i in range(k, len(draws), SERVE_MIXED_CLIENTS):
            t1 = time.perf_counter()
            code, body = serve_http(url + "/solve", "POST", {
                "dcop": bodies[draws[i]], "params": params,
                "wait": True, "timeout": 600})
            if code != 200:
                fail(f"elastic leg 1: POST /solve {code}: {body}")
            stream.append((t1, time.perf_counter() - t1, draws[i], body))

    t0 = time.perf_counter()
    run_clients(client, SERVE_MIXED_CLIENTS)
    stream_s = time.perf_counter() - t0
    by_replica = collections.Counter()
    first_new = None
    for t1, lat, key, body in sorted(stream, key=lambda row: row[0]):
        answers[key].append(body)
        index = router.pinned(body["id"]).index
        by_replica[index] += 1
        if index == new.index and first_new is None:
            first_new = lat
    if len(by_replica) != n_before + 1:
        fail(f"elastic leg 1: the stream reached replicas {by_replica}")
    latencies = [row[1] for row in stream]
    out["scale_up"] = dict(
        trigger=trigger, rolling_p99_ms_at_arm=p99, replica=new.index,
        spawn_s=spawn_s, prewarm_s=up_s - spawn_s, armed_to_serving_s=up_s,
        exemplars_replayed=len(exemplars),
        prewarm_launches=prewarm_backend.get("kernel_launches"),
        prewarm_compile_cache=prewarm_backend.get("compile_cache"),
        first_routed_ms=first_new * 1e3,
        stream=dict(requests=len(draws), clients=SERVE_MIXED_CLIENTS,
                    stream_s=stream_s,
                    problems_per_s=len(draws) / stream_s,
                    p50_ms=_percentile(latencies, 50) * 1e3,
                    p99_ms=_percentile(latencies, 99) * 1e3,
                    by_replica=dict(by_replica)))

    # Leg 2: a worker joins.
    port = free_port()
    remote_dir = os.path.join(tmp, "remote")
    cmd = [sys.executable, "-m", "pydcop_tpu_torch.dcop_cli", "serve",
           "--port", str(port), "--host", "127.0.0.1", "--device", card,
           "--join", url, "--journal_dir", remote_dir,
           "--host_id", "remote0", *router.worker_args]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if router.compile_cache_dir:
        env["PYDCOP_COMPILE_CACHE_DIR"] = router.compile_cache_dir
    with open(os.path.join(tmp, "remote.log"), "ab") as log:
        remote_proc = subprocess.Popen(cmd, env=env, cwd=HERE, stdout=log,
                                       stderr=log, start_new_session=True)
    try:
        def joined():
            return next((r for r in router.replicas if not r.managed
                         and r.port == port and r.status == "up"), None)

        join_s = _wait_for("the join", joined,
                           alive=lambda: remote_proc.poll() is None)
        remote = joined()
        code, stats = serve_http(url + "/stats")
        doc = stats["workers"][remote.index]
        if (doc["managed"], doc["status"], doc["host_id"]) != (
                False, "up", "remote0"):
            fail(f"elastic leg 2: /stats shows the joined worker as {doc}")
        # A session and a burst of acknowledged requests the joined
        # worker owns, every request answered.
        yaml_b = elastic_session_problem(objects, relations, dcop_mod, 4301,
                                         3)[0]
        params_b = session_params_for(router, yaml_b, remote.index)
        yaml_b, batches_b, expected_b = elastic_session_problem(
            objects, relations, dcop_mod, 4301, 3, params_b)
        sid_b = elastic_session(url, router, yaml_b, params_b, batches_b,
                                remote.index, "leg 2")
        owned = [s for s in range(MIXED_STRUCTS)
                 if rendezvous_owner(router, dcop_yaml(mixed_dcop(
                     s, ELASTIC_REMOTE_SEED)), params) == remote.index]
        if not owned:
            fail("elastic leg 2: no structure lands on the joined worker")
        burst = [(owned[k % len(owned)], ELASTIC_REMOTE_SEED + k)
                 for k in range(ELASTIC_REMOTE_BURST)]
        acks = {}
        for key in burst:
            code, ack = serve_http(url + "/solve", "POST", {
                "dcop": dcop_yaml(mixed_dcop(*key)), "params": params})
            if code != 202 or router.pinned(ack["id"]).index \
                    != remote.index:
                fail(f"elastic leg 2: POST /solve {code}: {ack}")
            acks[key] = ack["id"]
        for key, rid in acks.items():
            code, body = await_served(url, rid)
            if code != 200:
                fail(f"elastic leg 2: acknowledged {rid} answered {code}")
            answers[key].append(body)
        remote_backend = worker_profile(remote.url)
        _check_backend("the joined worker", remote_backend, card, kind,
                       built_none=True)
        ups = [r for r in router.replicas if r.status == "up"]
        if len(ups) != n_before + 2:
            fail(f"elastic leg 2: {len(ups)} workers up")
        names = {f"replica-{r.index}": worker_profile(r.url).get(
            "device_name") for r in ups}
        memory = None
        if card == "cuda":
            free, total = torch.cuda.mem_get_info()
            memory = dict(used_mib=(total - free) / 2**20,
                          total_mib=total / 2**20)
        out["join"] = dict(replica=remote.index, join_s=join_s,
                           workers_up=len(ups), device_names=names,
                           card_memory_all_up=memory)

        # Leg 3: scale down with a drain.
        yaml_a = elastic_session_problem(objects, relations, dcop_mod, 4201,
                                         4)[0]
        params_a = session_params_for(router, yaml_a, new.index)
        yaml_a, batches_a, expected_a = elastic_session_problem(
            objects, relations, dcop_mod, 4201, 4, params_a)
        sid_a = elastic_session(url, router, yaml_a, params_a, batches_a,
                                new.index, "leg 3")
        scaled_backend = worker_profile(new.url)
        migrations = router.migrations
        router.scale_down_quiet_checks = ELASTIC_QUIET_CHECKS
        router._quiet_checks = 0
        router.slo_p99_ms = ELASTIC_SLO_QUIET_MS
        try:
            drain_s = _wait_for("the scale-down",
                                lambda: router.scale_downs == 1)
        finally:
            router.slo_p99_ms = None
        moved_to = router.pinned(sid_a, router._session_pins)
        if not new.retired or new.status != "down" \
                or new.proc.poll() != 0 or moved_to is None \
                or moved_to.index == new.index \
                or router.migrations != migrations + 1:
            fail(f"elastic leg 3: after the drain {new.summary()}, "
                 f"session on {moved_to and moved_to.index}")
        for seq, batch in enumerate(batches_a[2:], 3):
            ack = elastic_patch_acked(url, sid_a, batch)
            if ack.get("seq") != seq:
                fail(f"elastic leg 3: batch {seq} acknowledged as {ack}")
        final_a = elastic_close_session(url, sid_a)
        if final_a.get("cost") != expected_a:
            fail(f"elastic leg 3: migrated session ended at "
                 f"{final_a.get('cost')}, uninterrupted {expected_a}")
        out["scale_down"] = dict(
            replica=new.index, armed_to_retired_s=drain_s,
            session_moved_to=moved_to.index, final_cost=final_a["cost"],
            uninterrupted_cost=expected_a,
            session_max_cycles=params_a["max_cycles"])

        # Leg 4: the joined worker's death.
        deaths, adopted = router.deaths, router.adopted_sessions
        t_kill = time.perf_counter()
        os.kill(remote_proc.pid, signal.SIGKILL)
        remote_proc.wait(timeout=60)
        down_s = _wait_for("the joined worker's death verdict",
                           lambda: remote.status == "down"
                           and router.deaths == deaths + 1)
        adopt_s = _wait_for(
            "the adoption", lambda: router.adopted_sessions > adopted
            and router.pinned(sid_b, router._session_pins).index
            != remote.index)
        ack = elastic_patch_acked(url, sid_b, batches_b[2])
        final_b = elastic_close_session(url, sid_b)
        if ack.get("seq") != 3 or final_b.get("cost") != expected_b:
            fail(f"elastic leg 4: adopted session acked {ack}, ended at "
                 f"{final_b.get('cost')}, uninterrupted {expected_b}")
        if remote.status != "down" or remote.restarts != 0 \
                or remote.proc is not None:
            fail(f"elastic leg 4: the dead remote {remote.summary()}")
        out["remote_death"] = dict(
            replica=remote.index, burst=len(acks), lost=0,
            verdict_s=down_s, adopted_s=down_s + adopt_s,
            session_adopted_by=router.pinned(
                sid_b, router._session_pins).index,
            final_cost=final_b["cost"], uninterrupted_cost=expected_b,
            session_max_cycles=params_b["max_cycles"],
            since_kill_s=time.perf_counter() - t_kill)
    finally:
        if remote_proc.poll() is None:
            remote_proc.kill()
            remote_proc.wait(timeout=60)
    out.update(
        legs_s=time.perf_counter() - t_legs, scale_ups=router.scale_ups,
        scale_downs=router.scale_downs,
        adopted_sessions=router.adopted_sessions,
        migrations=router.migrations, answers=dict(answers),
        flagship_answer=flagship_answer,
        launches=dict(collections.Counter(scaled_backend.get(
            "kernel_launches", {})) + collections.Counter(
                remote_backend.get("kernel_launches", {}))),
        workers={"scaled_up": scaled_backend, "joined": remote_backend})
    return out


# -- the generators slice ------------------------------------------------ #

# The port's generators at these sizes (one entry each: label, module of
# pydcop_tpu_torch.generators, function, arguments, keyword arguments).
GENERATED_PROBLEMS = [
    ("graph_coloring", "graphcoloring", "generate_graph_coloring",
     (10_000, 3, "scalefree"), {"soft": True, "m_edge": 2, "seed": 0}),
    ("ising", "ising", "generate_ising", (100,), {"seed": 0}),
    ("meetings", "meetingscheduling", "generate_meetings",
     (10, 500, 200, 4), {"seed": 0}),
    ("secp", "secp", "generate_secp", (3000, 600, 600), {"seed": 0}),
    ("iot", "iot", "generate_iot", (10_000,), {"seed": 0}),
    ("small_world", "smallworld", "generate_small_world", (10_000,),
     {"seed": 0}),
]
GENERATED_ALGOS = ("maxsum", "dsa", "mgm")
GENERATED_CYCLES = 60
# factor_to_var's dense n-ary update (still plain torch): calls timed
# after the warm-up, on the SECP problem's arity-3 and arity-4 buckets.
FACTOR_TO_VAR_REPS = 20
# The CLI leg: a small generated file through generate, graph and solve.
GENERATED_CLI = ["generate", "graph_coloring", "-v", "100", "-c", "3", "-g",
                 "scalefree", "-m", "2", "--seed", "0"]


def factor_to_var_bound(f: int, arity: int, d: int):
    """(bound_ms, bound_by) of one bucket's dense update: the cost table
    and the messages read once and the messages written once, against
    the f32 operations (arity adds a table entry, then a min over it and
    a subtract for each position)."""
    entries = f * d ** arity
    bytes_moved = 4 * (entries + 2 * f * arity * d)
    ops = entries * (arity + arity) + f * arity * d
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def time_factor_to_var(torch, ops, graph, bucket_index: int, seed: int):
    """One bucket's f2v update through ``ops.maxsum.factor_to_var`` on
    random messages (the binary bucket runs binary_factor_update.cu, the
    others torch), timed with CUDA events after a warm-up: ``ms`` a call
    replayed from a CUDA graph (device time; sorted spread of five
    replays in ``ms_spread``) and ``eager_ms`` a call launched from the
    host back to back (the host's launches included); the bound and the
    bucket's shape."""
    from types import SimpleNamespace

    bucket = graph.buckets[bucket_index]
    f = int(bucket.costs.shape[0])
    arity = bucket.costs.dim() - 1
    d = int(bucket.costs.shape[1])
    rng = np.random.default_rng(seed)
    msgs = torch.tensor(rng.normal(size=(f, arity, d)).astype(np.float32),
                        device=bucket.costs.device)
    one = SimpleNamespace(buckets=(bucket,))

    def call():
        return ops.factor_to_var(one, (msgs,))

    eager = cuda_ms(torch, call, FACTOR_TO_VAR_REPS)
    replays = graph_ms(torch, call, FACTOR_TO_VAR_REPS)
    bound_ms, bound_by = factor_to_var_bound(f, arity, d)
    return {"F": f, "arity": arity, "D": d, "ms": replays[2],
            "ms_spread": [replays[0], replays[-1]], "eager_ms": eager,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / replays[2]}


def phase_generated(ctx, card="cuda"):
    """The generators slice on the card.  Each of the port's generators
    makes its problem in this process at the sizes above; each problem
    is solved through ``api.solve`` with maxsum, dsa and mgm (60
    cycles) on the card and on the CPU, and every card solve equals the
    CPU's in assignment, cost, violations, cycles and status.  On the
    problems of unary and binary factors a fixed 60-cycle MaxSum run on
    the card equals the CPU's in every final message.  The launch
    counts are set to 0 before each card solve and read after it; their
    sum over the phase is the path's.  ``factor_to_var`` is timed on
    SECP's arity-3 and arity-4 buckets beside the binary kernel on the
    colouring's bucket.  Then the CLI leg: ``generate`` a small
    colouring, ``graph -a maxsum`` and ``solve --device`` on the file it
    wrote, in this process.  ``card="cpu"`` rehearses the phase (no
    launches counted, smaller sizes through ``problems=``)."""
    import contextlib
    import importlib
    import io
    import tempfile

    torch, _build, api = ctx["torch"], ctx["_build"], ctx["api"]
    from pydcop_tpu_torch import dcop_cli
    from pydcop_tpu_torch.algorithms.maxsum import build_engine
    from pydcop_tpu_torch.engine.convert import state_to_numpy
    from pydcop_tpu_torch.ops import maxsum as ops

    t_phase = time.perf_counter()
    launches = collections.Counter()
    rows, f2v_timing = {}, {}
    for label, module, func, args, kwargs in ctx.get(
            "problems", GENERATED_PROBLEMS):
        t0 = time.perf_counter()
        generator = getattr(importlib.import_module(
            f"pydcop_tpu_torch.generators.{module}"), func)
        dcop = generator(*args, **kwargs)
        if isinstance(dcop, tuple):
            dcop = dcop[0]
        row = {"variables": len(dcop.variables),
               "constraints": len(dcop.constraints),
               "generate_s": time.perf_counter() - t0, "solves": {}}
        for algo in GENERATED_ALGOS:
            _build.launch_counts.clear()
            t0 = time.perf_counter()
            res = api.solve(dcop, algo, max_cycles=GENERATED_CYCLES,
                            device=card)
            card_s = time.perf_counter() - t0
            got = dict(_build.launch_counts)
            launches.update(got)
            t0 = time.perf_counter()
            cpu = api.solve(dcop, algo, max_cycles=GENERATED_CYCLES,
                            device="cpu")
            cpu_s = time.perf_counter() - t0
            for key in ("assignment", "cost", "violations", "cycles",
                        "status"):
                if res[key] != cpu[key]:
                    fail(f"generated {label} {algo}: card {key} "
                         f"{res[key] if key != 'assignment' else '...'} != "
                         f"CPU {cpu[key] if key != 'assignment' else '...'}")
            if not np.isfinite(res["cost"]):
                fail(f"generated {label} {algo}: cost {res['cost']}")
            if card != "cpu" and not any(
                    n for k, n in got.items() if k.startswith(
                        "binary_factor_update" if algo == "maxsum"
                        else "segment_sum:positional")):
                fail(f"generated {label} {algo} launched {got}")
            row["solves"][algo] = {
                "cost": res["cost"], "violations": res["violations"],
                "cycles": res["cycles"], "status": res["status"],
                "card_s": card_s, "cpu_s": cpu_s, "launches": got}
        engine = build_engine(dcop, {}, device=card)
        arities = sorted({b.costs.dim() - 1 for b in engine.graph.buckets})
        row["arities"] = arities
        if max(arities) <= 2:
            cpu_engine = build_engine(dcop, {}, device="cpu")
            kw = dict(damping=engine.damping, damp_vars=engine.damp_vars,
                      damp_factors=engine.damp_factors,
                      stability=engine.stability)
            runs = [final_run(ops, state_to_numpy, g, GENERATED_CYCLES,
                              **kw)
                    for g in (engine.graph, cpu_engine.graph)]
            diff = run_differences(*runs)
            if diff:
                fail(f"generated {label}: card MaxSum run != CPU run in "
                     f"{diff}")
            row["messages_bit_equal"] = int(sum(
                a.size for a in runs[0][0]["f2v"]))
            del cpu_engine, runs
        if card != "cpu" and label == "graph_coloring":
            f2v_timing["binary_graph_coloring"] = time_factor_to_var(
                torch, ops, engine.graph, arities.index(2), seed=1)
        if card != "cpu" and label == "secp":
            for i, b in enumerate(engine.graph.buckets):
                arity = b.costs.dim() - 1
                if arity >= 3:
                    f2v_timing[f"secp_arity{arity}"] = time_factor_to_var(
                        torch, ops, engine.graph, i, seed=arity)
        del engine
        rows[label] = row

    # The CLI leg, in this process: generate, graph, solve on the card.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_generated_")
    path = os.path.join(tmp, "graph_coloring_100.yaml")

    def cli(args):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = dcop_cli.main(args)
        if rc != 0:
            fail(f"generated CLI leg: {' '.join(args)} exited {rc}")
        return out.getvalue()

    try:
        cli(["--output", path] + GENERATED_CLI)
        graph = json.loads(cli(["graph", "-a", "maxsum", path]))
        if (graph["graph"] != "factor_graph" or graph["nodes"]
                != graph["variables"] + graph["constraints"]):
            fail(f"generated CLI leg: graph printed {graph}")
        _build.launch_counts.clear()
        solved = json.loads(cli(["solve", "-a", "maxsum", "-c",
                                 str(GENERATED_CYCLES), "--device", card,
                                 path]))
        cli_launches = dict(_build.launch_counts)
        launches.update(cli_launches)
        cpu_solved = json.loads(cli(["solve", "-a", "maxsum", "-c",
                                     str(GENERATED_CYCLES), "--device",
                                     "cpu", path]))
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    for key in ("assignment", "cost", "violation", "cycle", "status"):
        if solved[key] != cpu_solved[key]:
            fail(f"generated CLI leg: card {key} != CPU")
    if card != "cpu" and not cli_launches.get("binary_factor_update"):
        fail(f"generated CLI leg launched {cli_launches}")
    return dict(problems=rows, factor_to_var=f2v_timing,
                cli={"args": GENERATED_CLI, "graph": graph,
                     "cost": solved["cost"], "cycle": solved["cycle"],
                     "launches": cli_launches},
                launches=dict(launches),
                seconds=time.perf_counter() - t_phase)


def free_port() -> int:
    """A local TCP port free now, for a process that must listen on a
    port known before it starts."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def check_fleet_answers(api, mixed_dcop, answers, where, flagship=None,
                        flagship_answers=()):
    """Every served answer against its instance's solo ``api.solve`` on
    each device of ``where`` (assignment and cost): ``answers`` maps a
    build_dcop_mixed key to its results, ``flagship_answers`` are the
    flagship's (FLEET_BIN_CYCLES cycles)."""
    for key in sorted(answers):
        for dev in where:
            solo = api.solve(mixed_dcop(*key), "maxsum",
                             max_cycles=SERVE_MIXED_CYCLES, device=dev)
            for res in answers[key]:
                _served_equal(f"fleet {key} vs {dev}", res, solo)
    if flagship_answers:
        for dev in where:
            solo = api.solve(flagship, "maxsum", max_cycles=FLEET_BIN_CYCLES,
                             device=dev)
            for k, res in enumerate(flagship_answers):
                _served_equal(f"fleet flagship copy {k} vs {dev}", res, solo)


def phase_fleet(ctx, card="cuda", elastic=True):
    """The fixed-size fleet: ``api.serve(port=0, replicas=2,
    device=card)`` — two worker processes on the card behind the router,
    their kernel libraries loaded from the directory the earlier phases
    built them in — driven in three legs:

    1. the serve phase's mixed stream (64 requests zipf over the 24
       build_dcop_mixed structures from 8 clients at 60 cycles) through
       the router;
    2. one bin of flagship problems: FLEET_BIN_MEMBERS copies of
       build_dcop(10,000) from as many clients;
    3. a burst of FLEET_KILL_REQUESTS acknowledged requests, then
       SIGKILL of the worker that owns most of them while some are
       still pending; every acknowledged request is then answered, the
       killed worker's share by its restart replaying its journal
       segment.

    With ``elastic`` the router is built with ``min_replicas=
    FLEET_REPLICAS`` and ``max_replicas=FLEET_MAX_REPLICAS`` and no SLO
    (its autoscaler unarmed through the three legs), and
    :func:`fleet_elastic_legs` then drives the elastic fleet on it: a
    scale-up with prewarm, a joined worker, a scale-down drain and the
    joined worker's death.

    Every answer equals its instance's solo api.solve on ``card`` and
    on the CPU (assignment and cost, the serve phase's comparison).
    Each worker's own reports show where it ran: ``/stats`` (the
    backend its dispatches used, the restart's replayed requests) and
    ``/profile`` (the card's name, the kernel libraries it loaded and
    its kernels' launch counts).  With ``card="cpu"`` the phase
    rehearses on the CPU (the tests shrink its sizes)."""
    import shutil
    import signal
    import tempfile

    torch, _build = ctx["torch"], ctx["_build"]
    objects, relations, dcop_mod = (ctx["objects"], ctx["relations"],
                                    ctx["dcop_mod"])
    from pydcop_tpu_torch import api
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

    mixed = {}

    def mixed_dcop(s, seed):
        if (s, seed) not in mixed:
            mixed[(s, seed)] = build_dcop_mixed(objects, relations,
                                                dcop_mod, s, seed)
        return mixed[(s, seed)]

    t_phase = time.perf_counter()
    draws = mixed_stream_draws()
    bodies = {key: dcop_yaml(mixed_dcop(*key)) for key in set(draws)}
    kill_keys = [(s % MIXED_STRUCTS, FLEET_KILL_SEED + s)
                 for s in range(FLEET_KILL_REQUESTS)]
    for key in kill_keys:
        bodies[key] = dcop_yaml(mixed_dcop(*key))
    flagship = ctx.get("dcop") or build_flagship(
        objects, relations, dcop_mod, FLAGSHIP_VARS)
    flagship_yaml = dcop_yaml(flagship)
    params = {"max_cycles": SERVE_MIXED_CYCLES}
    bin_params = {"max_cycles": FLEET_BIN_CYCLES}
    prep_s = time.perf_counter() - t_phase

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    served, latencies, acks = {}, [], {}
    try:
        t0 = time.perf_counter()
        handle = api.serve(
            port=0, replicas=FLEET_REPLICAS, device=card,
            journal_dir=os.path.join(tmp, "journal"),
            compile_cache_dir=str(_build.BUILD_DIR),
            batch_window_s=SERVE_MIXED_WINDOW_S, max_batch=16,
            envelope_overhead_ms=1e6, heartbeat_s=FLEET_HEARTBEAT_S,
            **(dict(min_replicas=FLEET_REPLICAS,
                    max_replicas=FLEET_MAX_REPLICAS) if elastic else {}))
        start_s = time.perf_counter() - t0
        router, url = handle.router, handle.url
        try:
            # Leg 1: the mixed stream.
            def client(k):
                for i in range(k, len(draws), SERVE_MIXED_CLIENTS):
                    t1 = time.perf_counter()
                    code, body = serve_http(url + "/solve", "POST", {
                        "dcop": bodies[draws[i]], "params": params,
                        "wait": True, "timeout": 600})
                    latencies.append(time.perf_counter() - t1)
                    if code != 200:
                        fail(f"fleet leg 1: POST /solve {code}: {body}")
                    served[draws[i]] = body

            t0 = time.perf_counter()
            run_clients(client, SERVE_MIXED_CLIENTS)
            stream_s = time.perf_counter() - t0

            # Leg 2: the flagship bin.
            flagship_served = [None] * FLEET_BIN_MEMBERS

            def submit(k):
                code, body = serve_http(url + "/solve", "POST", {
                    "dcop": flagship_yaml, "params": bin_params,
                    "wait": True, "timeout": 600})
                if code != 200:
                    fail(f"fleet leg 2: POST /solve {code}: {body}")
                flagship_served[k] = body

            t0 = time.perf_counter()
            run_clients(submit, FLEET_BIN_MEMBERS)
            bin_s = time.perf_counter() - t0

            # Leg 3: the burst, then SIGKILL mid-burst.
            completed_before = {
                w["index"]: w["stats"]["completed"]
                for w in serve_http(url + "/stats")[1]["workers"]}

            def fire(k):
                for i in range(k, len(kill_keys), SERVE_MIXED_CLIENTS):
                    code, ack = serve_http(url + "/solve", "POST", {
                        "dcop": bodies[kill_keys[i]], "params": params})
                    if code != 202:
                        fail(f"fleet leg 3: POST /solve {code}: {ack}")
                    acks[kill_keys[i]] = ack["id"]

            run_clients(fire, SERVE_MIXED_CLIENTS)
            owners = collections.Counter(
                router.pinned(rid).index for rid in acks.values())
            victim = router.replicas[owners.most_common(1)[0][0]]
            code, vstats = serve_http(victim.url + "/stats")
            pending_at_kill = owners[victim.index] - (
                vstats["completed"] - completed_before[victim.index])
            if pending_at_kill < 1:
                fail("fleet leg 3: the burst finished before the kill "
                     f"({owners[victim.index]} owned, none pending)")
            lost_launches = fleet_backends(url)[
                f"replica-{victim.index}"].get("kernel_launches", {})
            t_kill = time.perf_counter()
            os.kill(victim.proc.pid, signal.SIGKILL)
            while not (victim.restarts == 1
                       and victim.status == "up"):
                if time.perf_counter() - t_kill > 300:
                    fail(f"fleet leg 3: replica {victim.index} not back "
                         f"({victim.status})")
                time.sleep(0.02)
            restart_s = time.perf_counter() - t_kill
            answered = {key: await_served(url, rid)
                        for key, rid in acks.items()}
            answered_s = time.perf_counter() - t_kill
            lost = {key: code for key, (code, _) in answered.items()
                    if code != 200}
            if lost:
                fail(f"fleet leg 3: acknowledged requests lost: {lost}")
            code, stats = serve_http(url + "/stats")
            if code != 200:
                fail(f"fleet: GET /stats {code}")
            backends = fleet_backends(url)
            fixed_s = time.perf_counter() - t_phase
            elastic_out = (fleet_elastic_legs(ctx, handle, card,
                                              flagship_yaml, mixed_dcop,
                                              tmp) if elastic else None)
        finally:
            summary = handle.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    served_s = time.perf_counter() - t_phase
    exits = [w["exit"] for w in summary["workers"]]
    # The fixed workers and the retired scaled-up one drained (0); the
    # joined worker was never the router's process (None).
    want_exits = [0] * FLEET_REPLICAS + ([0, None] if elastic else [])
    if exits != want_exits:
        fail(f"fleet: worker exits {summary}")

    # What each worker reports of itself.
    workers = {w["index"]: w for w in stats["workers"]}
    if stats["up"] != FLEET_REPLICAS or stats["deaths"] != 1 \
            or workers[victim.index]["restarts"] != 1:
        fail(f"fleet: after the kill {stats['up']} up, "
             f"{stats['deaths']} deaths")
    replayed = workers[victim.index]["stats"]["replayed"]
    if replayed < pending_at_kill:
        fail(f"fleet: the restart replayed {replayed} of "
             f"{pending_at_kill} pending requests")
    kind = torch.cuda.get_device_name(0) if card == "cuda" else None
    launches = collections.Counter(lost_launches)
    for k, worker in workers.items():
        backend = backends[f"replica-{k}"]
        used = worker["stats"]["efficiency"]["backend"]
        if used != card or backend["backend"] != card:
            fail(f"fleet: replica {k} ran on {used} / {backend}")
        if card == "cuda":
            # binary_factor_update.cu ran in every worker: its edge
            # entry, or its lane entry where the worker's flushes were
            # all lane-packed (the restarted worker's replay may be).
            counts = backend.get("kernel_launches", {})
            if backend.get("device_name") != kind \
                    or "binary_factor_update" not in backend.get(
                        "kernel_libraries", ()) \
                    or not any(n for name, n in counts.items()
                               if name.startswith("binary_factor_update")):
                fail(f"fleet: replica {k} reports {backend}")
            launches.update(counts)

    # The answers: every one against its solo solve, card and CPU.
    t_check = time.perf_counter()
    where = [card] if card == "cpu" else [card, "cpu"]
    got = collections.defaultdict(list)
    for key, res in served.items():
        got[key].append(res)
    for key, (_code, res) in answered.items():
        got[key].append(res)
    flagship_got = list(flagship_served)
    if elastic:
        for key, results in elastic_out.pop("answers").items():
            got[key].extend(results)
        flagship_got.append(elastic_out.pop("flagship_answer"))
    check_fleet_answers(api, mixed_dcop, got, where, flagship=flagship,
                        flagship_answers=flagship_got)
    check_s = time.perf_counter() - t_check
    return dict(
        replicas=FLEET_REPLICAS, device=card, prep_s=prep_s,
        fixed_legs_s=fixed_s, elastic=elastic_out,
        start_s=start_s, restart_s=restart_s,
        answered_after_kill_s=answered_s, served_s=served_s,
        check_s=check_s,
        mixed=dict(requests=len(draws), clients=SERVE_MIXED_CLIENTS,
                   stream_s=stream_s,
                   problems_per_s=len(draws) / stream_s,
                   p50_ms=_percentile(latencies, 50) * 1e3,
                   p99_ms=_percentile(latencies, 99) * 1e3,
                   distinct_instances=len(served),
                   ledger_mean_s=_mean_ledger(list(served.values())),
                   slowest_ledger_s=max(
                       (r["ledger"] for r in served.values()),
                       key=lambda ledger: sum(ledger.values()))),
        flagship_bin=dict(members=FLEET_BIN_MEMBERS, n_vars=FLAGSHIP_VARS,
                          cycles=FLEET_BIN_CYCLES, wall_s=bin_s,
                          ledgers_s=[r["ledger"] for r in flagship_served],
                          flushes=[r["batch"] for r in flagship_served],
                          replicas=sorted({router.pinned(r["id"]).index
                                           for r in flagship_served})),
        kill=dict(requests=len(acks), victim=victim.index,
                  owned_by_victim=owners[victim.index],
                  pending_at_kill=pending_at_kill, replayed=replayed,
                  lost=0),
        affinity_hit_fraction=stats["affinity_hit_fraction"],
        routed=stats["routed"], reroutes=stats["reroutes"],
        worker_exits=exits[:FLEET_REPLICAS],
        workers={k: dict(
            backend=backends[f"replica-{k}"]["backend"],
            device_name=backends[f"replica-{k}"].get("device_name"),
            kernel_libraries=backends[f"replica-{k}"].get(
                "kernel_libraries"),
            forwarded=w["forwarded"], restarts=w["restarts"],
            dispatches=w["stats"]["dispatches"],
            lane_dispatches=w["stats"]["lane_dispatches"],
            envelope_dispatches=w["stats"]["envelope_dispatches"])
            for k, w in workers.items()},
        launches=dict(launches))


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
    cpu_graph = graph_from_numpy(var_costs, var_valid, buckets, device="cpu")
    t0 = time.perf_counter()
    cpu_scale = final_run(ops, state_to_numpy, cpu_graph, SCALE_CYCLES)
    cpu_scale_s = time.perf_counter() - t0
    del var_costs, var_valid, buckets
    diff = run_differences(first, cpu_scale)
    if diff:
        fail(f"scale leg: card run != CPU run in {diff}")
    # The whole-graph totals of the final values (MaxSum's constraint
    # cost, the local search's cost with the real unary costs): card =
    # CPU bit for bit.
    from pydcop_tpu_torch.ops.localsearch import assignment_cost

    final_values = torch.from_numpy(cpu_scale[1])
    with_sentinel = torch.cat([final_values.to(torch.int32),
                               torch.zeros(1, dtype=torch.int32)])
    scale_totals = {}
    for name, fn, vals in (
            ("assignment_constraint_cost", ops.assignment_constraint_cost,
             final_values),
            ("assignment_cost", assignment_cost, with_sentinel)):
        on_card = fn(graph, vals.cuda())
        on_cpu = fn(cpu_graph, vals)
        if (on_card.cpu().numpy().view(np.uint32)
                != on_cpu.numpy().view(np.uint32)):
            fail(f"scale leg: {name} on the card {float(on_card)} != CPU "
                 f"{float(on_cpu)}")
        scale_totals[name] = float(on_card)
    # The fused cost gather at scale: one launch, timed beside its bound.
    ctx["window_scale_gather"] = window_gather_timing(
        torch, ops, _build, graph,
        [(b.costs.numpy(), b.var_ids.numpy()) for b in cpu_graph.buckets],
        final_values.cuda())
    del first, cpu_scale, cpu_graph
    emit("scale_leg", n_vars=SCALE_VARS, n_factors=graph.buckets[0]
         .costs.shape[0], cycles=SCALE_CYCLES,
         s_per_cycle=scale_s / SCALE_CYCLES, cost=scale_cost,
         launches=grew, peak_mem_bytes=peak_scale,
         bit_equal=["card run 1", "card run 2", "CPU run"],
         cpu_s=cpu_scale_s, totals_card_equal_cpu=scale_totals)

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
    ctx["scale_edge"] = scale_graph
    del graph, scale_graph

    # 6c. The exact slice's kernel: the whole-graph totals in XLA's
    # order, against its plain version and a numpy model, timed.
    from pydcop_tpu_torch.ops import window_sum as window_sum_mod

    wsum = phase_window_sum(ctx, ls_launches[window_sum_mod.COUNTER])
    emit("window_sum_check", **wsum)

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

    # 11. The exact slice: DPOP on the reference's instances and on a
    # band whose UTIL tables are real work, SyncBB and NCBB on the
    # fixtures, and the CLI.
    emit("dpop_exact", **phase_dpop_exact(ctx))
    emit("dpop_wide", **phase_dpop_wide(ctx))
    emit("tree_search", **phase_tree_search(ctx))
    emit("dpop_cli", **phase_dpop_cli(ctx))

    # 12. This slice: the portfolio race behind algo="auto" and the
    # dynamic engine's scenario replay, each with the launch counts set
    # to 0 just before it and read just after.
    portfolio = phase_portfolio(ctx)
    emit("portfolio", **portfolio)
    dyn = phase_dynamic(ctx)
    emit("dynamic", **dyn)
    new_paths = {"portfolio": portfolio["launches"],
                 "portfolio_replay": portfolio["replay"]["launches"],
                 "portfolio_domino": portfolio["domino"]["launches"],
                 "dynamic": dyn["launches"]}

    # 13. The batch and lane slice: the lane entries against their plain
    # versions, the lane layout's solve, the stacked solve of 64
    # instances as one union, and envelope / lane packing of 24
    # structures; each path with the launch counts set to 0 just before
    # it and read just after.
    from pydcop_tpu_torch.engine.compile import (
        CompiledFactorGraph,
        FactorBucket,
    )

    lane_engine = build_engine(dcop, dict(params, layout="lane"))
    var_costs, var_valid, buckets = scale_arrays(SCALE_VARS)
    scale_host = CompiledFactorGraph(var_costs, var_valid, tuple(
        FactorBucket(c, ids) for c, ids in buckets))
    del var_costs, var_valid, buckets
    scale_lane = lane_graph_of(ctx, scale_host, "cuda")
    lane_check = phase_lane_kernel_check(ctx, lane_engine.graph, scale_lane)
    timing.update(lane_check.pop("timing"))
    max_err.update(lane_check["max_abs_err"])
    emit("lane_kernel_check", **lane_check)
    lane = phase_lane_layout(ctx, lane_engine, scale_host, scale_lane,
                             ctx.pop("scale_edge"))
    emit("lane_layout", **lane)
    del lane_engine, scale_host, scale_lane
    stacked = phase_batch_stacked(ctx)
    emit("batch_stacked", **stacked)
    packed = phase_batch_envelope_lane(ctx)
    emit("batch_envelope_lane", **packed)
    new_paths.update({"lane_layout": lane["launches"],
                      "batch_stacked": stacked["launches"],
                      "batch_envelope": packed["envelope"]["launches"],
                      "batch_lane": packed["lane"]["launches"]})

    # 14. The serving slice: api.serve on the card, five legs (the
    # flagship bin, the mixed stream, a session, journal recovery,
    # dpop), with the launch counts set to 0 just before and read
    # after the served legs.
    serve = phase_serve(ctx)
    emit("serve", **serve)
    emit("serve_problems_per_s", card=smi,
         mixed_stream=serve["mixed"]["problems_per_s"],
         flagship_bin_warm=serve["bin"]["warm_problems_per_s"])
    emit("serve_latency_ms", card=smi, p50=serve["mixed"]["p50_ms"],
         p99=serve["mixed"]["p99_ms"])
    emit("serve_seconds", card=smi, served_s=serve["served_s"],
         check_s=serve["check_s"], legs_s=serve["legs_s"],
         pipelined_share=serve["pipelined_share"])
    new_paths["serve"] = serve["launches"]

    # 15. The partitioned slice: ShardedMaxSumEngine on meshes naming
    # the card 2, 4 and 8 times (card = CPU after every cycle), the
    # S = 4 flagship path with the launch counts set to 0 just before it
    # and read just after, the scale arrays at S = 4, halo_sum.cu and the
    # boundary partial against their plain versions, a trip_shard run.
    ctx["scale_ms_per_cycle"] = scale_s / SCALE_CYCLES * 1e3
    sharded = phase_sharded(ctx)
    emit("sharded", **sharded)
    emit("sharded_ms_per_cycle", card=smi, **sharded["ms_per_cycle"],
         scale_S4=sharded["scale"]["ms_per_cycle"],
         scale_unsharded=sharded["scale"]["unsharded_ms_per_cycle"])
    new_paths["sharded"] = sharded["main"]["launches"]

    # 16. The fleet slice: api.serve(replicas=2) on the card, two
    # worker processes behind the router; the mixed stream, a flagship
    # bin, SIGKILL mid-burst.  The launches are the workers' own counts
    # (each process starts at 0), summed over the live workers and the
    # killed one's last report.
    fleet = phase_fleet(ctx)
    elastic = fleet.pop("elastic")
    emit("fleet", **fleet)
    emit("fleet_problems_per_s", card=smi,
         fleet_mixed_stream=fleet["mixed"]["problems_per_s"],
         serve_mixed_stream=serve["mixed"]["problems_per_s"])
    emit("fleet_latency_ms", card=smi, fleet_p50=fleet["mixed"]["p50_ms"],
         fleet_p99=fleet["mixed"]["p99_ms"],
         serve_p50=serve["mixed"]["p50_ms"],
         serve_p99=serve["mixed"]["p99_ms"])
    emit("fleet_seconds", card=smi, phase_s=fleet["served_s"],
         check_s=fleet["check_s"], worker_start_s=fleet["start_s"],
         worker_restart_s=fleet["restart_s"],
         answered_after_kill_s=fleet["answered_after_kill_s"],
         flagship_bin_s=fleet["flagship_bin"]["wall_s"],
         affinity_hit_fraction=fleet["affinity_hit_fraction"])
    new_paths["fleet"] = fleet["launches"]

    # 17. The elastic slice, on the fleet phase's router: a scale-up
    # whose prewarm runs on the card, a joined worker, a scale-down
    # drain and the joined worker's SIGKILL.  The launches are the
    # scaled-up and the joined workers' own counts (each process starts
    # at 0), read from their /profile.
    workers = elastic.pop("workers")
    emit("fleet_elastic", card=smi, **elastic,
         scaled_up_worker={k: workers["scaled_up"].get(k) for k in (
             "device_name", "kernel_libraries", "compile_cache")},
         joined_worker={k: workers["joined"].get(k) for k in (
             "device_name", "kernel_libraries", "compile_cache")})
    up = elastic["scale_up"]
    emit("fleet_elastic_problems_per_s", card=smi,
         three_workers=up["stream"]["problems_per_s"],
         fixed_fleet=fleet["mixed"]["problems_per_s"])
    emit("fleet_elastic_latency_ms", card=smi,
         three_workers_p50=up["stream"]["p50_ms"],
         three_workers_p99=up["stream"]["p99_ms"],
         fixed_fleet_p50=fleet["mixed"]["p50_ms"],
         fixed_fleet_p99=fleet["mixed"]["p99_ms"],
         scaled_up_first_routed=up["first_routed_ms"])
    emit("fleet_elastic_seconds", card=smi, legs_s=elastic["legs_s"],
         spawn_s=up["spawn_s"], prewarm_s=up["prewarm_s"],
         join_s=elastic["join"]["join_s"],
         scale_down_s=elastic["scale_down"]["armed_to_retired_s"],
         remote_verdict_s=elastic["remote_death"]["verdict_s"],
         remote_adopted_s=elastic["remote_death"]["adopted_s"],
         fixed_legs_s=fleet["fixed_legs_s"])
    new_paths["elastic"] = elastic["launches"]

    # 18. The generators slice: the port's generators make six problem
    # families in this process; each is solved with maxsum, dsa and mgm
    # on the card and on the CPU (card = CPU), with the launch counts
    # set to 0 before each card solve and read after it;
    # factor_to_var's n-ary buckets timed; the generate / graph / solve
    # CLI leg on a small generated file.
    generated = phase_generated(ctx)
    emit("generated", card=smi, **generated)
    emit("generated_seconds", card=smi, phase_s=generated["seconds"],
         generate_s={k: r["generate_s"]
                     for k, r in generated["problems"].items()})
    emit("factor_to_var_ms", card=smi, **generated["factor_to_var"])
    new_paths["generated"] = generated["launches"]

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
    wt = wsum["timing"]
    rows.append({
        "name": "window_sum", "route": "cuda",
        "source": "pydcop_tpu_torch/csrc/window_sum.cu",
        "replaces": "pydcop_tpu/ops/localsearch.py:139",
        "launches": ls_launches[window_sum_mod.COUNTER],
        "launches_by_path": {label: n[window_sum_mod.COUNTER]
                             for label, n in ls_launches["by_path"].items()
                             if n[window_sum_mod.COUNTER]},
        "launches_per_traced_maxsum_cycle": wsum[
            "launches_per_traced_maxsum_cycle"],
        "max_abs_err": wsum["max_abs_err"], "ms": wt["ms"],
        "plain_ms": wt["plain_ms"], "bound_ms": wt["bound_ms"],
        "bound_by": wt["bound_by"], "library_ms": wt["library_ms"],
        "shapes": {"scale_gather": {k: wsum["scale_gather"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "torch_ops_ms", "launches_per_call")}} if wsum.get(
                "scale_gather") else {}})
    from pydcop_tpu_torch.ops.binary_factor import LANE
    from pydcop_tpu_torch.ops.lane_sum import KERNEL as LANE_SUM
    from pydcop_tpu_torch.ops.lane_var_update import SEND, V2F

    for name, counter, source, replaces in (
            ("binary_factor_update: lane", LANE,
             "pydcop_tpu_torch/csrc/binary_factor_update.cu",
             "pydcop_tpu/ops/pallas_maxsum.py:54"),
            ("lane_sum", LANE_SUM, "pydcop_tpu_torch/csrc/lane_sum.cu",
             "pydcop_tpu/ops/maxsum_lane.py:318"),
            ("lane_var_update: v2f", V2F,
             "pydcop_tpu_torch/csrc/lane_var_update.cu",
             "pydcop_tpu/ops/maxsum_lane.py:332"),
            ("lane_var_update: send", SEND,
             "pydcop_tpu_torch/csrc/lane_var_update.cu",
             "pydcop_tpu/ops/maxsum_lane.py:286")):
        flag = timing[name]["flagship"]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": lane["launches"][counter],
            "max_abs_err": max_err[name], "ms": flag["ms"],
            "plain_ms": flag["plain_ms"], "bound_ms": flag["bound_ms"],
            "bound_by": flag["bound_by"], "library_ms": flag["library_ms"],
            "shapes": {label: {k: row[k] for k in keys if k in row}
                       for label, row in timing[name].items()
                       if label != "flagship"}})
    main_halo = sharded["halo_sum_timing"][f"flagship_S{SHARD_MAIN}"]
    rows.append({
        "name": "halo_sum", "route": "cuda",
        "source": "pydcop_tpu_torch/csrc/halo_sum.cu",
        "replaces": "pydcop_tpu/engine/sharding.py:426",
        "launches": sharded["main"]["launches"]["halo_sum"],
        "max_abs_err": max(row["max_abs_err"] for row in
                           sharded["halo_sum_timing"].values()),
        "ms": main_halo["ms"],
        "plain_ms": main_halo["plain_ms"], "bound_ms": main_halo["bound_ms"],
        "bound_by": main_halo["bound_by"],
        "library_ms": main_halo["library_ms"],
        "timed_input_mb": main_halo["timed_input_mb"],
        "shapes": {label: {k: row[k] for k in (
            "S", "B", "D", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "timed_input_mb")}
            for label, row in sharded["halo_sum_timing"].items()
            if label != f"flagship_S{SHARD_MAIN}"}})
    sub = sharded["subset_sum_timing"]
    scale_sub = sharded["subset_sum_timing_scale"]
    rows.append({
        "name": "segment_sum: halo", "route": "cuda",
        "source": "pydcop_tpu_torch/csrc/segment_sum.cu",
        "replaces": "pydcop_tpu/engine/sharding.py:439",
        "launches": sharded["main"]["launches"][seg_mod.HALO],
        "max_abs_err": sub["max_abs_err"], "ms": sub["ms"],
        "plain_ms": sub["plain_ms"],
        "bound_ms": sub["bound_ms"], "bound_by": sub["bound_by"],
        "library_ms": sub["library_ms"],
        "beyond_bound": sub.get("beyond_bound"),
        "shapes": {f"scale_S{SHARD_SCALE}": {k: scale_sub[k] for k in (
            "Eb", "B", "D", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err")}}})
    counter_of = {
        "halo_sum": "halo_sum", "segment_sum: halo": seg_mod.HALO,
        "binary_factor_update: lane": LANE, "lane_sum": LANE_SUM,
        "lane_var_update: v2f": V2F, "lane_var_update: send": SEND,
        "binary_factor_update": "binary_factor_update",
        "segment_sum": "segment_sum", "var_update": "var_update",
        "segment_sum: positional_table": seg_mod.POSITIONAL_TABLE,
        "segment_sum: positional": seg_mod.POSITIONAL,
        "threefry: uniform_f32": threefry.UNIFORM,
        "threefry: best_choice": threefry.BEST_CHOICE,
        "window_sum": window_sum_mod.COUNTER}
    for row in rows:
        by_path = row.setdefault("launches_by_path", {})
        for path, counts in new_paths.items():
            by_path[path] = counts.get(counter_of[row["name"]], 0)
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
    sys.exit({"--lane-profiles": lane_profiles,
              "--shard-profile": shard_profile}.get(
                  " ".join(sys.argv[1:]), run)())
