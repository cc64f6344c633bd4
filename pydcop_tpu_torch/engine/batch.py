"""Batched multi-instance solving: many DCOPs in one device dispatch.

Port of ``pydcop_tpu/engine/batch.py``.  The host half is copied:
``DEFAULT_BIN_SIZES``, :func:`stack_graphs`, :func:`bin_size_for`,
:func:`pad_to_bin`, :func:`pad_graph_to_envelope` and
:func:`stack_to_envelope` (numpy, the arrays equal to the
reference's).

The reference solves a stack with ``jax.vmap(run_maxsum)``: one
program over the instance axis.  Here no kernel has a batch axis: the
stack is placed once as ONE disjoint-union graph (:func:`stack_union`:
member m's variable rows, its own sentinel included, at ``m * (V +
1)``, each bucket's rows concatenated member after member with the ids
offset), and the edge-layout superstep runs on it, so every kernel
launches once a cycle for the whole stack.  Message passing never
crosses members, so each member's messages are the ones the vmapped
reference computes for its lane, given the same order of every sum:

- the belief sum's bucket fold is read off ONE member's shapes (what
  each vmapped lane sees): :func:`stacked_fold`, which is
  ``segment_sum.separate_buckets`` with no one-edge bucket moved (under
  vmap a one-edge bucket's scatter has a row per lane, and XLA does not
  rewrite it into a one-row update as it does for a solo solve) — for
  a stack of one, the solo fold (:func:`member_fold`);
- ``stable`` is per member: after the fixed cycle count every edge of
  the member matched its last message (count >= 2, both directions),
  reduced on the card and read once at the end;
- with ``prune`` the phase predicate is the union's (every member's
  survivors fit); pruning never changes a value, so the results are the
  same either way.

:func:`run_lane_packed` solves a different-structure group as one
lane-major union (``ops.maxsum_lane.pack_graphs``).
:func:`launch_stacked`/:func:`launch_lane_packed` queue a warm dispatch
on a side stream of the card and return at once;
:func:`collect_stacked`/:func:`collect_lane_packed` wait on its event
(``engine.timing.launch_engine_call``).  Nothing between the two
synchronises the host: the graph is placed through pinned memory and
the outputs come back the same way.  A cold dispatch (a stack shape not
run yet in this process, so kernels may still have to be built)
returns ``None``, as the reference's does, and the caller runs it
synchronously.
"""

import contextlib
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import (
    DeviceLike,
    aggregation_strategy,
    resolve_device,
    to_device_graph,
    to_lane_device_graph,
)
from pydcop_tpu_torch.engine.compile import (
    BIG,
    CompiledFactorGraph,
    FactorBucket,
    FactorGraphMeta,
    build_aggregation_arrays,
    compile_dcop,
)
from pydcop_tpu_torch.engine.runner import DeviceRunResult
from pydcop_tpu_torch.engine.timing import (
    finish_engine_call,
    launch_engine_call,
    timed_engine_call,
)
from pydcop_tpu_torch.observability import efficiency
from pydcop_tpu_torch.observability.profiler import profiler
from pydcop_tpu_torch.observability.trace import tracer
from pydcop_tpu_torch.ops import maxsum as maxsum_ops
from pydcop_tpu_torch.ops import maxsum_lane as lane_ops
from pydcop_tpu_torch.ops.segment_sum import separate_buckets
from pydcop_tpu_torch.serving.binning import (
    envelope_key,
    graph_cells,
    lane_cells,
)

# Batch-size ladder used when a caller asks for bin padding without
# giving one: powers of two keep the compiled-program count per
# structure logarithmic in the largest batch.
DEFAULT_BIN_SIZES = (1, 2, 4, 8, 16, 32, 64)

# Dispatch keys already run once in this process (the reference's jit
# warmth): a launch of another key is cold.
_warm: set = set()


def stack_graphs(
    graphs: Sequence[CompiledFactorGraph],
) -> CompiledFactorGraph:
    """Stack same-shaped compiled graphs along a new leading axis (host
    numpy, the reference's pytree stack)."""
    shapes = [
        (g.var_costs.shape,) + tuple(b.costs.shape for b in g.buckets)
        for g in graphs
    ]
    if any(s != shapes[0] for s in shapes):
        raise ValueError(
            "Batched solving requires identical compiled shapes; got "
            f"{sorted(set(shapes))}"
        )

    def stack(xs):
        return None if xs[0] is None else np.stack(
            [np.asarray(x) for x in xs])

    first = graphs[0]
    return CompiledFactorGraph(
        var_costs=stack([g.var_costs for g in graphs]),
        var_valid=stack([g.var_valid for g in graphs]),
        buckets=tuple(
            FactorBucket(costs=stack([g.buckets[k].costs for g in graphs]),
                         var_ids=stack([g.buckets[k].var_ids
                                        for g in graphs]))
            for k in range(len(first.buckets))),
        **{name: stack([getattr(g, name) for g in graphs])
           for name in ("agg_perm", "agg_sorted_seg", "agg_starts",
                        "agg_ends", "agg_ell")},
    )


def bin_size_for(n: int, bin_sizes: Sequence[int]) -> int:
    """Smallest ladder size >= n; n itself when the ladder tops out
    below it (an oversized dispatch runs once at its exact size rather
    than failing)."""
    for b in sorted(bin_sizes):
        if b >= n:
            return b
    return n


def pad_to_bin(
    graphs: Sequence[CompiledFactorGraph],
    bin_sizes: Sequence[int] = DEFAULT_BIN_SIZES,
) -> Tuple[List[CompiledFactorGraph], int, float]:
    """Pad a graph list up to the next bin size by repeating the last
    instance.  Returns (padded_graphs, n_real, pad_fraction) — padded
    lanes solve a duplicate problem whose results the caller drops."""
    n_real = len(graphs)
    if n_real == 0:
        return [], 0, 0.0
    target = bin_size_for(n_real, bin_sizes)
    padded = list(graphs) + [graphs[-1]] * (target - n_real)
    return padded, n_real, (target - n_real) / target


def _array_cells(graph: CompiledFactorGraph) -> int:
    """Total var-table + bucket-hypercube elements (the waste unit),
    shared with the pack-vs-solo cost model (``binning.graph_cells``)."""
    return graph_cells(graph)


def pad_graph_to_envelope(graph: CompiledFactorGraph,
                          env) -> CompiledFactorGraph:
    """Mask-pad a compiled graph up to a shape envelope
    (``serving.binning.Envelope``, duck-typed: ``v_env``/``d_env``/
    ``rows``).  Every padding element is inert by the compiler's own
    masking, so the padded graph's real variables compute the same
    messages:

    - domain slots ``d..d_env``: ``BIG`` cost, ``var_valid=False``;
    - variable rows ``v..v_env``: invalid rows no factor references;
    - bucket rows ``F..rows_env``: zero-cost rows whose ``var_ids``
      all point at the sentinel row ``v_env``.

    The envelope must COVER the graph (each dimension >= the real
    size, identical arity set) — a violated envelope raises instead of
    silently truncating.  Aggregation arrays are dropped (scatter)."""
    v, d = graph.n_vars, graph.dmax
    by_arity = {b.arity: b for b in graph.buckets}
    env_rows = dict(env.rows)
    if env.v_env < v or env.d_env < d:
        raise ValueError(
            f"envelope (v={env.v_env}, d={env.d_env}) does not cover "
            f"graph (v={v}, d={d})")
    if set(env_rows) != set(by_arity):
        raise ValueError(
            f"envelope arities {sorted(env_rows)} != graph arities "
            f"{sorted(by_arity)}")
    for a, b in by_arity.items():
        if env_rows[a] < b.n_factors:
            raise ValueError(
                f"envelope rows {env_rows[a]} < {b.n_factors} factors "
                f"at arity {a}")
    if (env.v_env == v and env.d_env == d
            and all(env_rows[a] == b.n_factors
                    for a, b in by_arity.items())):
        # Exact fit: nothing to pad, but the aggregation arrays still
        # go, so every member of a stack has the same structure.
        if all(a is None for a in (graph.agg_perm,
                                   graph.agg_sorted_seg,
                                   graph.agg_starts, graph.agg_ends,
                                   graph.agg_ell)):
            return graph
        return CompiledFactorGraph(
            var_costs=graph.var_costs, var_valid=graph.var_valid,
            buckets=graph.buckets,
        )

    ve, de = env.v_env, env.d_env
    dtype = graph.var_costs.dtype
    var_costs = np.full((ve + 1, de), BIG, dtype=dtype)
    var_costs[:v, :d] = np.asarray(graph.var_costs)[:v]
    var_valid = np.zeros((ve + 1, de), dtype=bool)
    var_valid[:v, :d] = np.asarray(graph.var_valid)[:v]

    buckets = []
    for a in sorted(env_rows):
        b = by_arity[a]
        n_facs = b.n_factors
        costs = np.zeros((env_rows[a],) + (de,) * a,
                         dtype=b.costs.dtype)
        if n_facs:
            block = np.full((n_facs,) + (de,) * a, BIG,
                            dtype=b.costs.dtype)
            block[(slice(None),) + (slice(0, d),) * a] = \
                np.asarray(b.costs)
            costs[:n_facs] = block
        ids = np.full((env_rows[a], a), ve, dtype=np.int32)
        real_ids = np.asarray(b.var_ids).copy()
        # Re-point the graph's own sentinel (index v) at the
        # envelope's (index ve).
        real_ids[real_ids == v] = ve
        ids[:n_facs] = real_ids
        buckets.append(FactorBucket(costs=costs, var_ids=ids))
    return CompiledFactorGraph(
        var_costs=var_costs, var_valid=var_valid,
        buckets=tuple(buckets),
    )


def stack_to_envelope(
    graphs: Sequence[CompiledFactorGraph], env,
) -> Tuple[List[CompiledFactorGraph], List[float]]:
    """Pad a *different*-structure group up to one shape envelope so
    it stacks into a single dispatch.  Returns ``(padded_graphs,
    envelope_waste)`` — per-member wasted fraction of the envelope's
    cells (``1 - real/envelope``)."""
    padded = [pad_graph_to_envelope(g, env) for g in graphs]
    waste = [
        round(1.0 - _array_cells(g) / max(_array_cells(p), 1), 4)
        for g, p in zip(graphs, padded)
    ]
    return padded, waste


# ------------------------------------------------------------------ #
# The stacked solve on the device: one disjoint union.


def stacked_fold(graph: CompiledFactorGraph) -> Tuple[Tuple[int, ...], int]:
    """The belief sum's bucket ``(order, sep)`` of one member as the
    vmapped reference sums it: the buckets in their own order,
    ``separate_buckets`` of their edge counts over the member's V + 1
    rows (no one-edge bucket moves under vmap).  This holds for stacks
    of two members or more: a stack of one is summed as a solo solve
    (:func:`member_fold`)."""
    sizes = [b.var_ids.size for b in graph.buckets]
    starts = np.cumsum([0] + sizes).tolist()
    order = tuple(range(len(sizes)))
    if len(sizes) < 2:
        return order, 0
    return order, separate_buckets(starts, graph.var_costs.shape[0])


def member_fold(graphs: Sequence[CompiledFactorGraph]):
    """The ``fold`` to place a stack of ``graphs`` with:
    :func:`stacked_fold` of the first member, or None (the solo solve's
    own fold, ``segment_sum.positional_fold``) for a stack of one —
    XLA drops a batch axis of one, and then moves a one-edge bucket's
    one-row update as it does for a solo solve."""
    return stacked_fold(graphs[0]) if len(graphs) > 1 else None


def stack_union(graphs: Sequence[CompiledFactorGraph]
                ) -> CompiledFactorGraph:
    """The disjoint union of same-shaped graphs (host numpy): member m's
    variable rows (its sentinel last) at ``m * (V + 1)``, each bucket
    the members' rows one after the other with the ids offset.  A
    ``sorted`` stack keeps its strategy (its arrays rebuilt over the
    union); ``ell`` and ``boundary`` stacks are not supported."""
    first = graphs[0]
    strategy = aggregation_strategy(first)
    if strategy not in ("scatter", "sorted"):
        raise NotImplementedError(
            f"the stacked solve supports the scatter and sorted "
            f"aggregations, not {strategy!r}")
    rows = first.var_costs.shape[0]
    buckets = tuple(
        FactorBucket(
            costs=np.concatenate([np.asarray(g.buckets[k].costs)
                                  for g in graphs]),
            var_ids=np.concatenate([
                np.asarray(g.buckets[k].var_ids).astype(np.int32)
                + np.int32(m * rows) for m, g in enumerate(graphs)]))
        for k in range(len(first.buckets)))
    var_costs = np.concatenate([np.asarray(g.var_costs) for g in graphs])
    union = CompiledFactorGraph(
        var_costs=var_costs,
        var_valid=np.concatenate([np.asarray(g.var_valid)
                                  for g in graphs]),
        buckets=buckets)
    if strategy == "sorted":
        perm, sorted_seg, _, _, _ = build_aggregation_arrays(
            buckets, var_costs.shape[0], "sorted", d=var_costs.shape[1])
        union = union._replace(agg_perm=perm, agg_sorted_seg=sorted_seg)
    return union


def _member_stable(counts: Sequence[torch.Tensor], n: int,
                   device: torch.device) -> torch.Tensor:
    """[n] bool: every edge of member m, in every bucket and both
    directions, matched its last message (count >= 2) — the member's
    ``stable`` after a fixed cycle count of at least one."""
    ok = torch.ones((n,), dtype=torch.bool, device=device)
    for c in counts:
        ok = ok & (c.reshape(n, -1) >= 2).all(dim=1)
    return ok


def _stacked_solve(graphs, fold, device, statics, non_blocking=False):
    """Place the union of ``graphs`` and run the fixed-cycle solve: the
    device tensors (values [B, V] int32, cycles [B] int32, stable [B]
    bool)."""
    n = len(graphs)
    rows = graphs[0].var_costs.shape[0]
    placed = to_device_graph(stack_union(graphs), device, fold=fold,
                             non_blocking=non_blocking)
    state, values = maxsum_ops.run_maxsum(
        placed, statics["max_cycles"], damping=statics["damping"],
        damp_vars=statics["damp_vars"],
        damp_factors=statics["damp_factors"],
        stability=statics["stability"], stop_on_convergence=False,
        prune=statics["prune"])
    # select_values drops the union's last row (the last member's
    # sentinel): put it back, then drop every member's own.
    values = torch.cat([values, values.new_zeros(1)]).view(n, rows)
    stable = _member_stable(state.v2f_count + state.f2v_count, n,
                            placed.var_costs.device)
    if statics["max_cycles"] < 1:
        stable = torch.zeros_like(stable)
    cycles = state.cycle.expand(n).to(torch.int32)
    return values[:, :rows - 1].contiguous(), cycles.contiguous(), stable


def _shape_signature(graphs) -> tuple:
    g = graphs[0]
    return ((len(graphs),) + g.var_costs.shape,) + tuple(
        (len(graphs),) + b.costs.shape for b in g.buckets)


# The rollup's per-structure cell label (one definition, shared with
# the dynamic engine — observability/efficiency.py).
_structure_label = efficiency.structure_label


class _StackedPrep(NamedTuple):
    """Host-side assembly of one stacked dispatch, shared by the
    synchronous and launched paths."""

    graphs: tuple
    fold: Optional[tuple]
    statics: dict
    key: tuple
    n_real: int
    pad_fraction: float
    envelope_waste: Optional[List[float]]
    max_cycles: int
    t_pack: float


class PendingDispatch(NamedTuple):
    """A launched, uncollected device dispatch: the card runs it while
    the host does other work.  Produced by :func:`launch_stacked` /
    :func:`launch_lane_packed`, consumed once by the matching
    ``collect_*``."""

    kind: str         # "stacked" | "lane"
    raw: Any          # engine.timing.Launched
    prep: Any
    key: tuple
    t_launch: float


def _prepare_stacked(graphs, max_cycles, damping, damping_nodes,
                     stability, pad_to_bins, prune,
                     envelope) -> _StackedPrep:
    if not graphs:
        raise ValueError("run_stacked needs at least one graph")
    t_pack = time.perf_counter()
    envelope_waste: Optional[List[float]] = None
    if envelope is not None:
        graphs, envelope_waste = stack_to_envelope(graphs, envelope)
    n_real = len(graphs)
    pad_fraction = 0.0
    if pad_to_bins is not None:
        graphs, n_real, pad_fraction = pad_to_bin(graphs, pad_to_bins)
    stack_graphs(graphs)   # the same-shape check
    statics = dict(
        max_cycles=max_cycles,
        damping=damping,
        damp_vars=damping_nodes in ("vars", "both"),
        damp_factors=damping_nodes in ("factors", "both"),
        stability=stability,
        prune=prune,
    )
    key = (
        "maxsum_batch", len(graphs), _shape_signature(graphs),
        tuple(sorted(statics.items())),
    )
    return _StackedPrep(tuple(graphs), member_fold(graphs), statics,
                        key, n_real, pad_fraction, envelope_waste,
                        max_cycles, t_pack)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _record(metrics, key, structure, run_s, compile_s, cycles, n_real,
            batch_size, pad_fraction, envelope_waste, packing):
    """The efficiency plane's dispatch sample (behind its enabled
    gate: ``PYDCOP_EFFICIENCY=0`` does no work)."""
    if not efficiency.tracker.enabled:
        return
    record = efficiency.tracker.record_dispatch(
        key=str(key), structure=structure,
        backend=efficiency.backend_name(),
        time_s=run_s, compile_s=compile_s, cycles=cycles,
        n_real=n_real, batch_size=batch_size,
        pad_fraction=pad_fraction, envelope_waste=envelope_waste,
        packing=packing,
        cost_entry=profiler.get(key) if profiler.enabled else None)
    if record is not None:
        metrics["efficiency"] = record


def _finish_stacked(prep: _StackedPrep, values, cycles, stable,
                    elapsed: float, compile_s: float, run_s: float,
                    t0: float, pipelined: bool = False):
    """Decode + accounting tail shared by both dispatch paths: one copy
    of the outputs to the host, the DeviceRunResult metrics and the
    efficiency plane's dispatch sample."""
    n_real = prep.n_real
    values = _host(values)[:n_real]
    cycles = _host(cycles)[:n_real]
    stable = _host(stable)[:n_real]
    batch_result = DeviceRunResult(
        assignment={},
        cycles=int(cycles.max()) if cycles.size else 0,
        converged=bool(stable.all()) if stable.size else False,
        time_s=elapsed,
        compile_time_s=compile_s,
        metrics={
            "batch_size": len(prep.graphs),
            "n_real": n_real,
            "pad_fraction": prep.pad_fraction,
            "cold_start": compile_s > 0.0,
            "run_time_s": run_s,
            "pack_host_s": t0 - prep.t_pack,
            "converged_lanes": [bool(s) for s in stable],
            "cells_total": (_array_cells(prep.graphs[0])
                            * len(prep.graphs)),
            "program_key": str(prep.key),
        },
    )
    if pipelined:
        batch_result.metrics["pipelined"] = True
    if prep.envelope_waste is not None:
        envelope_waste = prep.envelope_waste
        batch_result.metrics["packing"] = "envelope"
        batch_result.metrics["envelope_waste_lanes"] = envelope_waste
        batch_result.metrics["envelope_waste"] = round(
            sum(envelope_waste) / len(envelope_waste), 4
        ) if envelope_waste else 0.0
    _record(batch_result.metrics, prep.key,
            _structure_label(prep.graphs[0]), run_s, compile_s,
            prep.max_cycles, n_real, len(prep.graphs), prep.pad_fraction,
            batch_result.metrics.get("envelope_waste", 0.0) or 0.0,
            batch_result.metrics.get("packing") or (
                "batched" if n_real > 1 else "solo"))
    return values, cycles, batch_result


def _span(prep_graphs, n_real, max_cycles, **extra):
    return (tracer.span("engine_segment", "engine",
                        batch_size=len(prep_graphs), n_real=n_real,
                        from_cycle=0, extra_cycles=max_cycles, **extra)
            if tracer.active else contextlib.nullcontext())


def launch_stacked(
    graphs: Sequence[CompiledFactorGraph],
    max_cycles: int = 200,
    damping: float = 0.5,
    damping_nodes: str = "both",
    stability: float = 0.1,
    pad_to_bins: Optional[Sequence[int]] = None,
    prune: bool = False,
    envelope=None,
    device: DeviceLike = "cuda",
) -> Optional[PendingDispatch]:
    """Queue a stacked dispatch without waiting for it (dispatch k+1
    launches while k is still running).  Returns ``None`` when the
    dispatch is COLD (its key not run yet: the kernels' build belongs to
    the synchronous :func:`run_stacked`), and, with ``prune``, always
    (the pruned phase predicate is read on the host every cycle)."""
    prep = _prepare_stacked(graphs, max_cycles, damping,
                            damping_nodes, stability, pad_to_bins,
                            prune, envelope)
    if prep.key not in _warm or prune:
        return None
    dev = resolve_device(device)
    t0 = time.perf_counter()
    raw = launch_engine_call(
        _warm, prep.key,
        lambda: _stacked_solve(prep.graphs, prep.fold, dev, prep.statics,
                               non_blocking=True), dev)
    return PendingDispatch("stacked", raw, prep, prep.key, t0)


def collect_stacked(pending: PendingDispatch):
    """Wait for a :func:`launch_stacked` dispatch and run the shared
    decode/accounting tail.  Returns the same ``(values, cycles,
    batch_result)`` as :func:`run_stacked`; ``run_time_s`` is the
    launch-to-completion wall."""
    prep: _StackedPrep = pending.prep
    with _span(prep.graphs, prep.n_real, prep.max_cycles, pipelined=True):
        (values, cycles, stable), run_s = finish_engine_call(
            pending.key, pending.raw, pending.t_launch)
    elapsed = time.perf_counter() - pending.t_launch
    return _finish_stacked(prep, values, cycles, stable, elapsed,
                           0.0, run_s, pending.t_launch, pipelined=True)


def run_stacked(
    graphs: Sequence[CompiledFactorGraph],
    max_cycles: int = 200,
    damping: float = 0.5,
    damping_nodes: str = "both",
    stability: float = 0.1,
    pad_to_bins: Optional[Sequence[int]] = None,
    prune: bool = False,
    envelope=None,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, np.ndarray, DeviceRunResult]:
    """One device dispatch over a stack of same-shaped compiled graphs.

    All instances run ``max_cycles`` cycles (no convergence stop: a
    converged instance freezes by send suppression, so extra cycles do
    not change its assignment).  With ``pad_to_bins`` the stack is
    padded up the bin ladder first; with ``envelope`` (a
    ``serving.binning.Envelope``) different-structure graphs are
    mask-padded to its shapes first (:func:`stack_to_envelope`).

    Returns ``(values, cycles, batch_result)``: per-instance selected
    value indices / cycle counts for the first ``n_real`` lanes, plus a
    batch-level :class:`DeviceRunResult` whose ``metrics`` carry the
    dispatch accounting (``batch_size``, ``n_real``, ``pad_fraction``,
    ``cold_start``, ``run_time_s``, ``pack_host_s``,
    ``converged_lanes``, ``cells_total``, ``program_key``; with an
    envelope ``packing``, ``envelope_waste`` and
    ``envelope_waste_lanes``) and whose ``assignment`` is empty."""
    prep = _prepare_stacked(graphs, max_cycles, damping,
                            damping_nodes, stability, pad_to_bins,
                            prune, envelope)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    with _span(prep.graphs, prep.n_real, max_cycles):
        (values, cycles, stable), compile_s, run_s = timed_engine_call(
            _warm, prep.key,
            lambda: _stacked_solve(prep.graphs, prep.fold, dev,
                                   prep.statics),
            dev, max_cycles)
    elapsed = time.perf_counter() - t0
    return _finish_stacked(prep, values, cycles, stable, elapsed,
                           compile_s, run_s, t0)


# ------------------------------------------------------------------ #
# Lane packing.


class _LanePrep(NamedTuple):
    """Host-side assembly of one lane-packed dispatch."""

    graphs: tuple
    union: CompiledFactorGraph
    layout: Any
    lane: Any
    statics: dict
    key: tuple
    max_cycles: int
    t_pack: float


def _prepare_lane(graphs, max_cycles, damping, damping_nodes,
                  stability, d_env, ladder) -> _LanePrep:
    if not graphs:
        raise ValueError("run_lane_packed needs at least one graph")
    t_pack = time.perf_counter()
    union, layout = lane_ops.pack_graphs(graphs, d_env=d_env)
    if ladder is not None:
        # Ladder-round the union's variable/row counts so group
        # compositions reuse dispatch shapes — but KEEP the exact
        # domain: the caller grouped by domain rung already.
        union = pad_graph_to_envelope(
            union,
            envelope_key(union, ladder)._replace(d_env=union.dmax))
    lane = lane_ops.to_lane_graph(union)
    statics = dict(
        max_cycles=max_cycles,
        damping=damping,
        damp_vars=damping_nodes in ("vars", "both"),
        damp_factors=damping_nodes in ("factors", "both"),
        stability=stability,
    )
    key = (
        "maxsum_lane_pack",
        (lane.var_costs.shape,)
        + tuple(b.costs.shape for b in lane.buckets),
        tuple(sorted(statics.items())),
    )
    return _LanePrep(tuple(graphs), union, layout, lane, statics,
                     key, max_cycles, t_pack)


def _lane_packed_solve(lane, device, statics, non_blocking=False):
    """Place the lane union and run the fixed-cycle solve: (values,
    cycle, then each bucket's v2f counts, then each bucket's f2v
    counts), device tensors."""
    placed = to_lane_device_graph(lane, device, non_blocking=non_blocking)
    state, values = lane_ops.run_maxsum(
        placed, statics["max_cycles"], damping=statics["damping"],
        damp_vars=statics["damp_vars"],
        damp_factors=statics["damp_factors"],
        stability=statics["stability"], stop_on_convergence=False)
    return (values, state.cycle) + state.v2f_count + state.f2v_count


def _finish_lane(prep: _LanePrep, out, elapsed: float, compile_s: float,
                 run_s: float, t0: float, pipelined: bool = False):
    graphs = prep.graphs
    n_b = len(prep.lane.buckets)
    out = [_host(t) for t in out]
    values, cycle = out[0], out[1]
    v2f_count, f2v_count = out[2:2 + n_b], out[2 + n_b:]
    per_values = [values[s:s + n] for s, n in prep.layout.var_slices]
    converged = lane_ops.converged_per_graph(
        v2f_count, f2v_count, prep.layout)
    n_cycles = int(cycle)
    cycles = np.full((len(graphs),), n_cycles, dtype=np.int32)
    # Members carry only domain-rung padding; the union-level ladder
    # rounding is shared dispatch overhead, in the dispatch figure.
    real_cells = [_array_cells(g) for g in graphs]
    union_cells = max(_array_cells(prep.union), 1)
    member_cells = [lane_cells(g, prep.lane.dmax) for g in graphs]
    lane_waste = [
        round(1.0 - r / max(m, 1), 4)
        for r, m in zip(real_cells, member_cells)
    ]
    batch_result = DeviceRunResult(
        assignment={},
        cycles=n_cycles,
        converged=all(converged),
        time_s=elapsed,
        compile_time_s=compile_s,
        metrics={
            "batch_size": len(graphs),
            "n_real": len(graphs),
            "pad_fraction": 0.0,
            "cold_start": compile_s > 0.0,
            "run_time_s": run_s,
            "pack_host_s": t0 - prep.t_pack,
            "packing": "lane",
            "converged_lanes": [bool(c) for c in converged],
            "envelope_waste_lanes": lane_waste,
            "envelope_waste": round(
                1.0 - sum(real_cells) / union_cells, 4),
            "cells_total": union_cells,
            "program_key": str(prep.key),
        },
    )
    if pipelined:
        batch_result.metrics["pipelined"] = True
    _record(batch_result.metrics, prep.key, _structure_label(prep.union),
            run_s, compile_s, prep.max_cycles, len(graphs), len(graphs),
            0.0, batch_result.metrics["envelope_waste"], "lane")
    return per_values, cycles, batch_result


def run_lane_packed(
    graphs: Sequence[CompiledFactorGraph],
    max_cycles: int = 200,
    damping: float = 0.5,
    damping_nodes: str = "both",
    stability: float = 0.1,
    d_env: Optional[int] = None,
    ladder=None,
    device: DeviceLike = "cuda",
) -> Tuple[List[np.ndarray], np.ndarray, DeviceRunResult]:
    """One device dispatch over a lane-packed DISJOINT UNION of
    different-structure graphs (``ops.maxsum_lane.pack_graphs``):
    members concatenate along the variable axis and each arity's factor
    axis instead of padding to a common hypercube, so only the shared
    domain rung ``d_env`` (default: the group's max) is padded.
    ``ladder`` (a ``serving.binning.EnvelopeLadder``) rounds the
    union's variable/row counts up the ladder with masked sentinel
    rows.

    Returns ``(values, cycles, batch_result)`` like ``run_stacked``,
    with ``values`` a per-member list; ``converged_lanes`` holds
    per-member verdicts recovered from the suppression counters
    (``ops.maxsum_lane.converged_per_graph``)."""
    prep = _prepare_lane(graphs, max_cycles, damping, damping_nodes,
                         stability, d_env, ladder)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    with _span(graphs, len(graphs), max_cycles, packing="lane"):
        out, compile_s, run_s = timed_engine_call(
            _warm, prep.key,
            lambda: _lane_packed_solve(prep.lane, dev, prep.statics),
            dev, max_cycles)
    elapsed = time.perf_counter() - t0
    return _finish_lane(prep, out, elapsed, compile_s, run_s, t0)


def launch_lane_packed(
    graphs: Sequence[CompiledFactorGraph],
    max_cycles: int = 200,
    damping: float = 0.5,
    damping_nodes: str = "both",
    stability: float = 0.1,
    d_env: Optional[int] = None,
    ladder=None,
    device: DeviceLike = "cuda",
) -> Optional[PendingDispatch]:
    """Queue a lane-packed dispatch (see :func:`launch_stacked`);
    ``None`` when the union's shape is cold."""
    prep = _prepare_lane(graphs, max_cycles, damping, damping_nodes,
                         stability, d_env, ladder)
    if prep.key not in _warm:
        return None
    dev = resolve_device(device)
    t0 = time.perf_counter()
    raw = launch_engine_call(
        _warm, prep.key,
        lambda: _lane_packed_solve(prep.lane, dev, prep.statics,
                                   non_blocking=True), dev)
    return PendingDispatch("lane", raw, prep, prep.key, t0)


def collect_lane_packed(pending: PendingDispatch):
    """Wait for a :func:`launch_lane_packed` dispatch and run the shared
    decode/accounting tail."""
    prep: _LanePrep = pending.prep
    with _span(prep.graphs, len(prep.graphs), prep.max_cycles,
               packing="lane", pipelined=True):
        out, run_s = finish_engine_call(pending.key, pending.raw,
                                        pending.t_launch)
    elapsed = time.perf_counter() - pending.t_launch
    return _finish_lane(prep, out, elapsed, 0.0, run_s, pending.t_launch,
                        pipelined=True)


def solve_maxsum_batch(
    dcops: Sequence[DCOP],
    max_cycles: int = 200,
    noise_level: float = 0.01,
    damping: float = 0.5,
    damping_nodes: str = "both",
    stability: float = 0.1,
    pad_to_bins: Optional[Sequence[int]] = None,
    device: DeviceLike = "cuda",
) -> List[Dict]:
    """Solve a batch of same-shaped DCOPs in one dispatch.

    Returns one dict per instance: assignment, cost (host-evaluated),
    violations, cycles, and the shared dispatch accounting under
    ``batch``.  All instances run ``max_cycles`` cycles."""
    if not dcops:
        return []
    compiled: List[Tuple[CompiledFactorGraph, FactorGraphMeta]] = [
        compile_dcop(d, noise_level=noise_level) for d in dcops
    ]
    graphs = [c[0] for c in compiled]
    metas = [c[1] for c in compiled]

    values, cycles, batch_result = run_stacked(
        graphs,
        max_cycles=max_cycles,
        damping=damping,
        damping_nodes=damping_nodes,
        stability=stability,
        pad_to_bins=pad_to_bins,
        device=device,
    )

    results = []
    for i, (dcop, meta) in enumerate(zip(dcops, metas)):
        assignment = meta.assignment_from_indices(values[i])
        cost, violations = dcop.solution_cost(assignment)
        results.append({
            "assignment": assignment,
            "cost": cost,
            "violations": violations,
            "cycles": int(cycles[i]),
            "batch": dict(batch_result.metrics),
        })
    return results
