"""The MaxSum engine runner on one torch device.

Port of the single-device, edge-layout half of
``pydcop_tpu/engine/runner.py``: ``DeviceRunResult``, ``MaxSumEngine``
(``run``, ``run_trace``, the segmented ``run_checkpointed`` with its
guard and decimation, and the older ``run_decimated``),
``DecimationPlan``/``DecimationState`` and ``_DecimationRun``.  The
graph is placed on the device once; ``run`` and ``run_trace`` execute
the superstep loop of ``ops/maxsum.py`` and end their timing with
``torch.cuda.synchronize()`` on the card, so ``time_s`` is device time,
not enqueue time.  ``run_checkpointed`` waits on the current stream
only, never on the whole device, so the asynchronous checkpoint
writer's copies on their own stream overlap the next segment.

Every engine call goes through ``engine.timing.timed_engine_call``
under the reference's keys — ``(max_cycles, stop_on_convergence)``,
``("trace", ...)`` and ``("segment", extra, stop, damping, damp_vars,
damp_factors)`` — so the ``jit_compile``/``engine_call`` spans, the
per-key call counters and the profiler's ``metrics['xla_cost']``
entries are the reference's; segments run inside an ``engine_segment``
span and a decimation clamp records a ``decimation_clamp`` instant.
"""

import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from pydcop_tpu_torch.device import DeviceLike, to_device_graph
from pydcop_tpu_torch.engine.compile import (
    BIG,
    CompiledFactorGraph,
    FactorGraphMeta,
)
from pydcop_tpu_torch.engine.timing import timed_engine_call
from pydcop_tpu_torch.observability.profiler import key_str, profiler
from pydcop_tpu_torch.observability.trace import tracer
from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops import maxsum as maxsum_ops
from pydcop_tpu_torch.utils.tree import tree_leaves


@dataclass(frozen=True)
class DecimationPlan:
    """Segmented decimation policy (Improving Max-Sum through
    Decimation, arXiv:1706.02209): at every segment boundary, variables
    whose belief margin (gap between best and second-best value) clears
    ``margin`` are clamped to their selected value (unary costs set to
    BIG everywhere else), shrinking the set of edges still doing useful
    work round by round.

    ``margin``: threshold a variable's margin must exceed to clamp
    (0 = pure top-fraction selection, the classic schedule).
    ``frac_per_round``: cap on the fraction of ALL variables newly
    clamped per boundary.  ``force_progress``: clamp the top-margin free
    variable even when none clears the threshold, so the classic
    schedule ends with everything fixed.  ``cycles_per_round``: segment
    length used when the caller does not impose one.
    """

    margin: float = 0.0
    frac_per_round: float = 0.1
    force_progress: bool = True
    cycles_per_round: int = 60


class DecimationState(NamedTuple):
    """Checkpoint payload of a decimated run: solver state + the clamp
    set that must travel with it, so a resume in the middle of
    decimation continues the clamped problem, not the original one."""

    solver: Any           # MaxSumState
    fixed: Any            # [V] bool numpy: clamped variables
    var_costs: Any        # [V+1, D] f32 numpy: current (clamped) table


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class DeviceRunResult:
    """Result of an on-device solve.

    Timing convention (the reference's): ``time_s`` is the total wall
    time of the engine call, INCLUDING any compile that happened inside
    it; ``compile_time_s`` is the compile portion — here the seconds
    spent building CUDA kernels at their first use, 0 on a warm call.
    The two overlap: never sum them."""

    assignment: Dict[str, Any]
    cycles: int
    converged: bool
    time_s: float
    compile_time_s: float
    metrics: Dict[str, Any] = field(default_factory=dict)


def sync(device: torch.device):
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _DecimationRun:
    """Host-side clamp bookkeeping for ONE decimated
    ``run_checkpointed`` call: the fixed-variable mask, the clamped
    unary table, and their rollback snapshot.  All of it changes at
    segment boundaries on the host; a clamp hands the loop a graph with
    a fresh ``var_costs`` tensor and never writes into the old one,
    which the engine, its compile cache and retained snapshots share.
    """

    def __init__(self, engine, plan: DecimationPlan,
                 initial: Optional[DecimationState] = None):
        self.engine = engine
        self.plan = plan
        self.n_vars = len(engine.meta.var_names)
        if initial is not None:
            self.fixed = _host(initial.fixed).astype(bool).copy()
            self.var_costs = _host(initial.var_costs).copy()
        else:
            self.fixed = np.zeros(self.n_vars, dtype=bool)
            self.var_costs = _host(engine.graph.var_costs).copy()
        self.rounds = 0
        self.rollbacks = 0
        self._snap = None

    def put(self, arr: np.ndarray) -> torch.Tensor:
        """A new var_costs tensor on the engine's device."""
        return torch.tensor(arr, device=self.engine.device)

    def clamp(self, graph, state, values, margin):
        """Select-and-clamp at one segment boundary.  Returns
        ``(newly_clamped, graph, state)``: a nonzero count replaces the
        graph's unary table and clears the convergence flag (the clamped
        problem is a new problem; the messages adapt)."""
        margin = _host(margin)
        vals = _host(values)
        free = np.nonzero(~self.fixed)[0]
        if free.size == 0:
            return 0, graph, state
        cap = max(1, int(self.plan.frac_per_round * self.n_vars))
        if self.plan.margin > 0:
            eligible = free[margin[free] > self.plan.margin]
        else:
            eligible = free
        order = eligible[np.argsort(-margin[eligible], kind="stable")]
        chosen = order[:cap]
        if chosen.size == 0 and self.plan.force_progress:
            chosen = free[
                np.argsort(-margin[free], kind="stable")[:1]]
        if chosen.size == 0:
            return 0, graph, state
        d = self.var_costs.shape[1]
        for i in chosen:
            keep = int(vals[i])
            row = np.full((d,), BIG, self.var_costs.dtype)
            row[keep] = self.var_costs[i, keep]
            self.var_costs[i] = row
            self.fixed[i] = True
        self.rounds += 1
        graph = graph._replace(var_costs=self.put(self.var_costs))
        state = state._replace(
            stable=torch.tensor(False, device=self.engine.device))
        return int(chosen.size), graph, state

    def retain(self, graph):
        """Snapshot the clamp set with the recovery run's state
        snapshot: a rollback must restore both."""
        self._snap = (self.fixed.copy(), self.var_costs.copy(), graph)

    def rollback(self):
        """Restore the clamp set retained with the last validated
        snapshot; returns the graph to continue with."""
        fixed, var_costs, graph = self._snap
        self.fixed = fixed.copy()
        self.var_costs = var_costs.copy()
        self.rollbacks += 1
        return graph

    def snapshot_payload(self, solver_state) -> DecimationState:
        """Checkpoint payload: solver state + the CURRENT clamp set
        (taken after the boundary's clamp, so a resume replays the
        uninterrupted sequence)."""
        return DecimationState(
            solver=solver_state,
            fixed=self.fixed.copy(),
            var_costs=self.var_costs.copy(),
        )

    def active_edges(self, graph) -> int:
        """Edge slots whose variable is still free."""
        n = 0
        for b in graph.buckets:
            ids = _host(b.var_ids).reshape(-1)
            real = ids < self.n_vars
            n += int(np.sum(
                real & ~self.fixed[np.minimum(ids, self.n_vars - 1)]))
        return n

    def metrics(self, graph) -> Dict[str, Any]:
        return {
            "decimated_vars": int(self.fixed.sum()),
            "decimated_fraction": (
                float(self.fixed.sum()) / self.n_vars
                if self.n_vars else 0.0),
            "active_edges": self.active_edges(graph),
            "decimation_rounds": self.rounds,
            "decimation_rollbacks": self.rollbacks,
        }


def decimation_template(engine, solver_template) -> DecimationState:
    """Checkpoint restore template of a decimated run
    (``resilience/checkpoint.load_state`` restores into it)."""
    n_vars = len(engine.meta.var_names)
    return DecimationState(
        solver=solver_template,
        fixed=np.zeros(n_vars, dtype=bool),
        var_costs=_host(engine.graph.var_costs).copy(),
    )


class MaxSumEngine:
    """Runs MaxSum supersteps on a compiled factor graph.

    Parameters mirror the reference algo_params: damping (0.5),
    damping_nodes (vars/factors/both/none), stability (0.1).  ``noise``
    is applied at compile time, and so is the aggregation strategy (the
    graph's ``agg_*`` arrays).  ``prune`` turns on branch-and-bound
    pruning of the binary factor updates (same values, less work once
    the messages concentrate).  ``device`` defaults to ``"cuda"`` and
    raises when no card is present (pass ``"cpu"`` to run there).
    Sharding (``mesh``/``n_devices``) and ``layout="lane"`` are not
    ported yet and raise.  ``extra_metrics`` (e.g. the aggregation
    autotuner's decision) is merged into every result's metrics.
    Every run reads ``damping`` from the engine when it starts a
    segment, so a recovery damping bump takes effect at the next
    one."""

    def __init__(self, graph: CompiledFactorGraph, meta: FactorGraphMeta,
                 damping: float = 0.5, damping_nodes: str = "both",
                 stability: float = 0.1,
                 mesh=None, n_devices: Optional[int] = None,
                 layout: str = "edge", prune: bool = False,
                 device: DeviceLike = "cuda"):
        if layout not in ("edge", "lane"):
            raise ValueError(
                f"layout must be 'edge' or 'lane', got {layout!r}")
        if layout == "lane":
            raise NotImplementedError(
                "layout='lane' is not ported yet; use layout='edge'")
        if mesh is not None or (n_devices is not None and n_devices > 1):
            raise NotImplementedError(
                "multi-device runs (mesh/n_devices) are not ported yet")
        self.meta = meta
        self.graph = to_device_graph(graph, device)
        self.device = self.graph.var_costs.device
        self.damping = damping
        self.damp_vars = damping_nodes in ("vars", "both")
        self.damp_factors = damping_nodes in ("factors", "both")
        self.stability = stability
        self.prune = prune
        self.extra_metrics: Dict[str, Any] = {}
        # Keys already called once: the next call of a key is warm.
        self._warm: set = set()

    def init_state(self) -> maxsum_ops.MaxSumState:
        """Fresh solver state on this engine's device."""
        return maxsum_ops.init_state(self.graph)

    def _kwargs(self) -> Dict[str, Any]:
        return dict(damping=self.damping, damp_vars=self.damp_vars,
                    damp_factors=self.damp_factors,
                    stability=self.stability, prune=self.prune)

    def _call(self, key, fn, cycles: int):
        """``timed_engine_call`` of ``fn()`` under ``key``: (out,
        compile_s, run_s) by the first-call convention.  While the
        profiler is on, a cold key's profile entry is folded into
        ``extra_metrics['xla_cost']``, as the reference does."""
        out = timed_engine_call(self._warm, key, fn, self.device, cycles)
        if profiler.enabled and out[1] > 0:
            entry = profiler.get(key)
            if entry is not None:
                self.extra_metrics.setdefault(
                    "xla_cost", {})[key_str(key)] = entry
        return out

    def _segment_key(self, extra_cycles: int,
                     stop_on_convergence: bool):
        """Key of one segment call (the reference's segment program
        key: damping is part of it, so a recovery damping bump makes a
        new, cold key)."""
        return ("segment", extra_cycles, stop_on_convergence,
                self.damping, self.damp_vars, self.damp_factors)

    def _timed(self, key, fn, cycles: int):
        """``(out, run seconds, build seconds)`` of ``fn()`` through
        :meth:`_call`, the window closed by a synchronise on the
        card."""
        build_before = _build.build_seconds
        sync(self.device)
        out, _, run_s = self._call(key, fn, cycles)
        return out, run_s, _build.build_seconds - build_before

    def _metrics(self, compile_s: float, stats: Dict[str, int]
                 ) -> Dict[str, Any]:
        metrics = {**self.extra_metrics, "cold_start": compile_s > 0,
                   "device": str(self.device)}
        if self.prune:
            metrics.update(stats)
        return metrics

    def run(self, max_cycles: int = 1000,
            stop_on_convergence: bool = True) -> DeviceRunResult:
        """Solve from zero messages.  A first call on the card includes
        the kernels' build (reported in ``compile_time_s``); warm it up
        with an identical call before timing a steady state."""
        stats: Dict[str, int] = {}
        (state, values), run_s, compile_s = self._timed(
            (max_cycles, stop_on_convergence),
            lambda: maxsum_ops.run_maxsum(
                self.graph, max_cycles,
                stop_on_convergence=stop_on_convergence, stats=stats,
                **self._kwargs()), max_cycles)
        values = values.cpu().numpy()
        cycle, stable = int(state.cycle), bool(state.stable)
        n_msgs = sum(
            int(b.var_ids.shape[0] * b.var_ids.shape[1])
            for b in self.graph.buckets
        )
        return DeviceRunResult(
            assignment=self.meta.assignment_from_indices(values),
            cycles=cycle,
            converged=stable,
            time_s=run_s,
            compile_time_s=compile_s,
            metrics={
                **self._metrics(compile_s, stats),
                "msg_count": 2 * n_msgs * cycle,
                "cycles_per_s": cycle / run_s if run_s > 0 else 0.0,
            },
        )

    def run_trace(self, max_cycles: int,
                  stop_on_convergence: bool = True) -> DeviceRunResult:
        """Solve recording the cost of the selected assignment after
        every cycle (``metrics["cost_trace"]``, numpy [max_cycles], in
        the problem's sign and with the folded constant cost).  As
        :meth:`run`, it stops at the fixpoint by default, with the
        curve's tail holding the final cost."""
        base = self.meta.var_base_costs
        base = None if base is None else torch.tensor(
            base, dtype=torch.float32, device=self.device)
        stats: Dict[str, int] = {}
        (state, values, costs), run_s, compile_s = self._timed(
            ("trace", max_cycles, stop_on_convergence),
            lambda: maxsum_ops.run_maxsum_trace(
                self.graph, max_cycles, var_base_costs=base,
                stop_on_convergence=stop_on_convergence, stats=stats,
                **self._kwargs()), max_cycles)
        values = values.cpu().numpy()
        sign = 1.0 if self.meta.mode == "min" else -1.0
        return DeviceRunResult(
            assignment=self.meta.assignment_from_indices(values),
            cycles=int(state.cycle),
            converged=bool(state.stable),
            time_s=run_s,
            compile_time_s=compile_s,
            metrics={
                **self._metrics(compile_s, stats),
                "cost_trace": sign * costs.cpu().numpy()
                + self.meta.constant_cost,
            },
        )

    def _guard(self, graph, state, values, with_cost: bool):
        """Segment-boundary guard: ``(finite, cost)`` — a NaN/Inf scan
        over every floating-point leaf of ``state`` and, with
        ``with_cost``, the constraint cost of the selected assignment
        (0 otherwise), computed on the device and fetched in one
        transfer.  Pure reads: the guard never changes the trajectory."""
        finite = torch.ones((), dtype=torch.bool, device=self.device)
        for leaf in tree_leaves(state):
            if leaf.dtype.is_floating_point:
                finite = finite & torch.all(torch.isfinite(leaf))
        cost = (maxsum_ops.assignment_constraint_cost(graph, values)
                if with_cost else
                torch.zeros((), dtype=graph.var_costs.dtype,
                            device=self.device))
        ok, cost = torch.stack([finite.to(cost.dtype), cost]).tolist()
        return bool(ok), cost

    def _margin(self, graph, state) -> torch.Tensor:
        """[V] belief margin, the gap between the best and second-best
        valid value: the decimation confidence signal."""
        beliefs, _ = maxsum_ops.aggregate_beliefs(graph, state.f2v)
        masked = torch.where(graph.var_valid, beliefs, torch.inf)[:-1]
        best2 = torch.sort(masked, dim=1).values[:, :2]
        return best2[:, 1] - best2[:, 0]

    def run_checkpointed(self, max_cycles: int = 1000, *,
                         manager=None,
                         checkpoint_dir: Optional[str] = None,
                         segment_cycles: Optional[int] = None,
                         stop_on_convergence: bool = True,
                         initial_state=None,
                         max_segments: Optional[int] = None,
                         probe=None,
                         checkpoint_async: bool = True,
                         recovery=None,
                         decimation: Optional[DecimationPlan] = None,
                         ) -> DeviceRunResult:
        """The solve loop chunked into K-cycle segments with a state
        snapshot between segments (``resilience/checkpoint.py`` owns the
        format and the resume side).  Each segment re-enters
        ``run_maxsum_from`` with the exact state the previous one
        produced, so the segmented trajectory equals :meth:`run`'s:
        same assignment, cycles and every message.

        ``manager`` (a ``CheckpointManager``) or ``checkpoint_dir``
        enables snapshots; with neither this is a segmented run.  With
        ``checkpoint_async=True`` (default) an ``AsyncCheckpointWriter``
        copies each snapshot to the host on its own stream and writes it
        on its own thread, overlapping the next segment; all snapshots
        are on disk when this returns.  ``initial_state`` resumes from
        a restored snapshot; ``max_segments`` stops after that many
        segments (a deterministic stand-in for a preemption).
        ``probe``, when given, gets ``on_segment(state, values, run_s,
        compile_s)`` after every validated segment.

        ``recovery`` (a ``RecoveryPolicy``) arms the segment-boundary
        guard: a tripped guard rolls back to the last valid state and
        re-runs under the policy's escalation ladder
        (``resilience/recovery.py``); only validated states are
        checkpointed.  With no trips the run equals the unguarded one.

        ``decimation`` (a :class:`DecimationPlan`) clamps confident
        variables at every boundary and replaces the graph's unary
        table; the clamp set rides every snapshot
        (:class:`DecimationState`) and every recovery retain.  Metrics
        gain ``decimated_vars`` / ``decimated_fraction`` /
        ``active_edges`` / ``decimation_rounds`` /
        ``decimation_rollbacks``.
        """
        from pydcop_tpu_torch.resilience.checkpoint import (
            AsyncCheckpointWriter,
            CheckpointManager,
        )

        if manager is None and checkpoint_dir is not None:
            manager = CheckpointManager(
                checkpoint_dir, every=segment_cycles or 100
            )
        every = segment_cycles or (
            manager.every if manager is not None else 100
        )
        graph = self.graph
        decim = None
        if decimation is not None:
            initial_decim = (
                initial_state
                if isinstance(initial_state, DecimationState) else None
            )
            decim = _DecimationRun(self, decimation, initial_decim)
            if initial_decim is not None:
                graph = graph._replace(var_costs=decim.put(decim.var_costs))
                initial_state = initial_decim.solver
        elif isinstance(initial_state, DecimationState):
            raise ValueError(
                "initial_state carries a decimation clamp set but no "
                "decimation plan was passed — resuming it without one "
                "would silently solve a different problem")
        state = (
            initial_state if initial_state is not None
            else self.init_state()
        )
        rec = None
        if recovery is not None:
            from pydcop_tpu_torch.resilience.recovery import RecoveryRun

            rec = RecoveryRun(recovery, self)
            # The starting state is the first rollback target, with the
            # (initial) clamp set beside it.
            rec.retain(state, None)
            if decim is not None:
                decim.retain(graph)
        writer = None
        if manager is not None and checkpoint_async:
            writer = AsyncCheckpointWriter(manager)
        build_before = _build.build_seconds
        t0 = time.perf_counter()
        segments = 0
        checkpoints = 0
        interrupted = False
        values = None
        stats: Dict[str, int] = {}

        def segment(extra):
            """One segment through :meth:`_call` (its span, counters and
            profile); returns ((state, values), compile_s, run_s)."""
            seg_stats: Dict[str, int] = {}
            kw = self._kwargs()

            def call():
                seg_stats.clear()
                return maxsum_ops.run_maxsum_from(
                    graph, state, extra,
                    stop_on_convergence=stop_on_convergence,
                    stats=seg_stats, **kw)

            key = self._segment_key(extra, stop_on_convergence)
            if tracer.active:
                with tracer.span("engine_segment", "engine",
                                 segment=segments,
                                 from_cycle=int(state.cycle),
                                 extra_cycles=extra):
                    out = self._call(key, call, extra)
            else:
                out = self._call(key, call, extra)
            for k, v in seg_stats.items():
                stats[k] = stats.get(k, 0) + v
            return out

        try:
            while True:
                cycle = int(state.cycle)
                if values is not None and (
                    cycle >= max_cycles
                    or (stop_on_convergence and bool(state.stable))
                    # Every variable clamped: the decimated solve is
                    # complete (the clamped rows push messages to the
                    # BIG scale, where the stability test may never
                    # settle).
                    or (decim is not None and bool(decim.fixed.all()))
                ):
                    break
                # A resume at or past the cycle budget still needs the
                # value selection: a zero-extra segment computes it.
                extra = min(every, max(max_cycles - cycle, 0))
                (state, values), seg_compile_s, seg_run_s = segment(extra)
                segments += 1
                if rec is not None:
                    finite, g_cost = self._guard(
                        graph, state, values,
                        recovery.divergence_window > 0)
                    violation = rec.check(int(state.cycle), finite, g_cost)
                    if violation is not None:
                        # Tripped: the segment's output never reaches
                        # the probe or a checkpoint.  rollback raises
                        # RecoveryExhausted past the restart budget.
                        state, values = rec.rollback(violation)
                        if decim is not None:
                            graph = decim.rollback()
                        if max_segments is not None \
                                and segments >= max_segments:
                            interrupted = True
                            break
                        continue
                    rec.retain(state, values)
                    if decim is not None:
                        decim.retain(graph)
                if probe is not None:
                    probe.on_segment(state, values, seg_run_s,
                                     seg_compile_s)
                if decim is not None:
                    # Clamp BEFORE the checkpoint: the snapshot carries
                    # the post-clamp set, so a resume replays the
                    # uninterrupted boundary sequence.
                    newly, graph, state = decim.clamp(
                        graph, state, values, self._margin(graph, state))
                    if newly and tracer.active:
                        tracer.instant(
                            "decimation_clamp", "engine",
                            newly_clamped=newly,
                            decimated_vars=int(decim.fixed.sum()),
                            cycle=int(state.cycle))
                if manager is not None:
                    payload = (decim.snapshot_payload(state)
                               if decim is not None else state)
                    if writer is not None:
                        writer.submit(payload, state.cycle)
                    else:
                        manager.save(payload, int(state.cycle))
                    checkpoints += 1
                if max_segments is not None \
                        and segments >= max_segments:
                    interrupted = True
                    break
        finally:
            if writer is not None:
                # The error the loop is leaving by, if any (read here:
                # inside the except clause below sys.exc_info() is the
                # write error itself).  A write error must not mask it;
                # on a clean exit the write failure IS the error.
                leaving_by = sys.exc_info()[1]
                try:
                    writer.close()
                except Exception:
                    if leaving_by is None:
                        raise
        if values is None:
            # A guard trip on the first segment met a max_segments
            # break: the restored initial state has no selection yet.
            (state, values), _, _ = segment(0)
        values_host = values.cpu().numpy()
        cycle, stable = int(state.cycle), bool(state.stable)
        total = time.perf_counter() - t0
        compile_s = _build.build_seconds - build_before
        if decim is not None and decim.fixed.all() and not interrupted:
            # Fully decimated = solved: every variable carries its
            # clamped value.
            stable = True
        steady = max(total - compile_s, 0.0)
        return DeviceRunResult(
            assignment=self.meta.assignment_from_indices(values_host),
            cycles=cycle,
            converged=stable,
            time_s=total,
            compile_time_s=compile_s,
            metrics={
                **self._metrics(compile_s, stats),
                "segments": segments,
                "segment_cycles": every,
                "checkpoints_written": checkpoints,
                "checkpoint_async": writer is not None,
                "interrupted": interrupted,
                "cycles_per_s": cycle / steady if steady > 0 else 0.0,
                **(rec.metrics() if rec is not None else {}),
                **(decim.metrics(graph) if decim is not None else {}),
            },
        )

    def run_decimated(self, max_cycles: int = 1000,
                      frac: float = 0.1,
                      cycles_per_round: int = 60) -> DeviceRunResult:
        """MaxSum with decimation, the older host-driven loop:
        alternate ``cycles_per_round`` cycles of message passing with
        clamping the ``frac`` most confident free variables (at least
        one), until every variable is fixed or ``max_cycles`` cycles
        are spent.  ``run_checkpointed(decimation=...)`` is the
        segmented form the solve uses."""
        n_vars = len(self.meta.var_names)
        dmax = self.graph.var_costs.shape[1]
        var_costs = _host(self.graph.var_costs).copy()
        fixed = np.zeros(n_vars, dtype=bool)
        graph = self.graph
        state = maxsum_ops.init_state(graph)
        build_before = _build.build_seconds
        t0 = time.perf_counter()
        values = None
        while True:
            # Never overshoot the caller's cycle budget.
            remaining = max_cycles - int(state.cycle)
            if remaining <= 0 and values is not None:
                break
            extra = min(cycles_per_round, max(remaining, 1))
            (state, values), _, _ = self._call(
                ("decim", extra), lambda: maxsum_ops.run_maxsum_from(
                    graph, state, extra, damping=self.damping,
                    damp_vars=self.damp_vars,
                    damp_factors=self.damp_factors,
                    stability=self.stability, stop_on_convergence=True),
                extra)
            if bool(np.all(fixed)) or int(state.cycle) >= max_cycles:
                break
            margin = _host(self._margin(graph, state))
            vals_host = _host(values)
            free = np.nonzero(~fixed)[0]
            if free.size == 0:
                break
            k = max(1, int(frac * n_vars))
            chosen = free[np.argsort(-margin[free])[:k]]
            for i in chosen:
                keep = int(vals_host[i])
                clamp = np.full(dmax, BIG, np.float32)
                clamp[keep] = var_costs[i, keep]
                var_costs[i] = clamp
                fixed[i] = True
            graph = graph._replace(
                var_costs=torch.tensor(var_costs, device=self.device))
            # Clamped costs changed the problem: clear convergence so
            # the warm-started messages adapt.
            state = state._replace(
                stable=torch.tensor(False, device=self.device))
        values = _host(values)
        cycle = int(state.cycle)
        total = time.perf_counter() - t0
        compile_s = _build.build_seconds - build_before
        steady = max(total - compile_s, 0.0)
        return DeviceRunResult(
            assignment=self.meta.assignment_from_indices(values),
            cycles=cycle,
            converged=bool(np.all(fixed)),
            time_s=total,
            compile_time_s=compile_s,
            metrics={
                **self._metrics(compile_s, {}),
                "decimated_vars": int(fixed.sum()),
                "cycles_per_s": cycle / steady if steady > 0 else 0.0,
            },
        )
