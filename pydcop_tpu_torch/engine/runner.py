"""The MaxSum engine runner on one torch device.

Port of the single-device, edge-layout half of
``pydcop_tpu/engine/runner.py`` (``DeviceRunResult``,
``MaxSumEngine.__init__``/``init_state``/``run``/``run_trace``).  The
graph is placed on the device once; ``run`` and ``run_trace`` execute
the superstep loop of ``ops/maxsum.py`` and end their timing with
``torch.cuda.synchronize()`` on the card, so ``time_s`` is device time,
not enqueue time.
"""

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from pydcop_tpu_torch.device import DeviceLike, to_device_graph
from pydcop_tpu_torch.engine.compile import (
    CompiledFactorGraph,
    FactorGraphMeta,
)
from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops import maxsum as maxsum_ops


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
    autotuner's decision) is merged into every result's metrics."""

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

    def init_state(self) -> maxsum_ops.MaxSumState:
        """Fresh solver state on this engine's device."""
        return maxsum_ops.init_state(self.graph)

    def _kwargs(self) -> Dict[str, Any]:
        return dict(damping=self.damping, damp_vars=self.damp_vars,
                    damp_factors=self.damp_factors,
                    stability=self.stability, prune=self.prune)

    def _timed(self, fn):
        """``(out, run seconds, build seconds)`` of ``fn()``, the window
        closed by a synchronise on the card."""
        build_before = _build.build_seconds
        sync(self.device)
        t0 = time.perf_counter()
        out = fn()
        sync(self.device)
        return (out, time.perf_counter() - t0,
                _build.build_seconds - build_before)

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
            lambda: maxsum_ops.run_maxsum(
                self.graph, max_cycles,
                stop_on_convergence=stop_on_convergence, stats=stats,
                **self._kwargs()))
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
            lambda: maxsum_ops.run_maxsum_trace(
                self.graph, max_cycles, var_base_costs=base,
                stop_on_convergence=stop_on_convergence, stats=stats,
                **self._kwargs()))
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
