"""Engine-level telemetry for the segmented solve.

Port of ``pydcop_tpu/observability/engine_probe.py``.  The probe rides
``MaxSumEngine.run_checkpointed``'s segment boundaries: each segment
already ends with a synchronise of the engine's stream, so the
per-segment wall time handed to :meth:`EngineProbe.on_segment` is
honest, and the probe adds nothing inside the segment.  At the boundary
it evaluates, on the engine's device, the cost of the selected
assignment (the reference's ``cost_of``: constraint cost plus the
noise-free variable base costs) and the convergence health (the mean
|Δ| of the f2v messages against the previous segment's, and the
fraction of variables whose value flipped), and brings the three
scalars to the host in ONE transfer — the boundary's own read, no
other sync.

Per segment it emits a ``chunk`` trace instant (cycle, cost,
converged, seconds, residual, flip rate), the cycle counter and cost
gauge through a :class:`~pydcop_tpu_torch.observability.metrics.
CycleSnapshotter` (a JSONL snapshot per segment when a metrics path is
set), the ``pydcop_msg_residual``/``pydcop_flip_rate`` gauges, and a
point on the cost and convergence curves that ``api.solve`` returns in
``metrics['cost_curve']`` and ``metrics['convergence_curve']``.  The
cost is ``run_maxsum_trace``'s, so the curve's last point equals the
solver's cost.
"""

import logging
from typing import Any, List, Optional, Tuple

logger = logging.getLogger("pydcop.observability.engine_probe")


class EngineProbe:
    """Per-segment cost/convergence/timing recorder for a
    ``MaxSumEngine``."""

    def __init__(self, engine, metrics_path: Optional[str] = None,
                 metrics_every: int = 1, registry=None):
        from pydcop_tpu_torch.observability.metrics import CycleSnapshotter

        self.engine = engine
        self.snapshotter = CycleSnapshotter(
            metrics_path, every=metrics_every, reg=registry
        )
        reg = self.snapshotter.registry
        self._seg_seconds = reg.histogram(
            "pydcop_engine_segment_seconds",
            "Honest (sync-forced) wall seconds per engine chunk")
        self._compile_seconds = reg.counter(
            "pydcop_engine_compile_seconds_total",
            "Seconds spent jit-compiling engine programs")
        self._residual_g = reg.gauge(
            "pydcop_msg_residual",
            "Mean |delta| of f2v messages vs the previous segment "
            "(convergence health; 0 = message fixpoint)")
        self._flip_g = reg.gauge(
            "pydcop_flip_rate",
            "Fraction of variables whose selected value changed "
            "since the previous segment (oscillation signal)")
        # (cycle, cost, converged, seconds) per chunk.
        self.chunks: List[Tuple[int, Optional[float], bool, float]] = []
        # (cycle, residual, flip_rate) per chunk; None on the first.
        self.convergence: List[Tuple[int, Optional[float],
                                     Optional[float]]] = []
        # Host seconds the probe spent per boundary (its own cost).
        self.host_seconds: List[float] = []
        self._base = None
        self._prev_msgs = None
        self._prev_values = None

    def _cost(self, values):
        """The selected assignment's cost on the device, as a 0-d
        tensor: constraint cost + variable base costs (the reference's
        ``cost_of``, ``run_maxsum_trace``'s sum)."""
        import torch

        from pydcop_tpu_torch.ops import maxsum as maxsum_ops

        graph = self.engine.graph
        cost = maxsum_ops.assignment_constraint_cost(graph, values)
        base = self.engine.meta.var_base_costs
        if base is not None:
            if self._base is None:
                self._base = torch.as_tensor(
                    base, dtype=graph.var_costs.dtype,
                    device=graph.var_costs.device)
            cost = cost + torch.sum(torch.gather(
                self._base, 1, values.to(torch.int64)[:, None]))
        return cost

    @staticmethod
    def _convergence(prev_msgs, msgs, prev_values, values):
        """(residual, flip rate) as 0-d float32 tensors: the mean |Δ|
        of every f2v message against the previous segment's, summed
        bucket by bucket, and the fraction of flipped values.  Each
        mean is a sum times the float32 reciprocal of the count, the
        form XLA gives the reference's ``jnp.mean`` and division by a
        constant (so the flip rate is the reference's bit for bit)."""
        import numpy as np
        import torch

        num = torch.zeros((), dtype=torch.float32, device=values.device)
        den = 0
        for a, b in zip(prev_msgs, msgs):
            num = num + torch.sum(torch.abs(b.float() - a.float()))
            den += a.numel()
        residual = num * float(np.float32(1.0 / max(den, 1)))
        flips = (torch.sum((values != prev_values).to(torch.float32))
                 * float(np.float32(1.0 / max(values.numel(), 1))))
        return residual, flips

    def _boundary(self, state, values):
        """(cost, residual, flip rate) as Python floats (None where
        not computable), computed on the device and read in one
        transfer."""
        import time

        import torch

        t0 = time.perf_counter()
        msgs = getattr(state, "f2v", None)
        scalars = []
        try:
            scalars.append(self._cost(values).to(torch.float32))
        except Exception:
            logger.exception("Chunk cost evaluation failed")
            scalars.append(None)
        have_prev = msgs is not None and self._prev_msgs is not None
        if have_prev:
            scalars.extend(self._convergence(
                self._prev_msgs, msgs, self._prev_values, values))
        present = [s for s in scalars if s is not None]
        host = (torch.stack(present).tolist() if present else [])
        out = []
        for s in scalars:
            out.append(host.pop(0) if s is not None else None)
        raw_cost = out[0]
        residual, flips = (out[1], out[2]) if have_prev else (None, None)
        if msgs is not None:
            # The next segment builds new tensors and never writes into
            # this state's, so references are enough (no copy).
            self._prev_msgs = tuple(msgs)
            self._prev_values = values
        cost = None
        if raw_cost is not None:
            meta = self.engine.meta
            sign = 1.0 if meta.mode == "min" else -1.0
            cost = sign * raw_cost + meta.constant_cost
        self.host_seconds.append(time.perf_counter() - t0)
        return cost, residual, flips

    def on_segment(self, state, values, seconds: float,
                   compile_s: float):
        """Record one completed segment (called by ``run_checkpointed``
        at the boundary, after its synchronise).  A first call per
        segment key reports its whole interval as both compile and run
        (the overlapping-fields convention), so the run-only part is
        ``seconds - compile_s``."""
        from pydcop_tpu_torch.observability.trace import tracer

        cycle = int(state.cycle)
        converged = bool(state.stable)
        cost, residual, flips = self._boundary(state, values)
        run_s = max(float(seconds) - float(compile_s), 0.0)
        self.chunks.append((cycle, cost, converged, run_s))
        self.convergence.append((cycle, residual, flips))
        self._seg_seconds.observe(run_s)
        if compile_s:
            self._compile_seconds.inc(float(compile_s))
        if residual is not None:
            self._residual_g.set(residual)
        if flips is not None:
            self._flip_g.set(flips)
        self.snapshotter(cycle, cost, residual=residual,
                         flip_rate=flips)
        if tracer.active:
            tracer.instant(
                "chunk", "engine", cycle=cycle, cost=cost,
                converged=converged, seconds=run_s,
                compile_s=float(compile_s),
                residual=residual, flip_rate=flips,
            )

    def cost_curve(self) -> List[Tuple[int, float]]:
        """(cycle, cost) points for chunks where cost was computable."""
        return [(cycle, cost) for cycle, cost, _, _ in self.chunks
                if cost is not None]

    def convergence_curve(self) -> List[Tuple[int, float, float]]:
        """(cycle, residual, flip_rate) points where both signals
        were computable (segment 2 onward)."""
        return [(cycle, residual, flips)
                for cycle, residual, flips in self.convergence
                if residual is not None and flips is not None]

    def summary(self) -> dict:
        run_s = sum(s for _, _, _, s in self.chunks)
        return {
            "chunks": len(self.chunks),
            "chunk_seconds": run_s,
            "cost_curve": self.cost_curve(),
        }


def attach_result_metrics(result: Any, probe: "EngineProbe"):
    """Fold the probe's curves into a ``DeviceRunResult``/dict metrics
    mapping (shared by api.solve's probed paths)."""
    metrics = (result.metrics if hasattr(result, "metrics")
               else result.setdefault("metrics", {}))
    metrics["cost_curve"] = probe.cost_curve()
    metrics["probe_chunks"] = len(probe.chunks)
    metrics["convergence_curve"] = probe.convergence_curve()
    return result
