"""Exact-inference engine tier: DPOP through the runner seam.

Port of ``pydcop_tpu/engine/dpop.py``.  ``ops/dpop.solve_sweep`` owns
the algorithm (level-batched UTIL calls on the engine's device, host
VALUE sweep); this module owns the *accounting*: every device dispatch
is routed through :func:`engine.timing.timed_engine_call` so the
tracer, the metrics registry and the efficiency tracker see exact
solves through the same chokepoint as every iterative engine, and the
result comes back as a :class:`DeviceRunResult` with the overlapping
compile/run timing convention of the reference (eager torch compiles
nothing: a signature's first call counts as its compile).

Width policy lives here too: :func:`dpop_feasibility` answers "is exact
inference affordable on this pseudo-tree" (optionally after CEC
shrinkage) without materializing a single table — the portfolio racer,
the serve-plane admission check and the session oracle all gate on it.
"""

import time
from typing import Any, Dict, Optional

from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.engine.runner import DeviceRunResult
from pydcop_tpu_torch.engine.timing import timed_engine_call
from pydcop_tpu_torch.observability.trace import tracer
from pydcop_tpu_torch.ops import dpop as dpop_ops


def dpop_feasibility(graph, mode: str = "min", cec: bool = True,
                     max_elements: Optional[int] = None
                     ) -> Dict[str, Any]:
    """Width feasibility verdict for exact inference on ``graph``.

    Returns the raw :func:`ops.dpop.tree_stats` counters plus
    ``{"feasible", "max_elements_cap", "cec_max_elements"}``.  When the
    raw hypercubes bust the cap and ``cec`` is allowed, the CEC-shrunk
    sizes are tried before giving up — pruning is exactly how the width
    ceiling rises.  Never raises: infeasible is a verdict, not an error.
    """
    cap = dpop_ops.MAX_NODE_ELEMENTS if max_elements is None \
        else int(max_elements)
    stats = dpop_ops.tree_stats(graph)
    out: Dict[str, Any] = dict(stats)
    out["max_elements_cap"] = cap
    out["cec_max_elements"] = None
    if stats["max_elements"] <= cap:
        out["feasible"] = True
        return out
    if cec:
        try:
            survivors, _ = dpop_ops.cec_survivors(graph, mode)
            shrunk = dpop_ops.tree_stats(graph, survivors)
            out["cec_max_elements"] = shrunk["max_elements"]
            out["feasible"] = shrunk["max_elements"] <= cap
            return out
        except Exception:  # noqa: BLE001 — verdict, not error
            pass
    out["feasible"] = False
    return out


class DpopEngine:
    """One exact solve of a compiled pseudo-tree, fully accounted.

    Unlike the iterative engines there is no cycle budget to resume —
    ``run`` ignores ``max_cycles`` and always sweeps to the optimum (or
    raises :class:`ops.dpop.UtilTooLargeError` when a UTIL hypercube,
    even CEC-shrunk, busts ``MAX_NODE_ELEMENTS``).  The warm-key set
    persists across ``run`` calls, so repeat solves of same-signature
    structures count as warm calls.  ``device`` (default ``"cuda"``)
    is where the UTIL steps run; without a card it raises unless
    ``device="cpu"``.
    """

    def __init__(self, graph, mode: str = "min", cec: bool = True,
                 warm: Optional[set] = None,
                 device: DeviceLike = "cuda"):
        self.graph = graph
        self.mode = mode
        self.cec = cec
        self.device = resolve_device(device)
        self.efficiency_class = "dpop"
        # Callers that solve many same-shaped problems (the serving
        # dispatch plane) pass a shared warm-key set so signature-bucket
        # kernels compiled for one request are warm for the next.
        self._warm: set = warm if warm is not None else set()
        self._survivors = None  # cached cec_survivors result
        self.last_stats: Dict[str, Any] = {}

    def _call(self, key, fn):
        out, compile_s, run_s = timed_engine_call(self._warm, key, fn,
                                                  self.device)
        self._compile_s += compile_s
        self._run_s += run_s
        return out

    def run(self, max_cycles: Optional[int] = None) -> DeviceRunResult:
        del max_cycles  # exact: no budget, sweeps to the optimum
        t0 = time.perf_counter()
        self._compile_s = 0.0
        self._run_s = 0.0
        if self.cec and self._survivors is None:
            # The dominance pass only depends on the (static) problem;
            # repeat solves — the portfolio race's timed leg, serving
            # bins, the session oracle — reuse it.
            self._survivors = dpop_ops.cec_survivors(
                self.graph, self.mode)
        kwargs = dict(
            mode=self.mode, cec=self.cec, call=self._call,
            precomputed_survivors=self._survivors, device=self.device,
        )
        if tracer.enabled:
            with tracer.span("dpop_sweep", "engine", mode=self.mode,
                             cec=self.cec):
                assignment, stats = dpop_ops.solve_sweep(
                    self.graph, **kwargs)
        else:
            assignment, stats = dpop_ops.solve_sweep(
                self.graph, **kwargs)
        elapsed = time.perf_counter() - t0
        self.last_stats = dict(stats)
        metrics = dict(stats)
        metrics["engine"] = "dpop"
        metrics["optimal"] = True
        metrics["cold_start"] = self._compile_s > 0.0
        return DeviceRunResult(
            assignment=assignment,
            cycles=stats["levels"],
            converged=True,
            time_s=elapsed,
            compile_time_s=min(self._compile_s, elapsed),
            metrics=metrics,
        )
