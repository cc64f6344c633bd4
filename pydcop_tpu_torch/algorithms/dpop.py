"""DPOP: Dynamic Programming Optimization Protocol (exact).

Port of the device path of ``pydcop_tpu/algorithms/dpop.py``.

Reference parity: pydcop/algorithms/dpop.py (:115-441) — two-phase sweep
over the DFS pseudo-tree: UTIL messages flow leaves→root (each node joins
its assigned constraints with its children's UTIL tables and projects
itself out, :313-386), then VALUE assignments flow root→leaves (each node
slices its joined table on the received separator assignment and picks
its first-optimal value, :389-439).

Execution model here (two paths, selected by the ``engine`` param):

- ``jit``: level-batched tensor sweep on the solve's device — all nodes
  of a tree level with the same table signature are joined + projected
  by ONE UTIL call on stacked hypercubes (ops/dpop.py).  The value keeps
  the reference's name; here it names the batched device sweep.
- ``numpy``: per-node host sweep using the dense relation algebra
  (dcop/relations.py join/projection) — the reference execution to diff
  against, and the fallback when a UTIL table passes the device cap.
- ``auto`` (default): ``jit`` when the pseudo-tree's mean level width is
  at least 16, else ``numpy`` (the reference's rule;
  ``metrics["engine"]`` says which ran).

UTIL width is exponential in separator size; oversized tables raise
MemoryError in both paths (footprint accounting mirror:
computation_memory below, reference dpop.py:80-85).

Example::

    >>> from pydcop_tpu_torch.api import solve
    >>> from pydcop_tpu_torch.dcop.dcop import DCOP
    >>> from pydcop_tpu_torch.dcop.objects import Domain, Variable
    >>> from pydcop_tpu_torch.dcop.relations import constraint_from_str
    >>> d = Domain('d', '', [0, 1])
    >>> x, y = Variable('x', d), Variable('y', d)
    >>> dcop = DCOP('doc', objective='min')
    >>> dcop.add_constraint(constraint_from_str('c', '(x + y - 1)**2', [x, y]))
    >>> res = solve(dcop, 'dpop', device='cpu')
    >>> round(res['cost'], 3), sorted(res['assignment'].items())
    (0.0, [('x', 0), ('y', 1)])
"""

from typing import Dict, Optional

from pydcop_tpu_torch.algorithms import AlgoParameterDef, AlgorithmDef
from pydcop_tpu_torch.computations_graph import pseudotree as pt
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.relations import (
    NAryMatrixRelation,
    find_arg_optimal,
    join,
    projection,
)
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.engine.runner import DeviceRunResult
from pydcop_tpu_torch.ops.dpop import UtilTooLargeError

GRAPH_TYPE = "pseudotree"

algo_params = [
    AlgoParameterDef("engine", "str", ["auto", "jit", "numpy"], "auto"),
    # Cross-edge consistency preprocessing (ops/dpop.cec_survivors):
    # prunes soft-dominated domain values before the UTIL tables are
    # built.  Bit-identical assignments either way; "on" shrinks the
    # hypercubes (raising the width ceiling), "off" skips the host-side
    # dominance pass on problems already far under the cap.
    AlgoParameterDef("cec", "str", ["on", "off"], "on"),
]


def computation_memory(node) -> float:
    return pt.computation_memory(node)


def communication_load(src, target: str) -> float:
    return pt.communication_load(src, target)


def solve_on_device(dcop: DCOP, algo_def: AlgorithmDef,
                    max_cycles: int = 0, mesh=None,
                    n_devices: Optional[int] = None,
                    device: DeviceLike = "cuda",
                    **_) -> DeviceRunResult:
    """Exact solve via level-scheduled UTIL/VALUE sweeps; the UTIL
    steps run on ``device`` (without a card it raises unless
    ``device="cpu"``)."""
    import time

    resolve_device(device)
    requested = "auto"
    cec = True
    if algo_def is not None and algo_def.params:
        requested = algo_def.params.get("engine", "auto")
        cec = algo_def.params.get("cec", "on") != "off"
    engine = requested
    t0 = time.perf_counter()
    graph = pt.build_computation_graph(dcop)
    mode = dcop.objective

    if engine == "auto":
        # Batching pays when levels are wide (many nodes per kernel
        # call); deep narrow trees are dispatch-overhead-bound and run
        # faster through the per-node numpy sweep.
        depth = pt.node_depths(graph)
        levels = max(depth.values(), default=0) + 1
        mean_width = len(depth) / levels
        engine = "jit" if mean_width >= 16 else "numpy"

    if engine == "jit":
        try:
            # The engine tier (engine/dpop.DpopEngine) routes every
            # UTIL dispatch through timed_engine_call, so exact solves
            # show up in tracing, metrics and the efficiency ledgers
            # exactly like the iterative engines.
            from pydcop_tpu_torch.engine.dpop import DpopEngine

            res = DpopEngine(graph, mode=mode, cec=cec,
                             device=device).run()
            elapsed = time.perf_counter() - t0
            cost, _ = dcop.solution_cost(res.assignment)
            stats = dict(res.metrics)
            stats["device_cost"] = cost
            stats["engine"] = "jit"
            return DeviceRunResult(
                assignment=res.assignment,
                cycles=res.cycles,
                converged=True,
                time_s=elapsed,
                compile_time_s=res.compile_time_s,
                metrics=stats,
            )
        except UtilTooLargeError as e:
            if requested == "jit":
                raise
            # A UTIL table beyond the device cap (the host sweep can
            # still stream it): fall back, audibly.
            import logging

            logging.getLogger("pydcop.algo.dpop").warning(
                "jit sweep unavailable (%s); using numpy sweep", e
            )

    assignment, stats = _solve_numpy(graph, mode)
    elapsed = time.perf_counter() - t0
    cost, _ = dcop.solution_cost(assignment)
    return DeviceRunResult(
        assignment=assignment,
        cycles=stats.pop("levels"),
        converged=True,
        time_s=elapsed,
        compile_time_s=0.0,
        metrics={**stats, "device_cost": cost, "engine": "numpy",
                 "optimal": True},
    )


def _solve_numpy(graph, mode: str):
    """Host-side per-node sweep (dense numpy relation algebra)."""
    nodes = {n.name: n for n in graph.nodes}

    # Order nodes deepest-first for the UTIL sweep.
    depth = pt.node_depths(graph)
    util_order = sorted(nodes, key=lambda n: -depth[n])

    # UTIL phase: joined[n] = join(own constraints, children UTILs);
    # util_to_parent[n] = project(joined[n], n).
    joined: Dict[str, NAryMatrixRelation] = {}
    util_msgs: Dict[str, NAryMatrixRelation] = {}
    msg_count, msg_size = 0, 0
    for name in util_order:
        node = nodes[name]
        # Seed with the variable's own unary costs so problems modeled
        # with variable cost functions (not only constraints) stay exact.
        acc = NAryMatrixRelation(
            [node.variable], node.variable.cost_vector(),
            name=f"util_{name}",
        )
        for c in node.constraints:
            acc = join(acc, NAryMatrixRelation.from_func_relation(c))
        for child in node.children:
            acc = join(acc, util_msgs[child])
        joined[name] = acc
        if node.parent is not None:
            util_msgs[name] = projection(acc, node.variable, mode)
            msg_count += 1
            msg_size += util_msgs[name].matrix.size

    # VALUE phase: roots pick their optimum, then each child slices its
    # joined table on the separator assignment received from above.
    assignment: Dict[str, object] = {}
    value_order = sorted(nodes, key=lambda n: depth[n])
    for name in value_order:
        node = nodes[name]
        rel = joined[name]
        known = {
            v: assignment[v] for v in rel.scope_names
            if v != name and v in assignment
        }
        if known:
            rel = rel.slice(known)
        values, _ = find_arg_optimal(node.variable, rel, mode)
        assignment[name] = values[0]
        if node.children:
            msg_count += len(node.children)

    stats = {
        "msg_count": msg_count,
        "msg_size": msg_size,
        "levels": max(depth.values(), default=0) + 1,
    }
    return assignment, stats
