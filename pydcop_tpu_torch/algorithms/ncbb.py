"""NCBB: No-Commitment Branch and Bound (Chechetka & Sycara, 2006).

Port of ``pydcop_tpu/algorithms/ncbb.py``: a host search that touches
no tensor; the solve's ``device`` is checked (the device rule) and not
used.

Reference parity: pydcop/algorithms/ncbb.py (:139-350) — one computation
per variable on a DFS pseudo-tree, binary constraints only, synchronous.
Two phases: INIT (VALUE messages flow root→leaves, each variable greedily
picks the value optimal w.r.t. its already-assigned ancestors; leaves
start COST messages that accumulate subtree upper bounds on the way back
up, :216-330) and SEARCH.  The reference's search phase is a stub
(``search()`` is ``pass``, ncbb.py:341), so its observable result is the
greedy INIT assignment; here the engine path runs a *complete* search —
AND/OR branch-and-bound over the pseudo-tree, where sibling subtrees are
solved independently given their ancestor context (the "concurrent
search in different partitions" of the original article) with the INIT
upper bound used for pruning — and therefore returns the optimum.

Engine path: sequential host search (branch & bound is inherently
sequential, like syncbb); constraint tables are pre-materialized dense
numpy arrays so per-node evaluation is array indexing, and static
per-subtree lower bounds provide admissible pruning.

The reference's agent mode (a distributed AND/OR search with message
passing over the pseudo-tree) is not ported.

Example::

    >>> from pydcop_tpu_torch.api import solve
    >>> from pydcop_tpu_torch.dcop.dcop import DCOP
    >>> from pydcop_tpu_torch.dcop.objects import Domain, Variable
    >>> from pydcop_tpu_torch.dcop.relations import constraint_from_str
    >>> d = Domain('d', '', [0, 1])
    >>> x, y = Variable('x', d), Variable('y', d)
    >>> dcop = DCOP('doc', objective='min')
    >>> dcop.add_constraint(constraint_from_str('c', '(x + y - 1)**2', [x, y]))
    >>> res = solve(dcop, 'ncbb', device='cpu')
    >>> round(res['cost'], 3)
    0.0
"""

from typing import Dict, List, Optional

import numpy as np

from pydcop_tpu_torch.algorithms import AlgorithmDef
from pydcop_tpu_torch.computations_graph import pseudotree as pt
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.engine.runner import DeviceRunResult
from pydcop_tpu_torch.infrastructure.computations import ComputationException

GRAPH_TYPE = "pseudotree"

algo_params = []


def computation_memory(node) -> float:
    return pt.computation_memory(node)


def communication_load(src, target: str) -> float:
    return pt.communication_load(src, target)


def _check_binary(graph) -> None:
    """Reference ncbb.py:169-177: only binary constraints are supported
    (unary costs ride on the variable's cost vector instead)."""
    for node in graph.nodes:
        for c in node.constraints:
            if c.arity > 2:
                raise ComputationException(
                    f"Invalid constraint {c} with arity {c.arity} for "
                    f"variable {node.name}, NCBB only supports binary "
                    "constraints."
                )


def solve_on_device(dcop: DCOP, algo_def: AlgorithmDef,
                    max_cycles: int = 0, mesh=None,
                    n_devices: Optional[int] = None,
                    device: DeviceLike = "cuda",
                    **_) -> DeviceRunResult:
    import time

    resolve_device(device)
    t0 = time.perf_counter()
    mode = dcop.objective
    sign = 1.0 if mode == "min" else -1.0
    graph = pt.build_computation_graph(dcop)
    _check_binary(graph)
    nodes = {n.name: n for n in graph.nodes}

    # Dense per-node data, sign-adjusted so the search always minimizes.
    # Each constraint is charged at the lowest (deepest) node of its
    # scope — for binary constraints on a pseudo-tree the other scope
    # variable is always an ancestor of that node.
    domains: Dict[str, list] = {}
    unary: Dict[str, np.ndarray] = {}
    charged: Dict[str, list] = {}  # name -> [(ancestor or None, table)]
    for name, node in nodes.items():
        domains[name] = list(node.variable.domain)
        unary[name] = sign * node.variable.cost_vector()
        charged[name] = []
        for c in node.constraints:
            table = sign * np.asarray(c.to_array(), dtype=np.float64)
            if c.arity == 1:
                unary[name] = unary[name] + table
                continue
            other = next(n for n in c.scope_names if n != name)
            # Order the table as [other, self] for uniform indexing.
            if c.scope_names[0] == name:
                table = table.T
            charged[name].append((other, table))

    # Static admissible lower bound per subtree (used for pruning).
    lb_subtree: Dict[str, float] = {}

    def _lb(name: str) -> float:
        if name not in lb_subtree:
            node = nodes[name]
            own = float(np.min(unary[name]))
            for _, table in charged[name]:
                own += float(np.min(table))
            lb_subtree[name] = own + sum(_lb(ch) for ch in node.children)
        return lb_subtree[name]

    for name in nodes:
        _lb(name)

    # ---- INIT phase: greedy top-down, exactly the reference's VALUE
    # propagation (each variable optimizes w.r.t. assigned ancestors).
    greedy: Dict[str, int] = {}
    roots = [n.name for n in graph.nodes if n.parent is None]
    order: List[str] = []
    stack = list(roots)
    while stack:
        name = stack.pop()
        order.append(name)
        costs = unary[name].copy()
        for other, table in charged[name]:
            if other in greedy:
                costs = costs + table[greedy[other], :]
        greedy[name] = int(np.argmin(costs))
        stack.extend(nodes[name].children)
    upper_bound = _assignment_cost(greedy, unary, charged)
    msg_count = 2 * len(order)  # VALUE down + COST up

    # ---- SEARCH phase: AND/OR branch and bound.  Sibling subtrees are
    # independent given the ancestor context, so each is searched on its
    # own with a budget derived from the current bound.
    steps = 0

    def search(name: str, context: Dict[str, int], budget: float):
        """Best (cost, assignment) for the subtree rooted at ``name``
        given ancestor values ``context``; (inf, None) if nothing beats
        ``budget``."""
        nonlocal steps
        node = nodes[name]
        costs = unary[name].copy()
        for other, table in charged[name]:
            costs = costs + table[context[other], :]
        children = node.children
        children_lb = sum(lb_subtree[ch] for ch in children)
        best_cost, best_assign = np.inf, None
        # Visit values cheapest-first so good bounds arrive early.
        for v in np.argsort(costs, kind="stable"):
            steps += 1
            own = float(costs[v])
            bound = min(budget, best_cost)
            if own + children_lb >= bound:
                break  # sorted order: no later value can do better
            total = own
            assign = {name: int(v)}
            ctx = {**context, name: int(v)}
            ok = True
            for i, ch in enumerate(children):
                rest_lb = sum(lb_subtree[c] for c in children[i + 1:])
                ch_cost, ch_assign = search(
                    ch, ctx, bound - total - rest_lb
                )
                if ch_assign is None:
                    ok = False
                    break
                total += ch_cost
                assign.update(ch_assign)
            if ok and total < best_cost:
                best_cost, best_assign = total, assign
        return best_cost, best_assign

    assignment_idx: Dict[str, int] = {}
    total_cost = 0.0
    for root in roots:
        # Give each root the greedy bound for its own tree plus slack of
        # what other trees can still save; independent trees, so just use
        # the global upper bound minus other trees' lower bounds.
        others_lb = sum(lb_subtree[r] for r in roots if r != root)
        cost, assign = search(root, {}, upper_bound - others_lb + 1e-9)
        if assign is None:
            # Greedy was already optimal for this subtree.
            sub = _subtree_names(nodes, root)
            assign = {n: greedy[n] for n in sub}
            cost = _assignment_cost(
                assign, unary, charged, restrict=set(sub)
            )
        assignment_idx.update(assign)
        total_cost += cost

    elapsed = time.perf_counter() - t0
    assignment = {
        name: domains[name][idx] for name, idx in assignment_idx.items()
    }
    cost, _ = dcop.solution_cost(assignment)
    return DeviceRunResult(
        assignment=assignment,
        cycles=steps,
        converged=True,
        time_s=elapsed,
        compile_time_s=0.0,
        metrics={
            "msg_count": msg_count + steps,
            "device_cost": cost,
            "upper_bound": float(sign * upper_bound),
        },
    )


def _subtree_names(nodes, root: str) -> List[str]:
    out, stack = [], [root]
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(nodes[n].children)
    return out


def _assignment_cost(assign: Dict[str, int], unary, charged,
                     restrict=None) -> float:
    total = 0.0
    for name, v in assign.items():
        if restrict is not None and name not in restrict:
            continue
        total += float(unary[name][v])
        for other, table in charged[name]:
            total += float(table[assign[other], v])
    return total
