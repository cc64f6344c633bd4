"""SyncBB: Synchronous Branch & Bound — complete search over a total
variable order.

Port of ``pydcop_tpu/algorithms/syncbb.py``: a host search that touches
no tensor; the solve's ``device`` is checked (the device rule) and not
used.

Reference parity: pydcop/algorithms/syncbb.py (:160-512): variables in
lexical order exchange forward (partial path + bound) / backward /
terminate messages, one token in flight; each step extends the path with
the next value whose partial cost stays under the current bound.

Engine path: the same search executed as an iterative host DFS over the
ordered graph — sequential by nature (one token in the reference too),
so there is nothing to batch; constraint tables are pre-materialized
dense so per-step evaluation is array indexing, and partial costs are
accumulated incrementally per depth (a constraint is charged at the
depth where its last scope variable is assigned).

Example::

    >>> from pydcop_tpu_torch.api import solve
    >>> from pydcop_tpu_torch.dcop.dcop import DCOP
    >>> from pydcop_tpu_torch.dcop.objects import Domain, Variable
    >>> from pydcop_tpu_torch.dcop.relations import constraint_from_str
    >>> d = Domain('d', '', [0, 1])
    >>> x, y = Variable('x', d), Variable('y', d)
    >>> dcop = DCOP('doc', objective='min')
    >>> dcop.add_constraint(constraint_from_str('c', '(x + y - 1)**2', [x, y]))
    >>> res = solve(dcop, 'syncbb', device='cpu')
    >>> round(res['cost'], 3)
    0.0
"""

from typing import Dict, List, Optional

import numpy as np

from pydcop_tpu_torch.algorithms import AlgorithmDef
from pydcop_tpu_torch.computations_graph import ordered_graph as og
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike, resolve_device
from pydcop_tpu_torch.engine.runner import DeviceRunResult

GRAPH_TYPE = "ordered_graph"

algo_params = []


def computation_memory(node) -> float:
    return og.computation_memory(node)


def communication_load(src, target: str) -> float:
    return og.communication_load(src, target)


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
    variables = sorted(dcop.variables.values(), key=lambda v: v.name)
    var_index = {v.name: i for i, v in enumerate(variables)}
    domains = [list(v.domain) for v in variables]

    # Unary costs per variable (sign-adjusted so we always minimize).
    unary = [sign * v.cost_vector() for v in variables]

    # Charge each constraint at the depth where its scope completes.
    charged: List[List] = [[] for _ in variables]
    for c in dcop.constraints.values():
        if c.arity == 0:
            continue
        positions = [var_index[n] for n in c.scope_names]
        table = sign * np.asarray(c.to_array(), dtype=np.float64)
        charged[max(positions)].append((positions, table))

    n = len(variables)
    # Admissible future bound per depth: the best the not-yet-charged
    # costs could still contribute (needed for pruning correctness when
    # costs are negative, e.g. negated max-mode tables).
    step_lb = [
        float(np.min(unary[d])) + sum(
            float(np.min(table)) for _, table in charged[d]
        )
        for d in range(n)
    ]
    future_lb = [0.0] * (n + 1)
    for d in range(n - 1, -1, -1):
        future_lb[d] = future_lb[d + 1] + step_lb[d]

    best_cost = np.inf
    best_assignment: Optional[List[int]] = None
    # DFS stack: current value index per depth, -1 = not yet branched.
    values = [-1] * n
    prefix_cost = [0.0] * (n + 1)
    depth = 0
    steps = 0
    while depth >= 0:
        values[depth] += 1
        if values[depth] >= len(domains[depth]):
            values[depth] = -1
            depth -= 1
            continue
        steps += 1
        cost = prefix_cost[depth] + unary[depth][values[depth]]
        for positions, table in charged[depth]:
            cost += table[tuple(values[p] for p in positions)]
        if cost + future_lb[depth + 1] >= best_cost:
            continue  # prune: even a perfect completion cannot improve
        if depth == n - 1:
            best_cost = cost
            best_assignment = values[:]
            continue
        prefix_cost[depth + 1] = cost
        depth += 1

    elapsed = time.perf_counter() - t0
    if best_assignment is None:
        # Every full assignment hit an infinite cost: report initial.
        assignment = dcop.initial_assignment()
    else:
        assignment = {
            v.name: domains[i][best_assignment[i]]
            for i, v in enumerate(variables)
        }
    cost, _ = dcop.solution_cost(assignment)
    return DeviceRunResult(
        assignment=assignment,
        cycles=steps,
        converged=True,
        time_s=elapsed,
        compile_time_s=0.0,
        metrics={"msg_count": steps, "device_cost": cost},
    )
