"""Ising-model benchmark generator.

Ported copy of ``pydcop_tpu/generators/ising.py``:
the port keeps its own copy, behaviour unchanged.

Reference parity: pydcop/commands/generators/ising.py (:274
generate_ising): toroidal grid of binary variables; binary constraint
between neighbors costs k when equal and -k when different with
k ~ U[-bin_range, bin_range] (:360-395); unary constraint per variable
costs r for 0 and -r for 1 with r ~ U[-un_range, un_range] (:397-420);
one agent per grid cell, with factor-graph or variable distributions.
"""

from typing import Dict, Optional, Tuple

import numpy as np

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
from pydcop_tpu_torch.dcop.relations import (
    NAryMatrixRelation,
    constraint_from_str,
)
from pydcop_tpu_torch.generators.graphs import grid_2d_graph


def generate_ising(
    row_count: int,
    col_count: Optional[int] = None,
    bin_range: float = 1.6,
    un_range: float = 0.05,
    extensive: bool = True,
    no_agents: bool = False,
    fg_dist: bool = False,
    var_dist: bool = False,
    seed: Optional[int] = None,
) -> Tuple[DCOP, Dict, Dict]:
    """Returns (dcop, var_mapping, fg_mapping)."""
    if col_count is None:
        col_count = row_count
    rng = np.random.default_rng(seed)
    domain = Domain("var_domain", "binary", [0, 1])
    variables = {
        (r, c): Variable(f"v_{r}_{c}", domain)
        for r in range(row_count) for c in range(col_count)
    }
    dcop = DCOP(
        f"Ising_{row_count}_{col_count}_{bin_range}_{un_range}",
        objective="min",
    )
    for v in variables.values():
        dcop.add_variable(v)

    # Unary constraints.
    for (r, c), v in variables.items():
        value = float(rng.uniform(-un_range, un_range))
        name = f"cu_{v.name}"
        if extensive:
            dcop.add_constraint(NAryMatrixRelation(
                [v], np.array([value, -value]), name))
        else:
            dcop.add_constraint(constraint_from_str(
                name, f"{value} if {v.name} == 0 else {-value}", [v]))

    # Binary constraints on the toroidal grid.
    for (n1, n2) in grid_2d_graph(row_count, col_count, periodic=True):
        v1, v2 = variables[n1], variables[n2]
        value = float(rng.uniform(-bin_range, bin_range))
        name = f"cb_{v1.name}_{v2.name}"
        if extensive:
            table = np.array([[value, -value], [-value, value]])
            dcop.add_constraint(NAryMatrixRelation([v1, v2], table, name))
        else:
            dcop.add_constraint(constraint_from_str(
                name,
                f"{value} if {v1.name} == {v2.name} else {-value}",
                [v1, v2],
            ))

    var_mapping: Dict[str, list] = {}
    fg_mapping: Dict[str, list] = {}
    if not no_agents:
        for (r, c), v in variables.items():
            agent = AgentDef(f"a_{r}_{c}")
            dcop.add_agents(agent)
            if var_dist:
                var_mapping[agent.name] = [v.name]
            if fg_dist:
                fg_mapping[agent.name] = [v.name, f"cu_{v.name}"]
        if fg_dist:
            # Assign each binary constraint to exactly one agent (its
            # first endpoint's) — derived from the real edge list so
            # small/toroidal-duplicate grids stay consistent.
            for (n1, n2) in grid_2d_graph(
                row_count, col_count, periodic=True
            ):
                v1, v2 = variables[n1], variables[n2]
                fg_mapping[f"a_{n1[0]}_{n1[1]}"].append(
                    f"cb_{v1.name}_{v2.name}"
                )
    return dcop, var_mapping, fg_mapping
