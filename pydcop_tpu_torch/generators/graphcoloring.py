"""Graph-coloring benchmark generator.

Ported copy of ``pydcop_tpu/generators/graphcoloring.py``:
the port keeps its own copy, behaviour unchanged.

Reference parity: pydcop/commands/generators/graphcoloring.py (:238
generate; soft constraints = random 0-9 extensional tables :355; hard
constraints = 1000 on equal colors :378; graphs: random/grid/scalefree
:310-354).
"""

from typing import Optional

import numpy as np

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
from pydcop_tpu_torch.dcop.relations import (
    NAryMatrixRelation,
    constraint_from_str,
)
from pydcop_tpu_torch.generators import graphs

COLORS = ["R", "G", "B", "O", "F", "Y", "L", "C"]

HARD_PENALTY = 1000


def generate_graph_coloring(
    variables_count: int,
    colors_count: int,
    graph: str = "random",
    soft: bool = False,
    intentional: bool = False,
    p_edge: Optional[float] = None,
    m_edge: Optional[int] = None,
    allow_subgraph: bool = False,
    noagents: bool = False,
    seed: Optional[int] = None,
) -> DCOP:
    rng = np.random.default_rng(seed)
    if colors_count <= len(COLORS):
        colors = COLORS[:colors_count]
    else:
        colors = list(range(colors_count))
    domain = Domain("colors", "color", colors)
    variables = [
        Variable(f"v{i:03d}", domain) for i in range(variables_count)
    ]

    if graph == "random":
        if p_edge is None:
            raise ValueError("random graphs require --p_edge")
        edges = graphs.random_graph(
            variables_count, p_edge, allow_subgraph, seed)
    elif graph == "grid":
        edges = graphs.grid_graph(variables_count)
    elif graph == "scalefree":
        if m_edge is None:
            raise ValueError("scalefree graphs require --m_edge")
        edges = graphs.scalefree_graph(
            variables_count, m_edge, allow_subgraph, seed)
    else:
        raise ValueError(f"Unknown graph type {graph!r}")

    dcop = DCOP(
        f"graph_coloring_{variables_count}_{colors_count}_{graph}",
        objective="min",
    )
    for v in variables:
        dcop.add_variable(v)
    for i, (a, b) in enumerate(edges):
        v1, v2 = variables[a], variables[b]
        name = f"c{i}"
        if soft:
            if intentional:
                raise ValueError(
                    "Soft graph coloring constraints must be extensional"
                )
            table = rng.integers(0, 10, size=(len(domain), len(domain)))
            dcop.add_constraint(NAryMatrixRelation(
                [v1, v2], table.astype(float), name))
        elif intentional:
            dcop.add_constraint(constraint_from_str(
                name,
                f"{HARD_PENALTY} if {v1.name} == {v2.name} else 0",
                [v1, v2],
            ))
        else:
            table = np.zeros((len(domain), len(domain)))
            np.fill_diagonal(table, HARD_PENALTY)
            dcop.add_constraint(NAryMatrixRelation([v1, v2], table, name))

    if not noagents:
        dcop.add_agents([
            AgentDef(f"a{i:03d}", capacity=100)
            for i in range(variables_count)
        ])
    return dcop
