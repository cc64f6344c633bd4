"""Small-world benchmark generator: Watts-Strogatz constraint graph.

Ported copy of ``pydcop_tpu/generators/smallworld.py``:
the port keeps its own copy, behaviour unchanged.

Reference parity: pydcop/commands/generators/smallworld.py (small_world
subcommand: binary constraints with random costs over a small-world
graph).
"""

from typing import Optional

import numpy as np

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation
from pydcop_tpu_torch.generators.graphs import small_world_graph


def generate_small_world(
    num_variables: int,
    domain_range: int = 10,
    k: int = 4,
    p_rewire: float = 0.1,
    range_cost: int = 10,
    seed: Optional[int] = None,
) -> DCOP:
    rng = np.random.default_rng(seed)
    domain = Domain("d", "d", list(range(domain_range)))
    variables = [
        Variable(f"v{i:04d}", domain) for i in range(num_variables)
    ]
    dcop = DCOP(f"smallworld_{num_variables}", objective="min")
    for v in variables:
        dcop.add_variable(v)
    for idx, (i, j) in enumerate(
        small_world_graph(num_variables, k, p_rewire, seed=seed)
    ):
        table = rng.integers(
            0, range_cost, size=(domain_range, domain_range)
        ).astype(float)
        dcop.add_constraint(NAryMatrixRelation(
            [variables[i], variables[j]], table, f"c{idx}"))
    dcop.add_agents([
        AgentDef(f"a{i:04d}", capacity=100)
        for i in range(num_variables)
    ])
    return dcop
