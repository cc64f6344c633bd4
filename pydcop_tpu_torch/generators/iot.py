"""IoT benchmark generator: scale-free constraint graph, random costs.

Ported copy of ``pydcop_tpu/generators/iot.py``:
the port keeps its own copy, behaviour unchanged.

Reference parity: pydcop/commands/generators/iot.py (power-law graphs,
binary constraints with random costs, one agent per variable).
"""

from typing import Optional

import numpy as np

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation
from pydcop_tpu_torch.generators.graphs import scalefree_graph


def generate_iot(
    num_devices: int,
    domain_size: int = 3,
    m_edge: int = 2,
    range_cost: int = 10,
    seed: Optional[int] = None,
) -> DCOP:
    rng = np.random.default_rng(seed)
    domain = Domain("d", "action", list(range(domain_size)))
    variables = [
        Variable(f"v{i:04d}", domain) for i in range(num_devices)
    ]
    dcop = DCOP(f"iot_{num_devices}", objective="min")
    for v in variables:
        dcop.add_variable(v)
    for k, (i, j) in enumerate(
        scalefree_graph(num_devices, m_edge, seed=seed)
    ):
        table = rng.integers(
            0, range_cost, size=(domain_size, domain_size)
        ).astype(float)
        dcop.add_constraint(NAryMatrixRelation(
            [variables[i], variables[j]], table, f"c{k}"))
    dcop.add_agents([
        AgentDef(f"a{i:04d}", capacity=100) for i in range(num_devices)
    ])
    return dcop
