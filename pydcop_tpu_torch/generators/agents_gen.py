"""Agent-definition generator: capacities, hosting costs, routes.

Ported copy of ``pydcop_tpu/generators/agents_gen.py``:
the port keeps its own copy, behaviour unchanged.

Reference parity: pydcop/commands/generators/agents.py — modes
``variables`` (one agent per variable of given dcops) and ``count``;
hosting-cost methods None / name_mapping (cost 0 for the computation
whose name maps to the agent) / var_startswith; route methods None /
uniform.
"""

from typing import List, Optional

import numpy as np

from pydcop_tpu_torch.dcop.objects import AgentDef


def generate_agents(
    mode: str = "count",
    count: Optional[int] = None,
    variables: Optional[List[str]] = None,
    agent_prefix: str = "a",
    capacity: int = 100,
    hosting: str = "None",
    hosting_default: Optional[int] = None,
    routes: str = "None",
    routes_default: Optional[int] = None,
    adjacency: Optional[List] = None,
    seed: Optional[int] = None,
) -> List[AgentDef]:
    """`adjacency` (pairs of variable names sharing a constraint) is
    required for routes='graph': connected agents get cheap (1) routes,
    all other pairs the default."""
    rng = np.random.default_rng(seed)
    if hosting == "name_mapping" and mode != "variables":
        raise ValueError(
            "hosting 'name_mapping' requires mode 'variables' (one "
            "agent per variable, from dcop files)"
        )
    if routes == "graph" and adjacency is None:
        raise ValueError(
            "routes 'graph' requires dcop files (constraint adjacency)"
        )
    if mode == "variables":
        if not variables:
            raise ValueError(
                "agents generation mode 'variables' requires variables"
            )
        names = [f"{agent_prefix}{v}" for v in variables]
    else:
        if not count:
            raise ValueError(
                "agents generation mode 'count' requires count"
            )
        width = len(str(count - 1))
        names = [
            f"{agent_prefix}{i:0{width}d}" for i in range(count)
        ]
        variables = variables or []

    agents = []
    for i, name in enumerate(names):
        hosting_costs = {}
        default_hosting = 0
        if hosting != "None":
            if hosting_default is None:
                raise ValueError(
                    "--hosting requires --hosting_default"
                )
            default_hosting = hosting_default
            if hosting == "name_mapping" and mode == "variables":
                hosting_costs = {variables[i]: 0}
            elif hosting == "var_startswith":
                hosting_costs = {
                    v: 0 for v in variables
                    if name.endswith(v) or v.startswith(
                        name[len(agent_prefix):])
                }
        route_costs = {}
        default_route = 1
        if routes != "None":
            if routes_default is None:
                raise ValueError("--routes requires --routes_default")
            default_route = routes_default
            if routes == "graph" and mode == "variables":
                # Cheap routes between agents whose variables share a
                # constraint; default cost elsewhere (symmetric: stored
                # on both agents via the shared dict below).
                var_of_agent = variables[i]
                for (a, b) in adjacency:
                    other_var = None
                    if a == var_of_agent:
                        other_var = b
                    elif b == var_of_agent:
                        other_var = a
                    if other_var is not None and other_var in variables:
                        j = variables.index(other_var)
                        route_costs[names[j]] = 1
        agents.append(AgentDef(
            name,
            default_hosting_cost=default_hosting,
            hosting_costs=hosting_costs,
            default_route=default_route,
            routes=route_costs,
            capacity=capacity,
        ))
    return agents
