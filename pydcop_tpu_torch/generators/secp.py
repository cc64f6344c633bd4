"""SECP (Smart Environment Configuration Problem) generator —
smart-lighting scenes.

Ported copy of ``pydcop_tpu/generators/secp.py``:
the port keeps its own copy, behaviour unchanged.

Reference parity: pydcop/commands/generators/secp.py: lights are
variables over levels 0-4 with linear energy cost (:306-322); each model
is a variable plus a hard defining constraint tying it to a weighted sum
of lights (:201-236); rules are soft constraints setting targets for
lights/models (:238-303); one agent per light (:178-198).
"""

from typing import Optional

import numpy as np

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
from pydcop_tpu_torch.dcop.relations import constraint_from_str


def generate_secp(
    lights: int,
    models: int,
    rules: int,
    capacity: Optional[int] = None,
    max_model_size: int = 3,
    max_rule_size: int = 3,
    seed: Optional[int] = None,
) -> DCOP:
    rng = np.random.default_rng(seed)
    light_domain = Domain("light", "light", list(range(5)))
    dcop = DCOP(f"secp_{lights}_{models}_{rules}", objective="min")

    light_vars = {}
    for i in range(lights):
        v = Variable(f"l{i}", light_domain)
        light_vars[v.name] = v
        dcop.add_variable(v)
        efficiency = int(rng.integers(1, 10)) / 10
        dcop.add_constraint(constraint_from_str(
            f"c_l{i}", f"{efficiency} * l{i}", [v]))

    model_vars = {}
    for j in range(models):
        mv = Variable(f"m{j}", light_domain)
        model_vars[mv.name] = mv
        dcop.add_variable(mv)
        size = int(rng.integers(2, max(3, max_model_size + 1)))
        chosen = rng.choice(
            list(light_vars), size=min(size, lights), replace=False)
        parts = []
        for name in chosen:
            impact = int(rng.integers(1, 8)) / 10
            parts.append(f"{name} * {impact}")
        expression = (
            f"0 if 10 * abs(m{j} - ({' + '.join(parts)})) < 5 else 10000"
        )
        dcop.add_constraint(constraint_from_str(
            f"c_m{j}", expression,
            list(light_vars.values()) + [mv],
        ))

    all_vars = {**light_vars, **model_vars}
    for k in range(rules):
        max_size = min(max_rule_size, len(all_vars))
        size = int(rng.integers(1, max_size + 1))
        chosen = rng.choice(list(all_vars), size=size, replace=False)
        parts = [
            f"abs({name} - {int(rng.integers(0, 5))} )" for name in chosen
        ]
        dcop.add_constraint(constraint_from_str(
            f"r_{k}", f"10 * ({' + '.join(parts)})",
            list(all_vars.values()),
        ))

    # One agent per light with hosting cost 0 for its own light variable
    # and the light's cost factor — the pinning convention every SECP
    # distribution method relies on (reference generators/secp.py:178-198
    # build_agents: hosting_costs={light: 0, light_cost: 0},
    # default_hosting_cost=100).
    extra = {"capacity": capacity} if capacity else {}
    dcop.add_agents([
        AgentDef(
            f"a{i}",
            hosting_costs={f"l{i}": 0, f"c_l{i}": 0},
            default_hosting_cost=100,
            **extra,
        )
        for i in range(lights)
    ])
    return dcop
