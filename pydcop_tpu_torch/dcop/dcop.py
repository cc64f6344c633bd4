"""The DCOP problem container.

Ported copy of ``pydcop_tpu/dcop/dcop.py``: the port imports
nothing of the JAX package, so it keeps its own copy of the
host-side modelling layer, whole.  Behaviour is kept identical (the
compiled arrays must match the reference bit for bit).

Reference parity: pydcop/dcop/dcop.py (DCOP :41, add_agents :207, merge
:154, solution_cost :308, filter_dcop :370).
"""

from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

from pydcop_tpu_torch.dcop.objects import (
    AgentDef,
    Domain,
    ExternalVariable,
    Variable,
)
from pydcop_tpu_torch.dcop.relations import Constraint


class DCOP:
    """A DCOP: domains, variables, constraints, agents and an objective.

    >>> from pydcop_tpu_torch.dcop.objects import Variable, Domain
    >>> from pydcop_tpu_torch.dcop.relations import constraint_from_str
    >>> d = Domain('colors', 'color', ['R', 'G'])
    >>> v1, v2 = Variable('v1', d), Variable('v2', d)
    >>> c = constraint_from_str('c1', '1 if v1 == v2 else 0', [v1, v2])
    >>> dcop = DCOP('test', objective='min')
    >>> dcop.add_constraint(c)
    >>> sorted(dcop.variables)
    ['v1', 'v2']
    """

    def __init__(self, name: str = "dcop", objective: str = "min",
                 description: str = "",
                 domains: Optional[Dict[str, Domain]] = None,
                 variables: Optional[Dict[str, Variable]] = None,
                 constraints: Optional[Dict[str, Constraint]] = None,
                 agents: Optional[Dict[str, AgentDef]] = None):
        if objective not in ("min", "max"):
            raise ValueError(f"Objective must be min or max, got {objective}")
        self.name = name
        self.description = description
        self.objective = objective
        self.domains: Dict[str, Domain] = dict(domains) if domains else {}
        self.variables: Dict[str, Variable] = (
            dict(variables) if variables else {}
        )
        self.external_variables: Dict[str, ExternalVariable] = {}
        self.constraints: Dict[str, Constraint] = (
            dict(constraints) if constraints else {}
        )
        self._agents_def: "OrderedDict[str, AgentDef]" = OrderedDict()
        if agents:
            for a in agents.values():
                self.add_agents(a)
        self.dist_hints = None

    # ------------------------------------------------------------------ #
    # Content management

    def add_domain(self, domain: Domain):
        self.domains[domain.name] = domain

    def add_variable(self, variable: Variable):
        self.variables[variable.name] = variable
        self.domains.setdefault(variable.domain.name, variable.domain)

    def add_external_variable(self, variable: ExternalVariable):
        self.external_variables[variable.name] = variable
        self.domains.setdefault(variable.domain.name, variable.domain)

    def add_constraint(self, constraint: Constraint):
        """Add a constraint; its variables/domains are auto-registered."""
        self.constraints[constraint.name] = constraint
        for v in constraint.dimensions:
            if isinstance(v, ExternalVariable):
                self.add_external_variable(v)
            else:
                self.add_variable(v)

    def add_agents(self, agents: Union[AgentDef, Iterable[AgentDef], Dict]):
        if isinstance(agents, AgentDef):
            agents = [agents]
        elif isinstance(agents, dict):
            agents = list(agents.values())
        for a in agents:
            self._agents_def[a.name] = a

    @property
    def agents(self) -> Dict[str, AgentDef]:
        return self._agents_def

    def agent(self, name: str) -> AgentDef:
        return self._agents_def[name]

    def variable(self, name: str) -> Variable:
        return self.variables[name]

    def get_external_variable(self, name: str) -> ExternalVariable:
        return self.external_variables[name]

    def constraint(self, name: str) -> Constraint:
        return self.constraints[name]

    def domain(self, name: str) -> Domain:
        return self.domains[name]

    @property
    def all_variables(self) -> List[Variable]:
        return list(self.variables.values())

    def __add__(self, other: "DCOP") -> "DCOP":
        """Merge two DCOPs (same objective required)."""
        if self.objective != other.objective:
            raise ValueError("Cannot merge DCOPs with different objectives")
        merged = DCOP(f"{self.name}+{other.name}", self.objective)
        for d in (self, other):
            merged.domains.update(d.domains)
            merged.variables.update(d.variables)
            merged.external_variables.update(d.external_variables)
            merged.constraints.update(d.constraints)
            for a in d._agents_def.values():
                merged._agents_def[a.name] = a
        return merged

    # ------------------------------------------------------------------ #
    # Evaluation

    def solution_cost(self, assignment: Dict[str, Any],
                      infinity: float = float("inf")) -> Tuple[float, int]:
        """(cost, violation-count) of a full assignment.

        A constraint evaluating to +/- `infinity` counts as a hard
        violation and contributes 0 to the cost (reference convention,
        dcop.py:308-369).
        """
        cost, violations = 0.0, 0
        full = dict(assignment)
        for ev in self.external_variables.values():
            full.setdefault(ev.name, ev.value)
        for v in self.variables.values():
            if v.name not in full:
                raise ValueError(
                    f"Missing variable {v.name} in assignment"
                )
            cost += v.cost_for_val(full[v.name])
        for c in self.constraints.values():
            c_cost = c(**{v.name: full[v.name] for v in c.dimensions})
            if abs(c_cost) == infinity:
                violations += 1
            else:
                cost += c_cost
        return cost, violations

    def initial_assignment(self) -> Dict[str, Any]:
        """Initial (or first-domain-value) assignment of all variables."""
        return {
            v.name: (v.initial_value if v.initial_value is not None
                     else v.domain[0])
            for v in self.variables.values()
        }


def filter_dcop(dcop: DCOP, accept_unary: bool = False) -> DCOP:
    """Drop variables that appear in no (non-unary) constraint.

    Reference parity: dcop.py:370 — used to clean generated problems.
    """
    used = set()
    for c in dcop.constraints.values():
        if c.arity > 1 or accept_unary:
            used.update(c.scope_names)
    filtered = DCOP(dcop.name, dcop.objective, dcop.description)
    filtered.domains = dict(dcop.domains)
    for name, v in dcop.variables.items():
        if name in used:
            filtered.add_variable(v)
    for ev in dcop.external_variables.values():
        filtered.add_external_variable(ev)
    for c in dcop.constraints.values():
        if c.arity > 1 or accept_unary:
            filtered.add_constraint(c)
    filtered.add_agents(dcop.agents)
    filtered.dist_hints = dcop.dist_hints
    return filtered
