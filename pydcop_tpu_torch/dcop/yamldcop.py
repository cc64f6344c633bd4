"""YAML (de)serialization for DCOPs, agents, distributions and scenarios.

Ported copy of ``pydcop_tpu/dcop/yamldcop.py``: the port imports
nothing of the JAX package, so it keeps its own copy of the
host-side modelling layer.  Behaviour is kept identical (the
compiled arrays must match the reference bit for bit; the writers
give the reference's text).

Reference parity: pydcop/dcop/yamldcop.py (load_dcop_from_file :63,
load_dcop :96, dcop_yaml :119, _build_constraints :217, _build_agents
:316, yaml_agents :397, scenario load :504).  Format spec:
docs/usage/file_formats/dcop_format.yml in the reference — this module
accepts the exact same files (round-trip tested against the reference's
fixtures in tests/instances/).
"""

import os
import re
from typing import Any, Dict, Iterable, List, Optional, Union

import yaml

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import (
    AgentDef,
    Domain,
    ExternalVariable,
    Variable,
    VariableNoisyCostFunc,
    VariableWithCostFunc,
)
from pydcop_tpu_torch.dcop.relations import (
    Constraint,
    NAryMatrixRelation,
    assignment_matrix,
    constraint_from_external_definition,
    constraint_from_str,
)
from pydcop_tpu_torch.dcop.scenario import DcopEvent, EventAction, Scenario
from pydcop_tpu_torch.distribution.objects import (
    Distribution,
    DistributionHints,
)

_RANGE_RE = re.compile(r"^\s*(-?\d+)\s*\.\.\s*(-?\d+)\s*$")


class DcopInvalidFormatError(Exception):
    pass


# --------------------------------------------------------------------- #
# Loading


def load_dcop_from_file(filenames: Union[str, Iterable[str]],
                        main_dir: Optional[str] = None) -> DCOP:
    """Load a DCOP from one or several YAML files (contents are
    concatenated, reference behavior yamldcop.py:63)."""
    if isinstance(filenames, str):
        filenames = [filenames]
    filenames = list(filenames)
    contents = []
    for f in filenames:
        with open(f, encoding="utf-8") as fh:
            contents.append(fh.read())
    if main_dir is None:
        main_dir = os.path.dirname(os.path.abspath(filenames[0]))
    return load_dcop("\n".join(contents), main_dir=main_dir)


def _parse_domain_values(raw_values) -> List:
    if isinstance(raw_values, str):
        m = _RANGE_RE.match(raw_values)
        if m:
            lo, hi = int(m.group(1)), int(m.group(2))
            return list(range(lo, hi + 1))
        # Single scalar string: fall through to the shared coercion so
        # values: "7" and values: ["7"] produce the same int domain.
        raw_values = [raw_values]
    elif not isinstance(raw_values, (list, tuple)):
        # Unquoted scalar (values: 7 — yaml already parsed the type):
        # a one-value domain, same as the quoted form.
        raw_values = [raw_values]
    values: List = []
    for v in raw_values:
        if isinstance(v, str):
            m = _RANGE_RE.match(v)
            if m:
                values.extend(range(int(m.group(1)), int(m.group(2)) + 1))
                continue
        values.append(v)
    # If every value is an int or a *string* that parses as one, the
    # domain is an int domain (reference behavior for ranges / quoted
    # ints) — this also covers a range mixed with quoted ints, which
    # would otherwise produce an inconsistent [1, 2, 3, '7'] domain.
    # Values yaml already parsed as floats/bools are kept as-is —
    # coercing them would corrupt the domain.
    def _is_intish(v):
        if isinstance(v, bool) or not isinstance(v, (int, str)):
            return False
        if isinstance(v, str):
            try:
                int(v)
            except ValueError:
                return False
        return True

    if values and any(isinstance(v, str) for v in values) \
            and all(_is_intish(v) for v in values):
        return [int(v) for v in values]
    return values


# libyaml's parser where PyYAML was built with it: the same safe
# constructor and resolvers as ``yaml.safe_load``, several times faster
# on the megabyte documents a 10,000-variable problem makes.
_SAFE_LOADER = getattr(yaml, "CSafeLoader", yaml.SafeLoader)


def _safe_load(text: str):
    return yaml.load(text, Loader=_SAFE_LOADER)


def load_dcop(yaml_str: str, main_dir: str = ".") -> DCOP:
    data = _safe_load(yaml_str)
    if not data or "name" not in data:
        raise DcopInvalidFormatError("Missing DCOP name")
    objective = data.get("objective", "min")
    dcop = DCOP(
        data["name"], objective, description=data.get("description", "")
    )

    for dname, dspec in (data.get("domains") or {}).items():
        values = _parse_domain_values(dspec["values"])
        dcop.add_domain(Domain(dname, dspec.get("type", ""), values))

    for vname, vspec in (data.get("variables") or {}).items():
        dom = dcop.domain(vspec["domain"])
        initial = vspec.get("initial_value")
        if "cost_function" in vspec:
            if vspec.get("noise_level"):
                var: Variable = VariableNoisyCostFunc(
                    vname, dom, str(vspec["cost_function"]),
                    initial_value=initial,
                    noise_level=float(vspec["noise_level"]),
                )
            else:
                var = VariableWithCostFunc(
                    vname, dom, str(vspec["cost_function"]),
                    initial_value=initial,
                )
        else:
            var = Variable(vname, dom, initial_value=initial)
        dcop.add_variable(var)

    for vname, vspec in (data.get("external_variables") or {}).items():
        dom = dcop.domain(vspec["domain"])
        if "initial_value" not in vspec:
            raise DcopInvalidFormatError(
                f"External variable {vname} requires an initial_value"
            )
        dcop.add_external_variable(
            ExternalVariable(vname, dom, vspec["initial_value"])
        )

    all_vars = list(dcop.variables.values()) + list(
        dcop.external_variables.values()
    )
    by_name = {v.name: v for v in all_vars}
    for cname, cspec in (data.get("constraints") or {}).items():
        dcop.constraints[cname] = _build_constraint(
            cname, cspec, all_vars, main_dir, by_name
        )

    _build_agents(dcop, data.get("agents"), data.get("routes"),
                  data.get("hosting_costs"))

    hints = data.get("distribution_hints")
    if hints:
        dcop.dist_hints = DistributionHints(
            hints.get("must_host"), hints.get("host_with")
        )
    return dcop


def _build_constraint(cname: str, cspec: Dict, all_vars: List[Variable],
                      main_dir: str,
                      by_name: Dict[str, Variable]) -> Constraint:
    ctype = cspec.get("type")
    if ctype == "intention":
        expression = str(cspec["function"])
        if "source" in cspec:
            source = cspec["source"]
            if not os.path.isabs(source):
                source = os.path.join(main_dir, source)
            constraint = constraint_from_external_definition(
                cname, source, expression, all_vars
            )
        else:
            constraint = constraint_from_str(cname, expression, all_vars)
        partial = cspec.get("partial")
        if partial:
            sliced = constraint.slice(partial)
            sliced._name = cname
            return sliced
        return constraint
    if ctype == "extensional":
        var_names = cspec["variables"]
        if isinstance(var_names, str):
            var_names = [var_names]
        try:
            variables = [by_name[n] for n in var_names]
        except KeyError as e:
            raise DcopInvalidFormatError(
                f"Unknown variable in constraint {cname}: {e}"
            )
        default = cspec.get("default", 0)
        matrix = assignment_matrix(variables, default)
        for value, assignments in (cspec.get("values") or {}).items():
            for assignment in str(assignments).split("|"):
                tokens = _split_assignment_tokens(assignment)
                if len(tokens) != len(variables):
                    raise DcopInvalidFormatError(
                        f"Bad assignment {assignment!r} for constraint "
                        f"{cname}: expected {len(variables)} values"
                    )
                idx = tuple(
                    v.domain.to_domain_value(t)[0]
                    for v, t in zip(variables, tokens)
                )
                matrix[idx] = value
        return NAryMatrixRelation(variables, matrix, cname)
    raise DcopInvalidFormatError(
        f"Constraint {cname} has invalid type {ctype!r}"
    )


def _split_assignment_tokens(assignment: str) -> List[str]:
    """Split "1 2 'too bad'" into ['1', '2', 'too bad']."""
    tokens = re.findall(r"'[^']*'|\"[^\"]*\"|\S+", assignment.strip())
    return [t.strip("'\"") for t in tokens]


def _quote_token(token: str) -> str:
    """Quote an extensional-assignment token if it contains whitespace,
    so dumped files re-load through _split_assignment_tokens."""
    if re.search(r"\s", token):
        return "'" + token + "'"
    return token


def _build_agents(dcop: DCOP, agents_spec, routes_spec, hosting_spec):
    if agents_spec is None:
        return
    routes_spec = routes_spec or {}
    hosting_spec = hosting_spec or {}
    default_route = routes_spec.get("default", 1)
    default_hosting = hosting_spec.get("default", 0)

    # Routes are symmetric; defining the same pair twice is an error.
    routes: Dict[str, Dict[str, float]] = {}
    seen = set()
    for a, targets in routes_spec.items():
        if a == "default":
            continue
        for b, cost in targets.items():
            pair = frozenset((a, b))
            if pair in seen:
                raise DcopInvalidFormatError(
                    f"Route ({a}, {b}) defined more than once"
                )
            seen.add(pair)
            routes.setdefault(a, {})[b] = cost
            routes.setdefault(b, {})[a] = cost

    if isinstance(agents_spec, list):
        agents_spec = {a: {} for a in agents_spec}

    for aname, aspec in agents_spec.items():
        aspec = aspec or {}
        a_hosting = hosting_spec.get(aname, {}) or {}
        agent = AgentDef(
            aname,
            default_hosting_cost=a_hosting.get("default", default_hosting),
            hosting_costs=a_hosting.get("computations"),
            default_route=default_route,
            routes=routes.get(aname),
            **aspec,
        )
        dcop.add_agents(agent)


# --------------------------------------------------------------------- #
# Dumping


def dcop_yaml(dcop: DCOP) -> str:
    """Serialize a DCOP back to the YAML format."""
    data: Dict[str, Any] = {
        "name": dcop.name,
        "objective": dcop.objective,
    }
    if dcop.description:
        data["description"] = dcop.description
    data["domains"] = {
        d.name: {
            "values": list(d.values),
            **({"type": d.type} if d.type else {}),
        }
        for d in dcop.domains.values()
    }
    variables = {}
    for v in dcop.variables.values():
        vspec: Dict[str, Any] = {"domain": v.domain.name}
        if v.initial_value is not None:
            vspec["initial_value"] = v.initial_value
        if isinstance(v, VariableNoisyCostFunc):
            vspec["cost_function"] = v.cost_func.expression
            vspec["noise_level"] = v.noise_level
        elif isinstance(v, VariableWithCostFunc):
            if hasattr(v.cost_func, "expression"):
                vspec["cost_function"] = v.cost_func.expression
        variables[v.name] = vspec
    data["variables"] = variables
    if dcop.external_variables:
        data["external_variables"] = {
            v.name: {"domain": v.domain.name, "initial_value": v.value}
            for v in dcop.external_variables.values()
        }
    constraints = {}
    for c in dcop.constraints.values():
        if isinstance(c, NAryMatrixRelation):
            values: Dict[float, List[str]] = {}
            import numpy as np

            for idx in np.ndindex(*c.matrix.shape):
                val = float(c.matrix[idx])
                if val == 0:
                    continue
                assignment = " ".join(
                    _quote_token(str(v.domain[i]))
                    for v, i in zip(c.dimensions, idx)
                )
                values.setdefault(val, []).append(assignment)
            constraints[c.name] = {
                "type": "extensional",
                "variables": c.scope_names,
                "values": {
                    (int(v) if float(v).is_integer() else v):
                        " | ".join(assts)
                    for v, assts in values.items()
                },
            }
        else:
            expr = getattr(c, "expression", None)
            if expr is None:
                raise ValueError(
                    f"Cannot serialize constraint {c.name}: no expression"
                )
            constraints[c.name] = {"type": "intention", "function": expr}
    data["constraints"] = constraints
    if dcop.agents:
        data["agents"] = {
            a.name: (
                {**a.extra_attr} if a.extra_attr else {}
            )
            for a in dcop.agents.values()
        }
        # Routes (symmetric: dump each pair once) and hosting costs.
        routes: Dict[str, Dict[str, float]] = {}
        dumped_pairs = set()
        hosting: Dict[str, Any] = {}
        for a in dcop.agents.values():
            for other, cost in a.routes.items():
                pair = frozenset((a.name, other))
                if pair in dumped_pairs:
                    continue
                dumped_pairs.add(pair)
                routes.setdefault(a.name, {})[other] = cost
            h: Dict[str, Any] = {}
            if a.default_hosting_cost:
                h["default"] = a.default_hosting_cost
            if a.hosting_costs:
                h["computations"] = a.hosting_costs
            if h:
                hosting[a.name] = h
        default_routes = {a.default_route for a in dcop.agents.values()}
        if default_routes != {1} and len(default_routes) == 1:
            routes = {"default": default_routes.pop(), **routes}
        if routes:
            data["routes"] = routes
        if hosting:
            data["hosting_costs"] = hosting
    if dcop.dist_hints is not None:
        hints: Dict[str, Any] = {}
        if dcop.dist_hints.must_host_map:
            hints["must_host"] = dcop.dist_hints.must_host_map
        if hints:
            data["distribution_hints"] = hints
    return yaml.safe_dump(data, sort_keys=False, default_flow_style=False)


def yaml_agents(agents: List[AgentDef]) -> str:
    """Serialize a list of AgentDefs (``pydcop generate agents`` output)."""
    data: Dict[str, Any] = {}
    hosting: Dict[str, Any] = {}
    routes: Dict[str, Any] = {}
    for a in agents:
        data[a.name] = dict(a.extra_attr)
        if a.hosting_costs or a.default_hosting_cost:
            h: Dict[str, Any] = {}
            if a.default_hosting_cost:
                h["default"] = a.default_hosting_cost
            if a.hosting_costs:
                h["computations"] = a.hosting_costs
            hosting[a.name] = h
        if a.routes:
            routes[a.name] = a.routes
    out: Dict[str, Any] = {"agents": data}
    if hosting:
        out["hosting_costs"] = hosting
    if routes:
        out["routes"] = routes
    return yaml.safe_dump(out, sort_keys=False)


def load_agents_from_file(filename: str) -> List[AgentDef]:
    with open(filename, encoding="utf-8") as f:
        return load_agents(f.read())


def load_agents(yaml_str: str) -> List[AgentDef]:
    data = _safe_load(yaml_str) or {}
    dcop = DCOP("agents_only")
    _build_agents(dcop, data.get("agents"), data.get("routes"),
                  data.get("hosting_costs"))
    return list(dcop.agents.values())


# --------------------------------------------------------------------- #
# Scenario


def load_scenario_from_file(filename: str) -> Scenario:
    with open(filename, encoding="utf-8") as f:
        return load_scenario(f.read())


def load_scenario(yaml_str: str) -> Scenario:
    data = _safe_load(yaml_str) or {}
    events = []
    for espec in data.get("events") or []:
        if "delay" in espec:
            events.append(DcopEvent(espec.get("id", "delay"),
                                    delay=float(espec["delay"])))
        else:
            actions = [
                EventAction(
                    a["type"],
                    **{k: v for k, v in a.items() if k != "type"},
                )
                for a in espec.get("actions", [])
            ]
            events.append(DcopEvent(espec["id"], actions=actions))
    return Scenario(events)


def yaml_scenario(scenario: Scenario) -> str:
    events = []
    for e in scenario.events:
        if e.is_delay:
            events.append({"id": e.id, "delay": e.delay})
        else:
            events.append({
                "id": e.id,
                "actions": [
                    {"type": a.type, **a.args} for a in e.actions
                ],
            })
    return yaml.safe_dump({"events": events}, sort_keys=False)


# --------------------------------------------------------------------- #
# Distribution files (dist_format.yml)


def load_dist_from_file(filename: str) -> Distribution:
    with open(filename, encoding="utf-8") as f:
        return load_dist(f.read())


def load_dist(yaml_str: str) -> Distribution:
    data = _safe_load(yaml_str) or {}
    mapping = data.get("distribution", {})
    return Distribution({a: list(cs or []) for a, cs in mapping.items()})


def yaml_dist(dist: Distribution, inputs: Optional[Dict] = None,
              cost: Optional[float] = None) -> str:
    data: Dict[str, Any] = {}
    if inputs:
        data["inputs"] = inputs
    data["distribution"] = dist.mapping
    if cost is not None:
        data["cost"] = cost
    return yaml.safe_dump(data, sort_keys=False)
