"""Domains, variables and agent definitions.

Ported copy of ``pydcop_tpu/dcop/objects.py``: the port imports
nothing of the JAX package, so it keeps its own copy of the
host-side modelling layer, whole.  Behaviour is kept identical (the
compiled arrays must match the reference bit for bit).

Reference parity: pydcop/dcop/objects.py (Domain :46, Variable :175,
create_variables :258, BinaryVariable :335, VariableWithCostDict :410,
VariableWithCostFunc :464, VariableNoisyCostFunc :547, ExternalVariable
:618, AgentDef :669).

Design notes (TPU-first): a Domain is an ordered, finite list of values;
every value is addressed by its *index* throughout the device engine —
host-side objects keep the human-readable values, the compiled arrays only
ever see indices.  Noise for ``VariableNoisyCostFunc`` is drawn from a
PRNG seeded from the variable name so runs are reproducible across hosts
and backends (the reference uses an unseeded ``random.random()``, which
makes cost parity between runs impossible; we fix that deliberately).
"""

import hashlib
import itertools
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from pydcop_tpu_torch.utils.simple_repr import SimpleRepr, simple_repr, from_repr


class Domain(SimpleRepr):
    """An ordered, named, finite set of values.

    >>> d = Domain('colors', 'color', ['R', 'G', 'B'])
    >>> len(d)
    3
    >>> d.index('G')
    1
    >>> Domain('d', 'd', [1, 2, 3]).to_domain_value('2')
    (1, 2)
    """

    def __init__(self, name: str, domain_type: str, values: Iterable):
        self._name = name
        self._domain_type = domain_type
        self._values = tuple(values)

    @property
    def name(self) -> str:
        return self._name

    @property
    def type(self) -> str:
        return self._domain_type

    @property
    def domain_type(self) -> str:
        return self._domain_type

    @property
    def values(self) -> Tuple:
        return self._values

    def index(self, val) -> int:
        return self._values.index(val)

    def to_domain_value(self, val: str):
        """Map a string to the (index, value) pair it denotes in the domain.

        Accepts either the exact value or its string form (needed when
        values come back from JSON/CLI where ints become strings).
        """
        for i, v in enumerate(self._values):
            if v == val or str(v) == str(val):
                return i, v
        raise ValueError(f"{val!r} is not in domain {self._name}")

    def __iter__(self):
        return iter(self._values)

    def __len__(self):
        return len(self._values)

    def __getitem__(self, i):
        return self._values[i]

    def __contains__(self, v):
        return v in self._values

    def __eq__(self, other):
        return (
            isinstance(other, Domain)
            and self._name == other._name
            and self._values == other._values
            and self._domain_type == other._domain_type
        )

    def __hash__(self):
        return hash((self._name, self._domain_type, self._values))

    def __repr__(self):
        return f"Domain({self._name!r}, {self._domain_type!r}, {list(self._values)})"

    def __str__(self):
        return f"Domain({self._name})"


# Backward-compatible alias used throughout the reference's API.
VariableDomain = Domain

binary_domain = Domain("binary", "binary", [0, 1])


class Variable(SimpleRepr):
    """A decision variable with a finite domain.

    >>> v = Variable('v1', Domain('d', 'd', [0, 1, 2]), initial_value=1)
    >>> v.initial_value
    1
    """

    has_cost = False

    def __init__(self, name: str, domain: Union[Domain, Iterable],
                 initial_value=None):
        self._name = name
        if not isinstance(domain, Domain):
            domain = Domain(f"d_{name}", "unnamed", list(domain))
        self._domain = domain
        if initial_value is not None and initial_value not in domain:
            raise ValueError(
                f"Initial value {initial_value!r} not in domain of {name}"
            )
        self._initial_value = initial_value

    @property
    def name(self) -> str:
        return self._name

    @property
    def domain(self) -> Domain:
        return self._domain

    @property
    def initial_value(self):
        return self._initial_value

    def cost_for_val(self, val) -> float:
        return 0.0

    def cost_vector(self) -> np.ndarray:
        """Dense per-value costs, aligned with domain order (device form)."""
        return np.array(
            [float(self.cost_for_val(v)) for v in self._domain],
            dtype=np.float64,
        )

    def clone(self):
        return Variable(self._name, self._domain, self._initial_value)

    def __eq__(self, other):
        return (
            type(other) is type(self)
            and self._name == other.name
            and self._domain == other.domain
        )

    def __hash__(self):
        return hash((type(self).__name__, self._name, self._domain))

    def __repr__(self):
        return f"Variable({self._name!r}, {self._domain})"

    def __str__(self):
        return f"Variable({self._name})"


class BinaryVariable(Variable):
    """A 0/1 variable (used by the repair-as-DCOP machinery)."""

    def __init__(self, name: str, initial_value=0):
        super().__init__(name, binary_domain, initial_value)

    def clone(self):
        return BinaryVariable(self._name, initial_value=self._initial_value)

    def __repr__(self):
        return f"BinaryVariable({self._name!r})"


class VariableWithCostDict(Variable):
    """Variable with an explicit value→cost table."""

    has_cost = True

    def __init__(self, name, domain, costs: Dict, initial_value=None):
        super().__init__(name, domain, initial_value)
        self._costs = dict(costs)

    @property
    def costs(self):
        return dict(self._costs)

    def cost_for_val(self, val) -> float:
        return self._costs.get(val, 0.0)

    def clone(self):
        return VariableWithCostDict(
            self._name, self._domain, self._costs, self._initial_value
        )


class VariableWithCostFunc(Variable):
    """Variable whose per-value cost comes from a function of its value."""

    has_cost = True

    def __init__(self, name, domain, cost_func: Union[Callable, "str"],
                 initial_value=None):
        super().__init__(name, domain, initial_value)
        from pydcop_tpu_torch.utils.expressionfunction import ExpressionFunction

        if isinstance(cost_func, str):
            cost_func = ExpressionFunction(cost_func)
        if hasattr(cost_func, "variable_names"):
            names = list(cost_func.variable_names)
            if len(names) != 1 or names[0] != name:
                raise ValueError(
                    f"Cost function for variable {name} must depend exactly "
                    f"on it, got {names}"
                )
        self._cost_func = cost_func

    @property
    def cost_func(self):
        return self._cost_func

    def cost_for_val(self, val) -> float:
        if hasattr(self._cost_func, "variable_names"):
            return self._cost_func(**{self._name: val})
        return self._cost_func(val)

    def clone(self):
        return VariableWithCostFunc(
            self._name, self._domain, self._cost_func, self._initial_value
        )

    def _simple_repr(self):
        r = super()._simple_repr()
        r["cost_func"] = simple_repr(self._cost_func)
        return r

    @classmethod
    def _from_repr(cls, r):
        return cls(
            r["name"],
            from_repr(r["domain"]),
            from_repr(r["cost_func"]),
            initial_value=r.get("initial_value"),
        )


def _stable_noise(name: str, n: int, noise_level: float,
                  seed: Optional[int]) -> np.ndarray:
    """Per-value noise in [0, noise_level), deterministic in (name, seed).

    The reference draws unseeded random noise at construction
    (pydcop/dcop/objects.py:547); we derive the stream from the variable
    name + an optional global seed so CPU and TPU runs agree bit-for-bit.
    """
    h = hashlib.sha256(f"{name}:{seed}".encode()).digest()
    rng = np.random.default_rng(int.from_bytes(h[:8], "little"))
    return rng.random(n) * noise_level


class VariableNoisyCostFunc(VariableWithCostFunc):
    """Cost-function variable with small per-value noise added (tie-breaker).

    Used by maxsum's ``noise`` parameter (reference: maxsum.py:477-487).
    """

    has_cost = True

    def __init__(self, name, domain, cost_func, initial_value=None,
                 noise_level: float = 0.02, seed: Optional[int] = None):
        super().__init__(name, domain, cost_func, initial_value)
        self._noise_level = noise_level
        self._seed = seed
        self._noise = _stable_noise(name, len(self.domain), noise_level, seed)

    @property
    def noise_level(self) -> float:
        return self._noise_level

    def cost_for_val(self, val) -> float:
        base = super().cost_for_val(val)
        return base + float(self._noise[self.domain.index(val)])

    def clone(self):
        return VariableNoisyCostFunc(
            self._name, self._domain, self._cost_func, self._initial_value,
            self._noise_level, self._seed,
        )

    def _simple_repr(self):
        r = super()._simple_repr()
        r["noise_level"] = self._noise_level
        r["seed"] = self._seed
        return r

    @classmethod
    def _from_repr(cls, r):
        return cls(
            r["name"],
            from_repr(r["domain"]),
            from_repr(r["cost_func"]),
            initial_value=r.get("initial_value"),
            noise_level=r.get("noise_level", 0.02),
            seed=r.get("seed"),
        )


class ExternalVariable(Variable):
    """A sensor-style variable set from outside the optimization.

    Value changes fire subscribed callbacks (reference:
    pydcop/dcop/objects.py:618, ``_fire`` :655-663); used by dynamic DCOPs.
    """

    def __init__(self, name, domain, value=None):
        super().__init__(name, domain)
        self._cb = []
        self._value = None
        self.value = value if value is not None else domain[0]

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, val):
        if val == self._value:
            return
        if val not in self._domain:
            raise ValueError(
                f"Value {val!r} not in domain of external variable {self._name}"
            )
        self._value = val
        for cb in self._cb:
            cb(val)

    def subscribe(self, callback):
        self._cb.append(callback)

    def unsubscribe(self, callback):
        self._cb.remove(callback)

    def clone(self):
        return ExternalVariable(self._name, self._domain, self._value)

    def _simple_repr(self):
        r = super()._simple_repr()
        r.pop("initial_value", None)
        r["value"] = simple_repr(self._value)
        return r

    @classmethod
    def _from_repr(cls, r):
        return cls(r["name"], from_repr(r["domain"]), r.get("value"))


def _expand_indices(indexes) -> List[Tuple]:
    """Expand index ranges into the cartesian list of index tuples."""
    if isinstance(indexes, range):
        return [(i,) for i in indexes]
    dims = []
    for dim in indexes:
        if isinstance(dim, range):
            dims.append(list(dim))
        elif isinstance(dim, (list, tuple)):
            dims.append(list(dim))
        else:
            return [(i,) for i in indexes]
    return list(itertools.product(*dims))


def create_variables(name_prefix: str, indexes, domain: Domain,
                     separator: str = "_") -> Dict:
    """Mass-create variables from a prefix and index ranges.

    The prefix carries its own separator (reference objects.py:258:
    ``create_variables('x_', ...)`` names variables ``x_a_0``):

    >>> d = Domain('d', 'd', [0, 1])
    >>> vs = create_variables('x_', [['a', 'b'], range(2)], d)
    >>> sorted(vs)[0]
    ('a', 0)
    >>> vs[('a', 0)].name
    'x_a_0'
    """
    variables = {}
    if isinstance(indexes, range):
        indexes = [str(i) for i in indexes]
    if all(isinstance(i, str) for i in indexes):
        for i in indexes:
            name = name_prefix + i
            variables[name] = Variable(name, domain)
        return variables
    for combo in _expand_indices(indexes):
        name = name_prefix + separator.join(str(i) for i in combo)
        variables[tuple(combo)] = Variable(name, domain)
    return variables


def create_binary_variables(name_prefix: str, indexes,
                            separator: str = "_") -> Dict:
    """Mass-create BinaryVariables (used to build repair DCOPs)."""
    variables = {}
    if all(isinstance(i, str) for i in indexes):
        for i in indexes:
            name = name_prefix + i
            variables[name] = BinaryVariable(name)
        return variables
    for combo in _expand_indices(indexes):
        name = name_prefix + separator.join(str(i) for i in combo)
        variables[tuple(combo)] = BinaryVariable(name)
    return variables


DEFAULT_CAPACITY = 100
DEFAULT_HOSTING_COST = 0
DEFAULT_ROUTE = 1


class AgentDef(SimpleRepr):
    """Definition of an agent: capacity, hosting costs, routes, extras.

    >>> a = AgentDef('a1', capacity=100, foo='bar')
    >>> a.capacity
    100
    >>> a.foo
    'bar'
    >>> a.route('a2')
    1
    """

    def __init__(self, name: str,
                 default_hosting_cost: float = DEFAULT_HOSTING_COST,
                 hosting_costs: Optional[Dict[str, float]] = None,
                 default_route: float = DEFAULT_ROUTE,
                 routes: Optional[Dict[str, float]] = None,
                 **extra_attr):
        self._name = name
        self._default_hosting_cost = default_hosting_cost
        self._hosting_costs = dict(hosting_costs) if hosting_costs else {}
        self._default_route = default_route
        self._routes = dict(routes) if routes else {}
        self._extra_attr = dict(extra_attr)

    @property
    def name(self) -> str:
        return self._name

    @property
    def extra_attr(self) -> Dict:
        return dict(self._extra_attr)

    @property
    def capacity(self):
        return self._extra_attr.get("capacity", DEFAULT_CAPACITY)

    @property
    def default_hosting_cost(self) -> float:
        return self._default_hosting_cost

    @property
    def hosting_costs(self) -> Dict[str, float]:
        return dict(self._hosting_costs)

    @property
    def default_route(self) -> float:
        return self._default_route

    @property
    def routes(self) -> Dict[str, float]:
        return dict(self._routes)

    def hosting_cost(self, computation: str) -> float:
        return self._hosting_costs.get(computation, self._default_hosting_cost)

    def route(self, other_agent: str) -> float:
        if other_agent == self._name:
            return 0
        return self._routes.get(other_agent, self._default_route)

    def __getattr__(self, item):
        extra = object.__getattribute__(self, "_extra_attr")
        if item in extra:
            return extra[item]
        raise AttributeError(f"AgentDef has no attribute {item!r}")

    def __eq__(self, other):
        return (
            isinstance(other, AgentDef)
            and self._name == other._name
            and self._extra_attr == other._extra_attr
            and self._hosting_costs == other._hosting_costs
            and self._routes == other._routes
            and self._default_route == other._default_route
            and self._default_hosting_cost == other._default_hosting_cost
        )

    def __hash__(self):
        return hash(self._name)

    def __repr__(self):
        return f"AgentDef({self._name!r})"

    def __str__(self):
        return f"AgentDef({self._name})"

    def _simple_repr(self):
        r = {
            "__module__": self.__class__.__module__,
            "__qualname__": self.__class__.__qualname__,
            "name": self._name,
            "default_hosting_cost": self._default_hosting_cost,
            "hosting_costs": dict(self._hosting_costs),
            "default_route": self._default_route,
            "routes": dict(self._routes),
        }
        r.update(simple_repr(self._extra_attr))
        return r

    @classmethod
    def _from_repr(cls, r):
        extras = {
            k: v for k, v in r.items()
            if k not in ("name", "default_hosting_cost", "hosting_costs",
                         "default_route", "routes")
        }
        return cls(
            r["name"],
            default_hosting_cost=r.get("default_hosting_cost", 0),
            hosting_costs=r.get("hosting_costs"),
            default_route=r.get("default_route", 1),
            routes=r.get("routes"),
            **extras,
        )


def create_agents(name_prefix: str, indexes,
                  default_hosting_cost: float = 0,
                  hosting_costs: Optional[Dict] = None,
                  default_route: float = 1,
                  routes: Optional[Dict] = None,
                  separator: str = "_",
                  **extra_attr) -> Dict:
    """Mass-create AgentDefs from a prefix and index ranges."""
    agents = {}
    if isinstance(indexes, range):
        for i in indexes:
            name = f"{name_prefix}{i}"
            agents[name] = AgentDef(
                name, default_hosting_cost, hosting_costs,
                default_route, routes, **extra_attr)
        return agents
    for combo in _expand_indices(indexes):
        name = name_prefix + separator.join(str(i) for i in combo)
        agents[tuple(combo)] = AgentDef(
            name, default_hosting_cost, hosting_costs,
            default_route, routes, **extra_attr)
    return agents
