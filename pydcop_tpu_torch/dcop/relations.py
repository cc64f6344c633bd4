"""Constraint algebra — the numeric core of the modeling layer.

Ported copy of ``pydcop_tpu/dcop/relations.py``: the port imports
nothing of the JAX package, so it keeps its own copy of the
host-side modelling layer, whole.  Behaviour is kept identical (the
compiled arrays must match the reference bit for bit).

Reference parity: pydcop/dcop/relations.py (RelationProtocol :48,
ZeroAryRelation :218, UnaryFunctionRelation :270, UnaryBooleanRelation
:380, NAryFunctionRelation :456, AsNAryFunctionRelation :639,
NAryMatrixRelation :672, NeutralRelation :909, ConditionalRelation :948,
assignment_matrix :1155, constraint_from_str :1275,
constraint_from_external_definition :1314, find_optimum :1367,
generate_assignment_as_dict :1452, assignment_cost :1479,
find_arg_optimal :1554, optimal_cost_value :1641, join :1672,
projection :1717).

Every constraint — intentional (expression) or extensional (table) — can
materialize a dense **cost hypercube** (`to_array()`: one axis per
variable, axis length = domain size, C-order, axis order = `dimensions`
order); the engine compiler stacks these per arity bucket, and
`join`/`projection` (DPOP's math) are numpy broadcast-adds and
axis-reductions over it.  Materialization is capped
(`MAX_MATERIALIZED_ELEMENTS`) because ``d^arity`` explodes.
"""

import ast
import itertools
import re
from typing import (
    Any, Callable, Dict, Hashable, Iterable, List, Optional, Union,
)

import numpy as np

from pydcop_tpu_torch.dcop.objects import Variable
from pydcop_tpu_torch.utils.expressionfunction import ExpressionFunction
from pydcop_tpu_torch.utils.simple_repr import SimpleRepr, simple_repr, from_repr

DEFAULT_TYPE = np.float64

# Materialization guard: refuse to enumerate cost hypercubes bigger than
# this many elements (2**26 f64 = 512 MiB).
MAX_MATERIALIZED_ELEMENTS = 2 ** 26


class Constraint(SimpleRepr):
    """Base class for all constraints (cost/utility relations).

    A constraint has a name, an ordered list of variables (`dimensions`)
    and yields a numeric cost for every assignment of those variables.
    """

    def __init__(self, name: str):
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    @property
    def dimensions(self) -> List[Variable]:
        raise NotImplementedError

    @property
    def arity(self) -> int:
        return len(self.dimensions)

    @property
    def scope_names(self) -> List[str]:
        return [v.name for v in self.dimensions]

    @property
    def shape(self):
        return tuple(len(v.domain) for v in self.dimensions)

    def __call__(self, *args, **kwargs) -> float:
        raise NotImplementedError

    def get_value_for_assignment(self, assignment) -> float:
        """Cost for an assignment given as dict {var_name: value} or list
        of values in `dimensions` order."""
        if isinstance(assignment, dict):
            return self(**assignment)
        return self(*assignment)

    def to_array(self) -> np.ndarray:
        """Dense cost hypercube: one axis per dimension, C-order."""
        self._check_materializable()
        shape = self.shape
        dims = self.dimensions
        out = np.empty(shape, dtype=DEFAULT_TYPE)
        for idx in np.ndindex(*shape) if shape else [()]:
            assignment = {
                v.name: v.domain[i] for v, i in zip(dims, idx)
            }
            out[idx] = self(**assignment)
        return out

    def _check_materializable(self) -> None:
        shape = self.shape
        n = int(np.prod(shape)) if shape else 1
        if n > MAX_MATERIALIZED_ELEMENTS:
            raise MemoryError(
                f"Refusing to materialize constraint {self.name}: "
                f"{n} elements (> {MAX_MATERIALIZED_ELEMENTS})"
            )

    def table_signature(self) -> Optional[Hashable]:
        """A hashable key equal for constraints whose ``to_array()``
        tables are provably identical, or None when no cheap proof
        exists.  The engine compiler (engine/compile.py) memoizes
        bucket-table evaluation on this key, so 10k structurally
        identical expression factors (e.g. generated graph-coloring
        edges, whose expressions differ only in variable *names*) cost
        ONE table evaluation instead of 10k."""
        return None

    def slice(self, partial: Dict[str, Any]) -> "Constraint":
        """Constraint over the remaining dims with `partial` frozen."""
        remaining = [v for v in self.dimensions if v.name not in partial]
        return NAryFunctionRelation(
            lambda **kw: self(**{**partial, **kw}),
            remaining,
            name=f"{self.name}_sliced",
            f_kwargs=True,
        )

    def __eq__(self, other):
        return (
            type(self) is type(other)
            and self.name == other.name
            and self.scope_names == other.scope_names
        )

    def __hash__(self):
        return hash((type(self).__name__, self._name, tuple(self.scope_names)))

    def __repr__(self):
        return f"{type(self).__name__}({self._name!r}, {self.scope_names})"


# The reference exposes the same concept under this name.
RelationProtocol = Constraint


class ZeroAryRelation(Constraint):
    """A constant-cost relation with no variables."""

    def __init__(self, name: str, value: float):
        super().__init__(name)
        self._value = value

    @property
    def dimensions(self) -> List[Variable]:
        return []

    def __call__(self, *args, **kwargs) -> float:
        return self._value

    def to_array(self) -> np.ndarray:
        return np.array(self._value, dtype=DEFAULT_TYPE)


class UnaryFunctionRelation(Constraint):
    """Cost from a single-argument function of one variable."""

    def __init__(self, name: str, variable: Variable,
                 rel_function: Union[Callable, str]):
        super().__init__(name)
        self._variable = variable
        if isinstance(rel_function, str):
            rel_function = ExpressionFunction(rel_function)
        self._rel_function = rel_function

    @property
    def dimensions(self) -> List[Variable]:
        return [self._variable]

    @property
    def variable(self) -> Variable:
        return self._variable

    @property
    def expression(self) -> Optional[str]:
        if isinstance(self._rel_function, ExpressionFunction):
            return self._rel_function.expression
        return None

    def __call__(self, *args, **kwargs) -> float:
        if kwargs:
            val = kwargs[self._variable.name]
        else:
            (val,) = args
        if isinstance(self._rel_function, ExpressionFunction):
            names = list(self._rel_function.variable_names)
            if names:
                return self._rel_function(**{names[0]: val})
            return self._rel_function()
        return self._rel_function(val)


class UnaryBooleanRelation(Constraint):
    """Cost 1 when the variable's value is truthy, else 0."""

    def __init__(self, name: str, variable: Variable):
        super().__init__(name)
        self._variable = variable

    @property
    def dimensions(self) -> List[Variable]:
        return [self._variable]

    def __call__(self, *args, **kwargs) -> float:
        if kwargs:
            val = kwargs[self._variable.name]
        else:
            (val,) = args
        return 1 if val else 0


class NAryFunctionRelation(Constraint):
    """Cost from an arbitrary function over N variables.

    The function is called with keyword args (variable names) when it is
    an ExpressionFunction or `f_kwargs=True`, positionally otherwise.
    """

    def __init__(self, f: Union[Callable, str], variables: Iterable[Variable],
                 name: Optional[str] = None, f_kwargs: bool = False):
        if isinstance(f, str):
            f = ExpressionFunction(f)
        if name is None:
            name = getattr(f, "__name__", "relation")
        super().__init__(name)
        self._variables = list(variables)
        self._f = f
        self._f_kwargs = f_kwargs or isinstance(f, ExpressionFunction)

    @property
    def dimensions(self) -> List[Variable]:
        return list(self._variables)

    @property
    def function(self) -> Callable:
        return self._f

    @property
    def expression(self) -> Optional[str]:
        if isinstance(self._f, ExpressionFunction):
            return self._f.expression
        return None

    def __call__(self, *args, **kwargs) -> float:
        if args and not kwargs:
            kwargs = {v.name: a for v, a in zip(self._variables, args)}
        if self._f_kwargs:
            if isinstance(self._f, ExpressionFunction):
                needed = set(self._f.variable_names)
                kwargs = {k: v for k, v in kwargs.items() if k in needed}
            return self._f(**kwargs)
        return self._f(*[kwargs[v.name] for v in self._variables])

    def slice(self, partial: Dict[str, Any]) -> Constraint:
        if isinstance(self._f, ExpressionFunction):
            remaining = [
                v for v in self._variables if v.name not in partial
            ]
            return NAryFunctionRelation(
                self._f.partial(**partial), remaining,
                name=f"{self.name}_sliced",
            )
        return super().slice(partial)

    def to_array(self) -> np.ndarray:
        """Dense cost hypercube, evaluated vectorized when possible.

        Expression constraints are evaluated in ONE numpy call over an
        open meshgrid of the domain product instead of ``d^arity``
        python calls (the engine-compile hot path; see
        engine/compile.compile_factor_graph).  The numpy-elementwise
        rewrite (utils/expressionfunction._VectorizeTransform) is
        spot-checked against scalar evaluation at a few grid points;
        any failure or mismatch falls back to the reference
        per-assignment loop, so the vectorized path can only be
        faster, never different.
        """
        arr = self._vectorized_array()
        if arr is not None:
            return arr
        return super().to_array()

    def _vectorized_array(self) -> Optional[np.ndarray]:
        f = self._f
        if not isinstance(f, ExpressionFunction):
            return None
        if not f.supports_vectorized:
            return None
        self._check_materializable()
        dims = self.dimensions
        shape = self.shape
        if not shape:
            return None
        needed = set(f.variable_names)
        grids = {}
        for axis, v in enumerate(dims):
            if v.name not in needed:
                continue
            g_shape = [1] * len(dims)
            g_shape[axis] = len(v.domain)
            grids[v.name] = np.asarray(list(v.domain)).reshape(g_shape)
        try:
            out = f.vectorized(**grids)
            out = np.array(
                np.broadcast_to(np.asarray(out, dtype=DEFAULT_TYPE),
                                shape),
                dtype=DEFAULT_TYPE,
            )
        except Exception:
            f.mark_not_vectorizable()
            return None
        # Spot-check a few deterministic grid points against the
        # scalar path: the AST rewrite is semantics-preserving by
        # construction, but an expression can still mean something
        # different elementwise (e.g. a user callable smuggled into
        # scope) — a mismatch demotes this expression to the scalar
        # loop for the rest of the process.
        n = out.size
        for flat in {0, n - 1, n // 2, (n // 3) * 2}:
            idx = np.unravel_index(flat, shape)
            assignment = {
                v.name: v.domain[i] for v, i in zip(dims, idx)
            }
            try:
                ref = float(self(**assignment))
            except Exception:
                f.mark_not_vectorizable()
                return None
            if not np.isclose(out[idx], ref, rtol=1e-9, atol=1e-12,
                              equal_nan=True):
                f.mark_not_vectorizable()
                return None
        return out

    def table_signature(self) -> Optional[Hashable]:
        f = self._f
        if not isinstance(f, ExpressionFunction) or f.source_file:
            return None
        sig = getattr(self, "_table_sig", False)
        if sig is False:
            sig = _normalized_expression_key(
                f, [v.name for v in self._variables])
            if sig is not None:
                sig = (
                    sig,
                    tuple(tuple(v.domain) for v in self._variables),
                )
            self._table_sig = sig
        return sig

    def _simple_repr(self):
        return {
            "__module__": self.__class__.__module__,
            "__qualname__": self.__class__.__qualname__,
            "f": simple_repr(self._f),
            "variables": simple_repr(self._variables),
            "name": self._name,
        }

    @classmethod
    def _from_repr(cls, r):
        return cls(
            from_repr(r["f"]), from_repr(r["variables"]), name=r.get("name")
        )


def AsNAryFunctionRelation(*variables):
    """Decorator turning a python function into an NAryFunctionRelation.

    >>> from pydcop_tpu_torch.dcop.objects import Variable, Domain
    >>> d = Domain('d', 'd', [0, 1])
    >>> x, y = Variable('x', d), Variable('y', d)
    >>> @AsNAryFunctionRelation(x, y)
    ... def my_constraint(x, y):
    ...     return x + y
    >>> my_constraint(1, 1)
    2
    """

    def decorator(f):
        return NAryFunctionRelation(f, list(variables), name=f.__name__)

    return decorator


class NAryMatrixRelation(Constraint):
    """Extensional constraint: a dense numpy cost hypercube.

    One axis per variable (in `dimensions` order), axis length = domain
    size, entry = cost of the corresponding assignment.  This *is* the
    device form — `join` and `projection` operate on it directly.

    >>> from pydcop_tpu_torch.dcop.objects import Variable, Domain
    >>> d = Domain('d', 'd', ['a', 'b'])
    >>> x, y = Variable('x', d), Variable('y', d)
    >>> r = NAryMatrixRelation([x, y], np.array([[1, 2], [3, 4]]))
    >>> r(x='b', y='a')
    3.0
    """

    def __init__(self, variables: Iterable[Variable],
                 matrix: Optional[np.ndarray] = None, name: str = ""):
        super().__init__(name)
        self._variables = list(variables)
        shape = tuple(len(v.domain) for v in self._variables)
        if matrix is None:
            matrix = np.zeros(shape, dtype=DEFAULT_TYPE)
        else:
            matrix = np.asarray(matrix, dtype=DEFAULT_TYPE)
            if matrix.shape != shape:
                raise ValueError(
                    f"Matrix shape {matrix.shape} does not match domains "
                    f"{shape} for constraint {name}"
                )
        self._m = matrix

    @property
    def dimensions(self) -> List[Variable]:
        return list(self._variables)

    @property
    def matrix(self) -> np.ndarray:
        return self._m

    def _indices(self, kwargs: Dict[str, Any]):
        return tuple(
            v.domain.index(kwargs[v.name]) for v in self._variables
        )

    def __call__(self, *args, **kwargs) -> float:
        if args and not kwargs:
            kwargs = {v.name: a for v, a in zip(self._variables, args)}
        return float(self._m[self._indices(kwargs)])

    def to_array(self) -> np.ndarray:
        return self._m

    def get_value_for_assignment(self, assignment) -> float:
        if isinstance(assignment, dict):
            return self(**assignment)
        return float(
            self._m[tuple(v.domain.index(a)
                          for v, a in zip(self._variables, assignment))]
        )

    def set_value_for_assignment(self, assignment: Dict[str, Any],
                                 value: float) -> "NAryMatrixRelation":
        """Return a new relation with one entry changed (immutable style)."""
        m = self._m.copy()
        m[self._indices(assignment)] = value
        return NAryMatrixRelation(self._variables, m, self._name)

    def slice(self, partial: Dict[str, Any]) -> "NAryMatrixRelation":
        idx = tuple(
            v.domain.index(partial[v.name]) if v.name in partial
            else slice(None)
            for v in self._variables
        )
        remaining = [v for v in self._variables if v.name not in partial]
        return NAryMatrixRelation(remaining, self._m[idx], self._name)

    @classmethod
    def from_func_relation(cls, rel: Constraint) -> "NAryMatrixRelation":
        return cls(rel.dimensions, rel.to_array(), rel.name)

    def __eq__(self, other):
        return (
            isinstance(other, NAryMatrixRelation)
            and self.name == other.name
            and self.scope_names == other.scope_names
            and np.array_equal(self._m, other._m)
        )

    def __hash__(self):
        return hash((self._name, tuple(self.scope_names)))

    def _simple_repr(self):
        return {
            "__module__": self.__class__.__module__,
            "__qualname__": self.__class__.__qualname__,
            "variables": simple_repr(self._variables),
            "matrix": self._m.tolist(),
            "name": self._name,
        }

    @classmethod
    def _from_repr(cls, r):
        return cls(
            from_repr(r["variables"]),
            np.array(r["matrix"], dtype=DEFAULT_TYPE),
            r.get("name", ""),
        )


class NeutralRelation(Constraint):
    """All-zero relation, useful as a join identity."""

    def __init__(self, variables: Iterable[Variable], name: str = "neutral"):
        super().__init__(name)
        self._variables = list(variables)

    @property
    def dimensions(self) -> List[Variable]:
        return list(self._variables)

    def __call__(self, *args, **kwargs) -> float:
        return 0

    def to_array(self) -> np.ndarray:
        return np.zeros(self.shape, dtype=DEFAULT_TYPE)


class ConditionalRelation(Constraint):
    """Applies `relation` only when `condition` is truthy, else 0."""

    def __init__(self, condition: Constraint, relation: Constraint,
                 name: str = "conditional", return_default: float = 0):
        super().__init__(name)
        self._condition = condition
        self._relation = relation
        self._default = return_default

    @property
    def condition(self) -> Constraint:
        return self._condition

    @property
    def relation(self) -> Constraint:
        return self._relation

    @property
    def dimensions(self) -> List[Variable]:
        dims = list(self._condition.dimensions)
        for v in self._relation.dimensions:
            if v not in dims:
                dims.append(v)
        return dims

    def __call__(self, *args, **kwargs) -> float:
        if args and not kwargs:
            kwargs = {v.name: a for v, a in zip(self.dimensions, args)}
        cond_args = {
            v.name: kwargs[v.name] for v in self._condition.dimensions
        }
        if self._condition(**cond_args):
            rel_args = {
                v.name: kwargs[v.name] for v in self._relation.dimensions
            }
            return self._relation(**rel_args)
        return self._default


# Standalone identifiers (not attribute accesses): the shared scan
# behind the _normalized_expression_key fast path.
_IDENT_RE = re.compile(r"(?<![\w.])[A-Za-z_]\w*")


class _RenameVars(ast.NodeTransformer):
    def __init__(self, mapping: Dict[str, str]):
        self._mapping = mapping

    def visit_Name(self, node: ast.Name) -> ast.AST:
        new = self._mapping.get(node.id)
        if new is not None:
            return ast.Name(id=new, ctx=node.ctx)
        return node


def _normalized_expression_key(f: ExpressionFunction,
                               scope_names: List[str],
                               ) -> Optional[Hashable]:
    """Expression text with scope variable names replaced by their
    POSITION in the constraint's dimensions — e.g. both
    ``10 if v12 == v37 else 0`` and ``10 if v3 == v8 else 0``
    normalize to ``10 if __v0__ == __v1__ else 0``, proving the two
    cost tables are identical whenever the (positional) domains also
    match.  None when the expression is not a pure function of its
    scope (random/source/function bodies) or the fixed vars are not
    hashable."""
    expr = f.expression
    if "random" in expr or "source" in expr:
        # Conservative substring test (also rejects e.g. a variable
        # named "randomize"): a missed memo costs one extra eval, a
        # wrong hit would corrupt a cost table.
        return None
    try:
        fixed = tuple(sorted(f.fixed_vars.items()))
        hash(fixed)
    except TypeError:
        return None
    mapping = {n: f"__v{i}__" for i, n in enumerate(scope_names)}
    if '"' not in expr and "'" not in expr:
        # Fast path (a few µs/constraint — this runs once per factor
        # on the compile hot path): one precompiled identifier scan,
        # renaming scope names and leaving everything else (including
        # attribute positions like ``x.v1``, excluded by the
        # lookbehind).  Exact because without string literals every
        # standalone occurrence of an identifier is a Name node.
        normalized = _IDENT_RE.sub(
            lambda m: mapping.get(m.group(0), m.group(0)), expr)
        return (normalized, fixed)
    # String literals present: only the AST rename can distinguish a
    # quoted occurrence of a variable name from a real Name node.
    try:
        tree = ast.parse(expr.strip(), mode="eval")
    except SyntaxError:
        return None  # function-body form: not normalizable cheaply
    tree = _RenameVars(mapping).visit(tree)
    try:
        normalized = ast.unparse(tree)
    except AttributeError:
        return None
    return (normalized, fixed)


def constraint_from_str(name: str, expression: str,
                        all_variables: Iterable[Variable]) -> Constraint:
    """Build an intentional constraint from a python expression string.

    The constraint's dimensions are the variables (from `all_variables`)
    whose names appear free in the expression.
    """
    f = ExpressionFunction(expression)
    by_name = {v.name: v for v in all_variables}
    dims = []
    for n in f.variable_names:
        if n not in by_name:
            raise ValueError(
                f"Unknown variable {n!r} in constraint {name}: {expression}"
            )
        dims.append(by_name[n])
    return NAryFunctionRelation(f, dims, name=name)


def constraint_from_external_definition(
        name: str, source_file: str, expression: str,
        all_variables: Iterable[Variable]) -> Constraint:
    """Intentional constraint whose expression calls into a python file,
    exposed as `source` (e.g. ``source.my_fn(v1, v2)``)."""
    f = ExpressionFunction(expression, source_file=source_file)
    by_name = {v.name: v for v in all_variables}
    dims = [by_name[n] for n in f.variable_names]
    return NAryFunctionRelation(f, dims, name=name)


def assignment_matrix(variables: List[Variable],
                      default_value: float = 0) -> np.ndarray:
    """A cost hypercube over `variables` filled with `default_value`."""
    shape = tuple(len(v.domain) for v in variables)
    return np.full(shape, default_value, dtype=DEFAULT_TYPE)


def generate_assignment(variables: List[Variable]):
    """Lazily yield all assignments as value-lists (last var fastest)."""
    domains = [list(v.domain) for v in variables]
    for combo in itertools.product(*domains):
        yield list(combo)


def generate_assignment_as_dict(variables: List[Variable]):
    """Lazily yield all assignments as {name: value} (last var fastest)."""
    names = [v.name for v in variables]
    domains = [list(v.domain) for v in variables]
    for combo in itertools.product(*domains):
        yield dict(zip(names, combo))


def count_var_match(variables: Iterable[str], constraint: Constraint) -> int:
    scope = set(constraint.scope_names)
    return sum(1 for v in variables if v in scope)


def assignment_cost(assignment: Dict[str, Any],
                    constraints: Iterable[Constraint],
                    infinity: float = float("inf")) -> float:
    """Total cost of `assignment` over `constraints`.

    Raises ValueError if any constraint yields `infinity` (hard violation),
    matching the reference's hard-constraint detection convention.
    """
    cost = 0
    for c in constraints:
        c_cost = c(**{v.name: assignment[v.name] for v in c.dimensions})
        if abs(c_cost) == infinity:
            raise ValueError(
                f"Hard constraint {c.name} violated by assignment"
            )
        cost += c_cost
    return cost


def find_optimum(constraint: Constraint, mode: str) -> float:
    """Min (or max) cost over all assignments of the constraint."""
    arr = constraint.to_array()
    return float(arr.min() if mode == "min" else arr.max())


def find_optimal(variable: Variable, assignment: Dict[str, Any],
                 constraints: Iterable[Constraint], mode: str):
    """Best value(s) for `variable` given a partial assignment of the
    other variables in the constraints' scopes.

    Returns (list-of-optimal-values-in-domain-order, optimal_cost).
    """
    best_cost, best_vals = None, []
    better = (lambda a, b: a < b) if mode == "min" else (lambda a, b: a > b)
    for val in variable.domain:
        asst = dict(assignment)
        asst[variable.name] = val
        cost = 0
        for c in constraints:
            cost += c(**{v.name: asst[v.name] for v in c.dimensions})
        if best_cost is None or better(cost, best_cost):
            best_cost, best_vals = cost, [val]
        elif cost == best_cost:
            best_vals.append(val)
    return best_vals, best_cost


def find_arg_optimal(variable: Variable, relation: Constraint, mode: str):
    """Optimal value(s) of `variable` for a unary relation over it.

    Returns (list of optimal values in domain order, optimal cost) — taking
    ``values[0]`` gives the reference's first-optimum tie-breaking.
    """
    if relation.arity != 1 or relation.dimensions[0] != variable:
        raise ValueError(
            f"find_arg_optimal requires a unary relation on {variable.name}"
        )
    arr = np.asarray(
        [relation(**{variable.name: v}) for v in variable.domain],
        dtype=DEFAULT_TYPE,
    )
    opt = arr.min() if mode == "min" else arr.max()
    vals = [v for v, c in zip(variable.domain, arr) if c == opt]
    return vals, float(opt)


def optimal_cost_value(variable: Variable, mode: str = "min"):
    """(value, cost) minimizing (or maximizing) the variable's own cost."""
    costs = [variable.cost_for_val(v) for v in variable.domain]
    arr = np.asarray(costs, dtype=DEFAULT_TYPE)
    i = int(arr.argmin() if mode == "min" else arr.argmax())
    return variable.domain[i], float(arr[i])


def join(r1: Constraint, r2: Constraint) -> NAryMatrixRelation:
    """Pointwise sum of two relations over the union of their dims.

    This is DPOP's UTIL accumulation: the result's hypercube is the
    broadcast-add of the two inputs aligned on shared variables
    (reference semantics: relations.py:1672; here it is a pure numpy
    broadcast instead of per-assignment enumeration).
    """
    dims1, dims2 = r1.dimensions, r2.dimensions
    union = list(dims1) + [v for v in dims2 if v not in dims1]
    a1 = np.asarray(r1.to_array(), dtype=DEFAULT_TYPE)
    a2 = np.asarray(r2.to_array(), dtype=DEFAULT_TYPE)
    # Align each array to the union axis order via transpose + reshape.
    a1_aligned = _align(a1, dims1, union)
    a2_aligned = _align(a2, dims2, union)
    return NAryMatrixRelation(
        union, a1_aligned + a2_aligned, name=f"joined_{r1.name}_{r2.name}"
    )


def _align(arr: np.ndarray, dims: List[Variable],
           union: List[Variable]) -> np.ndarray:
    """Transpose/expand `arr` (axes=dims) to broadcast along `union`."""
    if not dims:
        return arr
    order = [dims.index(v) for v in union if v in dims]
    arr_t = np.transpose(arr, order)
    shape = tuple(
        len(v.domain) if v in dims else 1 for v in union
    )
    return arr_t.reshape(shape)


def projection(relation: Constraint, variable: Variable,
               mode: str = "min") -> NAryMatrixRelation:
    """Eliminate `variable` by min- (or max-) reducing its axis.

    DPOP's UTIL projection (reference semantics: relations.py:1717).
    """
    dims = relation.dimensions
    if variable not in dims:
        raise ValueError(
            f"Cannot project {variable.name} out of {relation.name}: "
            "not in dimensions"
        )
    axis = dims.index(variable)
    arr = np.asarray(relation.to_array(), dtype=DEFAULT_TYPE)
    reduced = arr.min(axis=axis) if mode == "min" else arr.max(axis=axis)
    remaining = [v for v in dims if v != variable]
    return NAryMatrixRelation(remaining, reduced, name=relation.name)


def add_var_to_rel(name: str, relation: Constraint, variable: Variable,
                   f: Callable) -> Constraint:
    """Extend a relation with an extra variable combined via ``f(rel, v)``."""
    dims = relation.dimensions + [variable]

    def extended(**kwargs):
        rel_args = {
            v.name: kwargs[v.name] for v in relation.dimensions
        }
        return f(relation(**rel_args), kwargs[variable.name])

    return NAryFunctionRelation(extended, dims, name=name, f_kwargs=True)
