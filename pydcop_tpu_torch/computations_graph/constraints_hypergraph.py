"""Constraints hypergraph: one node per variable, a hyperedge per
constraint.

Ported copy of ``pydcop_tpu/computations_graph/constraints_hypergraph.py``
(itself pyDCOP's: VariableComputationNode :49, ConstraintLink :113,
build_computation_graph :176).  Used by: dsa, adsa, dsatuto, mgm.
"""

from typing import Iterable, List, Optional

from pydcop_tpu_torch.computations_graph.objects import (
    ComputationGraph,
    ComputationNode,
    Link,
)
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import Variable
from pydcop_tpu_torch.dcop.relations import Constraint


class ConstraintLink(Link):
    """Hyperedge linking all variables in one constraint's scope."""

    def __init__(self, constraint_name: str, nodes: Iterable[str]):
        super().__init__(nodes, "constraint_link")
        self._constraint_name = constraint_name

    @property
    def constraint_name(self) -> str:
        return self._constraint_name

    def __eq__(self, other):
        return (
            isinstance(other, ConstraintLink)
            and self._constraint_name == other._constraint_name
            and self.nodes == other.nodes
        )

    def __hash__(self):
        return hash((self._constraint_name, self.nodes))

    def _simple_repr(self):
        return {
            "__module__": self.__class__.__module__,
            "__qualname__": self.__class__.__qualname__,
            "constraint_name": self._constraint_name,
            "nodes": list(self.nodes),
        }

    @classmethod
    def _from_repr(cls, r):
        return cls(r["constraint_name"], r["nodes"])


class VariableComputationNode(ComputationNode):
    def __init__(self, variable: Variable,
                 constraints: Iterable[Constraint],
                 links: Optional[Iterable[ConstraintLink]] = None):
        constraints = list(constraints)
        if links is None:
            links = [
                ConstraintLink(c.name, [v.name for v in c.dimensions])
                for c in constraints
            ]
        super().__init__(variable.name, "VariableComputation", links)
        self._variable = variable
        self._constraints = constraints

    @property
    def variable(self) -> Variable:
        return self._variable

    @property
    def constraints(self) -> List[Constraint]:
        return list(self._constraints)


class ComputationConstraintsHyperGraph(ComputationGraph):
    def __init__(self, nodes: Iterable[VariableComputationNode]):
        super().__init__("constraints_hypergraph", nodes)


def build_computation_graph(
        dcop: Optional[DCOP] = None,
        variables: Optional[Iterable[Variable]] = None,
        constraints: Optional[Iterable[Constraint]] = None,
) -> ComputationConstraintsHyperGraph:
    """One node per variable holding the constraints whose scope
    includes it."""
    if dcop is not None:
        variables = list(dcop.variables.values())
        constraints = list(dcop.constraints.values())
    else:
        variables = list(variables or [])
        constraints = list(constraints or [])

    nodes = []
    for v in variables:
        v_constraints = [
            c for c in constraints
            if v.name in (d.name for d in c.dimensions)
        ]
        nodes.append(VariableComputationNode(v, v_constraints))
    return ComputationConstraintsHyperGraph(nodes)


def computation_memory(node: ComputationNode) -> float:
    """Footprint: the variable's neighborhood (one value per neighbor)."""
    if not isinstance(node, VariableComputationNode):
        raise TypeError(f"Unsupported node {node}")
    neighbors = set()
    for c in node.constraints:
        neighbors.update(
            v.name for v in c.dimensions if v.name != node.name
        )
    return len(neighbors)


def communication_load(src: ComputationNode, target: str) -> float:
    """Local-search messages carry a single value."""
    return 1
