"""Constraints hypergraph + a total (lexical) variable order.

Ported copy of ``pydcop_tpu/computations_graph/ordered_graph.py``: the port
imports nothing of the JAX package, so it keeps its own copy, behaviour
unchanged.

Reference parity: pydcop/computations_graph/ordered_graph.py (OrderLink
:119 with next/previous, build_computation_graph :182).  Used by: syncbb.
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


class OrderLink(Link):
    """Directed next/previous link in the total order."""

    def __init__(self, link_type: str, source: str, target: str):
        if link_type not in ("next", "previous"):
            raise ValueError(f"Invalid order link type {link_type}")
        super().__init__([source, target], link_type)
        self._source = source
        self._target = target

    @property
    def source(self) -> str:
        return self._source

    @property
    def target(self) -> str:
        return self._target

    def _simple_repr(self):
        return {
            "__module__": self.__class__.__module__,
            "__qualname__": self.__class__.__qualname__,
            "link_type": self.type,
            "source": self._source,
            "target": self._target,
        }

    @classmethod
    def _from_repr(cls, r):
        return cls(r["link_type"], r["source"], r["target"])


class OrderedVarNode(ComputationNode):
    def __init__(self, variable: Variable,
                 constraints: Iterable[Constraint],
                 links: Iterable[OrderLink]):
        super().__init__(variable.name, "OrderedVariableComputation", links)
        self._variable = variable
        self._constraints = list(constraints)

    @property
    def variable(self) -> Variable:
        return self._variable

    @property
    def constraints(self) -> List[Constraint]:
        return list(self._constraints)

    @property
    def next_node(self) -> Optional[str]:
        for l in self.links:
            if l.type == "next" and l.source == self.name:
                return l.target
        return None

    @property
    def previous_node(self) -> Optional[str]:
        for l in self.links:
            if l.type == "previous" and l.source == self.name:
                return l.target
        return None


class OrderedConstraintGraph(ComputationGraph):
    def __init__(self, nodes: Iterable[OrderedVarNode]):
        super().__init__("ordered_graph", nodes)

    @property
    def ordered_nodes(self) -> List[OrderedVarNode]:
        return sorted(self.nodes, key=lambda n: n.name)


def build_computation_graph(
        dcop: Optional[DCOP] = None,
        variables: Optional[Iterable[Variable]] = None,
        constraints: Optional[Iterable[Constraint]] = None,
) -> OrderedConstraintGraph:
    if dcop is not None:
        variables = list(dcop.variables.values())
        constraints = list(dcop.constraints.values())
    else:
        variables = list(variables or [])
        constraints = list(constraints or [])

    ordered = sorted(variables, key=lambda v: v.name)
    nodes = []
    for i, v in enumerate(ordered):
        links = []
        if i > 0:
            links.append(OrderLink("previous", v.name, ordered[i - 1].name))
        if i < len(ordered) - 1:
            links.append(OrderLink("next", v.name, ordered[i + 1].name))
        v_constraints = [
            c for c in constraints
            if v.name in (d.name for d in c.dimensions)
        ]
        nodes.append(OrderedVarNode(v, v_constraints, links))
    return OrderedConstraintGraph(nodes)


def computation_memory(node: ComputationNode) -> float:
    if not isinstance(node, OrderedVarNode):
        raise TypeError(f"Unsupported node {node}")
    neighbors = set()
    for c in node.constraints:
        neighbors.update(
            v.name for v in c.dimensions if v.name != node.name
        )
    return len(neighbors)


def communication_load(src: ComputationNode, target: str) -> float:
    # SyncBB messages carry the current path: one (value, cost) per var.
    return 1
