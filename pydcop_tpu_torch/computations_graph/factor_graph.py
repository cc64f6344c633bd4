"""Bipartite factor graph: one node per variable, one per constraint.

Ported copy of ``pydcop_tpu/computations_graph/factor_graph.py``:
the port keeps its own copy, behaviour unchanged.

Reference parity: pydcop/computations_graph/factor_graph.py
(FactorComputationNode :45, VariableComputationNode :104, FactorGraphLink
:161, ComputationsFactorGraph :210, build_computation_graph :245).
Used by: maxsum, amaxsum, maxsum_dynamic.
"""

from typing import Iterable, List, Optional

from pydcop_tpu_torch.computations_graph.objects import (
    ComputationGraph,
    ComputationNode,
    Link,
)
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import ExternalVariable, Variable
from pydcop_tpu_torch.dcop.relations import Constraint

GRAPH_NODE_TYPE_VARIABLE = "VariableComputation"
GRAPH_NODE_TYPE_FACTOR = "FactorComputation"


class FactorGraphLink(Link):
    """A link between one variable node and one factor node."""

    def __init__(self, factor_node: str, variable_node: str):
        super().__init__([factor_node, variable_node], "factor_graph")
        self._factor_node = factor_node
        self._variable_node = variable_node

    @property
    def factor_node(self) -> str:
        return self._factor_node

    @property
    def variable_node(self) -> str:
        return self._variable_node

    def _simple_repr(self):
        return {
            "__module__": self.__class__.__module__,
            "__qualname__": self.__class__.__qualname__,
            "factor_node": self._factor_node,
            "variable_node": self._variable_node,
        }

    @classmethod
    def _from_repr(cls, r):
        return cls(r["factor_node"], r["variable_node"])


class VariableComputationNode(ComputationNode):
    def __init__(self, variable: Variable,
                 links: Optional[Iterable[FactorGraphLink]] = None):
        super().__init__(variable.name, GRAPH_NODE_TYPE_VARIABLE, links)
        self._variable = variable

    @property
    def variable(self) -> Variable:
        return self._variable

    @property
    def factors(self) -> List[str]:
        """Names of neighbor factor computations."""
        return [l.factor_node for l in self.links]


class FactorComputationNode(ComputationNode):
    def __init__(self, factor: Constraint,
                 links: Optional[Iterable[FactorGraphLink]] = None):
        super().__init__(factor.name, GRAPH_NODE_TYPE_FACTOR, links)
        self._factor = factor

    @property
    def factor(self) -> Constraint:
        return self._factor

    @property
    def variables(self) -> List[Variable]:
        return self._factor.dimensions


class ComputationsFactorGraph(ComputationGraph):
    def __init__(self, var_nodes: Iterable[VariableComputationNode],
                 factor_nodes: Iterable[FactorComputationNode]):
        var_nodes, factor_nodes = list(var_nodes), list(factor_nodes)
        super().__init__("factor_graph", var_nodes + factor_nodes)
        self.variable_nodes = var_nodes
        self.factor_nodes = factor_nodes

    def density(self) -> float:
        """Bipartite density: links / (|vars| * |factors|)."""
        possible = len(self.variable_nodes) * len(self.factor_nodes)
        if not possible:
            return 0.0
        return len(self.links) / possible


def build_computation_graph(
        dcop: Optional[DCOP] = None,
        variables: Optional[Iterable[Variable]] = None,
        constraints: Optional[Iterable[Constraint]] = None,
) -> ComputationsFactorGraph:
    """One variable node per variable, one factor node per constraint,
    one link per (constraint, variable-in-scope) pair."""
    if dcop is not None:
        variables = list(dcop.variables.values())
        constraints = list(dcop.constraints.values())
    else:
        variables = list(variables or [])
        constraints = list(constraints or [])

    links_by_var = {v.name: [] for v in variables}
    factor_nodes = []
    for c in constraints:
        links = []
        for v in c.dimensions:
            if v.name not in links_by_var:
                # External (read-only) variables get no computation node
                # — dynamic factors subscribe to them instead (reference
                # factor_graph.py:276: only listed variables get nodes).
                if isinstance(v, ExternalVariable):
                    continue
                raise ValueError(
                    f"Constraint {c.name} references unknown variable "
                    f"{v.name}"
                )
            link = FactorGraphLink(c.name, v.name)
            links.append(link)
            links_by_var[v.name].append(link)
        factor_nodes.append(FactorComputationNode(c, links))
    var_nodes = [
        VariableComputationNode(v, links_by_var[v.name]) for v in variables
    ]
    return ComputationsFactorGraph(var_nodes, factor_nodes)


def computation_memory(node: ComputationNode) -> float:
    """Footprint estimate: sum of neighbor message sizes (domain sizes)."""
    if isinstance(node, VariableComputationNode):
        return len(node.variable.domain) * len(node.links)
    if isinstance(node, FactorComputationNode):
        return sum(len(v.domain) for v in node.variables)
    raise TypeError(f"Unsupported node {node}")


def communication_load(src: ComputationNode, target: str) -> float:
    """Message size between two adjacent computations: one cost table."""
    if isinstance(src, VariableComputationNode):
        return len(src.variable.domain) + 1
    if isinstance(src, FactorComputationNode):
        for v in src.variables:
            if v.name == target:
                return len(v.domain) + 1
        raise ValueError(f"{target} not a neighbor of factor {src.name}")
    raise TypeError(f"Unsupported node {src}")
