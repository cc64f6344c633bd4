"""DFS pseudo-tree over the variable constraint graph.

Ported copy of ``pydcop_tpu/computations_graph/pseudotree.py``: the port
imports nothing of the JAX package, so it keeps its own copy, behaviour
unchanged.

Reference parity: pydcop/computations_graph/pseudotree.py (PseudoTreeLink
:51, PseudoTreeNode :122, get_dfs_relations :178, _generate_dfs_tree :325
— root = max-degree heuristic :349-355, _filter_relation_to_lowest_node
:452, build_computation_graph :472).  Used by: dpop, ncbb.

The traversal here is a deterministic iterative DFS (neighbors in name
order, root = max-degree, first name wins ties), so tree shape — and
therefore DPOP message content — is reproducible across runs and hosts.
Each constraint is assigned to the *lowest* node of its scope in the tree,
which is the node that joins it into its UTIL message.
"""

from typing import Dict, Iterable, List, Optional, Set

from pydcop_tpu_torch.computations_graph.objects import (
    ComputationGraph,
    ComputationNode,
    Link,
)
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import Variable
from pydcop_tpu_torch.dcop.relations import Constraint


class PseudoTreeLink(Link):
    """Directed tree relation between two nodes.

    link_type is one of: parent, children, pseudo_parent, pseudo_children.
    """

    def __init__(self, link_type: str, source: str, target: str):
        if link_type not in (
            "parent", "children", "pseudo_parent", "pseudo_children"
        ):
            raise ValueError(f"Invalid pseudo-tree link type {link_type}")
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


class PseudoTreeNode(ComputationNode):
    def __init__(self, variable: Variable,
                 constraints: Iterable[Constraint],
                 links: Iterable[PseudoTreeLink]):
        super().__init__(variable.name, "PseudoTreeComputation", links)
        self._variable = variable
        self._constraints = list(constraints)

    @property
    def variable(self) -> Variable:
        return self._variable

    @property
    def constraints(self) -> List[Constraint]:
        """Constraints assigned to this node (it is lowest in their scope)."""
        return list(self._constraints)

    def _links_of(self, link_type: str) -> List[str]:
        return [
            l.target for l in self.links
            if l.type == link_type and l.source == self.name
        ]

    @property
    def parent(self) -> Optional[str]:
        ps = self._links_of("parent")
        return ps[0] if ps else None

    @property
    def children(self) -> List[str]:
        return self._links_of("children")

    @property
    def pseudo_parents(self) -> List[str]:
        return self._links_of("pseudo_parent")

    @property
    def pseudo_children(self) -> List[str]:
        return self._links_of("pseudo_children")

    @property
    def is_root(self) -> bool:
        return self.parent is None


class ComputationPseudoTree(ComputationGraph):
    def __init__(self, nodes: Iterable[PseudoTreeNode]):
        super().__init__("pseudotree", nodes)

    @property
    def roots(self) -> List[PseudoTreeNode]:
        return [n for n in self.nodes if n.is_root]


def _adjacency(variables: List[Variable],
               constraints: List[Constraint]) -> Dict[str, Set[str]]:
    from pydcop_tpu_torch.utils.graphs import constraint_adjacency

    return constraint_adjacency(variables, constraints)


def build_computation_graph(
        dcop: Optional[DCOP] = None,
        variables: Optional[Iterable[Variable]] = None,
        constraints: Optional[Iterable[Constraint]] = None,
) -> ComputationPseudoTree:
    if dcop is not None:
        variables = list(dcop.variables.values())
        constraints = list(dcop.constraints.values())
    else:
        variables = list(variables or [])
        constraints = list(constraints or [])

    adj = _adjacency(variables, constraints)
    var_by_name = {v.name: v for v in variables}

    visited: Dict[str, int] = {}  # name -> dfs depth
    parent: Dict[str, Optional[str]] = {}
    children: Dict[str, List[str]] = {v.name: [] for v in variables}
    pseudo_parents: Dict[str, List[str]] = {v.name: [] for v in variables}
    pseudo_children: Dict[str, List[str]] = {v.name: [] for v in variables}

    remaining = set(adj)
    while remaining:
        # Root of next tree: max degree, first name on ties.
        root = max(
            sorted(remaining), key=lambda n: len(adj[n] & remaining)
        )
        parent[root] = None
        stack = [(root, iter(sorted(adj[root])))]
        visited[root] = 0
        remaining.discard(root)
        while stack:
            node, neighbors = stack[-1]
            advanced = False
            for nb in neighbors:
                if nb not in visited:
                    visited[nb] = len(stack)
                    parent[nb] = node
                    children[node].append(nb)
                    remaining.discard(nb)
                    stack.append((nb, iter(sorted(adj[nb]))))
                    advanced = True
                    break
                # Back edge to a strict ancestor (not the direct parent):
                # nb is a pseudo-parent of node.
                if (
                    nb != parent.get(node)
                    and nb not in children[node]
                    and visited[nb] < visited[node]
                    and nb not in pseudo_parents[node]
                ):
                    pseudo_parents[node].append(nb)
                    pseudo_children[nb].append(node)
            if not advanced:
                stack.pop()

    # Assign each constraint to the lowest node of its scope in the tree.
    assigned: Dict[str, List[Constraint]] = {v.name: [] for v in variables}
    for c in constraints:
        scope = [v.name for v in c.dimensions]
        lowest = max(scope, key=lambda n: visited.get(n, -1))
        assigned[lowest].append(c)

    nodes = []
    for v in variables:
        links = []
        if parent[v.name] is not None:
            links.append(PseudoTreeLink("parent", v.name, parent[v.name]))
        for ch in children[v.name]:
            links.append(PseudoTreeLink("children", v.name, ch))
        for pp in pseudo_parents[v.name]:
            links.append(PseudoTreeLink("pseudo_parent", v.name, pp))
        for pc in pseudo_children[v.name]:
            links.append(PseudoTreeLink("pseudo_children", v.name, pc))
        nodes.append(PseudoTreeNode(v, assigned[v.name], links))
    return ComputationPseudoTree(nodes)


def node_depths(graph: ComputationPseudoTree) -> Dict[str, int]:
    """Depth of every node (root = 0), memoized over parent links, in
    the reference's order of assignment.  A loop up each chain, where
    the reference recurses: a tree deeper than the interpreter's
    recursion limit (the flagship's DFS tree) raises there, not here."""
    nodes = {n.name: n for n in graph.nodes}
    depth: Dict[str, int] = {}
    for name in nodes:
        chain = []
        while name not in depth:
            parent = nodes[name].parent
            if parent is None:
                depth[name] = 0
                break
            chain.append(name)
            name = parent
        d = depth[name]
        for below in reversed(chain):
            d += 1
            depth[below] = d
    return depth


def computation_memory(node: ComputationNode) -> float:
    """DPOP UTIL-table footprint upper bound: product of separator domain
    sizes (exponential in separator size)."""
    if not isinstance(node, PseudoTreeNode):
        raise TypeError(f"Unsupported node {node}")
    sep = set(node.pseudo_parents)
    if node.parent:
        sep.add(node.parent)
    size = 1.0
    for c in node.constraints:
        for v in c.dimensions:
            if v.name in sep:
                size *= len(v.domain)
    return size


def communication_load(src: ComputationNode, target: str) -> float:
    return computation_memory(src)
