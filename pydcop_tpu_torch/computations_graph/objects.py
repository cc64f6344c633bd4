"""Base node/link/graph objects shared by all graph models.

Ported copy of ``pydcop_tpu/computations_graph/objects.py`` (itself
pyDCOP's computations_graph/objects.py: ComputationNode :37, Link :136,
ComputationGraph :197).
"""

from typing import Dict, Iterable, List, Optional

from pydcop_tpu_torch.utils.simple_repr import SimpleRepr


class Link(SimpleRepr):
    """An undirected link between named computations."""

    def __init__(self, nodes: Iterable[str], link_type: str = "link"):
        self._nodes = tuple(sorted(nodes))
        self._type = link_type

    @property
    def nodes(self):
        return self._nodes

    @property
    def type(self) -> str:
        return self._type

    def has_node(self, name: str) -> bool:
        return name in self._nodes

    def __eq__(self, other):
        return (
            isinstance(other, Link)
            and self._nodes == other._nodes
            and self._type == other._type
        )

    def __hash__(self):
        return hash((self._type, self._nodes))

    def __repr__(self):
        return f"Link({self._type}, {self._nodes})"

    def _simple_repr(self):
        return {
            "__module__": self.__class__.__module__,
            "__qualname__": self.__class__.__qualname__,
            "nodes": list(self._nodes),
            "link_type": self._type,
        }

    @classmethod
    def _from_repr(cls, r):
        return cls(r["nodes"], r.get("link_type", "link"))


class ComputationNode(SimpleRepr):
    """A named computation in the graph, with its links."""

    def __init__(self, name: str, node_type: str,
                 links: Optional[Iterable[Link]] = None):
        self._name = name
        self._node_type = node_type
        self._links = list(links) if links else []

    @property
    def name(self) -> str:
        return self._name

    @property
    def type(self) -> str:
        return self._node_type

    @property
    def links(self) -> List[Link]:
        return list(self._links)

    @property
    def neighbors(self) -> List[str]:
        """Names of all computations linked to this one (no duplicates,
        insertion order)."""
        seen, out = {self._name}, []
        for link in self._links:
            for n in link.nodes:
                if n not in seen:
                    seen.add(n)
                    out.append(n)
        return out

    def __eq__(self, other):
        return (
            isinstance(other, ComputationNode)
            and self._name == other._name
            and self._node_type == other._node_type
        )

    def __hash__(self):
        return hash((self._name, self._node_type))

    def __repr__(self):
        return f"ComputationNode({self._name!r}, {self._node_type!r})"


class ComputationGraph(SimpleRepr):
    """A set of computation nodes + links, typed by graph model."""

    def __init__(self, graph_type: str,
                 nodes: Optional[Iterable[ComputationNode]] = None):
        self._graph_type = graph_type
        self._nodes: Dict[str, ComputationNode] = {}
        for n in nodes or []:
            self._nodes[n.name] = n

    @property
    def graph_type(self) -> str:
        return self._graph_type

    @property
    def nodes(self) -> List[ComputationNode]:
        return list(self._nodes.values())

    def computation(self, name: str) -> ComputationNode:
        return self._nodes[name]

    def has_computation(self, name: str) -> bool:
        return name in self._nodes

    @property
    def links(self) -> List[Link]:
        seen, out = set(), []
        for n in self._nodes.values():
            for link in n.links:
                if link not in seen:
                    seen.add(link)
                    out.append(link)
        return out

    def density(self) -> float:
        n = len(self._nodes)
        if n < 2:
            return 0.0
        return 2 * len(self.links) / (n * (n - 1))

    def __len__(self):
        return len(self._nodes)

    def __repr__(self):
        return (
            f"ComputationGraph({self._graph_type}, {len(self._nodes)} nodes)"
        )
