"""Graph helpers over variables and constraints.

Ported copy of ``pydcop_tpu/utils/graphs.py``:
the port keeps its own copy, behaviour unchanged.

Reference parity: pydcop/utils/graphs.py (as_networkx_graph :131,
as_networkx_bipartite_graph :157, calc_diameter :86, cycles_count
:263, graph_diameter :270, all_pairs :289).

Structural metrics are computed with plain BFS over adjacency dicts
(no graph-library dependency); networkx is imported only inside the
two bridges kept for interop and analysis, so nothing else of the port
needs it.
"""

import itertools
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple


def constraint_adjacency(variables, constraints) -> Dict[str, Set[str]]:
    """Variable adjacency: two variables are neighbors when they share
    a constraint scope."""
    adj: Dict[str, Set[str]] = {v.name: set() for v in variables}
    for c in constraints:
        names = [v.name for v in c.dimensions]
        for a, b in itertools.combinations(names, 2):
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set()).add(a)
    return adj


def _bfs_depths(adj: Dict[str, Set[str]], root: str) -> Dict[str, int]:
    depths = {root: 0}
    queue = deque([root])
    while queue:
        node = queue.popleft()
        for neighbor in adj.get(node, ()):
            if neighbor not in depths:
                depths[neighbor] = depths[node] + 1
                queue.append(neighbor)
    return depths


# Above this node count, component diameters fall back to the
# double-BFS-sweep lower bound (exact on trees, very tight on sparse
# graphs) instead of all-node BFS — O(V+E) instead of O(V*(V+E)).
EXACT_DIAMETER_LIMIT = 2000


def components(adj: Dict[str, Set[str]]) -> List[Set[str]]:
    """Connected components of an adjacency dict."""
    seen: Set[str] = set()
    out = []
    for root in adj:
        if root in seen:
            continue
        component = set(_bfs_depths(adj, root))
        seen |= component
        out.append(component)
    return out


def calc_diameter(adj: Dict[str, Set[str]],
                  exact: bool = True) -> int:
    """Diameter of an adjacency dict.

    exact=True: max eccentricity by BFS from every node.
    exact=False: double-sweep lower bound (one BFS to find the
    furthest node, one BFS from it)."""
    if not adj:
        return 0
    if exact:
        best = 0
        for root in adj:
            depths = _bfs_depths(adj, root)
            if depths:
                best = max(best, max(depths.values()))
        return best
    root = next(iter(adj))
    depths = _bfs_depths(adj, root)
    far = max(depths, key=depths.get)
    depths = _bfs_depths(adj, far)
    return max(depths.values(), default=0)


def graph_diameter(variables, constraints,
                   adj: Optional[Dict[str, Set[str]]] = None,
                   ) -> List[int]:
    """Diameter of each connected component of the constraint graph
    (reference graphs.py:270).  Components above EXACT_DIAMETER_LIMIT
    nodes use the double-sweep estimate."""
    if adj is None:
        adj = constraint_adjacency(variables, constraints)
    diameters = []
    for component in components(adj):
        sub = {n: adj[n] & component for n in component}
        diameters.append(calc_diameter(
            sub, exact=len(component) <= EXACT_DIAMETER_LIMIT
        ))
    return diameters


def cycles_count(variables, constraints,
                 adj: Optional[Dict[str, Set[str]]] = None) -> int:
    """Number of independent cycles of the constraint graph
    (E - V + components, reference graphs.py:263)."""
    if adj is None:
        adj = constraint_adjacency(variables, constraints)
    n_edges = sum(len(neigh) for neigh in adj.values()) // 2
    return n_edges - len(adj) + len(components(adj))


def all_pairs(elements: Sequence) -> Iterable[Tuple]:
    """All unordered pairs (reference graphs.py:289)."""
    return itertools.combinations(elements, 2)


# -- networkx bridges (analysis / display interop) -------------------- #


def as_networkx_graph(variables, constraints):
    """Constraint graph as a networkx Graph (reference :131)."""
    import networkx as nx

    graph = nx.Graph()
    graph.add_nodes_from(v.name for v in variables)
    for c in constraints:
        names = [v.name for v in c.dimensions]
        graph.add_edges_from(itertools.combinations(names, 2))
    return graph


def as_networkx_bipartite_graph(variables, constraints):
    """Factor graph as a networkx bipartite Graph (reference :157)."""
    import networkx as nx

    graph = nx.Graph()
    graph.add_nodes_from((v.name for v in variables), bipartite=0)
    graph.add_nodes_from((c.name for c in constraints), bipartite=1)
    for c in constraints:
        graph.add_edges_from(
            (c.name, v.name) for v in c.dimensions
        )
    return graph
