"""Random graph structure generators (edge lists, no networkx).

Ported copy of ``pydcop_tpu/generators/graphs.py``:
the port keeps its own copy, behaviour unchanged.

Used by the problem generators: Erdős-Rényi random graphs (with a
single-component guarantee by default), 2-D grids (optionally toroidal),
Barabási-Albert scale-free graphs and Watts-Strogatz small worlds.
Reference analogues: pydcop/commands/generators/graphcoloring.py:310-354
(which delegate to networkx).
"""

from typing import List, Optional, Set, Tuple

import numpy as np

Edge = Tuple[int, int]


def _connect_components(n: int, edges: Set[Edge],
                        rng: np.random.Generator) -> Set[Edge]:
    """Add random edges until the graph has a single component."""
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for a, b in edges:
        union(a, b)
    roots = {find(i) for i in range(n)}
    while len(roots) > 1:
        comps = {}
        for i in range(n):
            comps.setdefault(find(i), []).append(i)
        groups = list(comps.values())
        a = groups[0][rng.integers(len(groups[0]))]
        b = groups[1][rng.integers(len(groups[1]))]
        edges.add((min(a, b), max(a, b)))
        union(a, b)
        roots = {find(i) for i in range(n)}
    return edges


def random_graph(n: int, p_edge: float, allow_subgraph: bool = False,
                 seed: Optional[int] = None) -> List[Edge]:
    """Erdős-Rényi G(n, p); connected unless allow_subgraph."""
    rng = np.random.default_rng(seed)
    edges = set()
    # Row-wise sampling keeps memory at O(n) instead of a dense n x n
    # matrix (matters for benchmark-scale graphs).
    for i in range(n - 1):
        row = rng.random(n - i - 1) < p_edge
        for off in np.nonzero(row)[0]:
            edges.add((i, i + 1 + int(off)))
    if not allow_subgraph:
        edges = _connect_components(n, edges, rng)
    return sorted(edges)


def grid_graph(n: int, periodic: bool = False) -> List[Edge]:
    """Square 2-D grid over the first s*s >= n nodes (reference uses
    exact squares; callers should pass a square count)."""
    side = int(np.sqrt(n))
    if side * side != n:
        raise ValueError(
            f"Grid graphs require a square variable count, got {n}"
        )
    edges = set()
    for r in range(side):
        for c in range(side):
            i = r * side + c
            if c + 1 < side:
                edges.add((i, r * side + c + 1))
            elif periodic and side > 2:
                edges.add((min(i, r * side), max(i, r * side)))
            if r + 1 < side:
                edges.add((i, (r + 1) * side + c))
            elif periodic and side > 2:
                edges.add((min(i, c), max(i, c)))
    return sorted(edges)


def grid_2d_graph(rows: int, cols: int,
                  periodic: bool = True) -> List[Tuple]:
    """Grid over (row, col) nodes, toroidal by default (ising layout,
    reference ising.py:285 nx.grid_2d_graph periodic)."""
    edges = set()
    for r in range(rows):
        for c in range(cols):
            right = (r, (c + 1) % cols) if periodic else (
                (r, c + 1) if c + 1 < cols else None
            )
            down = ((r + 1) % rows, c) if periodic else (
                (r + 1, c) if r + 1 < rows else None
            )
            for other in (right, down):
                if other is not None and other != (r, c):
                    edges.add(tuple(sorted([(r, c), other])))
    return sorted(edges)


def scalefree_graph(n: int, m_edge: int, allow_subgraph: bool = False,
                    seed: Optional[int] = None) -> List[Edge]:
    """Barabási-Albert preferential attachment: each new node attaches
    to m existing nodes with probability proportional to degree."""
    if m_edge < 1 or m_edge >= n:
        raise ValueError("scalefree requires 1 <= m_edge < n")
    rng = np.random.default_rng(seed)
    edges: Set[Edge] = set()
    targets = list(range(m_edge))
    repeated: List[int] = []
    for new in range(m_edge, n):
        for t in set(targets):
            edges.add((min(new, t), max(new, t)))
        repeated.extend(set(targets))
        repeated.extend([new] * m_edge)
        # Sample next targets by degree (nodes repeated by degree).
        targets = [
            repeated[rng.integers(len(repeated))] for _ in range(m_edge)
        ]
    if not allow_subgraph:
        edges = _connect_components(n, edges, rng)
    return sorted(edges)


def small_world_graph(n: int, k: int = 4, p_rewire: float = 0.1,
                      seed: Optional[int] = None) -> List[Edge]:
    """Watts-Strogatz ring lattice with random rewiring."""
    rng = np.random.default_rng(seed)
    edges: Set[Edge] = set()
    degree = [0] * n
    for i in range(n):
        for j in range(1, k // 2 + 1):
            a, b = i, (i + j) % n
            if a == b:
                continue
            if rng.random() < p_rewire and degree[a] < n - 1:
                # Rewire; skip (keep lattice edge) if we cannot find a
                # free target quickly — avoids spinning when a is close
                # to saturated.
                for _ in range(8 * n):
                    cand = int(rng.integers(n))
                    if cand != a and (min(a, cand), max(a, cand)) \
                            not in edges:
                        b = cand
                        break
            e = (min(a, b), max(a, b))
            if e not in edges:
                edges.add(e)
                degree[a] += 1
                degree[e[0] if e[1] == a else e[1]] += 1
    return sorted(edges)
