"""Graph helpers over variables and constraints.

Ported copy of the part of ``pydcop_tpu/utils/graphs.py`` the
pseudo-tree builder needs (``constraint_adjacency``); the rest of that
module (diameters, cycle counts, networkx bridges) is not ported yet.
"""

import itertools
from typing import Dict, Set


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
