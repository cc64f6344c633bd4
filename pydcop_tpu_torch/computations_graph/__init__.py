"""Computation graphs (ported copies): the factor graph of the MaxSum
family, the constraints hypergraph of the local-search family, the
pseudo-tree of DPOP and NCBB, and the ordered graph of SyncBB.  Each
module exposes ``build_computation_graph(dcop)``.
"""

import importlib


def load_graph_module(name: str):
    return importlib.import_module(
        f"pydcop_tpu_torch.computations_graph.{name}")
