"""``pydcop graph``: computation-graph metrics for a DCOP.

Ported copy of ``pydcop_tpu/commands/graph.py``:
the port keeps its own copy, behaviour unchanged.

Reference parity: pydcop/commands/graph.py — density, node/edge counts,
degree histogram for a given graph model.
"""

from pydcop_tpu_torch.commands._utils import emit_result


def set_parser(subparsers):
    parser = subparsers.add_parser(
        "graph", help="computation graph metrics for a dcop")
    parser.add_argument("dcop_files", nargs="+")
    parser.add_argument(
        "-g", "--graph", default=None,
        help="graph model (factor_graph, constraints_hypergraph, "
             "pseudotree, ordered_graph); defaults from --algo",
    )
    parser.add_argument("-a", "--algo", default=None,
                        help="algorithm whose GRAPH_TYPE to use")
    parser.add_argument("--display", action="store_true",
                        help="(kept for compatibility; no-op headless)")
    parser.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    from pydcop_tpu_torch.algorithms import load_algorithm_module
    from pydcop_tpu_torch.computations_graph import load_graph_module
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file

    if not args.graph and not args.algo:
        print("Error: one of --graph or --algo is required")
        return 2
    graph_type = args.graph
    if not graph_type:
        graph_type = load_algorithm_module(args.algo).GRAPH_TYPE
    dcop = load_dcop_from_file(args.dcop_files)
    graph = load_graph_module(graph_type).build_computation_graph(dcop)

    from pydcop_tpu_torch.utils.graphs import (
        constraint_adjacency,
        cycles_count,
        graph_diameter,
    )

    degrees = {}
    for node in graph.nodes:
        degrees[node.name] = len(node.neighbors)
    variables = list(dcop.variables.values())
    constraints = list(dcop.constraints.values())
    adj = constraint_adjacency(variables, constraints)
    result = {
        "graph": graph_type,
        "dcop": dcop.name,
        "variables": len(dcop.variables),
        "constraints": len(dcop.constraints),
        "nodes": len(graph.nodes),
        "edges": len(graph.links),
        "density": graph.density(),
        "max_degree": max(degrees.values(), default=0),
        "min_degree": min(degrees.values(), default=0),
        "avg_degree": (
            sum(degrees.values()) / len(degrees) if degrees else 0
        ),
        "cycles": cycles_count(variables, constraints, adj=adj),
        "component_diameters": graph_diameter(
            variables, constraints, adj=adj),
    }
    emit_result(result, args.output)
    return 0
