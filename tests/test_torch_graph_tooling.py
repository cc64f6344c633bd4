"""The port's graph tooling against ``pydcop_tpu``'s, on the CPU.

- ``utils/graphs.py``: adjacency, components, diameters (exact, and the
  double-sweep estimate above ``EXACT_DIAMETER_LIMIT`` nodes), cycle
  counts, ``all_pairs`` and the two networkx bridges, on the fixtures
  and on generated problems.  The estimate starts from the first node a
  set of names yields, which depends on ``PYTHONHASHSEED``, so both
  packages are compared in one process.
- ``computations_graph/factor_graph.py``: nodes, links, ``density()``,
  ``computation_memory`` and ``communication_load`` of every node and
  link; ``load_graph_module`` and the MaxSum family's ``GRAPH_TYPE``.
- ``utils/various.py::func_args``.

The cases follow ``tests/unit/test_graph_builders.py``,
``test_graph_objects_battery.py``, ``test_graphs_battery.py`` and
``test_utils_graphs.py``.
"""

import glob
import importlib
import os

import pytest
import torch

import pydcop_tpu.dcop.yamldcop as jy
import pydcop_tpu.utils.graphs as jg
import pydcop_tpu_torch.dcop.yamldcop as ty
import pydcop_tpu_torch.utils.graphs as tg

HERE = os.path.dirname(os.path.abspath(__file__))
INSTANCES = os.path.join(HERE, "instances")
FIXTURES = sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(INSTANCES, "*.y*ml"))
    if "scenario" not in os.path.basename(p))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def fixture_pair(name):
    path = os.path.join(INSTANCES, name)
    return jy.load_dcop_from_file(path), ty.load_dcop_from_file(path)


def generated_pair(module, func, *args, **kwargs):
    """The same generated problem in each package (the port's own
    generator; ``test_torch_generators.py`` holds it to the reference's)."""
    ref = getattr(importlib.import_module(
        f"pydcop_tpu.generators.{module}"), func)(*args, **kwargs)
    port = getattr(importlib.import_module(
        f"pydcop_tpu_torch.generators.{module}"), func)(*args, **kwargs)
    if isinstance(ref, tuple):
        ref, port = ref[0], port[0]
    return ref, port


GENERATED = {
    "coloring_scalefree": ("graphcoloring", "generate_graph_coloring",
                           (60, 3, "scalefree"), {"m_edge": 2, "seed": 0}),
    "coloring_random_split": ("graphcoloring", "generate_graph_coloring",
                              (40, 3, "random"),
                              {"p_edge": 0.03, "allow_subgraph": True,
                               "seed": 2}),
    "ising": ("ising", "generate_ising", (4, 5), {"seed": 1}),
    "secp": ("secp", "generate_secp", (8, 3, 4), {"seed": 0}),
    "meetings": ("meetingscheduling", "generate_meetings", (4, 6, 5, 3),
                 {"seed": 3}),
    "small_world": ("smallworld", "generate_small_world", (30,),
                    {"seed": 5}),
}


def problem_pair(key):
    if key in GENERATED:
        module, func, args, kwargs = GENERATED[key]
        return generated_pair(module, func, *args, **kwargs)
    return fixture_pair(key)


PROBLEMS = FIXTURES + sorted(GENERATED)


def scope(dcop):
    return list(dcop.variables.values()), list(dcop.constraints.values())


# -- utils/graphs.py --------------------------------------------------- #

@pytest.mark.parametrize("key", PROBLEMS)
def test_structural_metrics_equal_the_reference(key):
    ref, port = problem_pair(key)
    rv, rc = scope(ref)
    pv, pc = scope(port)
    adj = tg.constraint_adjacency(pv, pc)
    assert adj == jg.constraint_adjacency(rv, rc)
    assert tg.components(adj) == jg.components(adj)
    assert tg.cycles_count(pv, pc) == jg.cycles_count(rv, rc)
    assert tg.cycles_count(pv, pc, adj=adj) == jg.cycles_count(
        rv, rc, adj=adj)
    assert tg.graph_diameter(pv, pc) == jg.graph_diameter(rv, rc)
    for exact in (True, False):
        assert tg.calc_diameter(adj, exact=exact) == jg.calc_diameter(
            adj, exact=exact)
    root = next(iter(adj))
    assert tg._bfs_depths(adj, root) == jg._bfs_depths(adj, root)


def test_diameter_estimate_above_the_exact_limit():
    """A component of 3,000 nodes takes the double-sweep estimate in
    both packages, from the same first node of the same sets."""
    ref, port = generated_pair("graphcoloring", "generate_graph_coloring",
                               3_000, 3, "scalefree", m_edge=2, seed=0)
    assert tg.EXACT_DIAMETER_LIMIT == jg.EXACT_DIAMETER_LIMIT == 2_000
    rv, rc = scope(ref)
    pv, pc = scope(port)
    adj = tg.constraint_adjacency(pv, pc)
    comps = tg.components(adj)
    assert max(len(c) for c in comps) > tg.EXACT_DIAMETER_LIMIT
    got = tg.graph_diameter(pv, pc, adj=adj)
    assert got == jg.graph_diameter(rv, rc)
    # The component's sub-adjacency in the order graph_diameter builds it
    # (a set's order): the estimate starts at its first node.
    sub = {n: adj[n] & comps[0] for n in comps[0]}
    assert got[0] == tg.calc_diameter(sub, exact=False) == jg.calc_diameter(
        sub, exact=False)
    assert tg.cycles_count(pv, pc, adj=adj) == jg.cycles_count(rv, rc)


def test_small_cases_of_the_reference_batteries():
    from pydcop_tpu_torch.dcop.objects import Domain, Variable
    from pydcop_tpu_torch.dcop.relations import (
        NAryMatrixRelation,
        NeutralRelation,
        constraint_from_str,
    )

    d = Domain("d", "", [0, 1])
    vs = [Variable(f"v{i}", d) for i in range(4)]
    chain = [constraint_from_str(f"c{i}", f"v{i} + v{i + 1}",
                                 [vs[i], vs[i + 1]]) for i in range(3)]
    adj = tg.constraint_adjacency(vs, chain)
    assert adj["v1"] == {"v0", "v2"}
    assert tg.calc_diameter(adj) == 3
    assert tg.graph_diameter(vs, chain) == [3]
    assert tg.cycles_count(vs, chain) == 0
    closing = constraint_from_str("cc", "v0 + v3", [vs[0], vs[3]])
    assert tg.cycles_count(vs, chain + [closing]) == 1
    w = [Variable("w0", d), Variable("w1", d)]
    extra = NAryMatrixRelation(w, name="cw")
    assert sorted(tg.graph_diameter(vs + w, chain + [extra])) == [1, 3]
    clique = tg.constraint_adjacency(vs[:3], [NeutralRelation(vs[:3], "t")])
    assert clique["v0"] == {"v1", "v2"}
    assert tg.constraint_adjacency(vs[:2], []) == {"v0": set(),
                                                   "v1": set()}
    assert tg.calc_diameter({}) == 0
    assert list(tg.all_pairs([1, 2, 3])) == list(jg.all_pairs([1, 2, 3]))


@pytest.mark.parametrize("key", ["coloring_chain.yaml", "secp_lamps.yaml",
                                 "ising", "meetings"])
def test_networkx_bridges_equal_the_reference(key):
    nx = pytest.importorskip("networkx")
    ref, port = problem_pair(key)
    for bridge in ("as_networkx_graph", "as_networkx_bipartite_graph"):
        got = getattr(tg, bridge)(*scope(port))
        want = getattr(jg, bridge)(*scope(ref))
        assert list(got.nodes(data=True)) == list(want.nodes(data=True))
        assert list(got.edges) == list(want.edges)
        assert nx.is_isomorphic(got, want)


# -- computations_graph/factor_graph.py -------------------------------- #

def factor_graph_summary(fg_module, graph):
    nodes = [(n.name, n.type, sorted(n.neighbors)) for n in graph.nodes]
    links = [(type(l).__name__, l.factor_node, l.variable_node,
              sorted(l.nodes)) for l in graph.links]
    memory = {n.name: fg_module.computation_memory(n) for n in graph.nodes}
    load = {(n.name, other): fg_module.communication_load(n, other)
            for n in graph.nodes for other in sorted(n.neighbors)}
    return {
        "nodes": nodes, "links": links, "density": graph.density(),
        "variables": [n.name for n in graph.variable_nodes],
        "factors": [n.name for n in graph.factor_nodes],
        "var_factors": {n.name: n.factors for n in graph.variable_nodes},
        "factor_vars": {n.name: [v.name for v in n.variables]
                        for n in graph.factor_nodes},
        "memory": memory, "load": load,
    }


@pytest.mark.parametrize("key", PROBLEMS)
def test_factor_graph_equals_the_reference(key):
    from pydcop_tpu.computations_graph import factor_graph as jfg
    from pydcop_tpu_torch.computations_graph import factor_graph as tfg

    ref, port = problem_pair(key)
    want = factor_graph_summary(jfg, jfg.build_computation_graph(ref))
    got = factor_graph_summary(tfg, tfg.build_computation_graph(port))
    assert got == want
    assert len(got["links"]) == sum(
        len(c.dimensions) for c in port.constraints.values())
    pv, pc = scope(port)
    by_parts = tfg.build_computation_graph(variables=pv, constraints=pc)
    assert factor_graph_summary(tfg, by_parts) == got


def test_factor_graph_objects_and_refusals():
    from pydcop_tpu.computations_graph import factor_graph as jfg
    from pydcop_tpu_torch.computations_graph import factor_graph as tfg
    from pydcop_tpu_torch.dcop.objects import (
        Domain,
        ExternalVariable,
        Variable,
    )
    from pydcop_tpu_torch.dcop.relations import constraint_from_str

    link = tfg.FactorGraphLink("c1", "v1")
    back = tfg.FactorGraphLink._from_repr(link._simple_repr())
    assert (back.factor_node, back.variable_node) == ("c1", "v1")
    assert link._simple_repr()["factor_node"] == jfg.FactorGraphLink(
        "c1", "v1")._simple_repr()["factor_node"]
    assert tfg.build_computation_graph().density() == 0.0
    d = Domain("d", "", [0, 1, 2])
    x, y = Variable("x", d), Variable("y", d)
    e = ExternalVariable("e", d, 1)
    c = constraint_from_str("c", "x + y + e", [x, y, e])
    graph = tfg.build_computation_graph(variables=[x, y], constraints=[c])
    assert [n.name for n in graph.nodes] == ["x", "y", "c"]
    assert len(graph.links) == 2
    with pytest.raises(ValueError):
        tfg.build_computation_graph(variables=[x], constraints=[c])
    with pytest.raises(TypeError):
        tfg.computation_memory(object())
    with pytest.raises(TypeError):
        tfg.communication_load(object(), "x")
    with pytest.raises(ValueError):
        tfg.communication_load(graph.computation("c"), "nope")


@pytest.mark.parametrize("model", ["factor_graph", "constraints_hypergraph",
                                   "pseudotree", "ordered_graph"])
def test_graph_modules_load_by_name(model):
    from pydcop_tpu.computations_graph import load_graph_module as jload
    from pydcop_tpu_torch.computations_graph import load_graph_module

    module = load_graph_module(model)
    assert module.__name__ == f"pydcop_tpu_torch.computations_graph.{model}"
    ref, port = fixture_pair("coloring_12_3.yml")
    got = module.build_computation_graph(port)
    want = jload(model).build_computation_graph(ref)
    assert [n.name for n in got.nodes] == [n.name for n in want.nodes]
    assert len(got.links) == len(want.links)
    assert got.density() == want.density()


@pytest.mark.parametrize("algo", ["maxsum", "amaxsum", "maxsum_dynamic",
                                  "dsa", "mgm", "dpop", "syncbb", "ncbb"])
def test_graph_type_equals_the_reference(algo):
    from pydcop_tpu.algorithms import load_algorithm_module as jload
    from pydcop_tpu_torch.algorithms import load_algorithm_module

    assert load_algorithm_module(algo).GRAPH_TYPE == jload(algo).GRAPH_TYPE


def test_available_algorithms_equal_the_reference():
    from pydcop_tpu.algorithms import list_available_algorithms as jlist
    from pydcop_tpu_torch.algorithms import list_available_algorithms

    assert list_available_algorithms() == jlist()


# -- utils/various.py -------------------------------------------------- #

def _keyword_only(a, b, *, c):
    return a


@pytest.mark.parametrize("func", [
    lambda x, y: x, lambda: 0, _keyword_only, len, max,
    lambda x, *args, **kwargs: x, print,
])
def test_func_args_equals_the_reference(func):
    from pydcop_tpu.utils.various import func_args as jargs
    from pydcop_tpu_torch.utils.various import func_args

    assert func_args(func) == jargs(func)
