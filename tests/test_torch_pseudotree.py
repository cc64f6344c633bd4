"""The port's pseudo-tree, ordered graph and relation algebra against
``pydcop_tpu`` on the CPU.

- ``computations_graph/pseudotree.py::build_computation_graph`` builds
  the reference's tree from each package's own objects: the same roots,
  parents, children, pseudo-parents, pseudo-children and assigned
  constraints per node, the same ``node_depths``, and the same
  ``computation_memory`` and ``communication_load`` per node — on random
  trees (wide and deep), cyclic graphs, forests, mixed domain sizes,
  ternary chains and the repository's fixtures.
- ``computations_graph/ordered_graph.py``: the same next/previous links,
  constraints, memory and load per node.
- ``utils/graphs.py::constraint_adjacency``: the same adjacency.
- ``dcop/relations.py``'s ``join``, ``projection`` (min and max) and
  ``find_arg_optimal``: the same dimensions, names and arrays
  (``np.array_equal``) on unary, binary and ternary relations over
  mixed domains, and ``find_arg_optimal``'s refusal of a relation that
  is not unary on the variable.
"""

import numpy as np
import pytest
import torch

import pydcop_tpu.computations_graph.ordered_graph as j_og
import pydcop_tpu.computations_graph.pseudotree as j_pt
import pydcop_tpu.dcop.dcop as jd
import pydcop_tpu.dcop.objects as jo
import pydcop_tpu.dcop.relations as jr
import pydcop_tpu.utils.graphs as j_graphs
import pydcop_tpu_torch.computations_graph.ordered_graph as t_og
import pydcop_tpu_torch.computations_graph.pseudotree as t_pt
import pydcop_tpu_torch.dcop.dcop as td
import pydcop_tpu_torch.dcop.objects as to
import pydcop_tpu_torch.dcop.relations as tr
import pydcop_tpu_torch.utils.graphs as t_graphs
from test_torch_compile import load_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


JAX_MODS = (jo, jr, jd)
TORCH_MODS = (to, tr, td)


def random_dcop(mods, n, d, seed, extra_edges=0, objective="min",
                wide=True, integer=False):
    """The reference's ``tests/unit/test_dpop_jit.py`` random spanning
    tree (each variable tied to an earlier one: any earlier when
    ``wide``, one of the two before it otherwise) plus ``extra_edges``
    cycle-making edges, with ``rng.random`` tables (or integers in
    [0, 20) when ``integer``), built from one package's modules."""
    objects, relations, dcop_mod = mods
    rng = np.random.default_rng(seed)
    dom = objects.Domain("c", "", list(range(d)))
    dcop = dcop_mod.DCOP("t", objective=objective)
    vs = [objects.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)

    def table(shape):
        if integer:
            return rng.integers(0, 20, shape).astype(float)
        return rng.random(shape)

    k = 0
    for i in range(1, n):
        p = rng.integers(0, i) if wide else rng.integers(max(0, i - 2), i)
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[p], vs[i]], table((d, d)), f"c{k}"))
        k += 1
    for _ in range(extra_edges):
        i, j = rng.choice(n, size=2, replace=False)
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[i], vs[j]], table((d, d)), f"c{k}"))
        k += 1
    dcop.add_agents([objects.AgentDef(f"a{i}") for i in range(n)])
    return dcop


def forest_dcop(mods, seed=11):
    """Three 10-variable trees (the reference's forest case)."""
    objects, relations, dcop_mod = mods
    rng = np.random.default_rng(seed)
    dom = objects.Domain("c", "", [0, 1, 2])
    dcop = dcop_mod.DCOP("f", objective="min")
    vs = [objects.Variable(f"v{i}", dom) for i in range(30)]
    for v in vs:
        dcop.add_variable(v)
    for base in (0, 10, 20):
        for i in range(base + 1, base + 10):
            p = rng.integers(base, i)
            dcop.add_constraint(relations.NAryMatrixRelation(
                [vs[p], vs[i]], rng.random((3, 3)), f"c{i}"))
    return dcop


def mixed_domains_dcop(mods, seed=13, unary=False):
    """Domains of 2, 3 and 5 values on a random tree; with ``unary``,
    variable costs and unary constraints too."""
    objects, relations, dcop_mod = mods
    rng = np.random.default_rng(seed)
    doms = [objects.Domain(f"d{k}", "", list(range(k))) for k in (2, 3, 5)]
    dcop = dcop_mod.DCOP("m", objective="min")
    vs = []
    for i in range(24):
        dom = doms[i % 3]
        if unary and i % 4 == 0:
            vs.append(objects.VariableWithCostFunc(
                f"v{i}", dom, f"{float(rng.random()):.6f} * v{i} ** 2"))
        else:
            vs.append(objects.Variable(f"v{i}", dom))
    for v in vs:
        dcop.add_variable(v)
    for i in range(1, 24):
        p = rng.integers(0, i)
        shape = (len(vs[p].domain), len(vs[i].domain))
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[p], vs[i]], rng.random(shape), f"c{i}"))
    if unary:
        for i in range(0, 24, 5):
            dcop.add_constraint(relations.NAryMatrixRelation(
                [vs[i]], rng.random(len(vs[i].domain)), f"u{i}"))
    return dcop


def ternary_dcop(mods, seed=17, n=12):
    """A chain of ternary constraints (the reference's ternary case)."""
    objects, relations, dcop_mod = mods
    rng = np.random.default_rng(seed)
    dom = objects.Domain("c", "", [0, 1, 2])
    dcop = dcop_mod.DCOP("t3", objective="min")
    vs = [objects.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(2, n):
        dcop.add_constraint(relations.NAryMatrixRelation(
            [vs[i - 2], vs[i - 1], vs[i]], rng.random((3, 3, 3)), f"c{i}"))
    return dcop


def both(builder, *args, **kw):
    return builder(JAX_MODS, *args, **kw), builder(TORCH_MODS, *args, **kw)


CASES = {
    "tree_wide": lambda: both(random_dcop, 60, 3, 0),
    "tree_deep": lambda: both(random_dcop, 40, 3, 23, wide=False),
    "cyclic": lambda: both(random_dcop, 40, 3, 3, extra_edges=12),
    "max_mode": lambda: both(random_dcop, 50, 3, 7, extra_edges=5,
                             objective="max"),
    "forest": lambda: both(forest_dcop),
    "mixed_domains": lambda: both(mixed_domains_dcop),
    "mixed_domains_unary": lambda: both(mixed_domains_dcop, unary=True),
    "ternary": lambda: both(ternary_dcop),
    "wide_300": lambda: both(random_dcop, 300, 3, 29),
    "coloring_12_3": lambda: load_both("coloring_12_3.yml"),
    "secp_lamps": lambda: load_both("secp_lamps.yaml"),
    "pref_ring_max": lambda: load_both("pref_ring_max.yaml"),
    "loft_scene": lambda: load_both("loft_scene.yml"),
}


def _links(node):
    return (node.parent, list(node.children), list(node.pseudo_parents),
            list(node.pseudo_children))


@pytest.mark.parametrize("case", sorted(CASES))
def test_pseudotree_equals_reference(case):
    jax_dcop, torch_dcop = CASES[case]()
    jg = j_pt.build_computation_graph(jax_dcop)
    tg = t_pt.build_computation_graph(torch_dcop)
    jn = {n.name: n for n in jg.nodes}
    tn = {n.name: n for n in tg.nodes}
    assert list(jn) == list(tn)
    assert [n.name for n in jg.roots] == [n.name for n in tg.roots]
    for name in jn:
        assert _links(tn[name]) == _links(jn[name]), name
        assert ([c.name for c in tn[name].constraints]
                == [c.name for c in jn[name].constraints]), name
        assert (t_pt.computation_memory(tn[name])
                == j_pt.computation_memory(jn[name])), name
        assert (t_pt.communication_load(tn[name], "x")
                == j_pt.communication_load(jn[name], "x")), name
    assert t_pt.node_depths(tg) == j_pt.node_depths(jg)
    with pytest.raises(TypeError):
        t_pt.computation_memory(object())


@pytest.mark.parametrize("case", sorted(CASES))
def test_ordered_graph_and_adjacency_equal_reference(case):
    jax_dcop, torch_dcop = CASES[case]()
    jg = j_og.build_computation_graph(jax_dcop)
    tg = t_og.build_computation_graph(torch_dcop)
    assert ([n.name for n in tg.ordered_nodes]
            == [n.name for n in jg.ordered_nodes])
    for jnode, tnode in zip(jg.ordered_nodes, tg.ordered_nodes):
        assert (tnode.next_node, tnode.previous_node) == (
            jnode.next_node, jnode.previous_node)
        assert ([c.name for c in tnode.constraints]
                == [c.name for c in jnode.constraints])
        assert (t_og.computation_memory(tnode)
                == j_og.computation_memory(jnode))
        assert (t_og.communication_load(tnode, "x")
                == j_og.communication_load(jnode, "x"))
    assert (t_graphs.constraint_adjacency(
        list(torch_dcop.variables.values()),
        list(torch_dcop.constraints.values()))
        == j_graphs.constraint_adjacency(
            list(jax_dcop.variables.values()),
            list(jax_dcop.constraints.values())))


def _relations(mods, seed):
    """Unary, binary and ternary matrix relations over variables of 2,
    3 and 4 values, with rng.random tables (the same from one seed)."""
    objects, relations, _ = mods
    rng = np.random.default_rng(seed)
    vs = [objects.Variable(f"x{i}", objects.Domain(
        f"d{i}", "", list(range(k)))) for i, k in enumerate((2, 3, 4))]
    u = relations.NAryMatrixRelation([vs[1]], rng.random(3), "u")
    b = relations.NAryMatrixRelation([vs[2], vs[0]], rng.random((4, 2)),
                                     "b")
    t = relations.NAryMatrixRelation(vs[::-1], rng.random((4, 3, 2)), "t")
    return vs, [u, b, t]


def _same_relation(out, ref):
    assert out.name == ref.name
    assert [v.name for v in out.dimensions] == [v.name
                                                 for v in ref.dimensions]
    assert np.array_equal(np.asarray(out.matrix), np.asarray(ref.matrix))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_projection_find_arg_optimal_equal_reference(seed):
    jvs, jrels = _relations(JAX_MODS, seed)
    tvs, trels = _relations(TORCH_MODS, seed)
    for i in range(3):
        for j in range(3):
            jj = jr.join(jrels[i], jrels[j])
            tj = tr.join(trels[i], trels[j])
            _same_relation(tj, jj)
            for k, var in enumerate(tj.dimensions):
                for mode in ("min", "max"):
                    _same_relation(
                        tr.projection(tj, var, mode),
                        jr.projection(jj, jj.dimensions[k], mode))
    for mode in ("min", "max"):
        assert (tr.find_arg_optimal(tvs[1], trels[0], mode)
                == jr.find_arg_optimal(jvs[1], jrels[0], mode))
    with pytest.raises(ValueError):
        tr.find_arg_optimal(tvs[0], trels[0], "min")
    with pytest.raises(ValueError):
        tr.projection(trels[0], tvs[0])
