"""Whole-graph float32 totals (pydcop_tpu_torch/ops/window_sum.py) against
the jitted JAX reference on the CPU, bit for bit.

- ``window_tree_sum`` equals ``jax.jit(jnp.sum)`` over sizes 1-70,
  1,025, 15,000, 100,000 and 1,000,001, for signed values over eight
  decades, subnormal entries (read as zeros, results flushed), +-inf
  (and the NaN of inf - inf) and signed zeros; and, with
  ``residual_lanes``, the engine probe's ``jnp.sum(jnp.abs(b - a))``
  over [F, arity, D] messages (windows of 32 rows, rows in lanes over
  the arity axis where LLVM vectorises them).
- The six sites, each against its reference function jitted as the
  reference runs it: ``ops/localsearch.py::assignment_cost`` (the graph
  a jit argument), ``ops/maxsum.py::assignment_constraint_cost`` and the
  cost trace's ``cost_of`` with the variable-side sum (argument), the
  engine probe's ``cost_of`` (the graph closed over as constants) and
  its residual and flip rate (``EngineProbe._build_conv_fn``): on a grid
  of buckets (arity 0-4, D in {2, 3, 5}, 8-100 factors: every form of
  ``gather_stages``), on multi-bucket graphs, on the flagship-size graph
  (10,000 variables, 14,999 binary factors, real costs) and on
  ``tests/test_torch_trace.py``'s graphs, through ``run_maxsum_trace``,
  ``MaxSumEngine.run_trace``, the engine probe and the local-search
  runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydcop_tpu.dcop.dcop as jd
import pydcop_tpu.dcop.objects as jo
import pydcop_tpu.dcop.relations as jr
from pydcop_tpu.algorithms.maxsum import build_engine as jax_build_engine
from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu.observability.engine_probe import EngineProbe as JaxProbe
from pydcop_tpu.ops import dsa as JD
from pydcop_tpu.ops import localsearch as JL
from pydcop_tpu.ops import maxsum as JM
from pydcop_tpu_torch.algorithms.maxsum import build_engine
from pydcop_tpu_torch.engine.convert import graph_from_numpy
from pydcop_tpu_torch.observability.engine_probe import EngineProbe
from pydcop_tpu_torch.ops import dsa as TD
from pydcop_tpu_torch.ops import localsearch as TL
from pydcop_tpu_torch.ops import maxsum as TM
from pydcop_tpu_torch.ops.window_sum import (
    add,
    residual_lanes,
    window_tree_sum,
)
from test_torch_compile import load_both
from test_torch_dsa import build_mixed_real
from test_torch_prune import loopy_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def wide(rng, shape):
    """Signed float32 values over eight decades."""
    return (rng.standard_normal(shape)
            * 10.0 ** rng.uniform(-4, 4, shape)).astype(np.float32)


def values_of(kind: str, size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(1000 * seed + size)
    x = wide(rng, size)
    if kind == "subnormal":
        at = rng.integers(0, size, size // 4 + 1)
        x[at] = (rng.standard_normal(at.size) * 1e-39).astype(np.float32)
        x[rng.random(size) < 0.1] = np.float32(1.3e-38)
    elif kind == "inf":
        x[rng.integers(0, size)] = np.inf
        if size > 20:
            x[rng.integers(0, size)] = -np.inf
    elif kind == "zeros":
        x[rng.random(size) < 0.4] = -0.0
        x[rng.random(size) < 0.2] = 0.0
    return x


def same_bits(out: torch.Tensor, ref) -> bool:
    return (out.dtype == torch.float32
            and out.numpy().tobytes() == np.asarray(ref).tobytes())


_jnp_sum = jax.jit(jnp.sum)
SIZES = list(range(1, 71)) + [1025, 15000, 100000, 1000001]


@pytest.mark.parametrize("kind", ["signed", "subnormal", "inf", "zeros"])
@pytest.mark.parametrize("size", SIZES)
def test_window_tree_sum_equals_jnp_sum(size, kind):
    for seed in range(3):
        x = values_of(kind, size, seed)
        out = window_tree_sum(torch.from_numpy(x))
        assert out.shape == ()
        assert same_bits(out, _jnp_sum(x)), (size, kind, seed)


def test_window_tree_sum_of_nothing_and_of_one_subnormal():
    """An empty sum is +0.0; a one-value sum is a copy, unflushed."""
    assert same_bits(window_tree_sum(torch.zeros(0)), _jnp_sum(
        np.zeros(0, np.float32)))
    one = np.array([-1e-39], np.float32)
    assert same_bits(window_tree_sum(torch.from_numpy(one)), _jnp_sum(one))


def test_window_tree_sum_refuses_other_types():
    with pytest.raises(TypeError):
        window_tree_sum(torch.zeros(4, dtype=torch.float64))


# The reference probe's jitted (residual, flip rate) function (it reads
# nothing of the probe).
_conv = JaxProbe._build_conv_fn(None)

RESIDUAL_SHAPES = [(17, 2, 3), (100, 2, 3), (1000, 2, 3), (14999, 2, 3),
                   (64, 2, 3), (64, 2, 2), (300, 2, 8), (100, 2, 16),
                   (17, 4, 3), (9, 4, 4), (100, 4, 3), (100, 8, 3),
                   (17, 8, 2), (70, 3, 5), (30, 3, 3), (33, 1, 1),
                   (100, 2, 1), (100, 4, 1), (10, 2, 128)]


@pytest.mark.parametrize("shape", RESIDUAL_SHAPES)
def test_residual_and_flip_rate_equal_the_probe(shape):
    """The engine probe's convergence pair on one bucket's messages and
    on two buckets (this shape and a [20, 2, 3] one)."""
    rng = np.random.default_rng(sum(shape))
    n_vars = 37
    pv = rng.integers(0, 3, n_vars).astype(np.int32)
    v = np.where(rng.random(n_vars) < 0.3, (pv + 1) % 3, pv).astype(
        np.int32)
    for extra in ([], [(20, 2, 3)]):
        a = [np.abs(wide(rng, s)) * rng.choice([-1, 1], s).astype(
            np.float32) for s in [shape] + extra]
        b = [x + wide(rng, x.shape) for x in a]
        ref = _conv(tuple(a), tuple(b), pv, v)
        out = EngineProbe._convergence(
            tuple(torch.from_numpy(x) for x in a),
            tuple(torch.from_numpy(x) for x in b),
            torch.from_numpy(pv), torch.from_numpy(v))
        assert same_bits(out[0], ref[0]), (shape, extra)
        assert same_bits(out[1], ref[1]), (shape, extra)
    assert residual_lanes(shape) in (1, 2, 4, 8)


def build(n_vars, counts, d, seed=0):
    """The reference's compiled graph of ``counts[k]`` random factors of
    arity k + 1 over ``n_vars`` variables of domain ``d``, with real
    costs over eight decades, and the port's placed copy of the same
    arrays."""
    rng = np.random.default_rng(seed)
    dom = jo.Domain("d", "", list(range(d)))
    dcop = jd.DCOP("grid", objective="min")
    vs = [jo.Variable(f"v{i:05d}", dom) for i in range(n_vars)]
    for var in vs:
        dcop.add_variable(var)
    k = 0
    for arity, count in enumerate(counts, start=1):
        for _ in range(count):
            scope = [vs[i] for i in rng.choice(n_vars, arity,
                                               replace=False)]
            dcop.add_constraint(jr.NAryMatrixRelation(
                scope, np.ones((d,) * arity), f"c{k}"))
            k += 1
    g, _ = jax_compile(dcop, aggregation="scatter", use_cache=False)
    g = g._replace(
        var_costs=wide(rng, g.var_costs.shape),
        buckets=tuple(b._replace(costs=wide(rng, b.costs.shape))
                      for b in g.buckets))
    tg = graph_from_numpy(g.var_costs, g.var_valid,
                          [(b.costs, b.var_ids) for b in g.buckets],
                          device="cpu", aggregation="scatter")
    return g, tg


_ls_cost = jax.jit(JL.assignment_cost)
_ms_cost = jax.jit(JM.assignment_constraint_cost)
_trace_cost = jax.jit(lambda g, base, v: JM.assignment_constraint_cost(
    g, v) + jnp.sum(jnp.take_along_axis(base, v[:, None], axis=1)))


def assert_sites_equal(g, tg, seed):
    """assignment_cost, assignment_constraint_cost, the trace's cost_of
    and the probe's closed-over cost_of, at a random assignment."""
    rng = np.random.default_rng(seed)
    n, d = g.var_costs.shape
    vals = rng.integers(0, d, n).astype(np.int32)
    tv = torch.from_numpy(vals)
    base = wide(rng, (n - 1, d))
    tbase = torch.from_numpy(base)
    assert same_bits(TL.assignment_cost(tg, tv), _ls_cost(g, vals))
    assert same_bits(TM.assignment_constraint_cost(tg, tv[:-1]),
                     _ms_cost(g, vals[:-1]))
    assert same_bits(
        add(TM.assignment_constraint_cost(tg, tv[:-1]),
            TM.variable_cost(tbase, tv[:-1])),
        _trace_cost(g, base, vals[:-1]))
    closed = jax.jit(lambda v: JM.assignment_constraint_cost(g, v)
                     + jnp.sum(jnp.take_along_axis(jnp.asarray(base),
                                                   v[:, None], axis=1)))
    assert same_bits(
        add(TM.assignment_constraint_cost(tg, tv[:-1], site="probe"),
            TM.variable_cost(tbase, tv[:-1], site="probe")),
        closed(vals[:-1]))


GRID = [(arity, d, n) for arity in range(1, 5) for d in (2, 3, 5)
        for n in (8, 16, 20, 22, 24, 31, 32, 100)]


@pytest.mark.parametrize("arity,d,n", GRID)
def test_sites_on_one_bucket(arity, d, n):
    counts = [0, 0, 0, 0]
    counts[arity - 1] = n
    g, tg = build(max(n + 4, 12) if arity > 1 else n + 10, counts, d,
                  seed=n)
    for seed in range(3):
        assert_sites_equal(g, tg, seed)


MIXED = [((4, 21, 25), 3), ((15, 90, 20), 3), ((0, 21, 25), 3),
         ((4, 21, 0), 3), ((0, 24, 3), 3), ((10, 0, 20), 2),
         ((30, 300, 66), 3), ((0, 22, 0), 4), ((3, 20, 0), 5),
         ((0, 23, 9), 2), ((40, 40, 40), 4), ((0, 21, 1), 3),
         ((0, 22, 1), 5)]


@pytest.mark.parametrize("counts,d", MIXED)
def test_sites_on_several_buckets(counts, d):
    g, tg = build(60, counts, d, seed=sum(counts))
    for seed in range(3):
        assert_sites_equal(g, tg, seed)


def test_sites_on_the_flagship_size_graph():
    """10,000 variables, 14,999 binary factors (bench.py build_dcop's
    shape), D = 3, real costs; its f2v messages' residual too."""
    g, tg = build(10_000, (0, 14_999, 0), 3, seed=7)
    for seed in range(2):
        assert_sites_equal(g, tg, seed)
    rng = np.random.default_rng(3)
    a, b = wide(rng, (14_999, 2, 3)), wide(rng, (14_999, 2, 3))
    v = rng.integers(0, 3, 10_000).astype(np.int32)
    ref = _conv((a,), (b,), v, (v + 1) % 3)
    out = EngineProbe._convergence(
        (torch.from_numpy(a),), (torch.from_numpy(b),),
        torch.from_numpy(v), torch.from_numpy((v + 1) % 3))
    assert same_bits(out[0], ref[0]) and same_bits(out[1], ref[1])


def test_local_search_run_cost_on_the_flagship_size_graph():
    """run_dsa's final cost (assignment_cost inside the reference's
    jitted run) at the flagship's size with real costs."""
    g, tg = build(10_000, (0, 14_999, 0), 3, seed=9)
    ref = jax.jit(lambda gr: JD.run_dsa(gr, 5, variant="B",
                                        probability=0.7, seed=3))(g)
    values, cost, _ = TD.run_dsa(tg, 5, variant="B", probability=0.7,
                                 seed=3)
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref[0]))
    assert same_bits(cost, ref[1])


TRACE_GRAPHS = {
    "loopy_d32_variables": lambda: loopy_both(d=32, seed=0,
                                              unary="variables"),
    "loopy_d16": lambda: loopy_both(d=16, seed=2),
    "coloring_12_3": lambda: load_both("coloring_12_3.yml"),
    "loft_scene": lambda: load_both("loft_scene.yml"),
    "pref_ring_max": lambda: load_both("pref_ring_max.yaml"),
    "coloring_int_costs": lambda: load_both("coloring_int_costs.yaml"),
    "mixed_real": lambda: (build_mixed_real(jo, jr, jd, 40, seed=6),
                           None),
}


def _trace_pair(name):
    jax_dcop, torch_dcop = TRACE_GRAPHS[name]()
    if torch_dcop is None:
        import pydcop_tpu_torch.dcop.dcop as td
        import pydcop_tpu_torch.dcop.objects as to
        import pydcop_tpu_torch.dcop.relations as tr

        torch_dcop = build_mixed_real(to, tr, td, 40, seed=6)
    return jax_dcop, torch_dcop


@pytest.mark.parametrize("name", sorted(TRACE_GRAPHS))
def test_trace_and_probe_costs_on_the_trace_graphs(name):
    """On each graph: the engines' cost traces bit for bit, and the
    probe's cost of the final assignment (the reference's closed-over
    ``cost_of``) bit for bit."""
    jax_dcop, torch_dcop = _trace_pair(name)
    jeng = jax_build_engine(jax_dcop, {})
    teng = build_engine(torch_dcop, {}, device="cpu")
    ref = jeng.run_trace(30)
    out = teng.run_trace(30)
    assert out.assignment == ref.assignment
    assert (out.metrics["cost_trace"].tobytes()
            == ref.metrics["cost_trace"].tobytes())
    meta = teng.meta
    vals = np.array([meta.domains[i].index(out.assignment[v])
                     for i, v in enumerate(meta.var_names)], np.int32)
    jcost = JaxProbe(jeng)._build_cost_fn()(vals)
    tcost = EngineProbe(teng)._cost(torch.from_numpy(vals))
    assert same_bits(tcost, jcost)
