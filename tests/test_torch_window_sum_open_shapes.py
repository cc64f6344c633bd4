"""The sum orders ROADMAP Queue C item 1 left open, pinned against the
jitted JAX reference on the CPU, bit for bit (uint32 views): the
gathered costs of one bucket.

``ops/window_sum.py`` sums each whole-graph total in XLA:CPU's order;
where LLVM vectorised a direct sum of a bucket's 2-32 gathered costs
its form comes from ``gather_stages``.  The forms were read from probes
of the optimised HLO and IR and the sums' bits (jax 0.9.0); this file
holds one case per probed shape class: one bucket of arity 5-8, or of
one-value domains (D = 1), of 4, 8, 16, 21, 23, 24 and 32 factors over 40
variables, at the local search's site (``assignment_cost``) and the
cost trace's (``assignment_constraint_cost``, the graph a jit
argument).  ``tests/test_torch_window_sum_open_rows.py`` holds the
probe's site and the residual.

Costs are drawn anew per seed over one, three or six decades, so that
different orders give different bits; each graph is built once a class
with 32 factors and cut to each count.
"""

import jax
import numpy as np
import pytest
import torch

import pydcop_tpu.dcop.dcop as jd
import pydcop_tpu.dcop.objects as jo
import pydcop_tpu.dcop.relations as jr
from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu.ops import localsearch as JL
from pydcop_tpu.ops import maxsum as JM
from pydcop_tpu_torch.engine.convert import graph_from_numpy
from pydcop_tpu_torch.ops import localsearch as TL
from pydcop_tpu_torch.ops import maxsum as TM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def costs(rng, shape, decades):
    return (rng.standard_normal(shape)
            * 10.0 ** rng.uniform(-decades, decades, shape)).astype(
                np.float32)


def skeleton(n_vars, buckets, d, seed):
    """The reference's compiled graph of ``count`` random factors of
    each ``(arity, count)`` over ``n_vars`` variables of domain ``d``."""
    rng = np.random.default_rng(seed)
    dom = jo.Domain("d", "", list(range(d)))
    dcop = jd.DCOP("g", objective="min")
    vs = [jo.Variable(f"v{i:04d}", dom) for i in range(n_vars)]
    for var in vs:
        dcop.add_variable(var)
    k = 0
    for arity, count in buckets:
        for _ in range(count):
            scope = [vs[i] for i in rng.choice(n_vars, arity,
                                               replace=False)]
            dcop.add_constraint(jr.NAryMatrixRelation(
                scope, np.ones((d,) * arity), f"c{k}"))
            k += 1
    g, _ = jax_compile(dcop, aggregation="scatter", use_cache=False)
    return g


def drawn(g, seed):
    """``g`` with costs drawn over 1, 3 or 6 decades, the port's placed
    copy, and an assignment ([V + 1], the sentinel's value last)."""
    rng = np.random.default_rng(seed)
    decades = (1, 3, 6)[seed % 3]
    g = g._replace(
        var_costs=costs(rng, g.var_costs.shape, decades),
        buckets=tuple(b._replace(costs=costs(rng, b.costs.shape, decades))
                      for b in g.buckets))
    tg = graph_from_numpy(np.asarray(g.var_costs), np.asarray(g.var_valid),
                          [(np.asarray(b.costs), np.asarray(b.var_ids))
                           for b in g.buckets],
                          device="cpu", aggregation="scatter")
    n, d = g.var_costs.shape
    return g, tg, rng.integers(0, d, n).astype(np.int32)


def bits(x) -> int:
    return int(np.asarray(x, np.float32).view(np.uint32))


_ls_cost = jax.jit(JL.assignment_cost)
_ms_cost = jax.jit(JM.assignment_constraint_cost)


def assert_site(site, g0, seeds):
    for seed in seeds:
        g, tg, vals = drawn(g0, seed)
        tv = torch.from_numpy(vals)
        if site == "localsearch":
            ref, got = _ls_cost(g, vals), TL.assignment_cost(tg, tv)
        elif site == "maxsum":
            ref = _ms_cost(g, vals[:-1])
            got = TM.assignment_constraint_cost(tg, tv[:-1])
        else:
            ref = jax.jit(lambda v: JM.assignment_constraint_cost(g, v))(
                vals[:-1])
            got = TM.assignment_constraint_cost(tg, tv[:-1], site="probe")
        assert bits(got) == bits(ref), (site, seed, [b.var_ids.shape for b in g.buckets], float(got), float(ref))


# The shape classes (arity, D) of each site: the forms at 4 and 8
# factors and at 20-23 and 32 differ between them.
CLASSES = {
    "localsearch": [(5, 2), (5, 3), (6, 2), (7, 3), (8, 2), (2, 1), (4, 1),
                    (6, 1)],
    "maxsum": [(5, 2), (6, 3), (7, 2), (8, 3), (3, 1), (4, 1), (7, 1)],
}
COUNTS = [4, 8, 16, 21, 23, 24, 32]


def counts(site, arity, d):
    """COUNTS at every site and shape class (23 at the local search's
    site with D = 1 and arity >= 6 too, since the rule for it was
    found)."""
    return COUNTS
_SKELETONS = {}


def bucket_graph(arity, d, n):
    """One bucket of ``n`` factors over 40 variables (built once a
    class with 32 factors, then cut)."""
    g = _SKELETONS.get((arity, d))
    if g is None:
        g = _SKELETONS[(arity, d)] = skeleton(40, [(arity, 32)], d,
                                              seed=arity * 10 + d)
    return g._replace(buckets=tuple(
        b._replace(costs=b.costs[:n], var_ids=b.var_ids[:n])
        for b in g.buckets))


@pytest.mark.parametrize("site,arity,d", [
    (site, arity, d) for site, classes in CLASSES.items()
    for arity, d in classes])
def test_wide_and_unit_domain_buckets(site, arity, d):
    """One bucket of 4-32 factors: each count's head at the site."""
    for n in counts(site, arity, d):
        assert_site(site, bucket_graph(arity, d, n), range(3))
