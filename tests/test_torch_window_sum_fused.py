"""The one-launch whole-graph total (``ops/window_sum.py::window_total``,
its plain version on the CPU) against the jitted JAX reference, bit for
bit (uint32 views), at the six sites:

- ``localsearch.assignment_cost`` (``pydcop_tpu/ops/localsearch.py``,
  the graph a jit argument);
- ``maxsum.assignment_constraint_cost`` (the graph a jit argument);
- the cost trace's ``cost_of``, constraint and variable costs
  (``maxsum.assignment_total``; ``run_maxsum_trace`` writes each into
  its slot ``costs[n]``);
- the engine probe's ``cost_of`` (the graph closed over as constants);
- the engine probe's residual and flip rate
  (``EngineProbe._convergence``: one total from +0.0).

Graphs: one bucket; buckets of arity 1-4 beside the variable costs; a
one-factor bucket (its sum a copy); a first bucket whose sum is -0.0
(the chain starts from it: XLA drops the reference's ``0.0 +``);
subnormal and +-inf tables; the flagship's size (10,000 variables,
14,999 binary factors, D = 3).  Plus the entry's own rules on the CPU:
the chain's start, the output slot, the sentinel ids, refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.observability.engine_probe import EngineProbe as JaxProbe
from pydcop_tpu.ops import localsearch as JL
from pydcop_tpu.ops import maxsum as JM
from pydcop_tpu_torch.engine.convert import graph_from_numpy
from pydcop_tpu_torch.observability.engine_probe import EngineProbe
from pydcop_tpu_torch.ops import localsearch as TL
from pydcop_tpu_torch.ops import maxsum as TM
from pydcop_tpu_torch.ops import window_sum as ws
from test_torch_window_sum_open_shapes import bits, costs, skeleton


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def placed(g):
    return graph_from_numpy(np.asarray(g.var_costs), np.asarray(g.var_valid),
                            [(np.asarray(b.costs), np.asarray(b.var_ids))
                             for b in g.buckets],
                            device="cpu", aggregation="scatter")


def with_costs(g, rng, decades, fill=None):
    """``g`` with new costs; ``fill(rng, array)`` edits each table."""
    def draw(shape):
        x = costs(rng, shape, decades)
        if fill is not None:
            fill(rng, x)
        return x

    return g._replace(
        var_costs=draw(g.var_costs.shape),
        buckets=tuple(b._replace(costs=draw(b.costs.shape))
                      for b in g.buckets))


_ls_cost = jax.jit(JL.assignment_cost)
_ms_cost = jax.jit(JM.assignment_constraint_cost)
_trace_cost = jax.jit(lambda gr, base, v: JM.assignment_constraint_cost(
    gr, v) + jnp.sum(jnp.take_along_axis(base, v[:, None], axis=1)))
_conv = JaxProbe._build_conv_fn(None)


def assert_six_sites(g, seed, probe=True):
    """The six sites at a random assignment of ``g`` (costs as given)."""
    rng = np.random.default_rng(seed)
    tg = placed(g)
    n, d = g.var_costs.shape
    vals = rng.integers(0, d, n).astype(np.int32)
    tv = torch.from_numpy(vals)
    base = costs(rng, (n - 1, d), 3)
    tbase = torch.from_numpy(base)
    assert bits(TL.assignment_cost(tg, tv)) == bits(_ls_cost(g, vals))
    assert bits(TM.assignment_constraint_cost(tg, tv[:-1])) == bits(
        _ms_cost(g, vals[:-1]))
    assert bits(TM.assignment_total(tg, tv[:-1], tbase)) == bits(
        _trace_cost(g, base, vals[:-1]))
    if probe:
        closed = jax.jit(lambda v: JM.assignment_constraint_cost(g, v)
                         + jnp.sum(jnp.take_along_axis(
                             jnp.asarray(base), v[:, None], axis=1)))
        assert bits(TM.assignment_total(tg, tv[:-1], tbase,
                                        site="probe")) == bits(
            closed(vals[:-1]))
    shapes = [tuple(b.var_ids.shape) + (d,) for b in g.buckets]
    a = [np.abs(costs(rng, s, 3)) for s in shapes]
    b = [x + costs(rng, x.shape, 1) for x in a]
    pv = (vals[:-1] + 1) % d
    ref = _conv(tuple(a), tuple(b), pv, vals[:-1])
    out = EngineProbe._convergence(
        tuple(torch.from_numpy(x) for x in a),
        tuple(torch.from_numpy(x) for x in b),
        torch.from_numpy(pv), tv[:-1])
    assert bits(out[0]) == bits(ref[0]) and bits(out[1]) == bits(ref[1])


GRAPHS = {
    "one_bucket": (50, [(2, 70)], 3),
    "arity_0_to_4": (60, [(1, 12), (2, 90), (3, 21), (4, 9)], 3),
    "one_factor": (40, [(2, 30), (3, 1)], 3),
    "one_factor_first": (40, [(1, 1), (2, 45)], 2),
    "windowed_and_direct": (300, [(1, 40), (2, 1100), (3, 24)], 2),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_six_sites(name):
    n_vars, buckets, d = GRAPHS[name]
    g0 = skeleton(n_vars, buckets, d, seed=len(name))
    for seed in range(3):
        g = with_costs(g0, np.random.default_rng(seed), (1, 3, 6)[seed])
        assert_six_sites(g, seed, probe=seed == 0)


def test_chain_starts_from_a_negative_zero_first_part():
    """A one-factor first bucket costing -0.0 everywhere: its sum is a
    copy, -0.0, and the chain starts from it; alone, the total is -0.0
    (+0.0 had the reference's ``0.0 +`` been kept)."""
    g0 = skeleton(30, [(1, 1), (2, 20)], 3, seed=5)
    rng = np.random.default_rng(1)
    g = with_costs(g0, rng, 3)
    neg = g.buckets[0]._replace(costs=np.full(g.buckets[0].costs.shape,
                                              -0.0, np.float32))
    alone = g._replace(buckets=(neg,))
    both = g._replace(buckets=(neg,) + g.buckets[1:])
    for graph in (alone, both):
        assert_six_sites(graph, 3)
    vals = np.zeros(31, np.int32)
    total = TM.assignment_constraint_cost(placed(alone),
                                          torch.from_numpy(vals[:-1]))
    assert bits(total) == bits(np.float32(-0.0))


def test_chain_flag_and_the_output_slot():
    """from_zero adds the first part to +0.0 (``add(+0.0, -0.0)`` is
    +0.0); ``out`` receives the total and is returned."""
    neg = ws.Plain(torch.tensor([-0.0]))
    assert bits(ws.window_total([neg])) == bits(np.float32(-0.0))
    assert bits(ws.window_total([neg], from_zero=True)) == bits(
        np.float32(0.0))
    assert bits(ws.window_total([])) == bits(np.float32(0.0))
    slots = torch.full((4,), 7.0)
    x = torch.from_numpy(costs(np.random.default_rng(2), (100,), 3))
    got = ws.window_total([ws.Plain(x), ws.Plain(x[:5])], out=slots[2])
    assert got.data_ptr() == slots[2].data_ptr()
    assert bits(slots[2]) == bits(ws.add(ws.window_tree_sum(x),
                                         ws.window_tree_sum(x[:5])))
    assert slots[0] == 7.0 and slots[3] == 7.0


def test_gather_reads_ids_past_the_values_as_zero():
    """A padded bucket's sentinel id (V, past a [V] assignment) reads
    value 0, and ids None read row f at values[f]."""
    table = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    ids = torch.tensor([[0, 1], [2, 5], [5, 5]], dtype=torch.int32)
    values = torch.tensor([1, 1, 0], dtype=torch.int32)
    got = ws.gathered(ws.Gather(table, ids, 3, 2), values)
    assert got.tolist() == [3.0, 4.0, 8.0]
    var = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    got = ws.gathered(ws.Gather(var, None, 3, 2), values)
    assert got.tolist() == [1.0, 3.0, 4.0]


def test_refusals():
    with pytest.raises(TypeError):
        ws.window_total([ws.Plain(torch.zeros(4, dtype=torch.float64))])
    with pytest.raises(ValueError):
        ws.window_tree_sum(torch.zeros(20, 1, 3), rows=(8, 24))
    with pytest.raises(ValueError):
        ws.window_tree_sum(torch.zeros(40, 2, 3), lanes=4)


@pytest.mark.parametrize("kind", ["subnormal", "inf"])
def test_subnormal_and_infinite_tables(kind):
    """Tables holding subnormals (read as zeros, results flushed) or
    +-inf (a NaN where they meet)."""
    def fill(rng, x):
        flat = x.reshape(-1)
        if kind == "subnormal":
            flat[rng.random(flat.size) < 0.3] = np.float32(-1e-39)
            flat[rng.random(flat.size) < 0.2] = np.float32(1.3e-38)
        else:
            flat[rng.random(flat.size) < 0.02] = np.inf
            flat[rng.random(flat.size) < 0.02] = -np.inf

    g0 = skeleton(80, [(1, 10), (2, 150), (3, 20)], 3, seed=11)
    for seed in range(3):
        g = with_costs(g0, np.random.default_rng(seed), 1, fill)
        assert_six_sites(g, seed, probe=seed == 0)


def test_flagship_size_graph():
    """10,000 variables, 14,999 binary factors (bench.py build_dcop's
    shape), D = 3, real costs: every site."""
    g0 = skeleton(10_000, [(2, 14_999)], 3, seed=7)
    g = with_costs(g0, np.random.default_rng(7), 3)
    assert_six_sites(g, 7)


def test_run_maxsum_trace_writes_each_cost_into_its_slot():
    """The traced run's per-cycle costs (each written into ``costs[n]``
    by one total) equal the reference's, with and without the variable
    costs, stopping early or not."""
    g0 = skeleton(60, [(1, 8), (2, 90), (3, 12)], 3, seed=13)
    g = with_costs(g0, np.random.default_rng(13), 1)
    tg = placed(g)
    base = costs(np.random.default_rng(14), (60, 3), 2)
    for var_base in (None, base):
        for stop in (True, False):
            ref = JM.run_maxsum_trace(g, 25, var_base_costs=var_base,
                                      stop_on_convergence=stop)
            out = TM.run_maxsum_trace(
                tg, 25, stop_on_convergence=stop,
                var_base_costs=None if var_base is None else
                torch.from_numpy(var_base))
            assert (out[2].numpy().tobytes()
                    == np.asarray(ref[2]).tobytes())
            assert out[1].tolist() == np.asarray(ref[1]).tolist()
