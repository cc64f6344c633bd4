"""The cost trace at one-value domains (D = 1) and the values selected
after a lane run, against the jitted JAX reference on the CPU, bit for
bit (uint32 views).

At D = 1 every value the trace selects is 0, and the engine closes the
variable base costs over as constants, so XLA sums them while compiling
(``window_sum.folded_sum``: above 32 values the first windowed level
left to right in float32, then the rest left to right in float64,
rounded once), and inside the traced run the buckets' gathered costs are
contiguous rows summed left to right (``window_sum._lane_stages``).
Both layouts' traces are held here over a grid of variable counts
(9 to 80, and 1,100 to 40,000, where the runtime sum would take two
and three windowed levels) and bucket mixes.

Where the reference keeps no sums (the values selected after a run or
a traced cycle) XLA scatters the messages into ``var_costs`` directly,
so each belief is a running sum from its cost
(``maxsum_lane.selection_beliefs``); a graph whose beliefs nearly tie
shows it.

Costs are drawn over one, three or six decades, so that different
orders give different bits; the reference is jitted with the graph as
an argument and the base costs closed over, as its engine runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.ops import maxsum as JM
from pydcop_tpu.ops import maxsum_lane as JL
from pydcop_tpu_torch.engine.convert import graph_from_numpy
from pydcop_tpu_torch.ops import maxsum as TM
from pydcop_tpu_torch.ops import maxsum_lane as TL
from pydcop_tpu_torch.ops.window_sum import folded_sum
from test_torch_maxsum_lane import bits_equal, drawn_lane, port_lane
from test_torch_window_sum_open_shapes import costs, skeleton


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


MIXES = [
    [(1, 2)],
    [(2, 20), (3, 28)],
    [(4, 26)],
    [(1, 4), (5, 26)],
    [(2, 8), (4, 30), (5, 4)],
    [(1, 15), (2, 18), (3, 32), (4, 25), (5, 2)],
]


def _lane_trace_both(v, buckets, d, seed, cycles=4):
    decades = (1, 3, 6)[seed % 3]
    lane = drawn_lane(v, buckets, d, seed, decades=decades)
    base = costs(np.random.default_rng(seed + 7), (v, d), decades)
    ref = jax.jit(lambda x: JL.run_maxsum_trace(
        x, cycles, var_base_costs=jnp.asarray(base)))(lane)
    got = TL.run_maxsum_trace(port_lane(lane), cycles,
                              var_base_costs=torch.from_numpy(base))
    return ref, got


def _same_run(ref, got):
    (rs, rv, rc), (ps, pv, pc) = ref, got
    bits_equal(rc, pc)
    bits_equal(rv, pv)
    for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
        for r, p in zip(getattr(rs, field), getattr(ps, field)):
            bits_equal(r, p)
    assert int(rs.cycle) == int(ps.cycle)
    assert bool(rs.stable) == bool(ps.stable)


@pytest.mark.parametrize("mix", range(len(MIXES)))
@pytest.mark.parametrize("v", [9, 16, 23, 32, 33, 47, 80])
def test_lane_trace_at_unit_domain(v, mix):
    buckets = [(a, f) for a, f in MIXES[mix] if a <= v]
    _same_run(*_lane_trace_both(v, buckets, 1, v + mix))


@pytest.mark.parametrize("v", [1100, 2100, 40000])
def test_lane_trace_above_one_window_level(v):
    for seed in range(3):
        _same_run(*_lane_trace_both(v, [(1, 2), (2, 30)], 1, seed, 2))


@pytest.mark.parametrize("v", [12, 32, 100, 1100])
def test_edge_trace_at_unit_domain(v):
    """The edge layout's trace has the same folded sum (its reference
    closes the base costs over too)."""
    for seed in range(3):
        g = skeleton(v, [(1, 2), (2, 5)], 1, seed)
        rng = np.random.default_rng(seed)
        g = g._replace(
            var_costs=costs(rng, g.var_costs.shape, 3),
            buckets=tuple(b._replace(costs=np.abs(costs(rng, b.costs.shape,
                                                        3)))
                          for b in g.buckets))
        base = costs(rng, (v, 1), 6)
        _, rv, rc = jax.jit(lambda x: JM.run_maxsum_trace(
            x, 3, var_base_costs=jnp.asarray(base)))(g)
        tg = graph_from_numpy(g.var_costs, g.var_valid,
                              [(b.costs, b.var_ids) for b in g.buckets],
                              "cpu")
        _, pv, pc = TM.run_maxsum_trace(tg, 3,
                                        var_base_costs=torch.from_numpy(base))
        bits_equal(rc, pc)
        bits_equal(rv, pv)


def _folded_reference(x):
    """The folded sum by its definition, in numpy."""
    x = np.asarray(x, np.float32)
    if x.size > 32:
        n = -(-x.size // 32) * 32
        front = (n - x.size) // 2
        x = np.concatenate([np.zeros(front, np.float32), x,
                            np.zeros(n - x.size - front, np.float32)])
        out = []
        for w in x.reshape(-1, 32):
            acc = np.float32(0)
            for t in w:
                acc = np.float32(acc + t)
            out.append(acc)
        x = np.asarray(out, np.float32)
    return np.float32(sum(float(t) for t in x))


@pytest.mark.parametrize("n", [1, 2, 9, 32, 33, 100, 1024, 1025, 2100,
                               40000])
def test_folded_sum_follows_its_definition(n):
    x = costs(np.random.default_rng(n), (n, 1), 6)
    got = folded_sum(torch.from_numpy(x))
    assert got.shape == (1,) and got.dtype == torch.float32
    bits_equal(np.asarray([_folded_reference(x[:, 0])]), got)


@pytest.mark.parametrize("cycles", [2, 3])
def test_selected_values_sum_from_the_costs(cycles):
    """Near-tied beliefs at arity 4, D = 3 over six decades: the values
    after a run and after each traced cycle are those of beliefs summed
    from ``var_costs`` (from zeros, one value differs)."""
    lane = drawn_lane(17, [(4, 17)], 3, 2, decades=6)
    rs, rv = jax.jit(lambda x: JL.run_maxsum(
        x, cycles, stop_on_convergence=False))(lane)
    ps, pv = TL.run_maxsum(port_lane(lane), cycles,
                           stop_on_convergence=False)
    bits_equal(rv, pv)
    ref = jax.jit(lambda x: JL.run_maxsum_trace(
        x, cycles, stop_on_convergence=False))(lane)
    got = TL.run_maxsum_trace(port_lane(lane), cycles,
                              stop_on_convergence=False)
    _same_run(ref, got)
    pg = port_lane(lane)
    zero_first, _ = TL.aggregate_beliefs(pg, ps.f2v)
    assert not np.array_equal(TL.select_values(pg, zero_first).numpy(),
                              np.asarray(rv))
