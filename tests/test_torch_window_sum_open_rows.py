"""The sum orders ROADMAP Queue C item 1 left open, pinned against the
jitted JAX reference on the CPU, bit for bit (uint32 views): the engine
probe's site, the unary sum of 22 values, and the residual.

- At the probe's site (the reference jits the cost with the graph
  closed over as constants) one bucket of arity 5-8 or of D = 1, of
  8-32 factors; and a binary bucket of 16, 24 or 32 factors beside a
  bucket of arity 3-5 (``gather_stages``).
- The variable costs' sum of 22 values at D >= 3, at the local
  search's site and the cost trace's: lanes of 4, then 2 (the local
  search's was taken left to right at D = 3); and at the local search's
  site beside a bucket of arity >= 5 and 2-32 factors, from 20 values
  (``gather_stages(..., near=...)``).
- The residual ``jnp.sum(jnp.abs(b - a))`` over [F, arity, D] messages
  at arity 5-7 and 9-12, and at D = 1 and D > 8: rows in lanes over the
  arity axis (``residual_lanes``), and, where an inner axis is 1, the
  rows themselves in lanes (``residual_rows``: a direct sum, windows of
  32 rows, windows ending on padding).

Costs are drawn anew per seed over one, three or six decades, so that
different orders give different bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.observability.engine_probe import EngineProbe as JaxProbe
from pydcop_tpu.ops import maxsum as JM
from pydcop_tpu_torch.observability.engine_probe import EngineProbe
from pydcop_tpu_torch.ops import maxsum as TM
from pydcop_tpu_torch.ops.window_sum import (
    gather_stages,
    residual_lanes,
    residual_rows,
)
from test_torch_window_sum_open_shapes import (
    assert_site,
    bits,
    costs,
    drawn,
    skeleton,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("arity,d", [(5, 2), (6, 3), (7, 3), (8, 2),
                                     (2, 1), (5, 1), (8, 1)])
def test_buckets_at_the_probe_site(arity, d):
    """The graph closed over as constants: one bucket of 8-32 factors
    (one compile a seed: one seed, costs over one decade)."""
    for n in (8, 16, 21, 24, 32):
        assert_site("probe", skeleton(40, [(arity, n)], d, seed=n), [0])


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("neighbour", [3, 4, 5])
def test_probe_site_binary_bucket_beside_a_wider_one(neighbour, d):
    """A binary bucket of 16, 24 or 32 factors beside a bucket of arity
    3-5 of 8, 16 or 33 factors."""
    for f2, f3 in ((16, 8), (24, 16), (32, 33)):
        g = skeleton(60, [(2, f2), (neighbour, f3)], d, seed=f2 + f3)
        assert_site("probe", g, [0])


_trace_cost = jax.jit(lambda gr, base, v: JM.assignment_constraint_cost(
    gr, v) + jnp.sum(jnp.take_along_axis(base, v[:, None], axis=1)))


@pytest.mark.parametrize("d", [3, 4, 6])
@pytest.mark.parametrize("site", ["localsearch", "maxsum"])
def test_unary_sum_of_22_values(site, d):
    """22 variables beside a bucket of 40 binary factors."""
    g = skeleton(22, [(2, 40)], d, seed=d)
    assert gather_stages(site, 0, d, 22) == ((4, 16), (2, 20))
    if site == "localsearch":
        assert_site(site, g, range(3))
        return
    for seed in range(3):
        g1, tg, vals = drawn(g, seed)
        base = costs(np.random.default_rng(seed), (22, d), 3)
        got = TM.assignment_total(tg, torch.from_numpy(vals[:-1]),
                                  torch.from_numpy(base))
        assert bits(got) == bits(_trace_cost(g1, base, vals[:-1]))


_conv = JaxProbe._build_conv_fn(None)

RESIDUALS = [(17, 5, 3), (100, 5, 3), (17, 6, 2), (64, 6, 4), (17, 7, 3),
             (100, 7, 2), (17, 9, 2), (100, 10, 3), (32, 12, 2),
             (17, 4, 9), (100, 4, 9), (17, 8, 12), (64, 8, 16),
             (17, 2, 12), (4, 1, 3), (8, 1, 3), (17, 1, 3), (21, 1, 3),
             (25, 1, 3), (30, 1, 3), (32, 1, 3), (64, 1, 3), (63, 1, 3),
             (100, 1, 3), (30, 2, 1), (63, 2, 1), (128, 2, 1),
             (20, 1, 8), (96, 1, 8), (95, 1, 7), (24, 9, 1), (64, 9, 1),
             (8, 12, 1), (17, 12, 1), (17, 1, 16), (40, 1, 2),
             (1024, 5, 1)]


@pytest.mark.parametrize("shape", RESIDUALS)
def test_residual_open_shapes(shape):
    """The engine probe's residual over one bucket's [F, arity, D]
    messages and over two buckets (this shape and a [20, 2, 3] one)."""
    rng = np.random.default_rng(sum(shape))
    pv = rng.integers(0, 3, 9).astype(np.int32)
    for extra in ([], [(20, 2, 3)]):
        for decades in (1, 3):
            a = [np.abs(costs(rng, s, decades)) for s in [shape] + extra]
            b = [x + costs(rng, x.shape, decades) for x in a]
            ref = _conv(tuple(a), tuple(b), pv, pv)
            out = EngineProbe._convergence(
                tuple(torch.from_numpy(x) for x in a),
                tuple(torch.from_numpy(x) for x in b),
                torch.from_numpy(pv), torch.from_numpy(pv))
            assert bits(out[0]) == bits(ref[0]), (
                shape, extra, decades, residual_lanes(shape),
                residual_rows(shape))


@pytest.mark.parametrize("arity,f,d", [
    (arity, f, d) for arity, f in ((5, 4), (6, 16), (7, 32), (8, 8))
    for d in (2, 3, 4) if d ** arity <= 2 ** 12])
def test_unary_sum_beside_a_small_wide_bucket(arity, f, d):
    """The local search's variable costs (20-24 values) beside a bucket
    of arity >= 5 and 2-32 factors: lanes of 4 then 2 from 22 values at
    D = 2 and from 20 at D >= 3 (25 and 22 alone)."""
    for n_vars in (20, 22, 24):
        first = 22 if d == 2 else 20
        assert (gather_stages("localsearch", 0, d, n_vars,
                              near=((arity, f),)) != ()) == (
                                  n_vars >= first)
        assert_site("localsearch", skeleton(n_vars, [(arity, f)], d,
                                            seed=n_vars + f), range(2))
