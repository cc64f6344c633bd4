"""The whole-graph totals whose sum order follows the graph around the
operand (ROADMAP Queue C item 1), against the jitted JAX reference on
the CPU, bit for bit (uint32 views).

Each reproducer of the probe log is rebuilt with ``skeleton`` and
``drawn`` of ``tests/test_torch_window_sum_open_shapes.py`` and held over
twelve cost draws (one, three and six decades), not only the logged one:

- the six logged bit pairs (sites ``localsearch`` and ``maxsum``); the
  log's recipe (costs ``drawn(g, s)``, values from ``default_rng(s +
  100)``) does not give its bits again, so each case holds every draw;
- the graph seeds the log names without their shapes (12, 1024, 1030
  at ``localsearch``; 56, 1022, 1023, 1028, 1030 at ``maxsum``): the
  generator that drew them was not kept, so this file commits one
  (:func:`random_case`: arity 1-6, 1-50 factors, V 12-80, D 1-4), holds
  those seeds of it, and ``tests/test_torch_window_sum_sweep.py`` sweeps
  it;
- the engine probe's site with the graph closed over: 20-23 binary
  factors beside 64 ternary ones, D = 3, graph seeds 0-5;
- ``localsearch V=40 D=1 [(6, 23)]`` (``bucket_graph(6, 1, 23)``, costs
  ``drawn(g, 1)``: ref 0x4497626a, the parent 0x4497626b);
- the probe's residual at arity 16 at shapes of its probe (the grid of
  F and D: ``tests/test_torch_window_sum_residual16.py``);
- the portfolio's two sites: ``eager`` (the DPOP leg scores op by op)
  here on the portfolio's fixtures; ``race`` (the MaxSum legs score
  inside their jit with the graph closed over) by every leg's cost in
  ``tests/test_torch_portfolio.py``.

A case that still follows no rule is ``xfail(strict=True)`` with its
bits in the reason: it flips the day its rule is found.
"""

import jax
import numpy as np
import pytest
import torch

from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu.observability.engine_probe import EngineProbe as JaxProbe
from pydcop_tpu.ops import localsearch as JL
from pydcop_tpu.ops import maxsum as JM
from pydcop_tpu_torch.device import to_device_graph
from pydcop_tpu_torch.engine.compile import compile_dcop as torch_compile
from pydcop_tpu_torch.observability.engine_probe import EngineProbe
from pydcop_tpu_torch.ops import localsearch as TL
from pydcop_tpu_torch.ops import maxsum as TM
from test_torch_portfolio import FIXTURES, both
from test_torch_window_sum_open_shapes import (
    _ls_cost,
    _ms_cost,
    bits,
    bucket_graph,
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


def differing(site, g0, seeds):
    """The cost seeds whose total differs from the reference's, each
    with (reference bits, port bits)."""
    out = []
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
        if bits(got) != bits(ref):
            out.append((seed, hex(bits(ref)), hex(bits(got))))
    return out


def open_case(reason):
    return pytest.mark.xfail(strict=True, reason=reason)


# (site, V, D, buckets, graph seed), the logged bits in the comment.
LOGGED = [
    # 1033/0: ref 0xc0aa35a0 port 0xc0aa359e (the 5-ary bucket in lanes
    # of 4 then 2: its neighbour has arity 4)
    ("maxsum", 80, 3, [(4, 2), (5, 23)], 1033),
    # 1044/0: ref 0x40d6dda6 port 0x40d6ddaa
    ("maxsum", 12, 2, [(1, 1), (4, 28), (5, 20)], 1044),
    # 4/0: ref 0x4142af4c port 0x4142af4d
    ("maxsum", 80, 3, [(3, 20), (5, 23), (6, 12)], 4),
    # 26/2: ref 0xc9538e52 port 0xc9538e53 (the variable costs in lanes:
    # the buckets' arities add up to 5)
    ("localsearch", 20, 4, [(2, 16), (3, 24)], 26),
    # 29/2: ref 0x49c12fcf port 0x49c12fce (the ternary bucket of 8
    # factors in lanes: beside the binary one and the variable costs,
    # window_sum._eight_beside)
    ("localsearch", 12, 4, [(2, 23), (3, 8)], 29),
    # 56/1: ref 0xc4331b2b port 0xc4331b2d (the unary bucket in lanes:
    # beside a 6-ary one)
    ("localsearch", 40, 2, [(1, 23), (6, 24)], 56),
]


@pytest.mark.parametrize("site,n_vars,d,buckets,gseed", LOGGED)
def test_logged_case(site, n_vars, d, buckets, gseed):
    g0 = skeleton(n_vars, buckets, d, gseed)
    assert differing(site, g0, range(12)) == []


def random_case(seed: int):
    """A random graph in the probe log's ranges: V in {12, 20, 33, 40,
    80}, D 1-4, one to three buckets of distinct arities 1-6 with 1-50
    factors (those whose tables pass 2M entries dropped)."""
    rng = np.random.default_rng(seed)
    n_vars = int(rng.choice([12, 20, 33, 40, 80]))
    d = int(rng.integers(1, 5))
    n_buckets = int(rng.integers(1, 4))
    arities = sorted(rng.choice(np.arange(1, 7), n_buckets,
                                replace=False).tolist())
    counts = rng.integers(1, 51, n_buckets).tolist()
    buckets = [(a, c) for a, c in zip(arities, counts)
               if d ** a * c <= 2_000_000]
    return n_vars, d, buckets


# The graph seeds the probe log names without their shapes, drawn by
# random_case (other graphs than the log's: its generator was not kept).
LOGGED_SEEDS = [("localsearch", s) for s in (12, 1024, 1030)] + [
    ("maxsum", s) for s in (56, 1022, 1023, 1028, 1030)]


@pytest.mark.parametrize("site,seed", LOGGED_SEEDS)
def test_logged_seed_without_its_shape(site, seed):
    n_vars, d, buckets = random_case(seed)
    g0 = skeleton(n_vars, buckets, d, seed)
    assert differing(site, g0, range(4)) == [], (n_vars, d, buckets)


@pytest.mark.parametrize("gseed", range(6))
def test_probe_site_binary_bucket_beside_64_ternary(gseed):
    """The graph closed over as constants (one compile a draw)."""
    for n_binary, n_vars in ((20, 60), (23, 40)):
        g0 = skeleton(n_vars, [(2, n_binary), (3, 64)], 3, gseed)
        assert differing("probe", g0, range(3)) == []


def test_unit_domain_six_ary_bucket_of_23_factors_at_40_variables():
    g, tg, vals = drawn(bucket_graph(6, 1, 23), 1)
    ref = _ls_cost(g, vals)
    assert hex(bits(ref)) == "0x4497626a"
    assert bits(TL.assignment_cost(tg, torch.from_numpy(vals))) == bits(ref)
    assert differing("localsearch", bucket_graph(6, 1, 23), range(12)) == []


_conv = JaxProbe._build_conv_fn(None)


@pytest.mark.parametrize("shape", [(5, 16, 2), (17, 16, 3), (40, 16, 3),
                                   (100, 16, 4), (30, 16, 16)])
def test_residual_at_arity_16(shape):
    """The engine probe's residual over [F, 16, D] messages, alone and
    beside a [20, 2, 3] bucket."""
    rng = np.random.default_rng(sum(shape))
    pv = rng.integers(0, 3, 9).astype(np.int32)
    for extra in ([], [(20, 2, 3)]):
        for decades in (1, 3, 6):
            a = [np.abs(costs(rng, s, decades)) for s in [shape] + extra]
            b = [x + costs(rng, x.shape, decades) for x in a]
            ref = _conv(tuple(a), tuple(b), pv, pv)
            out = EngineProbe._convergence(
                tuple(torch.from_numpy(x) for x in a),
                tuple(torch.from_numpy(x) for x in b),
                torch.from_numpy(pv), torch.from_numpy(pv))
            assert bits(out[0]) == bits(ref[0]), (extra, decades)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_eager_site_on_the_portfolio_fixtures(name):
    """The reference's ``assignment_cost`` outside a jit (each op its
    own program): every sum left to right (``site="eager"``)."""
    jax_dcop, torch_dcop = both(name)
    g, _ = jax_compile(jax_dcop, noise_level=0.01, use_cache=False)
    tg = to_device_graph(torch_compile(torch_dcop, noise_level=0.01,
                                       use_cache=False)[0], "cpu")
    placed = jax.device_put(g)
    rng = np.random.default_rng(len(name))
    for _ in range(6):
        vals = rng.integers(0, g.var_costs.shape[1],
                            g.var_costs.shape[0]).astype(np.int32)
        vals[-1] = 0
        ref = JL.assignment_cost(placed, jax.numpy.asarray(vals))
        got = TL.assignment_cost(tg, torch.from_numpy(vals), site="eager")
        assert bits(got) == bits(ref)
