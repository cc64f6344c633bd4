"""The port's sorted, ell and boundary belief aggregations
(pydcop_tpu_torch/ops/maxsum.py::aggregate_beliefs) against the jitted
JAX reference, with the graph an argument as the reference's engine
passes it.

- ``sorted`` and ``ell`` equal the reference bit for bit on graphs of 1
  to 4 buckets with sentinel padding rows, on messages spread over seven
  decades, and in a 10-cycle jitted solve loop.  Tolerance: none.  Under
  ``ell`` the sentinel row's list is all dummy slots, so its sums are 0
  on both sides, while ``scatter``/``sorted`` sum the padding edges into
  it; ``var_valid`` masks that row out of every message, which the
  solve-loop check covers.
- ``sorted`` is one running sum over every bucket, so on 2+ buckets it
  differs from ``scatter``'s odd/even bucket form; on one bucket the
  two, and ``ell`` at max degree up to 18, give the same bits.
- ``ell`` above one bucket is pinned for max degree up to 15 and above
  32.  Between 16 and 32 the reference's sum over a concatenation of
  several buckets is vectorised by XLA in forms that depend on the
  bucket count and D; the port follows the one-bucket form there
  (ROADMAP Queue C).
- ``boundary`` (experiment-only, refused as a solve option, as in the
  reference) agrees with the reference within the reference's own
  tolerance, rtol = atol = 1e-5 (its prefix sum adds in another order
  than XLA's).
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

import pydcop_tpu.engine.compile as JC
from pydcop_tpu.ops import maxsum as J
from pydcop_tpu_torch.engine.convert import (
    graph_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from pydcop_tpu_torch.ops import maxsum as T


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


KW = dict(damping=0.5, damp_vars=True, damp_factors=True, stability=0.1)


def strategy_graphs(n_buckets, aggregation, seed=0, n_vars=150, d=3,
                    hub=0):
    """(JAX graph, port graph on the CPU) built from the same arrays, as
    compile_dcop lays them out: buckets of arity 1..n_buckets with
    random sizes and integer costs, a tenth of each bucket's rows
    padding (sentinel V, zero cost), the sentinel row invalid with BIG
    costs; ``hub`` more binary rows give variable 0 that many more
    edges."""
    rng = np.random.default_rng(seed)
    buckets = []
    for arity in range(1, n_buckets + 1):
        f = int(rng.integers(20, 80))
        ids = rng.integers(1, n_vars, size=(f, arity)).astype(np.int32)
        if arity == 2 and hub:
            extra = rng.integers(1, n_vars, size=(hub, 2)).astype(np.int32)
            extra[:, 0] = 0
            ids = np.concatenate([extra, ids])
        n_pad = ids.shape[0] // 10
        ids[-n_pad:] = n_vars
        costs = rng.integers(0, 5, size=(ids.shape[0],) + (d,) * arity)
        costs[-n_pad:] = 0
        buckets.append((costs.astype(np.float32), ids))
    var_costs = rng.normal(size=(n_vars + 1, d)).astype(np.float32)
    var_costs[-1] = JC.BIG
    var_valid = np.ones_like(var_costs, bool)
    var_valid[-1] = False
    fb = tuple(JC.FactorBucket(c, i) for c, i in buckets)
    g = JC.CompiledFactorGraph(
        var_costs, var_valid, fb,
        *JC.build_aggregation_arrays(fb, n_vars + 1, aggregation))
    return g, graph_from_numpy(var_costs, var_valid, buckets, "cpu",
                               aggregation=aggregation)


def sensitive(g, seed):
    """Per-bucket f2v messages over seven decades (BIG on invalid
    slots, like the real ones)."""
    rng = np.random.default_rng(seed)
    d = g.var_costs.shape[1]
    out = []
    for b in g.buckets:
        shape = b.var_ids.shape + (d,)
        m = (rng.normal(size=shape)
             * 10.0 ** rng.integers(-3, 4, size=shape)).astype(np.float32)
        out.append(np.where(g.var_valid[b.var_ids], m, np.float32(1e9)))
    return out


def _aggregate_both(g, tg, f2v):
    jb, js = jax.jit(J.aggregate_beliefs)(g, tuple(f2v))
    tb, ts = T.aggregate_beliefs(tg, tuple(torch.from_numpy(m)
                                           for m in f2v))
    return (np.asarray(jb), np.asarray(js)), (tb.numpy(), ts.numpy())


def _degree(tg):
    deg = np.diff(tg.agg_offsets.numpy())
    return int(deg[:-1].max())


@pytest.mark.parametrize("aggregation", ["sorted", "ell"])
@pytest.mark.parametrize("n_buckets", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_beliefs_equals_jax(aggregation, n_buckets, seed):
    g, tg = strategy_graphs(n_buckets, aggregation, seed=seed)
    assert tg.agg_strategy == aggregation
    assert _degree(tg) <= 15
    ref, out = _aggregate_both(g, tg, sensitive(g, 10 + seed))
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b, a)
    if aggregation == "ell":
        # The sentinel row's list is all dummy slots.
        assert (out[1][-1] == 0).all()
        np.testing.assert_array_equal(out[0][-1], g.var_costs[-1])


@pytest.mark.parametrize("hub,n_buckets", [
    (15, 1), (20, 1), (25, 1), (30, 1), (40, 1), (70, 1),
    (40, 2), (70, 3), (130, 4),
])
def test_ell_on_high_degree_graphs_equals_jax(hub, n_buckets):
    """One bucket at every order regime of the K-way sum, and several
    buckets above K = 32 (XLA's windows of 32)."""
    g, tg = strategy_graphs(n_buckets, "ell", seed=hub, hub=hub)
    k = g.agg_ell.shape[1]
    assert k == _degree(tg) and (n_buckets == 1 or k > 32)
    ref, out = _aggregate_both(g, tg, sensitive(g, hub))
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("n_buckets", [2, 3, 4])
def test_sorted_is_one_running_sum_unlike_scatter(n_buckets):
    gs, tgs = strategy_graphs(n_buckets, "sorted", seed=5)
    gc, tgc = strategy_graphs(n_buckets, "scatter", seed=5)
    f2v = sensitive(gs, 6)
    sorted_ref, sorted_out = _aggregate_both(gs, tgs, f2v)
    scatter_ref, scatter_out = _aggregate_both(gc, tgc, f2v)
    np.testing.assert_array_equal(scatter_out[1], scatter_ref[1])
    np.testing.assert_array_equal(sorted_out[1], sorted_ref[1])
    assert not np.array_equal(sorted_out[1], scatter_out[1])


def test_one_bucket_strategies_agree():
    f2v = None
    sums = {}
    for aggregation in ("scatter", "sorted", "ell"):
        g, tg = strategy_graphs(1, aggregation, seed=7, hub=12)
        f2v = sensitive(g, 8) if f2v is None else f2v
        sums[aggregation] = _aggregate_both(g, tg, f2v)[1][1]
    np.testing.assert_array_equal(sums["sorted"], sums["scatter"])
    np.testing.assert_array_equal(sums["ell"][:-1], sums["scatter"][:-1])


@pytest.mark.parametrize("n_buckets", [1, 3])
def test_boundary_within_reference_tolerance(n_buckets):
    g, tg = strategy_graphs(n_buckets, "boundary", seed=9)
    f2v = [np.random.default_rng(3).normal(size=m.shape).astype(np.float32)
           for m in sensitive(g, 3)]
    ref, out = _aggregate_both(g, tg, f2v)
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    gc, tgc = strategy_graphs(n_buckets, "scatter", seed=9)
    scatter = _aggregate_both(gc, tgc, f2v)[1]
    for a, b in zip(scatter, out):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("aggregation", ["sorted", "ell"])
@pytest.mark.parametrize("n_buckets", [1, 3])
def test_jitted_loop_from_sensitive_state(aggregation, n_buckets):
    """10 cycles of the reference's jitted solve loop from a state
    whose sums are order-sensitive end in the port's state and values."""
    g, tg = strategy_graphs(n_buckets, aggregation, seed=11)
    rng = np.random.default_rng(12)
    counts = [rng.integers(0, 6, size=b.var_ids.shape).astype(np.int8)
              for b in g.buckets]
    s = dict(v2f=sensitive(g, 13), f2v=sensitive(g, 14),
             v2f_count=counts, f2v_count=[c[::-1].copy() for c in counts],
             stable=False, cycle=3)
    js = J.MaxSumState(
        v2f=tuple(s["v2f"]), f2v=tuple(s["f2v"]),
        v2f_count=tuple(s["v2f_count"]), f2v_count=tuple(s["f2v_count"]),
        stable=np.asarray(False), cycle=np.asarray(3, np.int32))
    run = jax.jit(lambda gr, st: J.run_maxsum_from(
        gr, st, 10, stop_on_convergence=False, **KW))
    jstate, jvals = run(g, js)
    tstate, tvals = T.run_maxsum_from(
        tg, state_from_numpy(**s, device="cpu"), 10,
        stop_on_convergence=False, **KW)
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))
    tn = state_to_numpy(tstate)
    for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
        for a, b in zip(getattr(jstate, field), tn[field]):
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=field)


@pytest.mark.parametrize("aggregation", ["scatter", "sorted", "ell"])
def test_run_maxsum_equals_jax_under_each_strategy(aggregation):
    g, tg = strategy_graphs(2, aggregation, seed=15)
    run = jax.jit(partial(J.run_maxsum, max_cycles=40,
                          stop_on_convergence=False, **KW))
    jstate, jvals = run(g)
    tstate, tvals = T.run_maxsum(tg, 40, stop_on_convergence=False, **KW)
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))
    tn = state_to_numpy(tstate)
    for field in ("v2f", "f2v"):
        for a, b in zip(getattr(jstate, field), tn[field]):
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=field)
