"""The port's ELL gather-reduce (pydcop_tpu_torch/ops/ell.py) and its
domain-axis sum against the JAX reference on the CPU.

- ``gather_reduce`` equals the jitted ``pydcop_tpu.ops.ell.gather_reduce``
  bit for bit for every K from 1 to 32 and for K = 33, 45, 64 and 128,
  with dummy slots (index E) in the lists, on per-edge values spread over
  seven decades, at D = 3 and D = 128 and on [E] values.  Tolerance:
  none.  The sum's order is the one XLA gives the reference (left to
  right up to 18, vectorised forms for 19..32, windows of 32 above); a
  plain left-to-right sum differs where that order does, which the test
  asserts too, so it would notice if the reference's order changed.
- Above one bucket (ROADMAP Queue C) the K-way sum takes the forms
  probed on a grid of 1-3 buckets, D in {1, 2, 3, 4, 8}, K = 16..24,
  bit for bit against the jitted ``aggregate_beliefs``; the shapes
  whose order is unknown are refused when the lists are built, one
  test each, and the autotuner drops such a candidate.
- ``var_to_factor``'s sum over the domain axis follows XLA's windows of
  32 above D = 32 (left to right up to 32): bit-equal to the jitted
  reference at D = 2..40, 64, 100 and 128.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.engine.compile import CompiledFactorGraph, FactorBucket
from pydcop_tpu.ops import maxsum as J
from pydcop_tpu.ops.ell import gather_reduce as jax_gather_reduce
from pydcop_tpu_torch.engine.convert import graph_from_numpy
from pydcop_tpu_torch.ops import maxsum as T
from pydcop_tpu_torch.ops.ell import gather_reduce, ordered_sum


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_JAX_SUM = jax.jit(lambda e, v: jax_gather_reduce(e, v, 0.0, jnp.sum))


def seven_decades(rng, shape):
    return (rng.normal(size=shape)
            * 10.0 ** rng.integers(-3, 4, size=shape)).astype(np.float32)


def ell_case(k, d, seed, n_rows=61):
    """Lists of K slots over n_rows rows with 5 dummy slots, and values
    [E, D] (or [E] when d is 0)."""
    rng = np.random.default_rng(seed)
    n_edges = n_rows * k - 5
    shape = (n_edges, d) if d else (n_edges,)
    vals = seven_decades(rng, shape)
    ell = np.full(n_rows * k, n_edges, np.int32)
    ell[:n_edges] = rng.permutation(n_edges)
    return rng.permutation(ell.reshape(n_rows, k)), vals


KS = list(range(1, 33)) + [33, 45, 64, 128]


@pytest.mark.parametrize("d", [3, 128, 0])
@pytest.mark.parametrize("k", KS)
def test_gather_reduce_equals_jax(k, d):
    ell, vals = ell_case(k, d, seed=k * 7 + d)
    ref = np.asarray(_JAX_SUM(ell, vals))
    out = gather_reduce(torch.from_numpy(ell), torch.from_numpy(vals))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("k", [19, 20, 24, 31, 32, 33, 45, 64, 128])
def test_reference_order_is_not_left_to_right(k):
    """Where the pinned order is not a plain left-to-right sum, the
    reference's bits differ from that sum on these values: the test
    above would fail if XLA went back to it."""
    ell, vals = ell_case(k, 3, seed=k)
    x = torch.from_numpy(vals)[torch.from_numpy(ell).clamp(
        max=vals.shape[0] - 1).long()]
    x = torch.where(torch.from_numpy(ell < vals.shape[0])[..., None],
                    x, 0.0)
    plain = torch.zeros_like(x[:, 0])
    for j in range(k):
        plain = plain + x[:, j]
    ref = np.asarray(_JAX_SUM(ell, vals))
    assert not np.array_equal(plain.numpy(), ref)
    np.testing.assert_array_equal(ordered_sum(x).numpy(), ref)


def test_dummy_slots_count_as_zero():
    ell = torch.tensor([[0, 3, 3], [2, 1, 3]], dtype=torch.int32)
    vals = torch.tensor([[1.0], [2.0], [4.0]])
    out = gather_reduce(ell, vals)
    assert out.tolist() == [[1.0], [6.0]]


@pytest.mark.parametrize("d", list(range(2, 41)) + [64, 100, 128])
def test_domain_sum_of_var_to_factor_equals_jax(d):
    rng = np.random.default_rng(d)
    n_vars, n_factors = 80, 120
    ids = rng.integers(0, n_vars, size=(n_factors, 2)).astype(np.int32)
    var_costs = rng.normal(size=(n_vars + 1, d)).astype(np.float32)
    valid = rng.random((n_vars + 1, d)) < 0.9
    valid[:, 0] = True
    costs = np.zeros((n_factors, d, d), np.float32)
    g = CompiledFactorGraph(var_costs, valid,
                            (FactorBucket(costs, ids),))
    tg = graph_from_numpy(var_costs, valid, [(costs, ids)], "cpu")
    f2v = seven_decades(rng, (n_factors, 2, d))
    jb, js = jax.jit(J.aggregate_beliefs)(g, (f2v,))
    ref = jax.jit(J.var_to_factor)(g, (f2v,), jb, js)[0]
    msgs = (torch.from_numpy(f2v),)
    tb, ts = T.aggregate_beliefs(tg, msgs)
    out = T.var_to_factor(tg, msgs, tb, ts)[0]
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def multi_bucket_graphs(n_buckets, d, k, seed=0):
    """(reference graph with its ELL lists, bucket arrays): buckets of
    arity 1..n_buckets (arity 2 for one bucket) over 60 variables with
    integer costs, variable 0 of degree exactly K (its edges spread
    over the buckets), every other variable of lower degree."""
    import pydcop_tpu.engine.compile as JC

    rng = np.random.default_rng(seed)
    n_vars = 60
    buckets = []
    for bi in range(n_buckets):
        arity = bi + 1 if n_buckets > 1 else 2
        ids = ((np.arange(40 * arity).reshape(40, arity) * 7 + bi)
               % (n_vars - 1) + 1).astype(np.int32)
        n_hub = k // n_buckets + (1 if bi < k % n_buckets else 0)
        hub = np.zeros((n_hub, arity), np.int32)
        hub[:, 1:] = rng.integers(1, n_vars, size=(n_hub, arity - 1))
        ids = np.concatenate([hub, ids])
        costs = rng.integers(0, 5, size=(ids.shape[0],) + (d,) * arity)
        buckets.append((costs.astype(np.float32), ids))
    var_costs = rng.normal(size=(n_vars + 1, d)).astype(np.float32)
    var_costs[-1] = JC.BIG
    var_valid = np.ones_like(var_costs, bool)
    var_valid[-1] = False
    fb = tuple(JC.FactorBucket(c, i) for c, i in buckets)
    g = JC.CompiledFactorGraph(
        var_costs, var_valid, fb,
        *JC.build_aggregation_arrays(fb, n_vars + 1, "ell"))
    assert g.agg_ell.shape[1] == k
    return g, (var_costs, var_valid, buckets)


def _refused(n_buckets, d, k):
    from pydcop_tpu_torch.ops.ell import multi_bucket_form

    try:
        multi_bucket_form(n_buckets, d, k)
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("k", range(16, 25))
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n_buckets", [1, 2, 3])
def test_multi_bucket_ell_grid_equals_jax(n_buckets, d, k):
    """ROADMAP Queue C's ELL item: with several buckets the reference's
    K-way sum takes lanes of 8 over 16 slots at K = 16..18 (two buckets:
    17..18, K = 18 only at D = 1); elsewhere the one-bucket form.  Every
    cell of 1-3 buckets, D in {1, 2, 3, 4, 8}, K = 16..24 either equals
    the jitted reference's aggregate_beliefs bit for bit or is refused
    when the lists are built."""
    from pydcop_tpu.ops import maxsum as J

    g, arrays = multi_bucket_graphs(n_buckets, d, k, seed=n_buckets * 100
                                    + d * 10 + k)
    if _refused(n_buckets, d, k):
        with pytest.raises(ValueError, match="Queue C"):
            graph_from_numpy(*arrays, device="cpu", aggregation="ell")
        return
    tg = graph_from_numpy(*arrays, device="cpu", aggregation="ell")
    rng = np.random.default_rng(k)
    f2v = [seven_decades(rng, b.var_ids.shape + (d,)) for b in g.buckets]
    jb, js = jax.jit(J.aggregate_beliefs)(g, tuple(f2v))
    tb, ts = T.aggregate_beliefs(tg, tuple(torch.from_numpy(m)
                                           for m in f2v))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("n_buckets,d,k", [
    (3, 3, 20), (3, 3, 21), (3, 3, 22), (3, 3, 23),
    (2, 5, 17), (2, 6, 20), (3, 7, 16), (2, 16, 23), (4, 3, 18),
    (5, 1, 16),
])
def test_ell_refuses_shapes_of_unknown_order(n_buckets, d, k):
    """Each refused shape: three buckets at D = 3, K = 20..23 (no
    probed form matched at K = 20; K = 22 matched only the lanes), and
    D outside the probed grid or more than three buckets at K = 16..23.
    The builder raises a ValueError naming Queue C, so an explicit
    ``aggregation='ell'`` raises and the autotuner drops the candidate;
    the other aggregations build."""
    _, arrays = multi_bucket_graphs(n_buckets, d, k)
    with pytest.raises(ValueError, match="ROADMAP Queue C"):
        graph_from_numpy(*arrays, device="cpu", aggregation="ell")
    graph_from_numpy(*arrays, device="cpu", aggregation="scatter")
    graph_from_numpy(*arrays, device="cpu", aggregation="sorted")


def test_refused_ell_is_dropped_by_the_autotuner():
    from pydcop_tpu_torch.engine.autotune import autotune_aggregation
    from pydcop_tpu_torch.engine.compile import (
        CompiledFactorGraph as TGraph,
        FactorBucket as TBucket,
    )

    _, (var_costs, var_valid, buckets) = multi_bucket_graphs(3, 3, 21)
    graph = TGraph(var_costs, var_valid,
                   tuple(TBucket(c, i) for c, i in buckets))
    result = autotune_aggregation(graph, device="cpu", reps=1,
                                  use_cache=False)
    assert result["aggregation_timings_ms"]["ell"] is None
    assert "K=21" in result["aggregation_notes"]["ell"]
    assert result["aggregation"] != "ell"
