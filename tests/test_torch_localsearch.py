"""The port's shared local-search reductions (pydcop_tpu_torch/ops/
localsearch.py) against ``pydcop_tpu.ops.localsearch`` on the CPU.

Every reduction is held bit for bit (``np.array_equal`` on the raw
bits) under the ``scatter`` and ``ell`` aggregations, the reference
jitted with the graph as an argument as its engine does, on graphs of
arity 1-4 buckets with real-valued costs over seven decades (so a sum
taken in another order changes the bits), mixed domain sizes (prefix
valid slots, BIG elsewhere, an all-invalid sentinel row and padding
rows pointing at it), D in {1, 2, 3, 8} and a D = 30 graph:
``candidate_costs``, ``positional_sum`` (also on arbitrary per-edge
values, with the port's position-major layout), ``positional_max``,
``factor_current_costs``, ``neighbor_max``,
``neighbor_min_rank_where``, ``factor_valid_masks``,
``factor_min_over_valid`` / ``factor_max_over_valid``,
``best_candidates``, ``neighborhood_winners``, ``random_best_choice``
and ``random_initial_values``.  ``assignment_cost`` is held within
1e-6 of the sum of its terms' magnitudes (the scale of a float32 sum's
rounding; the totals here cancel, so a tolerance relative to the total
would measure the reference's own rounding): it sums in float64 and
rounds once, where the reference sums in float32 in XLA's reduction
order.  The neighbourhood reductions' inputs hold no -0.0: the max or
min of -0.0 and +0.0 may be either, and the local search's gains, made
by subtraction, are never -0.0.

The order of the positional sum (init first, then the (bucket,
position) units folded as ``segment_sum.separate_buckets`` folds
buckets) is also held on a grid of bucket sizes around the V + 1 merge
threshold, and the wrapper's refusals are checked.  Buckets hold at
least two factors: a one-factor bucket is ROADMAP Queue C's open item.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.engine.compile import (
    CompiledFactorGraph,
    FactorBucket,
    build_aggregation_arrays,
)
from pydcop_tpu.ops import localsearch as J
from pydcop_tpu_torch.engine.convert import graph_from_numpy
from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops import localsearch as T
from pydcop_tpu_torch.ops.segment_sum import (
    positional_sum,
    positional_sum_reference,
    separate_buckets,
)
from pydcop_tpu_torch.utils import prng


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


BIG = np.float32(1e9)
AGGREGATIONS = ["scatter", "ell"]


def spread(rng, shape):
    """Real values over seven decades."""
    return (rng.normal(size=shape)
            * 10.0 ** rng.integers(-3, 4, size=shape)).astype(np.float32)


def arrays(seed: int, n_vars: int, d: int, sizes, mixed: bool = True):
    """(var_costs, var_valid, [(costs, var_ids)]) of a compiled-like
    graph: ``sizes`` is (arity, F) per bucket, the last tenth of each
    bucket padding rows on the sentinel; each variable's first 1..D
    slots valid (BIG costs elsewhere) when ``mixed``."""
    rng = np.random.default_rng(seed)
    dom = (rng.integers(1, d + 1, size=n_vars) if mixed
           else np.full(n_vars, d))
    valid = np.zeros((n_vars + 1, d), bool)
    for i, k in enumerate(dom):
        valid[i, :k] = True
    var_costs = np.where(valid, spread(rng, (n_vars + 1, d)), BIG)
    var_costs[-1] = 0.0
    buckets = []
    for arity, f in sizes:
        ids = np.stack([rng.choice(n_vars, size=arity, replace=False)
                        for _ in range(f)]).astype(np.int32)
        ids[f - max(1, f // 10):] = n_vars
        costs = spread(rng, (f,) + (d,) * arity)
        buckets.append((costs, ids))
    return var_costs.astype(np.float32), valid, buckets


def both(var_costs, var_valid, buckets, aggregation):
    """The reference's CompiledFactorGraph and the port's placed graph
    (CPU) of the same arrays."""
    fb = tuple(FactorBucket(c, i) for c, i in buckets)
    perm, ss, st, en, ell = build_aggregation_arrays(
        fb, var_costs.shape[0], aggregation)
    jg = CompiledFactorGraph(var_costs, var_valid, fb, agg_perm=perm,
                             agg_sorted_seg=ss, agg_starts=st,
                             agg_ends=en, agg_ell=ell)
    tg = graph_from_numpy(var_costs, var_valid, buckets, device="cpu",
                          aggregation=aggregation)
    return jg, tg


def bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == np.float32:
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    else:
        np.testing.assert_array_equal(a, b)


GRAPHS = {
    "arity1-4_d1": (1, 120, 1, [(1, 40), (2, 90), (3, 30), (4, 12)]),
    "arity1-4_d2": (2, 150, 2, [(1, 60), (2, 130), (3, 40), (4, 20)]),
    "arity1-4_d3": (3, 200, 3, [(1, 90), (2, 220), (3, 40), (4, 15)]),
    "arity2-3_d8": (4, 90, 8, [(2, 100), (3, 20)]),
    "binary_d3": (5, 300, 3, [(2, 450)]),
    "d30": (6, 60, 30, [(1, 20), (2, 70)]),
}


@pytest.fixture(params=[(g, a) for g in GRAPHS for a in AGGREGATIONS],
                ids=lambda p: f"{p[0]}-{p[1]}", scope="module")
def graph_pair(request):
    name, aggregation = request.param
    seed, n_vars, d, sizes = GRAPHS[name]
    arr = arrays(seed, n_vars, d, sizes)
    jg, tg = both(*arr, aggregation)
    rng = np.random.default_rng(seed + 100)
    values = np.array([rng.integers(0, int(row.sum()) or 1)
                       for row in arr[1]], dtype=np.int32)
    return jg, tg, values


def test_candidate_costs_equal(graph_pair):
    jg, tg, values = graph_pair
    ref = jax.jit(J.candidate_costs)(jg, values)
    bits_equal(T.candidate_costs(tg, torch.tensor(values)).numpy(), ref)


def test_positional_sum_of_arbitrary_values_equal(graph_pair):
    """Per-edge values not from a cost table, the port's per-bucket
    tensors in its layout (position-major without ELL lists)."""
    jg, tg, _ = graph_pair
    rng = np.random.default_rng(9)
    d = jg.var_costs.shape[1]
    per = [spread(rng, (b.var_ids.shape[0], b.var_ids.shape[1], d))
           for b in jg.buckets]
    init = spread(rng, jg.var_costs.shape)
    ref = jax.jit(J.positional_sum)(jg, per, init)
    ell = tg.agg_ell is not None
    out = T.positional_sum(
        tg, [torch.tensor(p if ell else p.transpose(1, 0, 2).copy())
             for p in per], torch.tensor(init))
    bits_equal(out.numpy(), ref)


def test_positional_max_and_factor_costs_equal(graph_pair):
    jg, tg, values = graph_pair
    rng = np.random.default_rng(3)
    per = [rng.integers(-5, 6, size=b.var_ids.shape).astype(np.int32)
           for b in jg.buckets]
    ref = jax.jit(lambda g, p: J.positional_max(g, p, jnp.int32(-7)))(
        jg, per)
    out = T.positional_max(tg, [torch.tensor(p) for p in per], -7)
    bits_equal(out.numpy(), ref)
    fper = [spread(rng, b.var_ids.shape) for b in jg.buckets]
    ref = jax.jit(lambda g, p: J.positional_max(g, p, -jnp.inf))(jg, fper)
    out = T.positional_max(tg, [torch.tensor(p) for p in fper], -np.inf)
    bits_equal(out.numpy(), ref)
    ref = jax.jit(J.factor_current_costs)(jg, values)
    out = T.factor_current_costs(tg, torch.tensor(values))
    for a, b in zip(out, ref):
        bits_equal(a.numpy(), b)


def test_assignment_cost_close(graph_pair):
    jg, tg, values = graph_pair
    ref = float(jax.jit(J.assignment_cost)(jg, values))
    out = T.assignment_cost(tg, torch.tensor(values))
    assert out.dtype == torch.float32
    terms = np.abs(np.take_along_axis(jg.var_costs[:-1],
                                      values[:-1, None], 1)).sum()
    for costs in J.factor_current_costs(jg, values):
        terms += np.abs(np.asarray(costs, np.float64)).sum()
    assert abs(float(out) - ref) <= 1e-6 * terms


def test_neighbor_reductions_equal(graph_pair):
    jg, tg, values = graph_pair
    rng = np.random.default_rng(4)
    n = jg.var_costs.shape[0]
    # Rounded: ties between neighbours; + 0.0 turns -0.0 into +0.0.
    per_var = np.round(spread(rng, (n,)), 1) + np.float32(0.0)
    target = np.where(rng.random(n) < 0.5, per_var,
                      np.round(spread(rng, (n,)), 1) + np.float32(0.0)
                      ).astype(np.float32)
    ranks = rng.permutation(n).astype(np.float32)
    ranks[-1] = np.inf
    ref = jax.jit(J.neighbor_max)(jg, per_var)
    bits_equal(T.neighbor_max(tg, torch.tensor(per_var)).numpy(), ref)
    ref = jax.jit(J.neighbor_min_rank_where)(jg, per_var, target, ranks)
    out = T.neighbor_min_rank_where(tg, torch.tensor(per_var),
                                    torch.tensor(target),
                                    torch.tensor(ranks))
    bits_equal(out.numpy(), ref)


def test_valid_masks_and_factor_extrema_equal(graph_pair):
    jg, tg, _ = graph_pair
    jm = jax.jit(J.factor_valid_masks)(jg)
    tm = T.factor_valid_masks(tg)
    for jb, tb, a, b in zip(jg.buckets, tg.buckets, tm, jm):
        bits_equal(a.numpy(), b)
        bits_equal(T.factor_min_over_valid(tb, a).numpy(),
                   J.factor_min_over_valid(jb, b))
        bits_equal(T.factor_max_over_valid(tb, a).numpy(),
                   J.factor_max_over_valid(jb, b))


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1])
def test_winners_and_random_choices_equal(graph_pair, seed):
    jg, tg, values = graph_pair
    n = jg.var_costs.shape[0]
    ranks = np.random.default_rng(seed).permutation(n).astype(np.float32)
    jkey, words = jax.random.PRNGKey(seed), prng.key_words(seed)
    cand = np.asarray(jax.jit(J.candidate_costs)(jg, values))
    jb, jis = jax.jit(J.best_candidates)(jg, cand)
    tb, tis = T.best_candidates(tg, torch.tensor(cand))
    bits_equal(tb.numpy(), jb)
    bits_equal(tis.numpy(), jis)
    ref = jax.jit(J.neighborhood_winners)(jg, cand, values, jkey, ranks)
    out = T.neighborhood_winners(tg, torch.tensor(cand),
                                 torch.tensor(values), words,
                                 torch.tensor(ranks))
    for a, b in zip(out, ref):
        bits_equal(a.numpy(), b)
    mask = np.asarray(jis)
    bits_equal(T.random_best_choice(words, torch.tensor(mask)).numpy(),
               J.random_best_choice(jkey, mask))
    bits_equal(T.random_initial_values(words, tg).numpy(),
               jax.jit(J.random_initial_values)(jkey, jg))


# The positional sum's fold on a grid around the merge threshold: two
# buckets (arity 1 and 2) at V + 1 = 101, whose units hold F1, F2 and F2
# edges; merged while the running scatter's edges stay below V + 1.
FOLD_GRID = [(f1, f2) for f1 in (2, 50, 99, 100, 101, 150)
             for f2 in (2, 49, 50, 51, 100, 101)]


@pytest.mark.parametrize("f1,f2", FOLD_GRID)
@pytest.mark.parametrize("aggregation", AGGREGATIONS)
def test_positional_fold_around_the_merge_threshold(f1, f2, aggregation):
    arr = arrays(f1 * 1000 + f2, 100, 3, [(1, f1), (2, f2)], mixed=False)
    jg, tg = both(*arr, aggregation)
    values = np.random.default_rng(f2).integers(0, 3, 101).astype(np.int32)
    ref = jax.jit(J.candidate_costs)(jg, values)
    bits_equal(T.candidate_costs(tg, torch.tensor(values)).numpy(), ref)


def test_positional_fold_of_the_probed_shapes():
    """The unit folds of shapes probed against the reference's optimised
    HLO: units of 200 + 100 + 100 + 100 + 100 edges at V + 1 = 1001 all
    merge into ``init`` (one scatter); at 900 edges a unit they
    alternate, the first merging into ``init``."""
    assert separate_buckets([0, 200, 300, 400, 500, 600], 1001) == 0
    assert separate_buckets([0, 900, 1800, 2700, 3600, 4500],
                            1001) == 0b01010


def test_positional_wrapper_refuses_and_counts_nothing_on_the_cpu():
    arr = arrays(1, 40, 3, [(1, 10), (2, 30)])
    _, tg = both(*arr, "scatter")
    units = [torch.zeros((10, 3)), torch.zeros((30, 3)),
             torch.zeros((30, 3))]
    before = dict(_build.launch_counts)
    out = positional_sum(units, tg.pos_perm, tg.agg_offsets, tg.pos_units,
                         tg.var_costs, tg.agg_tiles)
    assert dict(_build.launch_counts) == before
    bits_equal(out.numpy(), tg.var_costs.numpy())
    ref = positional_sum_reference(torch.cat(units), tg.pos_perm,
                                   tg.agg_offsets, tg.pos_units,
                                   tg.var_costs)
    bits_equal(out.numpy(), ref.numpy())
    with pytest.raises(ValueError):
        positional_sum(units[:2], tg.pos_perm, tg.agg_offsets,
                       tg.pos_units, tg.var_costs, tg.agg_tiles)
    with pytest.raises(TypeError):
        positional_sum([u.double() for u in units], tg.pos_perm,
                       tg.agg_offsets, tg.pos_units, tg.var_costs,
                       tg.agg_tiles)


def test_positional_arrays_order_edges_by_unit():
    """``pos_perm`` walks each variable's edges unit by unit, factor by
    factor, and shares ``agg_offsets`` with the edge order."""
    arr = arrays(2, 50, 2, [(1, 20), (2, 40), (3, 10)])
    _, tg = both(*arr, "scatter")
    cols = np.concatenate([ids[:, p] for _, ids in arr[2]
                           for p in range(ids.shape[1])])
    perm = tg.pos_perm.numpy()
    np.testing.assert_array_equal(perm, np.argsort(cols, kind="stable"))
    counts = np.bincount(cols, minlength=51)
    np.testing.assert_array_equal(np.diff(tg.agg_offsets.numpy()), counts)
    np.testing.assert_array_equal(
        tg.pos_units.numpy(), np.cumsum([0, 20, 40, 40, 10, 10, 10]))
