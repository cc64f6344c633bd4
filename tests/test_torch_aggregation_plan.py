"""The tiled belief aggregation: its placement plan, a model of its walk,
and the per-bucket message form (pydcop_tpu_torch/ops/segment_sum.py).

- ``aggregation_plan`` covers every variable, the sentinel row
  included, exactly once: heavy variables (degree above the threshold)
  first, each a tile of its own, largest degree first; then light
  tiles of consecutive variables, at most ``TILE_THREADS // D`` wide
  and within one shared-memory pass of edges.  Checked on two
  fixtures, a mixed-arity graph with sentinel padding, a four-bucket
  padded array graph and a small power-law graph, at thresholds that
  make some variables heavy; placement stores the same plan.
- A numpy model of the CUDA kernel's walk — tile by tile, pass by pass
  of ``chunk`` edges through a buffer in CSR order, each (variable, d)
  carrying its running sum, its odd-bucket sum and its bucket from one
  pass to the next — equals the plain version bit for bit (no
  tolerance) on a power-law graph of three buckets whose hub straddles
  pass boundaries and bucket boundaries at once, at several pass sizes.
- The per-bucket tuple form of ``segment_sum`` (what
  ``aggregate_beliefs`` passes, and what the card reads in place)
  equals the one-tensor form and the jitted JAX ``aggregate_beliefs``
  across 2-6 buckets, and the wrapper refuses malformed tuples and
  plans.
"""

import jax
import numpy as np
import pytest
import torch

from pydcop_tpu.ops import maxsum as J
from pydcop_tpu_torch.engine.convert import graph_from_numpy
from pydcop_tpu_torch.ops.segment_sum import (
    HEAVY_DEGREE,
    TILE_THREADS,
    aggregation_plan,
    pass_edges,
    segment_sum,
    segment_sum_reference,
)
from test_torch_aggregation import _both, _messages, array_graphs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def powerlaw_graph(n_vars=400, d=3, seed=5, hub_rows=(60, 300, 100)):
    """Buckets of arity 1, 2 and 3 whose endpoints are drawn with weight
    (i + 1) ** -0.5; variable 0 is a hub in every bucket (``hub_rows``
    factors each); a tenth of each bucket's rows are padding."""
    rng = np.random.default_rng(seed)
    weight = (np.arange(n_vars) + 1.0) ** -0.5
    weight /= weight.sum()
    buckets = []
    for arity, (f_hub, f_rest) in zip((1, 2, 3),
                                      zip(hub_rows, (80, 500, 200))):
        f = f_hub + f_rest
        ids = rng.choice(n_vars, size=(f, arity), p=weight).astype(np.int32)
        ids[:f_hub, arity // 2] = 0
        ids = ids[rng.permutation(f)]
        ids[-(f // 10):] = n_vars
        buckets.append((np.zeros((f,) + (d,) * arity, np.float32), ids))
    var_costs = (rng.normal(size=(n_vars + 1, d)) * 10).astype(np.float32)
    return graph_from_numpy(var_costs, np.ones_like(var_costs, bool),
                            buckets, device="cpu")


def _plan_graphs():
    for problem in ("coloring_12_3.yml", "mixed30", "hub"):
        yield problem, _both(problem)[1]
    yield "buckets4", array_graphs(4)[1]
    yield "powerlaw", powerlaw_graph()


PLAN_GRAPHS = ["coloring_12_3.yml", "mixed30", "hub", "buckets4", "powerlaw"]


def _check_plan(tiles, offsets, d, heavy_degree):
    tiles = np.asarray(tiles, np.int64)
    n = offsets.shape[0] - 1
    degree = np.diff(offsets)
    assert tiles.ndim == 2 and tiles.shape[1] == 4
    first, end = tiles[:, 0], tiles[:, 1]
    assert (first < end).all()
    covered = np.concatenate([np.arange(a, b) for a, b in zip(first, end)])
    np.testing.assert_array_equal(np.sort(covered), np.arange(n))
    np.testing.assert_array_equal(tiles[:, 2], offsets[first])
    np.testing.assert_array_equal(tiles[:, 3], offsets[end])
    n_heavy = int((degree > heavy_degree).sum())
    heavy, light = tiles[:n_heavy], tiles[n_heavy:]
    assert (heavy[:, 1] - heavy[:, 0] == 1).all()
    assert (degree[heavy[:, 0]] > heavy_degree).all()
    assert (np.diff(degree[heavy[:, 0]]) <= 0).all()      # largest first
    width = light[:, 1] - light[:, 0]
    assert (width <= max(1, TILE_THREADS // d)).all()
    light_vars = np.concatenate(
        [np.arange(a, b) for a, b in zip(light[:, 0], light[:, 1])]
    ) if len(light) else np.zeros(0, np.int64)
    assert (degree[light_vars] <= heavy_degree).all()
    if heavy_degree < pass_edges(d):
        assert (light[:, 3] - light[:, 2] <= pass_edges(d)).all()
    return n_heavy


@pytest.mark.parametrize("threshold", [HEAVY_DEGREE, 64, 8, 2])
@pytest.mark.parametrize("name", PLAN_GRAPHS)
def test_plan_covers_every_variable_once(name, threshold):
    graph = dict(_plan_graphs())[name]
    offsets = graph.agg_offsets.numpy().astype(np.int64)
    d = graph.var_costs.shape[1]
    tiles = aggregation_plan(offsets, d, threshold)
    n_heavy = _check_plan(tiles, offsets, d, threshold)
    if threshold <= 8 and name != "coloring_12_3.yml":
        assert n_heavy > 0
    if name in ("mixed30", "buckets4", "powerlaw") and threshold == 2:
        # The sentinel row takes the padding edges and is heavy here.
        assert offsets.shape[0] - 2 in tiles[:n_heavy, 0]


@pytest.mark.parametrize("name", PLAN_GRAPHS)
def test_placement_stores_the_plan(name):
    graph = dict(_plan_graphs())[name]
    assert graph.agg_tiles.dtype == torch.int32
    np.testing.assert_array_equal(
        graph.agg_tiles.numpy(),
        aggregation_plan(graph.agg_offsets.numpy(),
                         graph.var_costs.shape[1]))


def test_plan_of_a_large_power_law_graph():
    """Thousands of variables, hubs above the default threshold, and
    light tiles cut by width and by edges."""
    rng = np.random.default_rng(9)
    n_vars = 20_000
    weight = (np.arange(n_vars) + 1.0) ** -0.5
    weight /= weight.sum()
    ids = rng.choice(n_vars, size=(60_000, 2), p=weight).astype(np.int32)
    var_costs = np.zeros((n_vars + 1, 3), np.float32)
    graph = graph_from_numpy(
        var_costs, np.ones_like(var_costs, bool),
        [(np.zeros((60_000, 3, 3), np.float32), ids)], device="cpu")
    offsets = graph.agg_offsets.numpy().astype(np.int64)
    assert _check_plan(graph.agg_tiles.numpy(), offsets, 3,
                       HEAVY_DEGREE) > 0
    assert (np.diff(offsets) == 0).sum() > 0


def tiled_model(flat, perm, offsets, buckets, var_costs, tiles, chunk):
    """What csrc/segment_sum.cu computes, as numpy float32: per tile,
    passes of ``chunk`` edges gathered into a buffer in CSR order with
    each edge's bucket; each (variable, d) adds its edges of the pass
    from the buffer, one add at a time, carrying its running sum, its
    odd-bucket sum and its bucket across passes."""
    sums = np.full_like(var_costs, np.nan)
    for v_lo, v_hi, e_lo, e_hi in tiles:
        width = v_hi - v_lo
        acc = np.zeros((width, var_costs.shape[1]), np.float32)
        part = np.zeros_like(acc)
        b = np.zeros(width, np.int64)
        for c in range(e_lo, e_hi, chunk):
            n = min(chunk, e_hi - c)
            p = perm[c:c + n]
            buf = flat[p]
            bkt = np.searchsorted(buckets, p, side="right") - 1
            for i, v in enumerate(range(v_lo, v_hi)):
                for e in range(max(offsets[v], c),
                               min(offsets[v + 1], c + n)):
                    while b[i] < bkt[e - c]:
                        if b[i] % 2:
                            acc[i] = acc[i] + part[i]
                            part[i] = 0.0
                        b[i] += 1
                    if b[i] % 2:
                        part[i] = part[i] + buf[e - c]
                    else:
                        acc[i] = acc[i] + buf[e - c]
        odd = b % 2 == 1
        acc[odd] = acc[odd] + part[odd]
        sums[v_lo:v_hi] = acc
    return var_costs + sums, sums


@pytest.mark.parametrize("chunk,threshold", [
    (64, 16), (128, 16), (100, HEAVY_DEGREE), (7, 2), (4096, 16)])
def test_tiled_walk_equals_plain_version(chunk, threshold):
    graph = powerlaw_graph()
    d = graph.var_costs.shape[1]
    perm = graph.agg_perm.numpy()
    offsets = graph.agg_offsets.numpy().astype(np.int64)
    buckets = graph.agg_buckets.numpy()
    tiles = aggregation_plan(offsets, d, threshold)
    rng = np.random.default_rng(chunk)
    n_edges = perm.shape[0]
    flat = (rng.normal(size=(n_edges, d))
            * 10.0 ** rng.integers(-3, 4, size=(n_edges, d))
            ).astype(np.float32)
    flat[::11, d - 1] = np.float32(1e9)
    model_b, model_s = tiled_model(flat, perm, offsets, buckets,
                                   graph.var_costs.numpy(), tiles, chunk)
    plain_b, plain_s = segment_sum_reference(
        torch.from_numpy(flat), graph.agg_perm, graph.agg_offsets,
        graph.agg_buckets, graph.var_costs)
    np.testing.assert_array_equal(model_s, plain_s.numpy())
    np.testing.assert_array_equal(model_b, plain_b.numpy())
    if chunk in (64, 128):
        # The hub's own tile straddles passes, a pass holds a bucket
        # boundary, and the odd bucket runs across a pass boundary.
        hub = tiles[0]
        assert hub[0] == 0 and hub[3] - hub[2] > 2 * chunk
        edge_bkt = np.searchsorted(buckets, perm[hub[2]:hub[3]],
                                   side="right") - 1
        bounds = np.flatnonzero(np.diff(edge_bkt)) + 1
        assert len(bounds) == 2 and (bounds % chunk != 0).all()
        odd = np.flatnonzero(edge_bkt == 1)
        assert odd[0] // chunk != odd[-1] // chunk


@pytest.mark.parametrize("n_buckets", [2, 3, 4, 5, 6])
def test_bucket_tuple_equals_flat_and_jax(n_buckets):
    g, tg = array_graphs(n_buckets, seed=n_buckets)
    f2v = _messages(g, 30 + n_buckets)
    d = g.var_costs.shape[1]
    parts = tuple(torch.from_numpy(m) for m in f2v)
    flat = torch.cat([p.reshape(-1, d) for p in parts])
    arrays = (tg.agg_perm, tg.agg_offsets, tg.agg_buckets, tg.var_costs)
    tb, ts = segment_sum(parts, *arrays, tg.agg_tiles)
    fb, fs = segment_sum(flat, *arrays)
    jb, js = jax.jit(J.aggregate_beliefs)(g, tuple(f2v))
    assert torch.equal(tb, fb) and torch.equal(ts, fs)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


@pytest.mark.parametrize("bad,err", [
    ("too_few_buckets", ValueError), ("wrong_width", ValueError),
    ("edge_count", ValueError), ("bucket_dtype", TypeError),
    ("tiles_shape", ValueError), ("tiles_dtype", TypeError),
    ("tiles_device", ValueError),
])
def test_wrapper_refuses_bad_tuples_and_plans(bad, err):
    _, tg = array_graphs(3)
    d = tg.var_costs.shape[1]
    parts = [torch.zeros(tuple(b.var_ids.shape) + (d,)) for b in tg.buckets]
    tiles = tg.agg_tiles
    args = (tg.agg_perm, tg.agg_offsets, tg.agg_buckets, tg.var_costs)
    segment_sum(parts, *args, tiles)     # the unaltered arguments are taken
    if bad == "too_few_buckets":
        parts = parts[:2]
    elif bad == "wrong_width":
        parts[1] = torch.zeros(parts[1].shape[:-1] + (d + 1,))
    elif bad == "edge_count":
        parts[0] = parts[0][:-1].contiguous()
    elif bad == "bucket_dtype":
        parts[2] = parts[2].double()
    elif bad == "tiles_shape":
        tiles = tiles[:, :3].contiguous()
    elif bad == "tiles_dtype":
        tiles = tiles.long()
    else:
        tiles = tiles.to("meta")
    with pytest.raises(err):
        segment_sum(parts, *args, tiles)
