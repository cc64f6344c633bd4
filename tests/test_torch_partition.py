"""The port's partitioner (pydcop_tpu_torch/engine/partition.py) against
the JAX package's (pydcop_tpu/engine/partition.py), on the CPU, after
``tests/unit/test_sharding_battery.py``'s ``TestPartitioner`` and
``TestPartitionCache``, case for case.

Tolerance: none.  The partitioner is host numpy in both packages:
``var_shard``, every bucket's ``factor_shard`` and the ``stats`` dict
are ``np.array_equal`` / ``==`` to the reference's for the same scopes
and shard count — grids, rings, random loopy graphs and mixed arity, at
S = 2..8 — and so are the adjacency and the cut statistics.
"""

import numpy as np
import pytest
import torch

import pydcop_tpu.engine.partition as JP
import pydcop_tpu_torch.engine.partition as TP
from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu_torch.engine.compile import compile_dcop as torch_compile
from torch_sharding_common import grid_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _grid_scopes(side):
    """Scope-index array of a 4-neighbor grid (one binary bucket)."""
    edges = []
    for r in range(side):
        for c in range(side):
            i = r * side + c
            if r + 1 < side:
                edges.append((i, (r + 1) * side + c))
            if c + 1 < side:
                edges.append((i, r * side + c + 1))
    return [np.asarray(edges, np.int64)], side * side


def _ring_scopes(n, chords=0):
    edges = [(i, (i + 1) % n) for i in range(n)]
    edges += [(i, (i + n // 2) % n) for i in range(0, n, 3)][:chords]
    return [np.asarray(edges, np.int64)], n


def _loopy_scopes(n, m, seed):
    rng = np.random.default_rng(seed)
    seen, edges = set(), []
    while len(edges) < m:
        i, j = (int(x) for x in rng.choice(n, size=2, replace=False))
        key = (min(i, j), max(i, j))
        if key not in seen:
            seen.add(key)
            edges.append(key)
    return [np.asarray(edges, np.int64)], n


def _mixed_scopes(n, seed):
    """Unary, binary, ternary and 4-ary buckets over n variables."""
    rng = np.random.default_rng(seed)
    scopes = [np.arange(n, dtype=np.int64)[:, None]]
    for arity, count in ((2, 2 * n), (3, n // 2), (4, n // 4)):
        rows = [rng.choice(n, size=arity, replace=False)
                for _ in range(count)]
        scopes.append(np.asarray(rows, np.int64))
    return scopes, n


def assert_same_partition(a, b):
    assert a.n_shards == b.n_shards
    assert a.var_shard.dtype == b.var_shard.dtype
    assert np.array_equal(a.var_shard, b.var_shard)
    assert len(a.factor_shard) == len(b.factor_shard)
    for fa, fb in zip(a.factor_shard, b.factor_shard):
        assert fa.dtype == fb.dtype
        assert np.array_equal(fa, fb)
    assert a.stats == b.stats


SHAPES = {
    "grid12": lambda: _grid_scopes(12),
    "grid7": lambda: _grid_scopes(7),
    "ring40": lambda: _ring_scopes(40),
    "ring_chords": lambda: _ring_scopes(45, chords=6),
    "loopy": lambda: _loopy_scopes(60, 90, 0),
    "loopy_dense": lambda: _loopy_scopes(30, 120, 1),
    "mixed": lambda: _mixed_scopes(40, 2),
}


@pytest.mark.parametrize("shards", range(2, 9))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_partition_equals_the_reference(shape, shards):
    scopes, n = SHAPES[shape]()
    assert_same_partition(
        TP.partition_factor_graph(scopes, n, shards),
        JP.partition_factor_graph(scopes, n, shards))


@pytest.mark.parametrize("passes,imbalance", [(0, 0.1), (1, 0.0),
                                              (4, 0.3), (8, 0.05)])
def test_refinement_knobs_equal_the_reference(passes, imbalance):
    scopes, n = _grid_scopes(11)
    assert_same_partition(
        TP.partition_factor_graph(scopes, n, 5, refine_passes=passes,
                                  imbalance=imbalance),
        JP.partition_factor_graph(scopes, n, 5, refine_passes=passes,
                                  imbalance=imbalance))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_adjacency_and_cut_statistics_equal_the_reference(shape):
    scopes, n = SHAPES[shape]()
    for a, b in zip(TP.build_adjacency(scopes, n),
                    JP.build_adjacency(scopes, n)):
        assert np.array_equal(a, b)
    part = JP.partition_factor_graph(scopes, n, 4)
    assert TP.cut_statistics(scopes, part.var_shard, part.factor_shard,
                             4) == JP.cut_statistics(
        scopes, part.var_shard, part.factor_shard, 4)


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_partition_compiled_equals_the_reference(shards):
    jdcop, tdcop = grid_both(7, decades=3, seed=5)
    jgraph, _ = jax_compile(jdcop, noise_level=0.01)
    tgraph, _ = torch_compile(tdcop, noise_level=0.01)
    assert_same_partition(
        TP.partition_compiled(tgraph, shards, use_cache=False),
        JP.partition_compiled(jgraph, shards, use_cache=False))
    ids = np.asarray(tgraph.buckets[0].var_ids)
    assert np.array_equal(TP.real_factor_rows(ids, tgraph.n_vars),
                          JP.real_factor_rows(ids, tgraph.n_vars))


def test_empty_and_degenerate_inputs_equal_the_reference():
    for scopes, n, s in (([], 5, 3), ([np.zeros((0, 2), np.int64)], 4, 2),
                         ([np.asarray([[0, 1]], np.int64)], 6, 4),
                         ([], 0, 2)):
        assert_same_partition(TP.partition_factor_graph(scopes, n, s),
                              JP.partition_factor_graph(scopes, n, s))
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        TP.partition_factor_graph([], 3, 0)


# ------------------------------ partitioner ------------------------- #
# The reference battery's TestPartitioner, case for case.


class TestPartitioner:
    def test_every_variable_assigned_once(self):
        scopes, n = _grid_scopes(12)
        part = TP.partition_factor_graph(scopes, n, 8)
        assert part.var_shard.shape == (n,)
        assert part.var_shard.min() >= 0
        assert part.var_shard.max() <= 7
        assert sum(part.stats["owned_vars_per_shard"]) == n

    def test_balance_within_cap(self):
        scopes, n = _grid_scopes(12)
        part = TP.partition_factor_graph(scopes, n, 8, imbalance=0.1)
        cap = int(np.ceil(n / 8 * 1.1))
        assert max(part.stats["owned_vars_per_shard"]) <= cap

    def test_grid_cut_is_small(self):
        scopes, n = _grid_scopes(16)
        part = TP.partition_factor_graph(scopes, n, 8)
        assert part.stats["edge_cut_fraction"] < 0.3

    def test_deterministic(self):
        scopes, n = _grid_scopes(10)
        a = TP.partition_factor_graph(scopes, n, 4)
        b = TP.partition_factor_graph(scopes, n, 4)
        assert np.array_equal(a.var_shard, b.var_shard)
        for fa, fb in zip(a.factor_shard, b.factor_shard):
            assert np.array_equal(fa, fb)

    def test_refinement_never_hurts(self):
        scopes, n = _grid_scopes(14)
        raw = TP.partition_factor_graph(scopes, n, 8, refine_passes=0)
        refined = TP.partition_factor_graph(scopes, n, 8,
                                            refine_passes=4)
        assert (refined.stats["edge_cut_fraction"]
                <= raw.stats["edge_cut_fraction"] + 1e-12)

    def test_factor_lands_on_scope_owner(self):
        scopes, n = _grid_scopes(10)
        part = TP.partition_factor_graph(scopes, n, 8)
        for sc, fs in zip(scopes, part.factor_shard):
            owner_hit = (part.var_shard[sc] == fs[:, None]).any(axis=1)
            assert owner_hit.all()

    def test_single_shard_degenerate(self):
        scopes, n = _grid_scopes(5)
        part = TP.partition_factor_graph(scopes, n, 1)
        assert (part.var_shard == 0).all()
        assert part.stats["edge_cut_fraction"] == 0.0

    def test_adjacency_clique_for_high_arity(self):
        scopes = [np.asarray([[0, 1, 2]], np.int64)]
        nbrs, starts, ends = TP.build_adjacency(scopes, 4)
        deg = ends - starts
        assert list(deg) == [2, 2, 2, 0]

    def test_cut_statistics_shape(self):
        scopes, n = _grid_scopes(6)
        part = TP.partition_factor_graph(scopes, n, 4)
        s = part.stats
        assert s["cut_incidences"] <= s["total_incidences"]
        assert len(s["halo_vars_per_shard"]) == 4
        assert s["boundary_vars"] >= max(s["halo_vars_per_shard"])


class TestPartitionCache:
    def _graph(self, side, use_cache=True):
        _, tdcop = grid_both(side, decades=None, seed=0)
        graph, _ = torch_compile(tdcop, noise_level=0.01,
                                 use_cache=use_cache)
        return graph

    def test_structure_keyed_hit(self):
        graph = self._graph(6)
        TP.partition_cache.clear()
        a = TP.partition_compiled(graph, 4)
        before = TP.partition_cache.stats()
        b = TP.partition_compiled(graph, 4)
        after = TP.partition_cache.stats()
        assert after["hits"] == before["hits"] + 1
        assert after["builds"] == before["builds"]
        assert np.array_equal(a.var_shard, b.var_shard)

    def test_shard_count_in_key(self):
        graph = self._graph(6)
        TP.partition_cache.clear()
        TP.partition_compiled(graph, 2)
        TP.partition_compiled(graph, 4)
        assert TP.partition_cache.stats()["builds"] == 2

    def test_env_optout(self, monkeypatch):
        monkeypatch.setenv("PYDCOP_COMPILE_CACHE", "0")
        graph = self._graph(5, use_cache=False)
        TP.partition_cache.clear()
        TP.partition_compiled(graph, 2)
        TP.partition_compiled(graph, 2)
        stats = TP.partition_cache.stats()
        assert stats["hits"] == 0
        assert stats["builds"] == 2

    def test_bounded_lru(self):
        cache = TP.PartitionCache(maxsize=2)
        for k in range(3):
            cache.put(k, k)
        assert cache.get(0) is None and cache.get(2) == 2
        assert cache.stats()["entries"] == 2
