"""The port's partitioned MaxSum engine (pydcop_tpu_torch/engine/
sharding.py's ``build_partitioned_graph`` and ``ShardOps``, run by
``ShardedMaxSumEngine``) against the JAX package's sharded runs, on the
CPU.

Tolerance: none.  The reference runs its ``shard_map`` program on the
repo's 8-device CPU mesh; the port runs the same partition shard by
shard on the CPU.  The port is held to the reference's SHARDED run (the
mesh reassociates sums, so that is a different trajectory from the
unsharded one):

- ``build_partitioned_graph``'s host arrays and metrics are
  ``np.array_equal`` / ``==`` to the reference's;
- every leaf of the state — each bucket's stacked messages and counts,
  the ``[B, D]`` halo slot, ``stable``, ``cycle`` — and the selected
  values are equal bit for bit after EVERY cycle, over costs of 1, 3
  and 6 decades, at S = 2, 3, 4 and 8, on binary and mixed-arity
  graphs, with and without pruning, with damping 0.5 and otherwise, on
  a constraint-free graph, a graph with no cut edge, a state among the
  subnormals, and at D = 28..32 where the halo decides the domain
  mean's form;
- ``run_maxsum_trace``'s per-cycle costs (with the variable base
  costs), whole runs' values, cycles and ``converged`` are the
  reference's.
"""

import jax
import numpy as np
import pytest
import torch

from pydcop_tpu.engine.partition import partition_compiled as jax_partition
from pydcop_tpu.engine.sharding import (
    build_partitioned_graph as jax_build_partitioned,
)
from pydcop_tpu.engine.sharding import make_mesh as jax_make_mesh
from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu_torch.engine.compile import compile_dcop as torch_compile
from pydcop_tpu_torch.engine.partition import partition_compiled
from pydcop_tpu_torch.engine.sharding import (
    build_partitioned_graph,
    make_mesh,
)
from torch_sharding_common import (
    binary_ternary_both,
    compare_cycles,
    engines,
    free_both,
    grid_both,
    loopy_both,
    mixed_both,
    nocut_both,
)

CYCLES = 25


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _cold_dispatch_caches():
    """Every test starts with both packages' batch dispatch caches
    empty, so ``cold_start`` compares like with like."""
    import pydcop_tpu.engine.batch as JB
    import pydcop_tpu_torch.engine.batch as TB

    JB._warm.clear()
    TB._warm.clear()


FIELDS = ("var_costs", "var_valid", "local_global", "bnd_local",
          "bnd_present", "bnd_owner", "halo_bnd", "bnd_edge_idx",
          "bnd_edge_seg")


@pytest.mark.parametrize("shards", [2, 3, 4, 8])
@pytest.mark.parametrize("problem", ["grid", "mixed", "loopy"])
def test_partitioned_graph_equals_the_reference(problem, shards):
    jdcop, tdcop = {"grid": lambda: grid_both(7),
                    "mixed": lambda: mixed_both(15),
                    "loopy": lambda: loopy_both()}[problem]()
    jgraph, _ = jax_compile(jdcop, noise_level=0.01)
    tgraph, _ = torch_compile(tdcop, noise_level=0.01)
    jsh, jm = jax_build_partitioned(
        jgraph, jax_partition(jgraph, shards), jax_make_mesh(shards))
    tsh, tm = build_partitioned_graph(
        tgraph, partition_compiled(tgraph, shards),
        make_mesh(devices=["cpu"] * shards))
    assert tm == jm
    for name in FIELDS:
        a, b = np.asarray(getattr(jsh, name)), getattr(tsh, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert len(tsh.buckets) == len(jsh.buckets)
    for jb, tb in zip(jsh.buckets, tsh.buckets):
        assert np.array_equal(np.asarray(jb.costs), tb.costs)
        assert np.array_equal(np.asarray(jb.var_ids), tb.var_ids)
    assert (tsh.n_shards, tsh.dmax, tsh.n_boundary, tsh.v_loc) == (
        jsh.n_shards, jsh.dmax, jsh.n_boundary, jsh.v_loc)
    assert len(tsh.shards) == shards


@pytest.mark.parametrize("decades", [1, 3, 6])
@pytest.mark.parametrize("shards", [2, 3, 4, 8])
def test_grid_runs_equal_the_reference_every_cycle(shards, decades):
    jeng, teng = engines(*grid_both(6, decades=decades, seed=shards),
                         shards)
    compare_cycles(jeng, teng, CYCLES)


@pytest.mark.parametrize("shards", [2, 3, 4, 8])
def test_mixed_arity_runs_equal_the_reference_every_cycle(shards):
    jeng, teng = engines(*mixed_both(12, decades=3, seed=shards), shards)
    compare_cycles(jeng, teng, CYCLES)


def test_expander_runs_equal_the_reference_every_cycle():
    """A random loopy graph: most edges cut, most variables halo."""
    jeng, teng = engines(*loopy_both(m=60, decades=6, seed=3), 4)
    assert teng.extra_metrics["edge_cut_fraction"] > 0.15
    compare_cycles(jeng, teng, CYCLES)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("prune", [False, True])
def test_pruned_runs_equal_the_reference_every_cycle(prune, shards):
    """D = 8: the binary buckets are prunable; the phase predicate is
    the global AND of the shards' fit tests."""
    jeng, teng = engines(*grid_both(5, decades=3, seed=7, d=8), shards,
                         {"prune": prune})
    compare_cycles(jeng, teng, CYCLES, prune=prune)


@pytest.mark.parametrize("params", [
    {"damping": 0.7}, {"damping": 0.0}, {"damping": 0.3,
                                         "damping_nodes": "vars"},
    {"damping": 0.9, "damping_nodes": "factors", "stability": 0.05},
], ids=["d07", "d0", "vars03", "factors09"])
def test_damping_variants_equal_the_reference_every_cycle(params):
    jeng, teng = engines(*grid_both(6, decades=3, seed=11), 3, params)
    compare_cycles(jeng, teng, CYCLES)


def test_subnormal_state_equals_the_reference_every_cycle():
    """Costs around 1e-36 and no noise: the sums, the halo partials and
    their reduction meet subnormal values, which both flush."""
    jeng, teng = engines(*grid_both(6, decades=3, seed=2, scale=1e-36),
                         3, {"noise": 0.0})
    _, tst = compare_cycles(jeng, teng, CYCLES)
    tiny = np.finfo(np.float32).tiny
    msgs = np.concatenate([m.numpy().ravel() for m in tst.f2v])
    assert np.any((msgs != 0) & (np.abs(msgs) < 1e3 * tiny))


@pytest.mark.parametrize("d", [28, 30, 32])
@pytest.mark.parametrize("layout", ["halo_S2", "halo_S3", "no_cut_S2"])
def test_wide_domain_mean_equals_the_reference(layout, d):
    """D = 28..32 on a fold that ends with a bucket summed on its own:
    unsharded, XLA fuses that add into the domain mean and vectorises
    it; with a boundary the halo rows are scattered into the sums, which
    XLA then materialises, and the mean is summed left to right (a graph
    without a cut keeps the fused form)."""
    from pydcop_tpu_torch.ops.maxsum import _sums_fused

    shards = int(layout[-1])
    components = 2 if layout.startswith("no_cut") else 1
    jeng, teng = engines(*binary_ternary_both(
        n=8 if components == 2 else 12, components=components, d=d,
        seed=d), shards)
    assert all(_sums_fused(sh.graph) for sh in teng.graph.shards)
    assert (teng.graph.n_boundary == 0) == (components == 2)
    compare_cycles(jeng, teng, 6)


def test_constraint_free_graph_equals_the_reference():
    jeng, teng = engines(*free_both(8), 8)
    assert teng.graph.n_boundary == 0
    compare_cycles(jeng, teng, 3)
    jr, tr = jeng.run(max_cycles=5), teng.run(max_cycles=5)
    assert (tr.assignment, tr.cycles, tr.converged) == (
        jr.assignment, jr.cycles, jr.converged)


def test_graph_without_cut_equals_the_reference():
    jeng, teng = engines(*nocut_both(8, decades=3, seed=1), 2)
    assert teng.extra_metrics["boundary_vars"] == 0
    assert teng.graph.n_boundary == 0
    compare_cycles(jeng, teng, CYCLES)


@pytest.mark.parametrize("stop", [True, False])
@pytest.mark.parametrize("shards", [2, 3, 8])
def test_traced_costs_equal_the_reference(shards, stop):
    """``run_trace``: every cycle's cost (constraint + variable base
    costs, summed per shard and reduced across shards), the values, the
    cycle count and ``converged``."""
    jeng, teng = engines(*grid_both(6, decades=3, seed=20 + shards),
                         shards)
    jr = jeng.run_trace(40, stop_on_convergence=stop)
    tr = teng.run_trace(40, stop_on_convergence=stop)
    a, b = jr.metrics["cost_trace"], tr.metrics["cost_trace"]
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (tr.assignment, tr.cycles, tr.converged) == (
        jr.assignment, jr.cycles, jr.converged)


def test_traced_mixed_arity_costs_equal_the_reference():
    jeng, teng = engines(*mixed_both(15, decades=6, seed=4), 4)
    jr, tr = jeng.run_trace(30), teng.run_trace(30)
    assert jr.metrics["cost_trace"].tobytes() == \
        tr.metrics["cost_trace"].tobytes()


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_whole_runs_equal_the_reference(shards):
    """``run`` with the stop test: values, cycles, ``converged`` and
    the partition metrics; the guard's global constraint cost is the
    reference's bit for bit."""
    jeng, teng = engines(*grid_both(7, decades=1, seed=shards), shards)
    jr, tr = jeng.run(max_cycles=120), teng.run(max_cycles=120)
    assert (tr.assignment, tr.cycles, tr.converged) == (
        jr.assignment, jr.cycles, jr.converged)
    for key in ("n_shards", "edge_cut_fraction", "halo_vars_per_shard",
                "boundary_vars", "balance", "msg_count",
                "halo_exchange_bytes_per_superstep"):
        assert tr.metrics[key] == jr.metrics[key], key
    values = np.asarray([tr.assignment[f"v{i}"] for i in range(49)],
                        np.int32)
    a = np.asarray(jeng._ops.assignment_constraint_cost(
        jeng.graph, jax.numpy.asarray(values)))
    b = teng._ops.assignment_constraint_cost(
        teng.graph, torch.from_numpy(values)).numpy()
    assert a.tobytes() == b.tobytes()


def test_recomputed_halo_equals_the_state_slot():
    """``recompute_halo`` of a state's f2v messages is the slot the
    superstep tail left there, bit for bit (and the reference's)."""
    jeng, teng = engines(*grid_both(6, decades=6, seed=9), 4)
    jst, tst = compare_cycles(jeng, teng, 7)
    halo = teng._ops.recompute_halo(teng.graph, tst.f2v)
    assert halo.numpy().tobytes() == tst.halo.numpy().tobytes()
    jhalo = jeng._ops.recompute_halo(jeng.graph, jst.f2v)
    assert np.asarray(jhalo).tobytes() == halo.numpy().tobytes()
