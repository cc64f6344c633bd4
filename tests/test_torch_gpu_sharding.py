"""On the card: the partitioned engine's runs equal the CPU's, and the
cross-shard reduction ``csrc/halo_sum.cu`` and the boundary partial
(``segment_sum.cu``'s subset entry) equal their plain versions.

This file imports neither JAX nor the JAX package.  Every test is
marked ``gpu`` and decides inside itself whether a card is present;
without one it skips.  Where JAX is missing run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu_sharding.py

- ``halo_sum`` on the card equals ``halo_sum_reference`` bit for bit on
  drawn ``[S, B, D]`` partials over 1, 3 and 6 decades, signed zeros and
  subnormals, at S = 1..8, on and off a 16-byte boundary, stacked or
  as separate tensors; ``subset_sum`` on the card
  equals its plain version.
- ``ShardedMaxSumEngine`` on a mesh naming the card 2, 3, 4 and 8 times
  equals the same engine on the CPU after every cycle (every message,
  count, the halo slot, ``stable``, ``cycle`` and the values), its
  traced costs and a ``trip_shard`` recovery too; the path launches the
  kernels it should, ``halo_sum`` once a cycle.
- ``api.solve(shards=)`` above the machine's card count raises.
"""

import numpy as np
import pytest
import torch

import pydcop_tpu_torch.dcop.dcop as dcop_mod
import pydcop_tpu_torch.dcop.objects as objects
import pydcop_tpu_torch.dcop.relations as relations
from pydcop_tpu_torch.engine.compile import compile_dcop
from pydcop_tpu_torch.engine.runner import ShardedMaxSumEngine
from pydcop_tpu_torch.engine.sharding import make_mesh
from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.ops.halo_sum import halo_sum, halo_sum_reference
from pydcop_tpu_torch.ops.segment_sum import (
    HALO,
    aggregation_plan,
    subset_sum,
)
from pydcop_tpu_torch.resilience.recovery import RecoveryPolicy

TINY = np.finfo(np.float32).tiny


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
def _cold_dispatch_cache():
    """Every test starts with the port's batch dispatch cache empty (the
    JAX package is not imported here)."""
    import pydcop_tpu_torch.engine.batch as TB

    TB._warm.clear()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def bits(t):
    return t.detach().cpu().numpy().view(np.int32)


def draw(shape, decades, seed, low=0.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.0, 1.0, shape)
            * 10.0 ** rng.uniform(low, low + decades, shape)
            ).astype(np.float32)


def grid(side, seed, decades=3, d=3):
    """A 4-neighbour grid with float tables over ``decades`` decades."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("c", "", list(range(d)))
    dcop = dcop_mod.DCOP(f"grid_{side}", objective="min")
    vs = [objects.Variable(f"v{i}", dom) for i in range(side * side)]
    for v in vs:
        dcop.add_variable(v)
    k = 0
    for r in range(side):
        for c in range(side):
            i = r * side + c
            for rr, cc in ((r + 1, c), (r, c + 1)):
                if rr < side and cc < side:
                    table = (rng.uniform(-1, 1, (d, d))
                             * 10.0 ** rng.uniform(0, decades, (d, d)))
                    dcop.add_constraint(relations.NAryMatrixRelation(
                        [vs[i], vs[rr * side + cc]], table, f"c{k}"))
                    k += 1
    dcop.add_agents([objects.AgentDef("a0")])
    return dcop


def engines(dcop, shards, **kw):
    graph, meta = compile_dcop(dcop, noise_level=0.01)
    card = ShardedMaxSumEngine(
        graph, meta, mesh=make_mesh(devices=["cuda"] * shards), **kw)
    cpu = ShardedMaxSumEngine(
        graph, meta, mesh=make_mesh(devices=["cpu"] * shards),
        device="cpu", **kw)
    return card, cpu


def assert_same_state(a, b, where):
    from pydcop_tpu_torch.utils.tree import tree_leaves

    for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
        x, y = x.cpu().numpy(), y.cpu().numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, (where, i)
        assert x.tobytes() == y.tobytes(), (where, i)


@pytest.mark.gpu
@pytest.mark.parametrize("decades", [1, 3, 6])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 5, 8])
def test_halo_sum_kernel_equals_plain(shards, decades):
    _need_card()
    for seed, b in enumerate((1, 37, 1_000, 4_096, 33_333)):
        parts = torch.from_numpy(draw((shards, b, 3), decades, seed))
        card = parts.cuda()
        want = halo_sum_reference(parts)
        before = _build.launch_counts["halo_sum"]
        got = halo_sum(card)
        assert _build.launch_counts["halo_sum"] == before + 1
        assert got.is_cuda
        assert np.array_equal(bits(got), bits(want))
        listed = halo_sum([p for p in card])
        assert np.array_equal(bits(listed), bits(want))
        # Partials that start off a 16-byte boundary.
        off = torch.empty(shards * b * 3 + 1, device="cuda")[1:].view(
            shards, b, 3)
        off.copy_(card)
        assert np.array_equal(bits(halo_sum(off)), bits(want))


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 3, 8])
def test_halo_sum_kernel_on_subnormals_and_signed_zeros(shards):
    _need_card()
    parts = draw((shards, 2_048, 4), 10, shards, low=-45.0)
    parts[:, :16] = -0.0
    parts[1:, 16:32] = 0.0
    parts[:, 32:48] = 1.5 * TINY * np.sign(parts[:, 32:48])
    parts = torch.from_numpy(parts)
    got = halo_sum(parts.cuda())
    assert np.array_equal(bits(got), bits(halo_sum_reference(parts)))
    assert not torch.signbit(got[:16]).any()


@pytest.mark.gpu
def test_subset_sum_kernel_equals_plain():
    _need_card()
    rng = np.random.default_rng(3)
    for d in (1, 3, 8, 11):
        f2v = [torch.from_numpy(draw((500, 2, d), 6, 1)),
               torch.from_numpy(draw((90, 3, d), 6, 2))]
        n_bnd = 77
        picked = np.sort(rng.choice(1_270, size=400, replace=False))
        seg = rng.integers(0, n_bnd, size=400)
        order = np.argsort(seg, kind="stable")
        perm = picked[order].astype(np.int32)
        offsets = np.searchsorted(seg[order], np.arange(n_bnd + 1),
                                  side="left").astype(np.int32)
        args = (torch.from_numpy(perm), torch.from_numpy(offsets),
                torch.from_numpy(aggregation_plan(offsets, d)),
                torch.zeros((n_bnd, d)))
        want = subset_sum(f2v, *args)
        before = _build.launch_counts[HALO]
        got = subset_sum([m.cuda() for m in f2v],
                         *(a.cuda() for a in args))
        assert _build.launch_counts[HALO] == before + 1
        assert np.array_equal(bits(got), bits(want)), d


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 3, 4, 8])
def test_sharded_run_card_equals_cpu_every_cycle(shards):
    _need_card()
    card, cpu = engines(grid(9, seed=shards, decades=6), shards)
    kw = dict(damping=card.damping, damp_vars=card.damp_vars,
              damp_factors=card.damp_factors, stability=card.stability,
              stop_on_convergence=False)
    cs, ps = card.init_state(), cpu.init_state()
    for c in range(15):
        cs, cv = card._ops.run_maxsum_from(card.graph, cs, 1, **kw)
        ps, pv = cpu._ops.run_maxsum_from(cpu.graph, ps, 1, **kw)
        assert cs.f2v[0].is_cuda and cs.halo.is_cuda
        assert_same_state(cs, ps, f"cycle {c + 1}")
        assert np.array_equal(cv.cpu().numpy(), pv.numpy())


@pytest.mark.gpu
def test_sharded_run_launches_the_kernels():
    _need_card()
    shards, cycles = 4, 12
    card, _ = engines(grid(10, seed=1), shards)
    card.run(3, stop_on_convergence=False)
    _build.launch_counts.clear()
    card.run(cycles, stop_on_convergence=False)
    got = dict(_build.launch_counts)
    assert got == {"binary_factor_update": shards * cycles,
                   "segment_sum": shards * (cycles + 1),
                   "var_update": 2 * shards * cycles,
                   HALO: shards * cycles,
                   "halo_sum": cycles}, got


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_trace_and_whole_run_card_equals_cpu(shards):
    _need_card()
    card, cpu = engines(grid(8, seed=10 + shards), shards)
    a, b = card.run_trace(30), cpu.run_trace(30)
    assert a.metrics["cost_trace"].tobytes() == \
        b.metrics["cost_trace"].tobytes()
    a, b = card.run(80), cpu.run(80)
    assert (a.assignment, a.cycles, a.converged) == (
        b.assignment, b.cycles, b.converged)


@pytest.mark.gpu
def test_trip_shard_on_the_card_equals_cpu():
    _need_card()
    card, cpu = engines(grid(8, seed=5), 4)
    policy = dict(trip_shard=((20, 1),))
    a = card.run_checkpointed(max_cycles=60, segment_cycles=10,
                              recovery=RecoveryPolicy(**policy))
    b = cpu.run_checkpointed(max_cycles=60, segment_cycles=10,
                             recovery=RecoveryPolicy(**policy))
    assert (a.assignment, a.cycles) == (b.assignment, b.cycles)
    assert a.metrics["n_shards"] == b.metrics["n_shards"] == 3
    assert a.metrics["lost_shards"] == [1]
    assert str(card.graph.shards[0].graph.var_costs.device).startswith(
        "cuda")


@pytest.mark.gpu
def test_more_shards_than_cards_raises():
    _need_card()
    from pydcop_tpu_torch.api import solve

    with pytest.raises(ValueError, match="device\\(s\\) available"):
        solve(grid(4, seed=0), "maxsum", max_cycles=5,
              shards=torch.cuda.device_count() + 1)
