"""The port's batched solving (pydcop_tpu_torch/engine/batch.py) against
the JAX package's (pydcop_tpu/engine/batch.py), on the CPU, after
``tests/api/test_batch_solving.py`` and
``tests/unit/test_envelope_battery.py``.

Tolerance: none.  The host arrays (stack, bin padding, envelope
padding and its waste figures) are ``np.array_equal`` / ``==`` to the
reference's; ``run_stacked``, ``run_lane_packed`` and
``solve_maxsum_batch`` give the reference's values, cycles, convergence
flags and metrics keys; and every member's final messages and counts in
the port's disjoint union equal the lane of the reference's
``jax.jit(jax.vmap(run_maxsum))`` bit for bit — including the graphs
with a one-edge bucket, where the vmapped reference sums the beliefs
in another order than a solo solve (``engine.batch.stacked_fold``).
``launch_*``/``collect_*`` give what ``run_*`` gives, and a cold
launch returns ``None``.
"""

import jax
import numpy as np
import pytest
import torch

import pydcop_tpu.engine.batch as JB
import pydcop_tpu.serving.binning as JBin
import pydcop_tpu_torch.engine.batch as TB
import pydcop_tpu_torch.serving.binning as TBin
from pydcop_tpu.dcop.dcop import DCOP as JDCOP
from pydcop_tpu.dcop.objects import AgentDef as JAgentDef
from pydcop_tpu.dcop.objects import Domain as JDomain
from pydcop_tpu.dcop.objects import Variable as JVariable
from pydcop_tpu.dcop.relations import NAryMatrixRelation as JRel
from pydcop_tpu.dcop.relations import constraint_from_str as jconstraint
from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu.ops import maxsum as JM
from pydcop_tpu_torch.dcop.dcop import DCOP as TDCOP
from pydcop_tpu_torch.dcop.objects import AgentDef as TAgentDef
from pydcop_tpu_torch.dcop.objects import Domain as TDomain
from pydcop_tpu_torch.dcop.objects import Variable as TVariable
from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation as TRel
from pydcop_tpu_torch.dcop.relations import constraint_from_str as tconstraint
from pydcop_tpu_torch.device import to_device_graph
from pydcop_tpu_torch.engine.compile import compile_dcop as torch_compile
from pydcop_tpu_torch.ops import maxsum as TM
from test_torch_maxsum_lane import bits_equal, port_graph
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


@pytest.fixture(autouse=True)
def _cold_dispatch_caches():
    """Every test starts with both packages' dispatch caches empty, so
    ``cold_start`` compares like with like: another file run earlier in
    the same worker process (the reference's envelope battery) can have
    warmed the reference's cache for the same program key."""
    JB._warm.clear()
    TB._warm.clear()


MAX_CYCLES = 40
J = (JDCOP, JAgentDef, JDomain, JVariable, JRel, jconstraint)
T = (TDCOP, TAgentDef, TDomain, TVariable, TRel, tconstraint)


def _ring(mods, n, d, seed, chords=0, objective="min"):
    """The reference batteries' ring (the api test's ``_instance`` is
    ``_ring(n, 3, seed, chords=...)`` with chords every third node)."""
    dcop_cls, agent_cls, dom_cls, var_cls, rel_cls, _ = mods
    rng = np.random.default_rng(seed)
    dom = dom_cls("c", "", list(range(d)))
    dcop = dcop_cls(f"ring{n}_{d}_{seed}_{chords}", objective=objective)
    vs = [var_cls(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    edges = [(i, (i + 1) % n) for i in range(n)]
    edges += [(i, (i + n // 2) % n) for i in range(chords)]
    for k, (i, j) in enumerate(edges):
        table = rng.integers(0, 10, size=(d, d)).astype(float)
        dcop.add_constraint(rel_cls([vs[i], vs[j]], table, f"c{k}"))
    dcop.add_agents([agent_cls("a0")])
    return dcop


def _mixed_arity(mods, n, seed):
    dcop_cls, agent_cls, dom_cls, var_cls, rel_cls, from_str = mods
    rng = np.random.default_rng(seed)
    dom = dom_cls("c", "", [0, 1, 2])
    dcop = dcop_cls(f"mix{n}_{seed}", objective="min")
    vs = [var_cls(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for k in range(n):
        table = rng.integers(0, 10, size=(3, 3)).astype(float)
        dcop.add_constraint(rel_cls([vs[k], vs[(k + 1) % n]], table,
                                    f"b{k}"))
    for k in range(0, n, 3):
        dcop.add_constraint(from_str(f"u{k}", f"v{k} * {1 + k % 3}",
                                     [vs[k]]))
    for k in range(0, n - 2, 4):
        dcop.add_constraint(from_str(
            f"t{k}", f"v{k} + v{k + 1} * v{k + 2}",
            [vs[k], vs[k + 1], vs[k + 2]]))
    dcop.add_agents([agent_cls("a0")])
    return dcop


def both(builder, *args, **kw):
    return builder(J, *args, **kw), builder(T, *args, **kw)


def graphs_of(pairs, **kw):
    return ([jax_compile(j, noise_level=0.01, **kw)[0] for j, _ in pairs],
            [torch_compile(t, noise_level=0.01, **kw)[0] for _, t in pairs])


def rings(n=24, count=6, chords=8):
    return [both(_ring, n, 3, seed, chords=chords) for seed in range(count)]


def _assert_metrics(ref, got):
    assert set(got.metrics) == set(ref.metrics)
    for key in ("batch_size", "n_real", "pad_fraction", "cold_start",
                "converged_lanes", "cells_total", "packing",
                "envelope_waste", "envelope_waste_lanes", "pipelined"):
        assert got.metrics.get(key) == ref.metrics.get(key), key
    assert (got.cycles, got.converged) == (ref.cycles, ref.converged)


# ------------------------------------------------------------------ #
# Host arrays.


def test_stack_graphs_equals_reference():
    jg, tg = graphs_of(rings(count=3))
    ref, got = JB.stack_graphs(jg), TB.stack_graphs(tg)
    bits_equal(ref.var_costs, got.var_costs)
    bits_equal(ref.var_valid, got.var_valid)
    for rb, pb in zip(ref.buckets, got.buckets):
        bits_equal(rb.costs, pb.costs)
        bits_equal(rb.var_ids, pb.var_ids)
    with pytest.raises(ValueError, match="identical compiled shapes"):
        TB.stack_graphs(tg[:1] + graphs_of([both(_ring, 30, 3, 1)])[1])


def test_bins_equal_reference():
    assert TB.DEFAULT_BIN_SIZES == JB.DEFAULT_BIN_SIZES
    for n in (1, 3, 7, 8, 33, 64, 65, 200):
        assert (TB.bin_size_for(n, TB.DEFAULT_BIN_SIZES)
                == JB.bin_size_for(n, JB.DEFAULT_BIN_SIZES))
    jg, tg = graphs_of(rings(count=5))
    for bins in (TB.DEFAULT_BIN_SIZES, (2, 3)):
        rp, rn, rf = JB.pad_to_bin(jg, bins)
        pp, pn, pf = TB.pad_to_bin(tg, bins)
        assert (pn, pf, len(pp)) == (rn, rf, len(rp))
    assert TB.pad_to_bin([]) == JB.pad_to_bin([])


def _covering(ladder_mod, graphs):
    envs = [ladder_mod.envelope_key(g) for g in graphs]
    arities = sorted({a for e in envs for a, _ in e.rows})
    rows = tuple((a, max(dict(e.rows).get(a, ladder_mod.DEFAULT_LADDER
                                          .rows[0]) for e in envs))
                 for a in arities)
    return ladder_mod.Envelope(v_env=max(e.v_env for e in envs),
                               d_env=max(e.d_env for e in envs),
                               rows=rows)


ENVELOPE_GROUPS = {
    "topologies": lambda: [both(_ring, 12, 3, 0), both(_ring, 9, 3, 1),
                           both(_ring, 17, 4, 2, chords=3),
                           both(_ring, 25, 3, 3)],
    "arities": lambda: [both(_mixed_arity, 9, 0),
                        both(_mixed_arity, 13, 1)],
    "domains": lambda: [both(_ring, 10, 2, 0), both(_ring, 14, 5, 1)],
}


@pytest.mark.parametrize("group", sorted(ENVELOPE_GROUPS))
def test_envelope_padding_equals_reference(group):
    jg, tg = graphs_of(ENVELOPE_GROUPS[group]())
    env = _covering(JBin, jg)
    assert tuple(_covering(TBin, tg)) == tuple(env)
    rp, rw = JB.stack_to_envelope(jg, env)
    pp, pw = TB.stack_to_envelope(tg, TBin.Envelope(*env))
    assert pw == rw
    for r, p in zip(rp, pp):
        bits_equal(r.var_costs, p.var_costs)
        bits_equal(r.var_valid, p.var_valid)
        for rb, pb in zip(r.buckets, p.buckets):
            bits_equal(rb.costs, pb.costs)
            bits_equal(rb.var_ids, pb.var_ids)


def test_envelope_refusals_and_sentinel_remap():
    g = torch_compile(_ring(T, 10, 3, 0), noise_level=0.01, pad_to=8)[0]
    jg = jax_compile(_ring(J, 10, 3, 0), noise_level=0.01, pad_to=8)[0]
    env = TBin.Envelope(16, 4, ((2, 32),))
    bits_equal(JB.pad_graph_to_envelope(jg, JBin.Envelope(*env))
               .buckets[0].var_ids,
               TB.pad_graph_to_envelope(g, env).buckets[0].var_ids)
    with pytest.raises(ValueError, match="does not cover"):
        TB.pad_graph_to_envelope(g, TBin.Envelope(4, 3, ((2, 16),)))
    with pytest.raises(ValueError, match="arities"):
        TB.pad_graph_to_envelope(g, TBin.Envelope(16, 3, ((3, 16),)))
    with pytest.raises(ValueError, match="rows"):
        TB.pad_graph_to_envelope(g, TBin.Envelope(16, 3, ((2, 4),)))
    exact = torch_compile(_ring(T, 10, 3, 0), noise_level=0.01)[0]
    fit = TBin.Envelope(exact.n_vars, exact.dmax,
                        tuple((b.arity, b.n_factors) for b in exact.buckets))
    assert TB.pad_graph_to_envelope(exact, fit) is exact


# ------------------------------------------------------------------ #
# Every member's messages against the vmapped reference.


def _vmapped(graphs, cycles):
    def one(g):
        return JM.run_maxsum(g, cycles, stop_on_convergence=False)

    return jax.jit(jax.vmap(one))(JB.stack_graphs(graphs))


def _union_state(graphs, cycles):
    """The port's stacked solve, keeping its final state."""
    placed = to_device_graph(TB.stack_union(graphs), "cpu",
                             fold=TB.stacked_fold(graphs[0]))
    return TM.run_maxsum(placed, cycles, stop_on_convergence=False)


UNION_SHAPES = [
    (12, [(2, 20)], 3), (12, [(1, 3), (2, 15), (3, 4)], 3),
    (40, [(1, 1), (2, 30)], 2), (40, [(2, 30), (1, 1)], 3),
    (40, [(1, 1), (2, 1), (3, 20)], 3), (40, [(2, 1), (3, 6), (4, 2)], 5),
    (12, [(2, 23), (3, 8)], 1), (9, [(1, 2), (2, 1), (3, 1)], 3),
]


@pytest.mark.parametrize("spec", UNION_SHAPES)
def test_member_messages_equal_the_vmapped_reference(spec):
    g0 = skeleton(*spec, 1)
    members = []
    for s in range(3):
        rng = np.random.default_rng(s)
        members.append(g0._replace(
            var_costs=costs(rng, g0.var_costs.shape, 2),
            buckets=tuple(b._replace(costs=np.abs(costs(rng, b.costs.shape,
                                                        2)))
                          for b in g0.buckets)))
    rs, rv = _vmapped(members, 25)
    ps, pv = _union_state([port_graph(g) for g in members], 25)
    n = len(members)
    rows = g0.var_costs.shape[0]
    values = torch.cat([pv, pv.new_zeros(1)]).view(n, rows)[:, :-1]
    bits_equal(rv, values)
    for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
        for r, p in zip(getattr(rs, field), getattr(ps, field)):
            bits_equal(r, p.reshape((n,) + tuple(np.asarray(r).shape[1:])))


# ------------------------------------------------------------------ #
# The dispatch entry points.


@pytest.mark.parametrize("bins", [None, (4, 8)])
def test_run_stacked_equals_reference(bins):
    jg, tg = graphs_of(rings())
    rv, rc, rr = JB.run_stacked(jg, max_cycles=MAX_CYCLES,
                                pad_to_bins=bins)
    pv, pc, pr = TB.run_stacked(tg, max_cycles=MAX_CYCLES,
                                pad_to_bins=bins, device="cpu")
    bits_equal(rv, pv)
    bits_equal(rc, pc)
    _assert_metrics(rr, pr)


def test_run_stacked_of_sorted_graphs_equals_reference():
    jg, tg = graphs_of(rings(count=3), aggregation="sorted")
    rv, rc, rr = JB.run_stacked(jg, max_cycles=MAX_CYCLES)
    pv, pc, pr = TB.run_stacked(tg, max_cycles=MAX_CYCLES, device="cpu")
    bits_equal(rv, pv)
    _assert_metrics(rr, pr)


def test_run_stacked_with_prune_gives_the_same_values():
    jg, tg = graphs_of(rings(count=3))
    rv, _, _ = JB.run_stacked(jg, max_cycles=MAX_CYCLES)
    pv, _, _ = TB.run_stacked(tg, max_cycles=MAX_CYCLES, prune=True,
                              device="cpu")
    bits_equal(rv, pv)


@pytest.mark.parametrize("group", sorted(ENVELOPE_GROUPS))
def test_run_stacked_envelope_equals_reference(group):
    jg, tg = graphs_of(ENVELOPE_GROUPS[group]())
    env = _covering(JBin, jg)
    rv, rc, rr = JB.run_stacked(jg, max_cycles=MAX_CYCLES, envelope=env)
    pv, pc, pr = TB.run_stacked(tg, max_cycles=MAX_CYCLES,
                                envelope=TBin.Envelope(*env), device="cpu")
    bits_equal(rv, pv)
    bits_equal(rc, pc)
    _assert_metrics(rr, pr)


@pytest.mark.parametrize("ladder", [None, "UNION_LADDER"])
@pytest.mark.parametrize("budget", [4, MAX_CYCLES])
def test_run_lane_packed_equals_reference(ladder, budget):
    pairs = [both(_ring, 12, 3, 0), both(_ring, 9, 3, 1),
             both(_ring, 21, 3, 2), both(_ring, 15, 4, 3, chords=2),
             both(_mixed_arity, 9, 1), both(_ring, 6, 3, 0),
             both(_ring, 30, 3, 1, chords=10)]
    jg, tg = graphs_of(pairs)
    rv, rc, rr = JB.run_lane_packed(
        jg, max_cycles=budget,
        ladder=None if ladder is None else getattr(JBin, ladder))
    pv, pc, pr = TB.run_lane_packed(
        tg, max_cycles=budget,
        ladder=None if ladder is None else getattr(TBin, ladder),
        device="cpu")
    assert len(pv) == len(rv)
    for r, p in zip(rv, pv):
        bits_equal(r, p)
    bits_equal(rc, pc)
    _assert_metrics(rr, pr)


def test_launch_is_cold_then_collects_what_run_gives():
    jg, tg = graphs_of(rings(n=18, count=4))
    kw = dict(max_cycles=17, damping=0.6, device="cpu")
    assert TB.launch_stacked(tg, **kw) is None
    v, c, res = TB.run_stacked(tg, **kw)
    pending = TB.launch_stacked(tg, **kw)
    assert pending is not None and pending.kind == "stacked"
    lv, lc, lres = TB.collect_stacked(pending)
    bits_equal(v, lv)
    bits_equal(c, lc)
    assert lres.metrics["pipelined"] is True
    assert lres.metrics["converged_lanes"] == res.metrics["converged_lanes"]
    assert TB.launch_stacked(tg, prune=True, **kw) is None

    assert TB.launch_lane_packed(tg[:3], **kw) is None
    v, c, res = TB.run_lane_packed(tg[:3], **kw)
    pending = TB.launch_lane_packed(tg[:3], **kw)
    lv, lc, lres = TB.collect_lane_packed(pending)
    for a, b in zip(v, lv):
        bits_equal(a, b)
    assert lres.metrics["converged_lanes"] == res.metrics["converged_lanes"]
    rv, _, _ = JB.run_lane_packed(jg[:3], max_cycles=17, damping=0.6)
    for a, b in zip(rv, lv):
        bits_equal(a, b)


@pytest.mark.parametrize("objective", ["min", "max"])
def test_solve_maxsum_batch_equals_reference(objective):
    pairs = [both(_ring, 24, 3, seed, chords=8, objective=objective)
             for seed in range(4)]
    ref = JB.solve_maxsum_batch([j for j, _ in pairs], max_cycles=80)
    got = TB.solve_maxsum_batch([t for _, t in pairs], max_cycles=80,
                                device="cpu")
    for r, p in zip(ref, got):
        for key in ("assignment", "cost", "violations", "cycles"):
            assert p[key] == r[key], key
        assert set(p["batch"]) == set(r["batch"])
    assert TB.solve_maxsum_batch([], device="cpu") == []
    with pytest.raises(ValueError, match="identical compiled shapes"):
        TB.solve_maxsum_batch([pairs[0][1], both(_ring, 30, 3, 1)[1]],
                              device="cpu")


def test_batch_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    _, tg = graphs_of(rings(count=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TB.run_stacked(tg, max_cycles=3)
