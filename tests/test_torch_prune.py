"""Branch-and-bound pruning in the port (pydcop_tpu_torch/ops/maxsum.py:
PruneTable, prune_tables, _survivors, prune_fits, _pruned_binary_update
and the phase choice of run_maxsum_from) against the jitted JAX
reference, on the reference's own bit-identity family: loopy colourings
with integer tables (``tests/unit/test_workreduction_battery.py``
``loopy_dcop``), built here from each package's own objects, at D = 16
and 32.

Tolerance: none.  The tables, survivor masks, phase predicate and pruned
messages are compared on states the reference's jitted superstep
reaches, and on a state with NaN and signed zeros; whole solves are
compared in every field of the final state, against the reference's
pruned run and against the port's own dense run, under each
aggregation, with the number of pruned-step cycles beside the
reference's.  (The reference never returns that count; it is read here
by evaluating its jitted ``prune_fits`` along its own trajectory.)
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

import pydcop_tpu.dcop.dcop as jd
import pydcop_tpu.dcop.objects as jo
import pydcop_tpu.dcop.relations as jr
import pydcop_tpu_torch.dcop.dcop as td
import pydcop_tpu_torch.dcop.objects as to
import pydcop_tpu_torch.dcop.relations as tr
from pydcop_tpu.algorithms.maxsum import build_engine as jax_build_engine
from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu.ops import maxsum as J
from pydcop_tpu_torch.algorithms.maxsum import build_engine
from pydcop_tpu_torch.device import to_device_graph
from pydcop_tpu_torch.engine.compile import compile_dcop as torch_compile
from pydcop_tpu_torch.engine.convert import state_from_numpy, state_to_numpy
from pydcop_tpu_torch.ops import maxsum as T
from pydcop_tpu_torch.ops.binary_factor import binary_factor_update


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
FIELDS = ("v2f", "f2v", "v2f_count", "f2v_count")


def build_loopy(objects, relations, dcop_mod, n=40, d=16, seed=0,
                density=1.8, spread=40, unary="factors"):
    """The reference battery's loopy_dcop: equality penalty per edge,
    integer unary costs as unary matrix relations, or, with
    ``unary="variables"``, as the variables' own cost functions (the
    same costs, one binary bucket)."""
    rng = np.random.default_rng(seed)
    pairs, seen = [], set()
    while len(pairs) < int(n * density):
        i, j = rng.choice(n, 2, replace=False)
        key = (min(i, j), max(i, j))
        if key in seen:
            continue
        seen.add(key)
        pairs.append((i, j))
    unaries = [rng.integers(0, spread, size=(d,)).astype(float)
               for _ in range(n)]
    dom = objects.Domain("d", "", list(range(d)))
    dcop = dcop_mod.DCOP(f"wr{n}_{seed}", objective="min")
    if unary == "variables":
        vs = [objects.VariableWithCostFunc(
            f"v{i}", dom, lambda val, u=unaries[i]: float(u[val]))
            for i in range(n)]
    else:
        vs = [objects.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    eye = np.eye(d)
    for k, (i, j) in enumerate(pairs):
        dcop.add_constraint(
            relations.NAryMatrixRelation([vs[i], vs[j]], eye, f"c{k}"))
    if unary == "factors":
        for i, v in enumerate(vs):
            dcop.add_constraint(relations.NAryMatrixRelation(
                [v], unaries[i], f"u{i}"))
    dcop.add_agents([objects.AgentDef("a0")])
    return dcop


def loopy_both(**kw):
    return build_loopy(jo, jr, jd, **kw), build_loopy(to, tr, td, **kw)


def loopy_graphs(aggregation="scatter", noise=0.0, **kw):
    """(JAX graph, port graph on the CPU), each compiled by its own
    package from its own objects."""
    jax_dcop, torch_dcop = loopy_both(**kw)
    g, _ = jax_compile(jax_dcop, noise_level=noise, aggregation=aggregation,
                       use_cache=False)
    tg, _ = torch_compile(torch_dcop, noise_level=noise,
                          aggregation=aggregation, use_cache=False)
    return g, to_device_graph(tg, "cpu")


def reached_states(g, cycles):
    """The reference's jitted superstep's states after each of
    ``cycles`` counts, as numpy dicts."""
    step = jax.jit(lambda s, gr: J.superstep(s, gr, **KW))
    state, out = J.init_state(g), []
    for c in range(max(cycles) + 1):
        if c in cycles:
            out.append({f: tuple(np.asarray(a) for a in getattr(state, f))
                        for f in FIELDS}
                       | {"stable": bool(state.stable),
                          "cycle": int(state.cycle)})
        state = step(state, g)
    return out


def _binary(g):
    return [i for i, b in enumerate(g.buckets) if b.var_ids.shape[1] == 2][0]


@pytest.mark.parametrize("d", [16, 32])
def test_prune_tables_equal_jax(d):
    g, tg = loopy_graphs(d=d)
    ref = jax.jit(J.prune_tables)(g)
    out = T.prune_tables(tg)
    assert [t is None for t in ref] == [t is None for t in out]
    bi = _binary(g)
    assert ref[bi] is not None and out[bi].width == ref[bi].width
    for field in ("row_min", "row_max", "valid"):
        for a, b in zip(getattr(ref[bi], field), getattr(out[bi], field)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(out[bi].costs_t.numpy(),
                                  np.asarray(ref[bi].costs_t))
    assert out[bi].costs_t.is_contiguous()


def test_small_domains_and_other_arities_stay_dense():
    g, tg = loopy_graphs(d=7)
    assert all(t is None for t in T.prune_tables(tg))
    assert all(t is None for t in J.prune_tables(g))


@pytest.mark.parametrize("d,cycles", [(16, (0, 3, 12, 40)),
                                      (32, (0, 2, 6, 25))])
def test_survivors_fits_and_pruned_update_equal_jax(d, cycles):
    """At D = 16 (budget 2) the survivors never fit on this family; at
    D = 32 (budget 4) they do after the first cycles."""
    g, tg = loopy_graphs(d=d, seed=1)
    bi = _binary(g)
    pts = T.prune_tables(tg)

    @jax.jit
    def ref_fn(gr, v2f):
        pt = J.prune_tables(gr)
        m = v2f[bi]
        return (J._survivors(m, pt[bi], 0), J._survivors(m, pt[bi], 1),
                J.prune_fits(v2f, pt),
                J._pruned_binary_update(gr.buckets[bi], m, pt[bi]))

    seen_fit = set()
    for s in reached_states(g, cycles):
        v2f = tuple(torch.from_numpy(a) for a in s["v2f"])
        s0, s1, fits, upd = ref_fn(g, s["v2f"])
        np.testing.assert_array_equal(
            T._survivors(v2f[bi], pts[bi], 0).numpy(), np.asarray(s0))
        np.testing.assert_array_equal(
            T._survivors(v2f[bi], pts[bi], 1).numpy(), np.asarray(s1))
        out_fits = T.prune_fits(v2f, pts)
        assert out_fits.dtype == torch.bool and out_fits.dim() == 0
        assert bool(out_fits) == bool(fits)
        seen_fit.add(bool(fits))
        pruned = T._pruned_binary_update(tg.buckets[bi], v2f[bi], pts[bi])
        np.testing.assert_array_equal(pruned.numpy(), np.asarray(upd))
        if bool(fits):
            # Where the phase predicate holds, the dense update's values.
            dense = binary_factor_update(tg.buckets[bi].costs, v2f[bi])
            np.testing.assert_array_equal(pruned.numpy(), dense.numpy())
    assert seen_fit == ({False} if d == 16 else {False, True})


def test_pruned_update_keeps_nan_and_signed_zeros_like_jax():
    g, tg = loopy_graphs(d=16, seed=2)
    bi = _binary(g)
    s = reached_states(g, (30,))[0]
    m = s["v2f"][bi].copy()
    m[0, 0, 3] = np.nan
    m[1, 1, :] = -0.0
    m[2, 0, :] = 0.0
    m[3, 1, 5] = -0.0
    ref = jax.jit(lambda gr, mm: J._pruned_binary_update(
        gr.buckets[bi], mm, J.prune_tables(gr)[bi]))(g, m)
    out = T._pruned_binary_update(tg.buckets[bi], torch.from_numpy(m),
                                  T.prune_tables(tg)[bi])
    ref = np.asarray(ref)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert np.isnan(ref).any()
    np.testing.assert_array_equal(np.signbit(out.numpy()), np.signbit(ref))


def _reference_fast_cycles(g, n):
    """Cycles of the reference's run whose state satisfies its jitted
    prune_fits: the cycles its phase loops run the pruned step."""
    fits = jax.jit(lambda gr, v2f: J.prune_fits(v2f, J.prune_tables(gr)))
    step = jax.jit(lambda s, gr: J.superstep(s, gr, **KW))
    state, count = J.init_state(g), 0
    for _ in range(n):
        count += bool(fits(g, state.v2f))
        state = step(state, g)
    return count


def _same_state(tstate, jstate):
    tn = state_to_numpy(tstate)
    for field in FIELDS:
        for a, b in zip(getattr(jstate, field), tn[field]):
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=field)
    assert tn["stable"] == bool(jstate.stable)
    assert tn["cycle"] == int(jstate.cycle)


@pytest.mark.parametrize("aggregation,unary", [
    ("scatter", "variables"), ("sorted", "variables"), ("sorted", "factors"),
    ("ell", "factors"), ("boundary", "factors")])
def test_pruned_run_equals_jax_and_dense(aggregation, unary):
    """Unary costs as factors make two buckets; scatter is compared on
    the one-bucket form of the same problem, since the reference's
    scatter over two buckets follows XLA's shape-dependent fold
    (ROADMAP Queue C)."""
    cycles = 50
    g, tg = loopy_graphs(aggregation=aggregation, d=32, seed=0,
                         unary=unary)
    assert len(g.buckets) == (1 if unary == "variables" else 2)
    stats = {}
    pstate, pvals = T.run_maxsum(tg, cycles, stop_on_convergence=False,
                                 prune=True, stats=stats, **KW)
    dstate, dvals = T.run_maxsum(tg, cycles, stop_on_convergence=False,
                                 **KW)
    np.testing.assert_array_equal(pvals.numpy(), dvals.numpy())
    dn = state_to_numpy(dstate)
    for field in FIELDS:
        for a, b in zip(dn[field], state_to_numpy(pstate)[field]):
            np.testing.assert_array_equal(b, a, err_msg=field)
    assert 0 < stats["prune_fast_cycles"] < cycles
    assert stats["prune_fast_cycles"] == _reference_fast_cycles(g, cycles)
    if aggregation == "boundary":
        return   # its prefix sum is held to the reference by tolerance
    run = jax.jit(partial(J.run_maxsum, max_cycles=cycles,
                          stop_on_convergence=False, prune=True, **KW))
    jstate, jvals = run(g)
    np.testing.assert_array_equal(pvals.numpy(), np.asarray(jvals))
    _same_state(pstate, jstate)


@pytest.mark.parametrize("stop", [True, False])
def test_pruned_run_from_a_carried_state(stop):
    """run_maxsum_from with pruning from a mid-run reference state, with
    and without stopping at the fixpoint."""
    g, tg = loopy_graphs(d=32, seed=1, unary="variables")
    s = reached_states(g, (5,))[0]
    js = J.MaxSumState(**{f: tuple(s[f]) for f in FIELDS},
                       stable=np.asarray(s["stable"]),
                       cycle=np.asarray(s["cycle"], np.int32))
    run = jax.jit(lambda gr, st: J.run_maxsum_from(
        gr, st, 60, stop_on_convergence=stop, prune=True, **KW))
    jstate, jvals = run(g, js)
    tstate, tvals = T.run_maxsum_from(
        tg, state_from_numpy(**s, device="cpu"), 60,
        stop_on_convergence=stop, prune=True, **KW)
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))
    _same_state(tstate, jstate)
    if stop:
        assert int(tstate.cycle) < 65 and bool(tstate.stable)


def test_engine_prune_with_noise_equals_dense_and_jax():
    """The engine path with tie-breaking noise: prune=True gives the
    dense solve, and the reference's."""
    jax_dcop, torch_dcop = loopy_both(d=32, seed=1, unary="variables")
    results = {}
    for prune in (False, True):
        res = build_engine(torch_dcop, {"prune": prune},
                           device="cpu").run(max_cycles=150)
        results[prune] = res
    ref = jax_build_engine(jax_dcop, {"prune": True}).run(max_cycles=150)
    for res in results.values():
        assert res.assignment == ref.assignment
        assert res.cycles == ref.cycles
        assert res.converged == ref.converged
    assert results[True].metrics["prune_fast_cycles"] > 0
    assert "prune_fast_cycles" not in results[False].metrics
