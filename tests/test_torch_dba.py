"""The port's DBA step and run (pydcop_tpu_torch/ops/dba.py) against
``pydcop_tpu.ops.dba`` on the CPU, state by state.

From the same seed, the port's state — values, the two key words, the
cycle, every bucket's breakout weights and the termination counters —
equals the reference's after ``init_state`` and after every one of 40
steps (``np.array_equal``; the reference's step jitted with the graph as
an argument), under ``scatter`` and ``ell``, on the reference's
``coloring_csp`` instances (equality cost 10000, the ring with random
chords of ``tests/unit/test_algorithms_device.py``; also at D = 5) and
on graphs of arity 1-4 with one-factor buckets and real-valued tables
at D in {2, 3, 5} (violation: a cost at or above a low ``infinity``).
The counters are compared with ``np.array_equal`` (-0.0 equals +0.0):
the reference makes them through ``-neighbor_max(-tc)``.  The weighted
counts are integers, exact in any order; they go through the positional
sum as the reference's do.

``run_dba`` runs in chunks of gated steps with one host read a chunk;
its values, violation count and cycles equal the reference's jitted
``run_dba`` (a ``lax.while_loop``) on instances that stop on their
counters before ``max_cycles`` and on instances that reach it, at
chunks of 1, 3 and 32 steps.  A gated step that is off keeps the state.
The state converter round-trips the reference's state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydcop_tpu.dcop.dcop as jd
import pydcop_tpu.dcop.objects as jo
import pydcop_tpu.dcop.relations as jr
from pydcop_tpu.algorithms.mgm import lexic_ranks as j_lexic_ranks
from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu.ops import dba as J
from pydcop_tpu_torch.engine.convert import (
    graph_from_numpy,
    localsearch_state_from_numpy,
    localsearch_state_to_numpy,
)
from pydcop_tpu_torch.ops import dba as T
from test_torch_localsearch import arrays, both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CYCLES = 40


def coloring_csp(objects, relations, dcop_mod, n_vars=10, d=3,
                 infinity=10000.0, seed=0, extra_soft=False):
    """The reference's ``coloring_csp``
    (tests/unit/test_algorithms_device.py:226) from one package's
    objects: a ring plus random chords, equal colours cost
    ``infinity``, else 0; with ``extra_soft`` random soft tables on the
    first half of the edges."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("colors", "color", list(range(d)))
    variables = [objects.Variable(f"v{i}", dom) for i in range(n_vars)]
    dcop = dcop_mod.DCOP("csp", objective="min")
    eq = np.where(np.eye(d) > 0, infinity, 0.0)
    edges = [(i, (i + 1) % n_vars) for i in range(n_vars)]
    for _ in range(n_vars // 3):
        i, j = rng.choice(n_vars, size=2, replace=False)
        if (i, j) not in edges and (j, i) not in edges:
            edges.append((i, j))
    for k, (i, j) in enumerate(edges):
        dcop.add_constraint(relations.NAryMatrixRelation(
            [variables[i], variables[j]], eq, f"c{k}"))
    if extra_soft:
        for k, (i, j) in enumerate(edges[: n_vars // 2]):
            dcop.add_constraint(relations.NAryMatrixRelation(
                [variables[i], variables[j]], rng.random((d, d)), f"s{k}"))
    return dcop


def dcop_graphs(dcop, aggregation="scatter"):
    """(reference graph, port graph on the CPU of the same arrays,
    lexical ranks [V+1]) of a reference DCOP."""
    jg, meta = jax_compile(dcop, aggregation=aggregation)
    tg = graph_from_numpy(jg.var_costs, jg.var_valid,
                          [(b.costs, b.var_ids) for b in jg.buckets],
                          device="cpu", aggregation=aggregation)
    return jg, tg, j_lexic_ranks(meta)


# Arity 1-4, one-factor buckets among them, real-valued tables.
MIXED_SIZES = [(1, 1), (2, 40), (3, 1), (3, 12), (4, 6)]


def mixed_graphs(d, aggregation="scatter", seed=3, n_vars=30,
                 sizes=MIXED_SIZES):
    """(reference graph, port graph, ranks) of ``sizes`` ((arity, F)
    per bucket) at D."""
    jg, tg = both(*arrays(seed, n_vars, d, sizes), aggregation)
    ranks = np.arange(n_vars + 1, dtype=np.float32)
    ranks[-1] = np.inf
    return jg, tg, ranks


# (label, graph builder, infinity): DBA counts costs at or above
# ``infinity`` as violations.
PROBLEMS = {
    "csp": (lambda agg: dcop_graphs(coloring_csp(jo, jr, jd, 30, seed=1),
                                    agg), 10000.0),
    "csp_d5": (lambda agg: dcop_graphs(
        coloring_csp(jo, jr, jd, 24, d=5, seed=2), agg), 10000.0),
    "mixed_d2": (lambda agg: mixed_graphs(2, agg), 1.0),
    "mixed_d3": (lambda agg: mixed_graphs(3, agg), 1.0),
    "mixed_d5": (lambda agg: mixed_graphs(5, agg, n_vars=20), 1.0),
}


def assert_same_dba(tstate, jstate):
    out = localsearch_state_to_numpy(tstate)
    np.testing.assert_array_equal(out["values"], np.asarray(jstate.values))
    np.testing.assert_array_equal(out["key"],
                                  np.asarray(jstate.key, np.uint32))
    assert out["cycle"] == int(jstate.cycle)
    assert len(out["weights"]) == len(jstate.weights)
    for a, b in zip(out["weights"], jstate.weights):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(out["term_counter"],
                                  np.asarray(jstate.term_counter))


@pytest.mark.parametrize("aggregation", ["scatter", "ell"])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_dba_state_equals_reference_every_step(problem, aggregation):
    build, infinity = PROBLEMS[problem]
    jg, tg, ranks = build(aggregation)
    jstate, tstate = J.init_state(jg, 4), T.init_state(tg, 4)
    assert_same_dba(tstate, jstate)
    step = jax.jit(lambda s, g: J.dba_step(
        s, g, infinity=infinity, lexic_ranks=jnp.asarray(ranks)))
    t_ranks = torch.tensor(ranks)
    moved = 0
    for _ in range(CYCLES):
        before = tstate.values.clone()
        jstate = step(jstate, jg)
        tstate = T.dba_step(tstate, tg, infinity=infinity,
                            lexic_ranks=t_ranks)
        assert_same_dba(tstate, jstate)
        moved += int((tstate.values != before).sum())
    # Breakouts happened (not on the five-colour ring, solved without).
    bumped = sum(float(w.sum() - w.numel()) for w in tstate.weights)
    assert moved > 0 and (bumped > 0) == (problem != "csp_d5")


def test_weighted_counts_and_violation_count_equal():
    jg, tg, _ = mixed_graphs(3)
    values = np.asarray(J.init_state(jg, 6).values)
    rng = np.random.default_rng(2)
    weights = [rng.integers(1, 9, size=b.var_ids.shape).astype(np.float32)
               for b in jg.buckets]
    ref = jax.jit(lambda g, w, v: J._weighted_violation_counts(
        g, w, v, 1.0))(jg, weights, values)
    out = T.weighted_violation_counts(
        tg, [torch.tensor(w) for w in weights], torch.tensor(values), 1.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    ref = jax.jit(lambda g, v: J.violation_count(g, v, 1.0))(jg, values)
    out = T.violation_count(tg, torch.tensor(values), 1.0)
    assert float(out) == float(ref) > 0


# (label, dcop builder, max_cycles, max_distance, seed) of runs that stop
# on their counters before max_cycles and of runs that reach it.
RUNS = [
    ("csp8_stops", lambda: coloring_csp(jo, jr, jd, 8, seed=2), 200, 8, 0),
    ("csp12_stops", lambda: coloring_csp(jo, jr, jd, 12, seed=0), 200, 5,
     3),
    ("csp20_stops", lambda: coloring_csp(jo, jr, jd, 20, seed=1), 300, 10,
     3),
    ("csp20_budget", lambda: coloring_csp(jo, jr, jd, 20, seed=1), 25, 50,
     3),
]


@pytest.mark.parametrize("label,build,max_cycles,max_distance,seed", RUNS)
def test_run_dba_equals_reference_at_every_chunk(label, build, max_cycles,
                                                 max_distance, seed):
    jg, tg, ranks = dcop_graphs(build())
    ref = jax.jit(lambda g: J.run_dba(
        g, max_cycles, infinity=10000.0, max_distance=max_distance,
        lexic_ranks=jnp.asarray(ranks), seed=seed))(jg)
    cycles = int(ref[2])
    assert (cycles < max_cycles) == label.endswith("stops")
    for chunk in (1, 3, 32):
        values, cost, got = T.run_dba(
            tg, max_cycles, infinity=10000.0, max_distance=max_distance,
            lexic_ranks=ranks, seed=seed, chunk=chunk)
        np.testing.assert_array_equal(values.numpy(), np.asarray(ref[0]))
        assert float(cost) == float(ref[1])
        assert got == cycles


def test_gated_step_keeps_the_state():
    jg, tg, ranks = mixed_graphs(3)
    state = T.init_state(tg, 1)
    t_ranks = torch.tensor(ranks)
    for _ in range(3):
        state = T.dba_step(state, tg, infinity=1.0, lexic_ranks=t_ranks)
    kept = T.dba_step(state, tg, infinity=1.0, lexic_ranks=t_ranks,
                      gate=torch.tensor(False))
    went = T.dba_step(state, tg, infinity=1.0, lexic_ranks=t_ranks,
                      gate=torch.tensor(True))
    free = T.dba_step(state, tg, infinity=1.0, lexic_ranks=t_ranks)
    a, b = localsearch_state_to_numpy(kept), localsearch_state_to_numpy(
        state)
    assert a["cycle"] == b["cycle"] == 3
    assert a["key"].tolist() != b["key"].tolist()
    for name in ("values", "term_counter"):
        np.testing.assert_array_equal(a[name], b[name])
    for x, y in zip(a["weights"], b["weights"]):
        np.testing.assert_array_equal(x, y)
    a, b = localsearch_state_to_numpy(went), localsearch_state_to_numpy(free)
    assert a["cycle"] == b["cycle"] == 4
    np.testing.assert_array_equal(a["values"], b["values"])
    with pytest.raises(ValueError, match="chunk"):
        T.run_dba(tg, 5, lexic_ranks=ranks, chunk=0)


def test_state_converter_round_trips_the_reference_state():
    jg, tg, ranks = dcop_graphs(coloring_csp(jo, jr, jd, 30, seed=1))
    step = jax.jit(lambda s, g: J.dba_step(
        s, g, infinity=10000.0, lexic_ranks=jnp.asarray(ranks)))
    jstate = J.init_state(jg, 5)
    for _ in range(6):
        jstate = step(jstate, jg)
    tstate = localsearch_state_from_numpy(
        "dba", np.asarray(jstate.values), np.asarray(jstate.key),
        np.asarray(jstate.cycle), device="cpu",
        weights=[np.asarray(w) for w in jstate.weights],
        term_counter=np.asarray(jstate.term_counter))
    assert isinstance(tstate, T.DbaState)
    assert_same_dba(tstate, jstate)
    back = localsearch_state_to_numpy(tstate)
    again = localsearch_state_from_numpy("dba", device="cpu", **back)
    assert_same_dba(again, jstate)
    for _ in range(5):
        jstate = step(jstate, jg)
        tstate = T.dba_step(tstate, tg, infinity=10000.0,
                            lexic_ranks=torch.tensor(ranks))
        assert_same_dba(tstate, jstate)
