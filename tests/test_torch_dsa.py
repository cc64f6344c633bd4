"""The port's DSA step (pydcop_tpu_torch/ops/dsa.py) against
``pydcop_tpu.ops.dsa`` on the CPU, state by state.

From the same seed, the port's state — values [V+1] int32, the two key
words, the cycle — equals the reference's after ``init_state`` and after
every one of 40 steps (``np.array_equal``; the reference's step jitted
with the graph as an argument), for variants A, B and C, ``p_mode``
fixed and arity, the staggered schedule's colour classes (adsa), under
the ``scatter`` and ``ell`` aggregations, on a colouring problem with
integer costs (many ties: the current-value dropping and the
violated-constraint rule of variant B decide there) and on a mixed
problem of arity 1-3 with real costs and domains of 2 and 3 values.
``greedy_classes`` equals the reference's (``np.array_equal``), and the
state converter carries the reference's state over.
"""

import jax
import numpy as np
import pytest
import torch

import pydcop_tpu.dcop.dcop as jd
import pydcop_tpu.dcop.objects as jo
import pydcop_tpu.dcop.relations as jr
from pydcop_tpu.algorithms.dsa import _arity_probabilities as j_arity
from pydcop_tpu.engine.compile import build_aggregation_arrays
from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu.ops import dsa as J
from pydcop_tpu_torch.algorithms.dsa import _arity_probabilities
from pydcop_tpu_torch.engine.convert import (
    graph_from_numpy,
    localsearch_state_from_numpy,
    localsearch_state_to_numpy,
)
from pydcop_tpu_torch.ops import dsa as T
from pydcop_tpu_torch.ops.localsearch import placed
from test_torch_compile import build_coloring


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


def build_mixed_real(objects, relations, dcop_mod, n_vars: int = 60,
                     seed: int = 4):
    """Domains of 2 and 3 values; unary, binary and ternary constraints
    with real-valued costs (matrices), built from one package's
    objects."""
    rng = np.random.default_rng(seed)
    doms = [objects.Domain("d2", "", [0, 1]),
            objects.Domain("d3", "", [0, 1, 2])]
    dcop = dcop_mod.DCOP("mixed_real", objective="min")
    vs = [objects.Variable(f"v{i:03d}", doms[i % 2]) for i in range(n_vars)]
    for v in vs:
        dcop.add_variable(v)
    k = 0
    for arity, count in ((1, n_vars // 4), (2, n_vars * 3 // 2),
                         (3, n_vars // 3)):
        for _ in range(count):
            scope = [vs[i] for i in rng.choice(n_vars, size=arity,
                                               replace=False)]
            shape = tuple(len(v.domain) for v in scope)
            costs = np.round(rng.normal(size=shape) * 5.0, 3)
            dcop.add_constraint(relations.NAryMatrixRelation(
                scope, costs, f"c{k}"))
            k += 1
    dcop.add_agents([objects.AgentDef("a0")])
    return dcop


PROBLEMS = {
    "coloring": lambda: build_coloring(jo, jr, jd, 80, seed=2),
    "mixed_real": lambda: build_mixed_real(jo, jr, jd),
}


def graphs(problem: str, aggregation: str):
    """The reference's compiled graph (numpy) and the port's placed copy
    of the same arrays (CPU)."""
    jg, meta = jax_compile(PROBLEMS[problem](), aggregation=aggregation)
    tg = graph_from_numpy(jg.var_costs, jg.var_valid,
                          [(b.costs, b.var_ids) for b in jg.buckets],
                          device="cpu", aggregation=aggregation)
    return jg, tg, meta


def assert_same_state(tstate, jstate):
    out = localsearch_state_to_numpy(tstate)
    np.testing.assert_array_equal(out["values"], np.asarray(jstate.values))
    np.testing.assert_array_equal(out["key"],
                                  np.asarray(jstate.key, np.uint32))
    assert out["cycle"] == int(jstate.cycle)


STEP_CASES = [
    ("coloring", "scatter", "A", "fixed", False),
    ("coloring", "scatter", "B", "fixed", False),
    ("coloring", "scatter", "C", "fixed", False),
    ("coloring", "ell", "B", "fixed", False),
    ("coloring", "scatter", "B", "fixed", True),
    ("mixed_real", "scatter", "A", "arity", False),
    ("mixed_real", "scatter", "B", "arity", False),
    ("mixed_real", "scatter", "C", "fixed", False),
    ("mixed_real", "ell", "B", "arity", False),
    ("mixed_real", "ell", "C", "fixed", True),
    ("mixed_real", "scatter", "A", "fixed", True),
]


@pytest.mark.parametrize("problem,aggregation,variant,p_mode,staggered",
                         STEP_CASES)
def test_dsa_state_equals_reference_every_step(problem, aggregation,
                                               variant, p_mode, staggered):
    jg, tg, _ = graphs(problem, aggregation)
    prob = 0.7
    if p_mode == "arity":
        prob = j_arity(jg, 0.7)
        np.testing.assert_array_equal(_arity_probabilities(jg, 0.7), prob)
    classes, n_classes = None, 1
    if staggered:
        classes, n_classes = J.greedy_classes(jg)
        t_classes, t_n = T.greedy_classes(tg)
        np.testing.assert_array_equal(t_classes, classes)
        assert t_n == n_classes > 1
    seed = 11
    jstate = J.init_state(jg, seed)
    tstate = T.init_state(tg, seed)
    assert_same_state(tstate, jstate)
    step = jax.jit(lambda s, g: J.dsa_step(
        s, g, variant=variant, probability=prob,
        classes=None if classes is None else jax.numpy.asarray(classes),
        n_classes=n_classes))
    t_prob = placed(tg, prob)
    t_cls = placed(tg, classes)
    moved = 0
    for _ in range(CYCLES):
        before = tstate.values.clone()
        jstate = step(jstate, jg)
        tstate = T.dsa_step(tstate, tg, variant=variant,
                            probability=t_prob, classes=t_cls,
                            n_classes=n_classes)
        assert_same_state(tstate, jstate)
        moved += int((tstate.values != before).sum())
    assert moved > 0


def test_run_dsa_equals_reference():
    jg, tg, _ = graphs("mixed_real", "scatter")
    ref = jax.jit(lambda g: J.run_dsa(g, 25, variant="B",
                                      probability=0.7, seed=3))(jg)
    values, cost, cycles = T.run_dsa(tg, 25, variant="B", probability=0.7,
                                     seed=3)
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref[0]))
    assert cycles == int(ref[2]) == 25
    assert cost.dtype == torch.float32
    assert cost.numpy().tobytes() == np.asarray(ref[1]).tobytes()


@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_greedy_classes_equal(problem):
    jg, tg, _ = graphs(problem, "scatter")
    classes, n = J.greedy_classes(jg)
    t_classes, t_n = T.greedy_classes(tg)
    np.testing.assert_array_equal(t_classes, classes)
    assert t_n == n
    t_classes, t_n = T.greedy_classes(jg)
    np.testing.assert_array_equal(t_classes, classes)


def test_state_converter_continues_the_reference_run():
    """A reference state taken mid-run, converted, steps on in the port
    as in the reference."""
    jg, tg, _ = graphs("coloring", "scatter")
    step = jax.jit(lambda s, g: J.dsa_step(s, g, variant="B",
                                           probability=0.7))
    jstate = J.init_state(jg, 5)
    for _ in range(7):
        jstate = step(jstate, jg)
    tstate = localsearch_state_from_numpy(
        "dsa", np.asarray(jstate.values), np.asarray(jstate.key),
        np.asarray(jstate.cycle), device="cpu")
    assert isinstance(tstate, T.DsaState)
    for _ in range(5):
        jstate = step(jstate, jg)
        tstate = T.dsa_step(tstate, tg, variant="B", probability=0.7)
        assert_same_state(tstate, jstate)


def test_violated_vars_equal():
    jg, tg, _ = graphs("mixed_real", "scatter")
    values = np.asarray(J.init_state(jg, 2).values)
    ref = jax.jit(J.violated_vars)(jg, values)
    out = T.violated_vars(tg, torch.tensor(values))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_build_aggregation_arrays_of_both_packages_agree():
    """The ELL lists the port places are the reference's."""
    jg, tg, _ = graphs("mixed_real", "ell")
    ell = build_aggregation_arrays(jg.buckets, jg.var_costs.shape[0],
                                   "ell")[4]
    np.testing.assert_array_equal(tg.agg_ell.numpy(), ell)
