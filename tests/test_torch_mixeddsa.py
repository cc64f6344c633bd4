"""The port's MixedDSA step (pydcop_tpu_torch/ops/mixeddsa.py) against
``pydcop_tpu.ops.mixeddsa`` on the CPU, state by state.

From the same seed, the port's state (values, the two key words, the
cycle) equals the reference's after ``init_state`` and after every one
of 40 steps (``np.array_equal``; the reference's step jitted with the
graph as an argument) for variants A, B and C on the reference's
``coloring_csp`` with infinite equality costs and soft tables on half
its edges, and on graphs of arity 1-4 with one-factor buckets, real
tables over seven decades and infinite entries in half the factors, at
D in {2, 3, 5} and under ``ell`` (where the reference still scatters).

The reference sums its two candidate metrics in two interleaved chains
of per-(bucket, position) ``segment_sum``s, not through its
``positional_sum``: ``candidate_metrics`` is held bit for bit against
them, both sums, on those graphs — the float cost chain follows the
positional sum's fold (one-factor buckets moved), which the one-factor
graphs show; ``classify_factors``, ``soft_violated_vars``,
``run_mixeddsa`` and the state converter equal the reference's.
"""

import jax
import numpy as np
import pytest
import torch

import pydcop_tpu.dcop.dcop as jd
import pydcop_tpu.dcop.objects as jo
import pydcop_tpu.dcop.relations as jr
from pydcop_tpu.ops import mixeddsa as J
from pydcop_tpu_torch.engine.convert import localsearch_state_from_numpy
from pydcop_tpu_torch.ops import mixeddsa as T
from test_torch_dba import MIXED_SIZES, coloring_csp, dcop_graphs
from test_torch_dsa import assert_same_state
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


def hard_graphs(d, aggregation="scatter", seed=7, n_vars=30):
    """(reference graph, port graph) of ``MIXED_SIZES`` at D with
    real tables, a random entry or two of every other factor made
    infinite (a hard constraint)."""
    var_costs, var_valid, buckets = arrays(seed, n_vars, d, MIXED_SIZES)
    rng = np.random.default_rng(seed)
    for costs, _ in buckets:
        flat = costs.reshape(costs.shape[0], -1)
        for f in range(0, costs.shape[0], 2):
            flat[f, rng.integers(0, flat.shape[1], size=2)] = np.inf
    return both(var_costs, var_valid, buckets, aggregation)


GRAPHS = {
    "csp_inf": lambda: dcop_graphs(coloring_csp(
        jo, jr, jd, 30, infinity=float("inf"), seed=3, extra_soft=True))[:2],
    "hard_d2": lambda: hard_graphs(2),
    "hard_d3": lambda: hard_graphs(3),
    "hard_d5": lambda: hard_graphs(5, n_vars=20),
    "hard_d3_ell": lambda: hard_graphs(3, "ell"),
}
CASES = [(g, v) for g in ("csp_inf", "hard_d3") for v in "ABC"] + [
    ("hard_d2", "B"), ("hard_d5", "C"), ("hard_d3_ell", "B"),
    ("hard_d3_ell", "C")]


@pytest.mark.parametrize("graph,variant", CASES)
def test_mixeddsa_state_equals_reference_every_step(graph, variant):
    jg, tg = GRAPHS[graph]()
    jstate, tstate = J.init_state(jg, 3), T.init_state(tg, 3)
    assert_same_state(tstate, jstate)
    classes, t_classes = J.classify_factors(jg), T.classify_factors(tg)
    step = jax.jit(lambda s, g, c: J.mixeddsa_step(
        s, g, variant=variant, proba_hard=0.7, proba_soft=0.5, classes=c))
    moved = 0
    for _ in range(CYCLES):
        before = tstate.values.clone()
        jstate = step(jstate, jg, classes)
        tstate = T.mixeddsa_step(tstate, tg, variant=variant,
                                 proba_hard=0.7, proba_soft=0.5,
                                 classes=t_classes)
        assert_same_state(tstate, jstate)
        moved += int((tstate.values != before).sum())
    assert moved > 0


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_pieces_equal_reference(graph):
    """classify_factors, both candidate sums (bit for bit) and
    soft_violated_vars at three assignments."""
    jg, tg = GRAPHS[graph]()
    classes, t_classes = J.classify_factors(jg), T.classify_factors(tg)
    assert any(bool(np.asarray(h).any()) for h, _ in classes)
    for (jh, jo_), (th, to_) in zip(classes, t_classes):
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(to_.numpy(), np.asarray(jo_))
    metrics = jax.jit(J._candidate_metrics)
    soft = jax.jit(J._soft_violated_vars)
    for seed in range(3):
        values = np.asarray(J.init_state(jg, seed).values)
        tv = torch.tensor(values)
        ref_nb, ref_cost = metrics(jg, values, classes)
        nb, cost = T.candidate_metrics(tg, tv, t_classes)
        np.testing.assert_array_equal(nb.numpy(), np.asarray(ref_nb))
        np.testing.assert_array_equal(cost.numpy().view(np.uint32),
                                      np.asarray(ref_cost).view(np.uint32))
        np.testing.assert_array_equal(
            T.soft_violated_vars(tg, tv, t_classes).numpy(),
            np.asarray(soft(jg, values, classes)))


def test_run_mixeddsa_and_converter_equal_reference():
    jg, tg = GRAPHS["hard_d3"]()
    ref = jax.jit(lambda g: J.run_mixeddsa(g, 15, variant="C",
                                           proba_hard=0.9, seed=4))(jg)
    values, cost, cycles = T.run_mixeddsa(tg, 15, variant="C",
                                          proba_hard=0.9, seed=4)
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref[0]))
    assert cycles == int(ref[2]) == 15
    assert float(cost) == pytest.approx(float(ref[1]), rel=1e-6)
    step = jax.jit(lambda s, g, c: J.mixeddsa_step(
        s, g, variant="B", proba_hard=0.7, proba_soft=0.5, classes=c))
    classes = J.classify_factors(jg)
    jstate = J.init_state(jg, 8)
    for _ in range(5):
        jstate = step(jstate, jg, classes)
    tstate = localsearch_state_from_numpy(
        "mixeddsa", np.asarray(jstate.values), np.asarray(jstate.key),
        np.asarray(jstate.cycle), device="cpu")
    assert isinstance(tstate, T.MixedDsaState)
    t_classes = T.classify_factors(tg)
    for _ in range(5):
        jstate = step(jstate, jg, classes)
        tstate = T.mixeddsa_step(tstate, tg, variant="B", proba_hard=0.7,
                                 proba_soft=0.5, classes=t_classes)
        assert_same_state(tstate, jstate)
