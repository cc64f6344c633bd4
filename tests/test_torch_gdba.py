"""The port's GDBA step (pydcop_tpu_torch/ops/gdba.py) against
``pydcop_tpu.ops.gdba`` on the CPU, state by state.

From the same seed, the port's state — values, the two key words, the
cycle and every bucket's modifier tables — equals the reference's after
``init_state`` and after every one of 30 steps (``np.array_equal``; the
reference's step jitted with the graph as an argument) for all 24
combinations of ``modifier`` (A, M), ``violation`` (NZ, NM, MX) and
``increase_mode`` (E, R, C, T) on a graph of arity 1-3 with a
one-factor bucket and real-valued tables over seven decades (the
effective costs' sums are order-sensitive there), and for a few
combinations on arity 1-4 graphs with one-factor buckets at D in
{2, 3, 5}, under ``ell`` and on the reference's ``coloring_csp`` with
soft tables on half its edges.  The effective cost of a candidate is
gathered from the cost and the modifier tables and then added or
multiplied, one rounding as the reference's add of whole tables;
``factor_min_max``, ``candidate_eff_costs`` and ``increase_delta``
equal the reference's pieces.  ``run_gdba`` and the state converter
equal the reference's.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydcop_tpu.dcop.dcop as jd
import pydcop_tpu.dcop.objects as jo
import pydcop_tpu.dcop.relations as jr
from pydcop_tpu.ops import gdba as J
from pydcop_tpu_torch.engine.convert import (
    localsearch_state_from_numpy,
    localsearch_state_to_numpy,
)
from pydcop_tpu_torch.ops import gdba as T
from test_torch_dba import coloring_csp, dcop_graphs, mixed_graphs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CYCLES = 30

# The sweep's graph: arity 1-3 with a one-factor bucket whose one-row
# update changes the fold's mask (segment_sum.positional_fold), kept
# small: the reference compiles a step per combination.
SWEEP_SIZES = [(2, 30), (1, 1), (3, 25)]

GRAPHS = {
    "sweep_d3": lambda: mixed_graphs(3, n_vars=20, sizes=SWEEP_SIZES),
    "mixed_d3": lambda: mixed_graphs(3),
    "mixed_d2": lambda: mixed_graphs(2, seed=5),
    "mixed_d5_ell": lambda: mixed_graphs(5, "ell", n_vars=20),
    "csp_soft": lambda: dcop_graphs(coloring_csp(jo, jr, jd, 30, seed=1,
                                                 extra_soft=True)),
}

MODES = list(itertools.product("AM", ("NZ", "NM", "MX"), "ERCT"))
CASES = [("sweep_d3",) + m for m in MODES] + [
    ("mixed_d3", "A", "NZ", "E"), ("mixed_d3", "M", "MX", "R"),
    ("mixed_d2", "A", "NZ", "E"), ("mixed_d2", "M", "MX", "C"),
    ("mixed_d5_ell", "A", "NM", "R"), ("mixed_d5_ell", "M", "NZ", "T"),
    ("csp_soft", "A", "NZ", "E"), ("csp_soft", "M", "NM", "R"),
]


def assert_same_gdba(tstate, jstate):
    out = localsearch_state_to_numpy(tstate)
    np.testing.assert_array_equal(out["values"], np.asarray(jstate.values))
    np.testing.assert_array_equal(out["key"],
                                  np.asarray(jstate.key, np.uint32))
    assert out["cycle"] == int(jstate.cycle)
    assert len(out["modifiers"]) == len(jstate.modifiers)
    for a, b in zip(out["modifiers"], jstate.modifiers):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("graph,modifier,violation,increase", CASES)
def test_gdba_state_equals_reference_every_step(graph, modifier, violation,
                                                increase):
    jg, tg, ranks = GRAPHS[graph]()
    jstate = J.init_state(jg, modifier=modifier, seed=2)
    tstate = T.init_state(tg, modifier=modifier, seed=2)
    assert_same_gdba(tstate, jstate)
    minmax = J.factor_min_max(jg)
    t_minmax = T.factor_min_max(tg)
    step = jax.jit(lambda s, g, mm: J.gdba_step(
        s, g, modifier_mode=modifier, violation_mode=violation,
        increase_mode=increase, minmax=mm,
        lexic_ranks=jnp.asarray(ranks)))
    t_ranks = torch.tensor(ranks)
    for _ in range(CYCLES):
        jstate = step(jstate, jg, minmax)
        tstate = T.gdba_step(tstate, tg, modifier_mode=modifier,
                             violation_mode=violation,
                             increase_mode=increase, minmax=t_minmax,
                             lexic_ranks=t_ranks)
        assert_same_gdba(tstate, jstate)
    base = 0.0 if modifier == "A" else 1.0
    assert any(bool((m != base).any()) for m in tstate.modifiers)


def test_pieces_equal_reference():
    jg, tg, _ = mixed_graphs(3)
    for (jmin, jmax), (tmin, tmax) in zip(J.factor_min_max(jg),
                                          T.factor_min_max(tg)):
        np.testing.assert_array_equal(tmin.numpy(), np.asarray(jmin))
        np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))
    rng = np.random.default_rng(4)
    values = np.asarray(J.init_state(jg, seed=3).values)
    mods = [rng.integers(0, 4, size=(b.var_ids.shape[0], b.var_ids.shape[1])
                         + b.costs.shape[1:]).astype(np.float32)
            for b in jg.buckets]
    for mode in "AM":
        ref = jax.jit(lambda g, m, v: J._candidate_eff_costs(
            g, m, v, mode))(jg, mods, values)
        out = T.candidate_eff_costs(tg, [torch.tensor(m) for m in mods],
                                    torch.tensor(values), mode)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    for jb, tb in zip(jg.buckets, tg.buckets):
        mask = rng.random(jb.var_ids.shape[0]) < 0.5
        for p, mode in itertools.product(range(jb.var_ids.shape[1]),
                                         "ERCT"):
            ref = J._increase_delta(jb, values, mask, p, mode)
            out = T.increase_delta(tb, torch.tensor(values),
                                   torch.tensor(mask), p, mode)
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_run_gdba_and_converter_equal_reference():
    jg, tg, ranks = mixed_graphs(3)
    kw = dict(modifier_mode="M", violation_mode="NM", increase_mode="R")
    ref = jax.jit(lambda g: J.run_gdba(
        g, 12, lexic_ranks=jnp.asarray(ranks), seed=6, **kw))(jg)
    values, cost, cycles = T.run_gdba(tg, 12, lexic_ranks=ranks, seed=6,
                                      **kw)
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref[0]))
    assert cycles == int(ref[2]) == 12
    assert cost.dtype == torch.float32
    assert cost.numpy().tobytes() == np.asarray(ref[1]).tobytes()
    step = jax.jit(lambda s, g, mm: J.gdba_step(
        s, g, minmax=mm, lexic_ranks=jnp.asarray(ranks), modifier_mode="A",
        violation_mode="NZ", increase_mode="E"))
    minmax = J.factor_min_max(jg)
    jstate = J.init_state(jg, seed=1)
    for _ in range(4):
        jstate = step(jstate, jg, minmax)
    tstate = localsearch_state_from_numpy(
        "gdba", np.asarray(jstate.values), np.asarray(jstate.key),
        np.asarray(jstate.cycle), device="cpu",
        modifiers=[np.asarray(m) for m in jstate.modifiers])
    assert isinstance(tstate, T.GdbaState)
    assert_same_gdba(tstate, jstate)
    again = localsearch_state_from_numpy(
        "gdba", device="cpu", **localsearch_state_to_numpy(tstate))
    assert_same_gdba(again, jstate)
    t_minmax = T.factor_min_max(tg)
    for _ in range(4):
        jstate = step(jstate, jg, minmax)
        again = T.gdba_step(again, tg, minmax=t_minmax,
                            lexic_ranks=torch.tensor(ranks),
                            modifier_mode="A", violation_mode="NZ",
                            increase_mode="E")
        assert_same_gdba(again, jstate)
