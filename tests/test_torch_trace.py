"""The port's cost-trace run (ops/maxsum.py::run_maxsum_trace and
engine/runner.py::MaxSumEngine.run_trace) against the jitted JAX
reference.

- On integer-cost tables (the reference's own loopy family, and the
  time-to-cost instance of bench.py) the final state, the values and the
  whole cost curve equal the reference's bit for bit, with and without
  stopping at the fixpoint and with and without pruning.  The cost is a
  float sum over the factors and the variables, taken in another order
  than XLA's; on integer tables every order is exact.
- On the fixtures' float tables the engine's curves agree within a
  relative 1e-6 (stated; the sum order differs), and the assignments,
  cycles and convergence are equal.
- Traced and untraced runs agree on ``cycles`` and the assignment; the
  curve's tail holds the final cost after an early stop.
- chip_smoke.py's builder of the time-to-cost instance gives
  bench.py's ``build_ttc_graph`` arrays exactly, and on it the port's
  pruned trace, its dense trace and the reference's pruned trace are
  equal (the first 60 of bench's 160 cycles, D = 128; chip_smoke.py
  runs all 160 on the card and the CPU).
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from pydcop_tpu.algorithms.maxsum import build_engine as jax_build_engine
from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu.ops import maxsum as J
from pydcop_tpu_torch.algorithms.maxsum import build_engine
from pydcop_tpu_torch.device import to_device_graph
from pydcop_tpu_torch.engine.compile import compile_dcop as torch_compile
from pydcop_tpu_torch.engine.convert import graph_from_numpy, state_to_numpy
from pydcop_tpu_torch.ops import maxsum as T
from test_torch_compile import load_both
from test_torch_prune import FIELDS, KW, loopy_both


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


def _same_state(tstate, jstate):
    tn = state_to_numpy(tstate)
    for field in FIELDS:
        for a, b in zip(getattr(jstate, field), tn[field]):
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=field)
    assert tn["stable"] == bool(jstate.stable)
    assert tn["cycle"] == int(jstate.cycle)


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("stop", [True, False])
def test_run_maxsum_trace_equals_jax(stop, prune):
    jax_dcop, torch_dcop = loopy_both(d=32, seed=0, unary="variables")
    g, meta = jax_compile(jax_dcop, noise_level=0.0, use_cache=False)
    tg, tmeta = torch_compile(torch_dcop, noise_level=0.0, use_cache=False)
    tg = to_device_graph(tg, "cpu")
    base = meta.var_base_costs
    run = jax.jit(partial(J.run_maxsum_trace, max_cycles=CYCLES,
                          var_base_costs=base, stop_on_convergence=stop,
                          prune=prune, **KW))
    jstate, jvals, jcosts = run(g)
    tstate, tvals, tcosts = T.run_maxsum_trace(
        tg, CYCLES, var_base_costs=torch.from_numpy(
            tmeta.var_base_costs), stop_on_convergence=stop, prune=prune,
        **KW)
    _same_state(tstate, jstate)
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))
    assert tcosts.shape == (CYCLES,) and tcosts.dtype == torch.float32
    np.testing.assert_array_equal(tcosts.numpy(), np.asarray(jcosts))
    if stop:
        n = int(tstate.cycle)
        assert n < CYCLES and (tcosts[n:] == tcosts[n - 1]).all()


@pytest.mark.parametrize("stop", [True, False])
def test_engine_run_trace_equals_jax_on_integer_tables(stop):
    jax_dcop, torch_dcop = loopy_both(d=16, seed=2)
    ref = jax_build_engine(jax_dcop, {"prune": True}).run_trace(
        CYCLES, stop_on_convergence=stop)
    out = build_engine(torch_dcop, {"prune": True}, device="cpu").run_trace(
        CYCLES, stop_on_convergence=stop)
    assert out.assignment == ref.assignment
    assert (out.cycles, out.converged) == (ref.cycles, ref.converged)
    np.testing.assert_array_equal(out.metrics["cost_trace"],
                                  ref.metrics["cost_trace"])
    assert out.metrics["cost_trace"].dtype == ref.metrics["cost_trace"].dtype


@pytest.mark.parametrize("fixture", ["coloring_12_3.yml", "loft_scene.yml",
                                     "pref_ring_max.yaml",
                                     "coloring_int_costs.yaml"])
def test_engine_run_trace_on_fixtures(fixture):
    """Float tables: the curve within a relative 1e-6 (another sum
    order); the objective's sign and the folded constant as the
    reference applies them."""
    jax_dcop, torch_dcop = load_both(fixture)
    ref = jax_build_engine(jax_dcop, {}).run_trace(80)
    out = build_engine(torch_dcop, {}, device="cpu").run_trace(80)
    assert out.assignment == ref.assignment
    assert (out.cycles, out.converged) == (ref.cycles, ref.converged)
    np.testing.assert_allclose(out.metrics["cost_trace"],
                               ref.metrics["cost_trace"], rtol=1e-6)
    final, _ = torch_dcop.solution_cost(out.assignment)
    assert out.metrics["cost_trace"][-1] == pytest.approx(final, rel=1e-6)


def test_traced_and_untraced_runs_agree():
    _, torch_dcop = loopy_both(d=16, seed=2)
    run = build_engine(torch_dcop, {}, device="cpu").run(max_cycles=400)
    trace = build_engine(torch_dcop, {}, device="cpu").run_trace(400)
    assert run.cycles < 400, "the agreement would be vacuous"
    assert trace.cycles == run.cycles
    assert trace.assignment == run.assignment
    costs = trace.metrics["cost_trace"]
    assert len(costs) == 400
    assert (costs[run.cycles:] == costs[run.cycles - 1]).all()


def test_ttc_builder_equals_bench():
    var_costs, var_valid, buckets = chip_smoke.ttc_arrays(
        chip_smoke.TTC_VARS)
    ref = bench.build_ttc_graph(chip_smoke.TTC_SEED)
    np.testing.assert_array_equal(var_costs, ref.var_costs)
    np.testing.assert_array_equal(var_valid, ref.var_valid)
    assert len(ref.buckets) == len(buckets) == 1
    np.testing.assert_array_equal(buckets[0][0], ref.buckets[0].costs)
    np.testing.assert_array_equal(buckets[0][1], ref.buckets[0].var_ids)
    assert (bench.TTC_N_VARS, bench.TTC_DOMAIN, bench.TTC_CYCLES) == (
        chip_smoke.TTC_VARS, chip_smoke.TTC_DOMAIN, chip_smoke.TTC_CYCLES)


def test_ttc_pruned_trace_equals_dense_and_jax():
    """bench_time_to_cost's run: a fixed budget, no convergence stop."""
    cycles = 60
    g = bench.build_ttc_graph(chip_smoke.TTC_SEED)
    tg = graph_from_numpy(*chip_smoke.ttc_arrays(chip_smoke.TTC_VARS),
                          device="cpu")
    runs = {}
    for prune in (True, False):
        stats = {}
        runs[prune] = T.run_maxsum_trace(
            tg, cycles, stop_on_convergence=False, prune=prune,
            stats=stats, **KW) + (stats,)
    jstate, jvals, jcosts = jax.jit(partial(
        J.run_maxsum_trace, max_cycles=cycles, stop_on_convergence=False,
        prune=True))(g)
    for state, values, costs, _ in runs.values():
        _same_state(state, jstate)
        np.testing.assert_array_equal(values.numpy(), np.asarray(jvals))
        np.testing.assert_array_equal(costs.numpy(), np.asarray(jcosts))
    fast = runs[True][3]["prune_fast_cycles"]
    assert runs[False][3]["prune_fast_cycles"] == 0
    assert 0 < fast < cycles
