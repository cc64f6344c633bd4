"""Generated problems solved by the port against the reference, on the
CPU.

- The port solves the port's generated problem and the reference solves
  its own (``test_torch_generators.py`` holds the two DCOPs' YAML
  equal): ``maxsum``, ``dsa`` and ``mgm`` give the same assignment, cost,
  violations, cycles and status on SECP (arities 1-4, intentional
  constraints), on Ising (binary and unary tables of real costs) and,
  with MaxSum, on the other families the card's ``generated`` phase
  solves, cut to size.  The two packages' compiled arrays are equal
  too.
- The local search's positional sum with a one-factor bucket at V + 1
  above 301 (ROADMAP Queue C's unprobed case): generated SECP problems
  of 321 and 401 variables whose arity-3 or arity-4 bucket holds one
  factor, stepped state by state through DSA (A, B, C) and MGM, with
  every candidate cost held bit for bit, then solved through
  ``api.solve``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydcop_tpu.api import solve as jax_solve
from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu.generators import graphcoloring as jgc
from pydcop_tpu.generators import iot as jiot
from pydcop_tpu.generators import ising as jising
from pydcop_tpu.generators import meetingscheduling as jmeet
from pydcop_tpu.generators import secp as jsecp
from pydcop_tpu.generators import smallworld as jsw
from pydcop_tpu.ops import dsa as JD
from pydcop_tpu.ops import localsearch as JL
from pydcop_tpu.ops import mgm as JM
from pydcop_tpu_torch.api import solve
from pydcop_tpu_torch.engine.compile import compile_dcop
from pydcop_tpu_torch.generators import graphcoloring as tgc
from pydcop_tpu_torch.generators import iot as tiot
from pydcop_tpu_torch.generators import ising as tising
from pydcop_tpu_torch.generators import meetingscheduling as tmeet
from pydcop_tpu_torch.generators import secp as tsecp
from pydcop_tpu_torch.generators import smallworld as tsw
from pydcop_tpu_torch.ops import dsa as TD
from pydcop_tpu_torch.ops import localsearch as TL
from pydcop_tpu_torch.ops import mgm as TM
from test_torch_dsa import assert_same_state
from test_torch_localsearch import bits_equal, both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PROBLEMS = {
    "secp": (jsecp.generate_secp, tsecp.generate_secp, (40, 10, 10),
             {"seed": 0}),
    "secp_wide": (jsecp.generate_secp, tsecp.generate_secp, (60, 12, 20),
                  {"max_model_size": 3, "max_rule_size": 3, "seed": 5}),
    "ising": (lambda *a, **k: jising.generate_ising(*a, **k)[0],
              lambda *a, **k: tising.generate_ising(*a, **k)[0], (6,),
              {"seed": 0}),
    "ising_rect": (lambda *a, **k: jising.generate_ising(*a, **k)[0],
                   lambda *a, **k: tising.generate_ising(*a, **k)[0],
                   (4, 7), {"bin_range": 2.0, "seed": 3}),
    "coloring": (jgc.generate_graph_coloring, tgc.generate_graph_coloring,
                 (200, 3, "scalefree"), {"soft": True, "m_edge": 2,
                                         "seed": 0}),
    "meetings": (jmeet.generate_meetings, tmeet.generate_meetings,
                 (10, 20, 10, 4), {"seed": 0}),
    "iot": (jiot.generate_iot, tiot.generate_iot, (150,), {"seed": 0}),
    "small_world": (jsw.generate_small_world, tsw.generate_small_world,
                    (100,), {"seed": 0}),
}


def generated(name):
    ref_gen, port_gen, args, kwargs = PROBLEMS[name]
    return ref_gen(*args, **kwargs), port_gen(*args, **kwargs)


def assert_same_solve(out, ref, local_search):
    assert out["assignment"] == ref["assignment"]
    assert out["cycles"] == ref["cycles"]
    assert out["status"] == ref["status"]
    assert out["cost"] == ref["cost"]
    assert out["violations"] == ref["violations"]
    if local_search:
        assert out["metrics"]["device_cost"] == ref["metrics"][
            "device_cost"]


def assert_same_compile(jdcop, tdcop):
    jg, _ = jax_compile(jdcop)
    tg, _ = compile_dcop(tdcop)
    np.testing.assert_array_equal(tg.var_costs, jg.var_costs)
    np.testing.assert_array_equal(tg.var_valid, jg.var_valid)
    assert len(tg.buckets) == len(jg.buckets)
    for tb, jb in zip(tg.buckets, jg.buckets):
        np.testing.assert_array_equal(tb.costs, jb.costs)
        np.testing.assert_array_equal(tb.var_ids, jb.var_ids)
    return tg


@pytest.mark.parametrize("algo,params,cycles", [
    ("maxsum", {}, 60), ("dsa", {}, 60), ("mgm", {}, 60),
])
@pytest.mark.parametrize("name", ["secp", "secp_wide", "ising"])
def test_generated_solve_equals_the_reference(name, algo, params, cycles):
    jdcop, tdcop = generated(name)
    assert_same_compile(jdcop, tdcop)
    ref = jax_solve(jdcop, algo, max_cycles=cycles, algo_params=params)
    out = solve(tdcop, algo, max_cycles=cycles, algo_params=params,
                device="cpu")
    assert_same_solve(out, ref, algo != "maxsum")


@pytest.mark.parametrize("name,algo,params", [
    ("coloring", "maxsum", {}), ("meetings", "maxsum", {}),
    ("iot", "maxsum", {}), ("small_world", "maxsum", {}),
    ("secp", "dsa", {"variant": "C", "seed": 3}),
    ("ising", "mgm", {"break_mode": "random", "seed": 1}),
    ("ising_rect", "maxsum", {}),
])
def test_other_generated_solves_equal_the_reference(name, algo, params):
    jdcop, tdcop = generated(name)
    assert_same_compile(jdcop, tdcop)
    ref = jax_solve(jdcop, algo, max_cycles=40, algo_params=params)
    out = solve(tdcop, algo, max_cycles=40, algo_params=params,
                device="cpu")
    assert_same_solve(out, ref, algo != "maxsum")


# -- ROADMAP Queue C: one-factor buckets at V + 1 above 301 ------------ #

ONE_FACTOR_PROBLEMS = {
    # One model of two lights: the arity-3 bucket holds one factor.
    "arity3": ((320, 1, 40), {"max_model_size": 2, "max_rule_size": 2,
                              "seed": 0}),
    # One model of three lights: the arity-4 bucket holds one factor.
    "arity4": ((400, 1, 60), {"max_model_size": 3, "max_rule_size": 2,
                              "seed": 0}),
}
CYCLES = 40
CANDIDATE_COSTS = jax.jit(JL.candidate_costs)


def one_factor_graphs(name, aggregation="scatter"):
    """Both packages' graphs of the port's generated problem; asserts
    the one-factor bucket the probe is about."""
    args, kwargs = ONE_FACTOR_PROBLEMS[name]
    jdcop = jsecp.generate_secp(*args, **kwargs)
    tdcop = tsecp.generate_secp(*args, **kwargs)
    compiled = assert_same_compile(jdcop, tdcop)
    n_rows = compiled.var_costs.shape[0]
    assert n_rows >= len(tdcop.variables) + 1 > 301
    sizes = [b.costs.shape[0] for b in compiled.buckets]
    assert 1 in sizes, sizes
    assert sizes.index(1) == len(sizes) - 1
    buckets = [(b.costs, b.var_ids) for b in compiled.buckets]
    jg, tg = both(compiled.var_costs, compiled.var_valid, buckets,
                  aggregation)
    return jdcop, tdcop, jg, tg


@pytest.mark.parametrize("aggregation", ["scatter", "ell"])
@pytest.mark.parametrize("name", list(ONE_FACTOR_PROBLEMS))
def test_one_factor_candidate_costs_above_301_rows(name, aggregation):
    _, _, jg, tg = one_factor_graphs(name, aggregation)
    rng = np.random.default_rng(7)
    valid = np.asarray(jg.var_valid)
    for _ in range(3):
        values = np.array([rng.integers(max(int(row.sum()), 1))
                           for row in valid], dtype=np.int32)
        bits_equal(TL.candidate_costs(tg, torch.tensor(values)).numpy(),
                   CANDIDATE_COSTS(jg, values))


@pytest.mark.parametrize("variant", ["A", "B", "C"])
@pytest.mark.parametrize("name", list(ONE_FACTOR_PROBLEMS))
def test_one_factor_dsa_above_301_rows_every_step(name, variant):
    _, _, jg, tg = one_factor_graphs(name)
    jstate, tstate = JD.init_state(jg, 3), TD.init_state(tg, 3)
    step = jax.jit(lambda s, g: JD.dsa_step(s, g, variant=variant,
                                            probability=0.7))
    moved = 0
    for _ in range(CYCLES):
        before = tstate.values.clone()
        jstate = step(jstate, jg)
        tstate = TD.dsa_step(tstate, tg, variant=variant, probability=0.7)
        assert_same_state(tstate, jstate)
        moved += int((tstate.values != before).sum())
    assert moved > 0


@pytest.mark.parametrize("name", list(ONE_FACTOR_PROBLEMS))
def test_one_factor_mgm_above_301_rows_every_step(name):
    _, _, jg, tg = one_factor_graphs(name)
    ranks = np.arange(jg.var_costs.shape[0], dtype=np.float32)
    ranks[-1] = np.inf
    jstate, tstate = JM.init_state(jg, 5), TM.init_state(tg, 5)
    step = jax.jit(lambda s, g: JM.mgm_step(
        s, g, lexic_ranks=jnp.asarray(ranks), break_mode="lexic"))
    for _ in range(CYCLES):
        jstate = step(jstate, jg)
        tstate = TM.mgm_step(tstate, tg, lexic_ranks=torch.tensor(ranks),
                             break_mode="lexic")
        assert_same_state(tstate, jstate)


@pytest.mark.parametrize("algo", ["dsa", "mgm"])
@pytest.mark.parametrize("name", list(ONE_FACTOR_PROBLEMS))
def test_one_factor_solve_above_301_rows(name, algo):
    jdcop, tdcop, _, _ = one_factor_graphs(name)
    ref = jax_solve(jdcop, algo, max_cycles=CYCLES)
    out = solve(tdcop, algo, max_cycles=CYCLES, device="cpu")
    assert_same_solve(out, ref, True)
