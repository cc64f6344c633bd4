"""The port's decimation (``DecimationPlan``, ``_DecimationRun``,
``run_checkpointed(decimation=...)``, ``run_decimated``), its routing
through ``api.solve`` and the CLI, and the ``amaxsum`` /
``maxsum_dynamic`` delegations, against ``pydcop_tpu`` on the CPU.
Mirrors the reference's ``tests/api/test_decimation.py`` and the
decimation tests of ``tests/unit/test_workreduction_battery.py``, each
run compared with the reference's on the same instance (built by each
package from its own objects).

Tolerance: none.  Assignments, costs, cycles, status, the decimation
metrics and (where snapshots are written) every final message and
clamp: the last snapshot's content checksum.
"""

import json
import os
import subprocess
import sys

import jax  # noqa: F401  (imported first: JAX stays on the CPU)
import numpy as np
import pytest
import torch

import pydcop_tpu.dcop.dcop as jd
import pydcop_tpu.dcop.objects as jo
import pydcop_tpu.dcop.relations as jr
import pydcop_tpu.resilience.checkpoint as jck
import pydcop_tpu.resilience.recovery as jrec
import pydcop_tpu_torch.dcop.dcop as td
import pydcop_tpu_torch.dcop.objects as to
import pydcop_tpu_torch.dcop.relations as tr
import pydcop_tpu_torch.resilience.checkpoint as tck
import pydcop_tpu_torch.resilience.recovery as trec
from pydcop_tpu.api import solve as jax_solve
from pydcop_tpu.engine.runner import DecimationPlan as JaxPlan
from pydcop_tpu.engine.runner import (
    decimation_template as jax_decimation_template,
)
from pydcop_tpu_torch.algorithms.maxsum import decimation_plan_from_params
from pydcop_tpu_torch.api import solve
from pydcop_tpu_torch.engine.runner import (
    DecimationPlan,
    DecimationState,
    decimation_template,
)
from test_torch_checkpoint import (
    REPO,
    assert_same_run,
    checksum,
    coloring_both,
    engines,
    managers,
)
from test_torch_compile import load_both

DECIM_KEYS = ("decimated_vars", "decimated_fraction", "active_edges",
              "decimation_rounds", "decimation_rollbacks", "segments",
              "segment_cycles", "checkpoints_written", "interrupted")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def loopy_both(n, seed):
    """The reference's ``loopy_coloring`` (tests/api/test_decimation.py:
    the same construction at density 2.2) in each package."""
    return coloring_both(n=n, seed=seed, density=2.2)


def assert_same_solve(ref, out, metric_keys=DECIM_KEYS):
    for key in ("assignment", "cost", "violations", "cycles", "status"):
        assert out[key] == ref[key], key
    assert set(out) == set(ref)
    for key in metric_keys:
        if key in ref["metrics"]:
            assert out["metrics"][key] == ref["metrics"][key], key


@pytest.mark.parametrize("instance,params", [
    ((150, 1, 2.2), {"decimation": 10}),
    ((150, 1, 2.2), {"decimation_margin": 0.005}),
    ((150, 1, 2.2), {"decimation": 10, "decimation_margin": 0.005}),
    ((150, 1, 2.2), {"decimation": 0}),
    # Clamped problems whose messages decay into the subnormal range,
    # where the reference flushes them to zero.
    ((36, 1, 1.6), {"decimation_margin": 0.005}),
    ((36, 1, 1.6), {"decimation": 10, "decimation_margin": 0.005}),
])
def test_decimated_solve_equals_jax(instance, params):
    """Classic schedule, threshold mode, both together (threshold capped
    at 10 % a round) and ``decimation:0`` (the plain path)."""
    n, seed, density = instance
    jdcop, tdcop = coloring_both(n=n, seed=seed, density=density)
    ref = jax_solve(jdcop, "maxsum", max_cycles=600, algo_params=params)
    out = solve(tdcop, "maxsum", max_cycles=600, algo_params=params,
                device="cpu")
    assert_same_solve(ref, out)
    if params.get("decimation_margin"):
        assert 0 < out["metrics"]["decimated_vars"]
    elif params.get("decimation"):
        assert out["metrics"]["decimated_vars"] == n
        assert out["status"] == "FINISHED"
    else:
        assert "decimated_vars" not in out["metrics"]
        plain = solve(tdcop, "maxsum", max_cycles=600, device="cpu")
        assert (out["assignment"], out["cost"]) == (plain["assignment"],
                                                    plain["cost"])


def test_decimation_fixes_every_variable_like_jax():
    jdcop, tdcop = loopy_both(40, seed=0)
    ref = jax_solve(jdcop, "maxsum", max_cycles=2000,
                    algo_params={"decimation": 20})
    out = solve(tdcop, "maxsum", max_cycles=2000,
                algo_params={"decimation": 20}, device="cpu")
    assert_same_solve(ref, out)
    assert out["status"] == "FINISHED"
    assert out["metrics"]["decimated_vars"] == 40
    assert out["metrics"]["active_edges"] == 0
    assert len(out["assignment"]) == 40


def _tree(objects, relations, dcop_mod):
    rng = np.random.default_rng(5)
    dom = objects.Domain("d", "", [0, 1, 2])
    dcop = dcop_mod.DCOP("tree", objective="min")
    vs = [objects.Variable(f"v{i}", dom) for i in range(30)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(1, 30):
        j = int(rng.integers(0, i))
        table = rng.integers(0, 9, size=(3, 3)).astype(float)
        dcop.add_constraint(
            relations.NAryMatrixRelation([vs[j], vs[i]], table, f"c{i}"))
    dcop.add_agents([objects.AgentDef("a0")])
    return dcop


def test_decimation_on_a_tree_equals_jax_and_the_optimum():
    """On a tree BP is exact and clamping keeps the optimum (the
    reference's DPOP cost)."""
    params = {"decimation": 10, "stability": 1e-6, "noise": 0.001}
    jdcop, tdcop = _tree(jo, jr, jd), _tree(to, tr, td)
    exact = jax_solve(jdcop, "dpop")
    ref = jax_solve(jdcop, "maxsum", max_cycles=3000, algo_params=params)
    out = solve(tdcop, "maxsum", max_cycles=3000, algo_params=params,
                device="cpu")
    assert_same_solve(ref, out)
    assert out["cost"] == pytest.approx(exact["cost"], abs=1e-4)


def test_anytime_probe_and_final_cost_equal_jax():
    """The work-reduction battery's decimated colouring with a probe at
    every segment: the same per-segment costs as the reference, every
    variable clamped, ``active_edges`` down to 0."""
    jdcop, tdcop = coloring_both()
    jeng, teng = engines((jdcop, tdcop))
    costs = {"jax": [], "torch": []}

    def probe(label, dcop):
        class CostProbe:
            def on_segment(self, state, values, run_s, compile_s):
                vals = np.asarray(values)
                asg = {f"v{i}": int(vals[i]) for i in range(len(vals))}
                costs[label].append(dcop.solution_cost(asg)[0])
        return CostProbe()

    kw = dict(max_cycles=1500, segment_cycles=25)
    ref = jeng.run_checkpointed(
        decimation=JaxPlan(frac_per_round=0.2, cycles_per_round=25),
        probe=probe("jax", jdcop), **kw)
    out = teng.run_checkpointed(
        decimation=DecimationPlan(frac_per_round=0.2, cycles_per_round=25),
        probe=probe("torch", tdcop), **kw)
    assert_same_run(ref, out)
    assert costs["torch"] == costs["jax"] and costs["torch"]
    assert out.converged
    assert out.metrics["decimated_fraction"] == 1.0
    assert out.metrics["active_edges"] == 0
    assert out.metrics["decimation_rounds"] >= 2
    final_cost, _ = tdcop.solution_cost(out.assignment)
    assert final_cost <= min(costs["torch"]) + 1


def test_resume_mid_decimation_equals_uninterrupted_and_jax(tmp_path):
    """Stopped after 3 rounds and resumed by a fresh engine: the
    uninterrupted run, and the reference's, to the last message and
    clamp."""
    from pydcop_tpu_torch.algorithms.maxsum import build_engine

    jdcop, tdcop = coloring_both(seed=6)
    tplan = DecimationPlan(frac_per_round=0.25, cycles_per_round=20)
    jplan = JaxPlan(frac_per_round=0.25, cycles_per_round=20)
    kw = dict(max_cycles=1500, segment_cycles=20)
    jfull, tfull = managers(tmp_path / "full", 20)
    jeng, teng = engines((jdcop, tdcop))
    full = teng.run_checkpointed(decimation=tplan, manager=tfull, **kw)
    jref = jeng.run_checkpointed(decimation=jplan, manager=jfull, **kw)
    assert_same_run(jref, full)
    jpart, tpart = managers(tmp_path / "part", 20)
    part = build_engine(tdcop, {}, device="cpu").run_checkpointed(
        decimation=tplan, manager=tpart, max_segments=3, **kw)
    assert part.metrics["interrupted"]
    assert 0 < part.metrics["decimated_vars"] < len(tdcop.variables)
    resumed = tck.resume_from_checkpoint(
        build_engine(tdcop, {}, device="cpu"), tpart, decimation=tplan,
        **kw)
    assert resumed.metrics["resumed_from_cycle"] == 60
    assert (resumed.assignment, resumed.cycles) == (full.assignment,
                                                    full.cycles)
    assert resumed.metrics["decimated_vars"] == full.metrics[
        "decimated_vars"]
    assert checksum(tpart.latest()) == checksum(tfull.latest()) == \
        checksum(jfull.latest())
    # The snapshot's clamp set is the port's own, in the reference's
    # dtypes: bool mask, float32 table.
    state, _ = tck.load_state(tpart.latest(), decimation_template(
        teng, teng.init_state()))
    assert isinstance(state, DecimationState)
    assert state.fixed.dtype == np.bool_ and state.fixed.all()
    assert state.var_costs.dtype == np.float32
    jstate, _ = jck.load_state(tpart.latest(), jax_decimation_template(
        jeng, jeng.init_state()))
    assert np.array_equal(np.asarray(jstate.fixed), state.fixed)


def test_trip_on_the_first_segment_rolls_the_clamp_set_back():
    """A trip on the very first segment rolls back to the empty clamp
    set (the initial retain carries it), as in the reference."""
    jeng, teng = engines(coloring_both(seed=11))
    kw = dict(max_cycles=900, segment_cycles=15)
    ref = jeng.run_checkpointed(
        decimation=JaxPlan(frac_per_round=0.25, cycles_per_round=15),
        recovery=jrec.RecoveryPolicy(trip_cycles=(1,)), **kw)
    out = teng.run_checkpointed(
        decimation=DecimationPlan(frac_per_round=0.25,
                                  cycles_per_round=15),
        recovery=trec.RecoveryPolicy(trip_cycles=(1,)), **kw)
    assert_same_run(ref, out)
    assert out.metrics["guard_trips"] == 1
    assert out.metrics["decimation_rollbacks"] == 1
    assert out.metrics["decimated_vars"] == 36


def test_resume_without_plan_is_refused():
    _, teng = engines(coloring_both(seed=9))
    fake = DecimationState(
        solver=teng.init_state(),
        fixed=np.zeros(36, bool),
        var_costs=teng.graph.var_costs.numpy().copy())
    with pytest.raises(ValueError, match="clamp set"):
        teng.run_checkpointed(max_cycles=50, initial_state=fake)


def test_clamp_replaces_var_costs_and_never_writes_in_place():
    """A clamp hands the loop a fresh var_costs tensor; the engine's own
    table, shared with every later run, keeps its values."""
    _, teng = engines(coloring_both(seed=2))
    before = teng.graph.var_costs.clone()
    res = teng.run_checkpointed(
        max_cycles=300, segment_cycles=20,
        decimation=DecimationPlan(frac_per_round=0.5, cycles_per_round=20))
    assert res.metrics["decimated_vars"] == 36
    assert torch.equal(teng.graph.var_costs, before)
    again = teng.run(max_cycles=100)
    assert again.assignment == engines(coloring_both(seed=2))[1].run(
        max_cycles=100).assignment


@pytest.mark.parametrize("frac,per_round", [(0.1, 60), (0.3, 25)])
def test_run_decimated_equals_jax(frac, per_round):
    jeng, teng = engines(coloring_both(n=60, seed=3))
    ref = jeng.run_decimated(max_cycles=2000, frac=frac,
                             cycles_per_round=per_round)
    out = teng.run_decimated(max_cycles=2000, frac=frac,
                             cycles_per_round=per_round)
    assert_same_run(ref, out)
    assert out.converged and out.metrics["decimated_vars"] == 60


def test_decimation_plan_from_params_equals_jax():
    from pydcop_tpu.algorithms.maxsum import (
        decimation_plan_from_params as jax_plan,
    )

    for params in ({}, {"decimation": 0}, {"decimation": 10},
                   {"decimation_margin": 0.5},
                   {"decimation": 5, "decimation_margin": 0.1}):
        ref, out = jax_plan(params), decimation_plan_from_params(params)
        assert (out is None) == (ref is None)
        if out is not None:
            assert (out.margin, out.frac_per_round, out.force_progress,
                    out.cycles_per_round) == (
                ref.margin, ref.frac_per_round, ref.force_progress,
                ref.cycles_per_round)


# ------------------------------------------------------------------ #
# the delegating algorithms


EXTERNAL_YAML = """
name: dyn
objective: min
domains:
  c: {values: [0, 1, 2]}
variables:
  x: {domain: c}
  y: {domain: c}
  z: {domain: c}
external_variables:
  s: {domain: c, initial_value: 1}
constraints:
  xy: {type: intention, function: 5 if x == y else 0}
  yz: {type: intention, function: 5 if y == z else 0}
  xs: {type: intention, function: 3 if x == s else x}
  zs: {type: intention, function: 2 * abs(z - s)}
agents: [a1, a2, a3]
"""


@pytest.mark.parametrize("algo,source,params", [
    ("amaxsum", "coloring_12_3.yml", {}),
    ("amaxsum", "loft_scene.yml", {"decimation": 20}),
    ("maxsum_dynamic", "coloring_12_3.yml", {}),
    ("maxsum_dynamic", EXTERNAL_YAML, {}),
    ("maxsum_dynamic", EXTERNAL_YAML, {"damping": 0.7}),
])
def test_delegating_algorithms_solve_like_jax(algo, source, params):
    jdcop, tdcop = load_both(source)
    ref = jax_solve(jdcop, algo, max_cycles=100, algo_params=params)
    out = solve(tdcop, algo, max_cycles=100, algo_params=params,
                device="cpu")
    assert_same_solve(ref, out)
    maxsum = solve(tdcop, "maxsum", max_cycles=100, algo_params=params,
                   device="cpu") if algo == "amaxsum" else None
    if maxsum is not None:
        assert (out["assignment"], out["cost"]) == (maxsum["assignment"],
                                                    maxsum["cost"])


def test_delegating_algorithms_have_no_segmentable_engine(tmp_path):
    """As in the reference, checkpointing needs the algorithm's own
    ``build_engine``, which only maxsum declares."""
    _, tdcop = load_both("coloring_12_3.yml")
    for algo in ("amaxsum", "maxsum_dynamic"):
        with pytest.raises(NotImplementedError, match="segmentable"):
            solve(tdcop, algo, max_cycles=10, device="cpu",
                  checkpoint_dir=str(tmp_path))


def test_delegating_algorithms_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    _, tdcop = load_both("coloring_12_3.yml")
    for algo in ("amaxsum", "maxsum_dynamic"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            solve(tdcop, algo, max_cycles=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(tdcop, "maxsum", max_cycles=10,
              algo_params={"decimation": 10})


def test_cli_decimated_checkpointed_solve(tmp_path):
    """The README's example: ``-p decimation:10 --checkpoint_dir``."""
    path = os.path.join(REPO, "tests", "instances", "coloring_12_3.yml")
    env = dict(os.environ, PYTHONPATH=REPO)
    ck = str(tmp_path / "ck")
    proc = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a", "maxsum",
         "-c", "300", "-p", "decimation:10", "--checkpoint_dir", ck,
         "--device", "cpu", path],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    ref = jax_solve(load_both("coloring_12_3.yml")[0], "maxsum",
                    max_cycles=300, algo_params={"decimation": 10},
                    checkpoint_dir=str(tmp_path / "j"))
    assert out["assignment"] == ref["assignment"]
    assert (out["cost"], out["cycle"], out["status"]) == (
        ref["cost"], ref["cycles"], ref["status"])
    assert checksum(os.path.join(ck, f"ckpt_{out['cycle']}.npz")) == \
        checksum(os.path.join(str(tmp_path / "j"),
                              f"ckpt_{ref['cycles']}.npz"))
