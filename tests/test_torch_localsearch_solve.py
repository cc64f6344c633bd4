"""The local-search solves of the port (``pydcop_tpu_torch.api.solve``
and its CLI) against ``pydcop_tpu.api.solve`` on the CPU.

For dsa (A/B/C, p_mode fixed and arity, stop_cycle), adsa (lockstep and
staggered), dsatuto, mgm (lexic, random), mgm2 (each favor, thresholds),
dba (max_distance, infinity, stop_cycle: accepted and unused), gdba
(modifier, violation and increase modes, stop_cycle unused), mixeddsa
(variants, probabilities, stop_cycle: the run's length, status
FINISHED) and the ``ell`` aggregation, on the repository's fixtures and on a
mixed real-cost problem, the port's solve with ``device="cpu"`` equals
the reference's: the same assignment, cycles, status and cost (the
host's ``solution_cost``, exactly); ``metrics['device_cost']`` is held
at a relative 1e-6 (the port sums in float64, the reference in float32
in XLA's order).  ``python -m pydcop_tpu_torch solve -a <algo> --device
cpu`` prints the same assignment and cost.  The result conventions are
the reference's ``run_device_fn``'s: ``cold_start``, ``warmup_time_s``
and ``compile_time`` 0 with ``warmup=True``; ``schedule``,
``n_classes`` and ``supersteps`` for staggered adsa; a ``device_solve``
span in a traced solve and a ``("device_fn", "run_dsa")`` profiler
entry in a metered one.  The quality checks of the reference's
``tests/unit/test_algorithms_device.py`` (DSA quality, MGM monotone,
MGM2 quality) hold on the port, and so do those of its ``TestDba``,
``TestGdba`` and ``TestMixedDsa``: DBA solves colourable CSPs, stops on
its counters before ``max_cycles`` with the reference's cycle count
(also with an unconstrained variable) and refuses ``objective="max"``;
GDBA and MixedDSA reach the reference's quality.  Without
``device="cpu"`` and without a card, the solve raises.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import pydcop_tpu.dcop.dcop as jd
import pydcop_tpu.dcop.objects as jo
import pydcop_tpu.dcop.relations as jr
import pydcop_tpu_torch.dcop.dcop as td
import pydcop_tpu_torch.dcop.objects as to
import pydcop_tpu_torch.dcop.relations as tr
from pydcop_tpu.api import solve as jax_solve
from pydcop_tpu_torch import dcop_cli
from pydcop_tpu_torch.api import solve
from test_torch_compile import INSTANCES, build_coloring, load_both
from test_torch_dba import coloring_csp
from test_torch_dsa import build_mixed_real


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CASES = [
    ("dsa", {}), ("dsa", {"variant": "A", "seed": 3}),
    ("dsa", {"variant": "C", "p_mode": "arity"}),
    ("dsa", {"probability": 0.3, "stop_cycle": 12}),
    ("dsa", {"aggregation": "ell"}),
    ("adsa", {}), ("adsa", {"schedule": "staggered", "variant": "A"}),
    ("dsatuto", {"seed": 2}),
    ("mgm", {}), ("mgm", {"break_mode": "random", "seed": 1}),
    ("mgm", {"aggregation": "ell"}),
    ("mgm2", {}), ("mgm2", {"favor": "no", "threshold": 0.3}),
    ("mgm2", {"favor": "coordinated", "aggregation": "ell"}),
    ("dba", {}), ("dba", {"max_distance": 5, "seed": 3, "stop_cycle": 7}),
    ("dba", {"infinity": 1, "aggregation": "ell"}),
    ("gdba", {}),
    ("gdba", {"modifier": "M", "violation": "NM", "increase_mode": "R",
              "stop_cycle": 5}),
    ("gdba", {"violation": "MX", "increase_mode": "T",
              "aggregation": "ell"}),
    ("mixeddsa", {}),
    ("mixeddsa", {"variant": "A", "proba_hard": 0.9, "aggregation": "ell"}),
    ("mixeddsa", {"variant": "C", "stop_cycle": 12, "proba_soft": 0.3}),
]

PROBLEMS = ["coloring_12_3.yml", "secp_lamps.yaml", "pref_ring.yaml",
            "mixed_real"]


def load(problem):
    if problem == "mixed_real":
        return (build_mixed_real(jo, jr, jd, 40, seed=6),
                build_mixed_real(to, tr, td, 40, seed=6))
    return load_both(problem)


def assert_same_solve(out, ref):
    assert out["assignment"] == ref["assignment"]
    assert out["cycles"] == ref["cycles"]
    assert out["status"] == ref["status"]
    assert out["cost"] == ref["cost"]
    assert out["violations"] == ref["violations"]
    assert out["metrics"]["device_cost"] == ref["metrics"]["device_cost"]


@pytest.mark.parametrize("problem", PROBLEMS)
@pytest.mark.parametrize("algo,params", CASES)
def test_solve_equals_reference(problem, algo, params):
    jdcop, tdcop = load(problem)
    ref = jax_solve(jdcop, algo, max_cycles=30, algo_params=params)
    out = solve(tdcop, algo, max_cycles=30, algo_params=params,
                device="cpu")
    assert_same_solve(out, ref)
    assert out["metrics"]["cold_start"] is True
    assert out["compile_time"] == out["time"] > 0
    if params.get("schedule") == "staggered":
        for key in ("schedule", "n_classes", "supersteps"):
            assert out["metrics"][key] == ref["metrics"][key]


@pytest.mark.parametrize("algo", ["dsa", "adsa", "dsatuto", "mgm", "mgm2"])
def test_cli_equals_reference(algo):
    jdcop, _ = load_both("coloring_12_3.yml")
    ref = jax_solve(jdcop, algo, max_cycles=20, algo_params={"seed": 4})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dcop_cli.main(["solve", "-a", algo, "-c", "20", "-p",
                            "seed:4", "--device", "cpu",
                            os.path.join(INSTANCES, "coloring_12_3.yml")])
    assert rc == 0
    out = json.loads(buf.getvalue())
    assert out["assignment"] == ref["assignment"]
    assert out["cost"] == ref["cost"]
    assert out["cycle"] == ref["cycles"] == 20
    assert out["status"] == ref["status"]


def test_warm_solve_conventions():
    _, tdcop = load_both("coloring_12_3.yml")
    cold = solve(tdcop, "mgm2", max_cycles=15, device="cpu")
    warm = solve(tdcop, "mgm2", max_cycles=15, warmup=True, device="cpu")
    assert warm["assignment"] == cold["assignment"]
    assert warm["compile_time"] == 0.0
    assert warm["metrics"]["cold_start"] is False
    assert warm["metrics"]["warmup_time_s"] > 0
    assert warm["metrics"]["cycles_per_s"] > 0
    assert warm["metrics"]["device"] == "cpu"


def test_traced_and_metered_solve(tmp_path):
    _, tdcop = load_both("coloring_12_3.yml")
    trace = str(tmp_path / "t.json")
    plain = solve(tdcop, "dsa", max_cycles=10, device="cpu")
    res = solve(tdcop, "dsa", max_cycles=10, device="cpu", trace=trace,
                metrics_file=str(tmp_path / "m.jsonl"))
    assert res["assignment"] == plain["assignment"]
    with open(trace, encoding="utf-8") as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans = [e for e in events if e.get("name") == "device_solve"]
    assert len(spans) == 1 and spans[0]["args"]["warmed"] is False
    entry = res["metrics"]["xla_cost"]
    assert list(entry) == ["('device_fn', 'run_dsa')"]
    assert entry["('device_fn', 'run_dsa')"]["available"] is False


def test_quality_of_the_reference_battery():
    """tests/unit/test_algorithms_device.py's invariants on the port:
    DSA reaches a reasonable cost, MGM is monotone in its budget and
    never worse than its start, MGM2 reaches a reasonable cost."""
    dcop = build_coloring(to, tr, td, 200, seed=1)
    random_cost = solve(dcop, "mgm", max_cycles=0, device="cpu")["cost"]
    dsa = solve(dcop, "dsa", max_cycles=100, device="cpu")["cost"]
    short = solve(dcop, "mgm", max_cycles=5, device="cpu")["cost"]
    long = solve(dcop, "mgm", max_cycles=60, device="cpu")["cost"]
    mgm2 = solve(dcop, "mgm2", max_cycles=100, device="cpu")["cost"]
    assert long <= short <= random_cost
    assert dsa < random_cost / 2 and mgm2 < random_cost / 2


def test_solve_without_a_card_raises():
    _, tdcop = load_both("coloring_12_3.yml")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for algo in ("dsa", "mgm2"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solve(tdcop, algo, max_cycles=5)


def test_seeds_past_32_bits_equal_reference():
    """jax keeps a seed's low 32 bits; so does the port."""
    jdcop, tdcop = load_both("secp_lamps.yaml")
    for seed in (2 ** 32 + 5, 2 ** 40 + 3):
        ref = jax_solve(jdcop, "dsa", max_cycles=10,
                        algo_params={"seed": seed})
        out = solve(tdcop, "dsa", max_cycles=10,
                    algo_params={"seed": seed}, device="cpu")
        assert out["assignment"] == ref["assignment"]
        assert np.isfinite(out["cost"])


@pytest.mark.parametrize("algo", ["dba", "gdba", "mixeddsa"])
def test_breakout_cli_equals_reference(algo):
    jdcop, _ = load_both("coloring_12_3.yml")
    ref = jax_solve(jdcop, algo, max_cycles=20, algo_params={"seed": 4})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dcop_cli.main(["solve", "-a", algo, "-c", "20", "-p",
                            "seed:4", "--device", "cpu",
                            os.path.join(INSTANCES, "coloring_12_3.yml")])
    assert rc == 0
    out = json.loads(buf.getvalue())
    assert out["assignment"] == ref["assignment"]
    assert out["cost"] == ref["cost"]
    assert out["cycle"] == ref["cycles"]
    assert out["status"] == ref["status"]


def csp_both(n_vars, seed, **kw):
    return (coloring_csp(jo, jr, jd, n_vars, seed=seed, **kw),
            coloring_csp(to, tr, td, n_vars, seed=seed, **kw))


@pytest.mark.parametrize("n_vars,seed,params,lonely", [
    (8, 2, {"max_distance": 8}, False),
    (12, 0, {}, False),
    (20, 1, {"seed": 3}, False),
    (20, 5, {"max_distance": 10}, True),
])
def test_dba_stops_on_its_counters_like_the_reference(n_vars, seed, params,
                                                      lonely):
    """The reference's TestDba instances: a colourable CSP is solved
    (cost 0) and the run stops on its counters before max_cycles, at
    the reference's cycle; an unconstrained variable does not stop it
    early."""
    jdcop, tdcop = csp_both(n_vars, seed)
    if lonely:
        jdcop.add_variable(jo.Variable("lonely", jo.Domain("d", "",
                                                           [0, 1, 2])))
        tdcop.add_variable(to.Variable("lonely", to.Domain("d", "",
                                                           [0, 1, 2])))
    ref = jax_solve(jdcop, "dba", max_cycles=400, algo_params=params)
    out = solve(tdcop, "dba", max_cycles=400, algo_params=params,
                device="cpu")
    assert_same_solve(out, ref)
    assert out["cost"] == 0 and out["cycles"] < 400


def test_dba_refuses_max_and_breakout_seeds_past_32_bits():
    _, tdcop = load_both("coloring_12_3.yml")
    tdcop.objective = "max"
    with pytest.raises(ValueError, match="minimization"):
        solve(tdcop, "dba", max_cycles=10, device="cpu")
    jdcop, tdcop = csp_both(20, 1, infinity=float("inf"), extra_soft=True)
    for algo in ("dba", "gdba", "mixeddsa"):
        for seed in (2 ** 40 + 3,):
            ref = jax_solve(jdcop, algo, max_cycles=10,
                            algo_params={"seed": seed})
            out = solve(tdcop, algo, max_cycles=10,
                        algo_params={"seed": seed}, device="cpu")
            assert out["assignment"] == ref["assignment"]
            assert out["cycles"] == ref["cycles"]


def test_breakout_quality_of_the_reference_battery():
    """TestGdba / TestMixedDsa's invariants on the port: no violated
    hard constraint left, and soft quality no worse than the
    reference's solve."""
    jdcop, tdcop = csp_both(12, 30, infinity=float("inf"), extra_soft=True)
    out = solve(tdcop, "mixeddsa", max_cycles=200, device="cpu")
    assert out["violations"] == 0
    assert out["cost"] == jax_solve(jdcop, "mixeddsa",
                                    max_cycles=200)["cost"]
    jdcop, tdcop = load("mixed_real")
    out = solve(tdcop, "gdba", max_cycles=100, device="cpu")
    assert out["violations"] == 0
    assert out["cost"] == jax_solve(jdcop, "gdba", max_cycles=100)["cost"]


def test_breakout_solves_without_a_card_raise():
    _, tdcop = load_both("coloring_12_3.yml")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for algo in ("dba", "gdba", "mixeddsa"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solve(tdcop, algo, max_cycles=5)
