"""The port's solve entry points against pydcop_tpu.api.solve on the CPU:
the same assignment, cost, cycles and status on the named fixtures and
on a 300-variable instance built like bench.py's flagship problem, with
the default options and with pruning, the sorted and ell aggregations
and ``aggregation="auto"`` (measured, and replayed from a stored
decision); the CLI in a subprocess, its per-cycle metrics CSV holding
the JAX engine's cost trace; and the device rule (no silent CPU
fallback).  The options the port does not run yet still raise (the
lane layout runs: ``tests/test_torch_maxsum_lane.py``).
"""

import csv
import json
import os
import subprocess
import sys

import jax  # noqa: F401  (imported first: JAX stays on the CPU)
import pytest
import torch

from pydcop_tpu.algorithms.maxsum import build_engine as jax_build_engine
from pydcop_tpu.api import solve as jax_solve
from pydcop_tpu_torch.algorithms.maxsum import build_engine
from pydcop_tpu_torch.api import solve as torch_solve
from test_torch_compile import INSTANCES, build_coloring_both, load_both
from test_torch_prune import loopy_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_result(jax_dcop, torch_dcop, max_cycles, **params):
    ref = jax_solve(jax_dcop, "maxsum", max_cycles=max_cycles,
                    algo_params=params or None)
    out = torch_solve(torch_dcop, "maxsum", max_cycles=max_cycles,
                      algo_params=params or None, device="cpu")
    for key in ("assignment", "cost", "violations", "cycles", "status"):
        assert out[key] == ref[key], key
    assert set(out) == set(ref)
    assert out["backend"] == "device"
    return out


@pytest.mark.parametrize("fixture,max_cycles", [
    ("coloring_12_3.yml", 60),
    ("coloring_chain.yaml", 100),
    ("coloring_int_costs.yaml", 100),
    ("pref_ring_max.yaml", 100),
    ("loft_scene.yml", 100),
])
def test_fixture_solves_identically(fixture, max_cycles):
    out = _assert_same_result(*load_both(fixture), max_cycles)
    if fixture == "coloring_12_3.yml":
        assert out["cost"] == 5000.0


def test_params_pass_through():
    _assert_same_result(*load_both("coloring_12_3.yml"), 80,
                        damping="0.7", damping_nodes="vars",
                        stability="0.05", noise="0.02")


def test_bench_style_instance_solves_identically():
    _assert_same_result(*build_coloring_both(300), 200)


def test_cli_solve_on_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    path = os.path.join(INSTANCES, "coloring_12_3.yml")
    proc = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "--algo",
         "maxsum", "-c", "60", "--device", "cpu", path],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout)
    ref = jax_solve(load_both("coloring_12_3.yml")[0], "maxsum",
                    max_cycles=60)
    assert result["cost"] == 5000.0 == ref["cost"]
    assert result["assignment"] == ref["assignment"]
    assert result["cycle"] == ref["cycles"] == 60
    assert result["status"] == ref["status"]
    assert set(result) == {"status", "assignment", "cost", "violation",
                           "time", "msg_count", "msg_size", "cycle",
                           "compile_time", "backend"}


def test_default_device_is_cuda_and_never_falls_back():
    """With no ``device`` argument the port runs on the card; on a host
    without one it raises instead of quietly using the CPU."""
    dcop = load_both("coloring_chain.yaml")[1]
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_solve(dcop, "maxsum", max_cycles=10)


@pytest.mark.parametrize("params,kw", [
    ({}, {"n_devices": 2}),
    ({}, {"mesh": "two cpus"}),
])
def test_unported_options_raise(params, kw):
    """The replicated-variable mesh is not ported: ``n_devices > 1`` and
    ``mesh`` raise, naming the ROADMAP item that holds them (the
    partitioned ``shards=`` runs: ``tests/test_torch_sharding*.py``)."""
    from pydcop_tpu_torch.engine.sharding import make_mesh

    if "mesh" in kw:
        kw = {"mesh": make_mesh(devices=["cpu", "cpu"])}
    dcop = load_both("coloring_chain.yaml")[1]
    with pytest.raises(NotImplementedError, match=r"item 6\(b\)"):
        build_engine(dcop, params, device="cpu", **kw)


@pytest.mark.parametrize("fixture,max_cycles", [
    ("coloring_12_3.yml", 60), ("loft_scene.yml", 100),
    ("pref_ring_max.yaml", 100),
])
@pytest.mark.parametrize("params", [
    {"aggregation": "sorted"}, {"aggregation": "ell"}, {"prune": True},
    {"prune": True, "aggregation": "ell"},
])
def test_options_solve_identically(fixture, max_cycles, params):
    _assert_same_result(*load_both(fixture), max_cycles, **params)


@pytest.mark.parametrize("params", [
    {"prune": True}, {"prune": True, "aggregation": "sorted"},
    {"prune": "true", "noise": "0"},
])
def test_pruned_solve_of_a_large_domain_problem(params):
    """D = 32: the pruned step runs on most cycles."""
    out = _assert_same_result(*loopy_both(d=32, seed=1, unary="variables"),
                              150, **params)
    assert out["metrics"]["prune_fast_cycles"] > 0


def test_auto_replays_a_stored_decision(tmp_path, monkeypatch):
    """Both packages read the file named by PYDCOP_AGG_AUTOTUNE_CACHE;
    with the same stored decision both solve with it (the port replays
    only entries that carry its writer's mark)."""
    from pydcop_tpu_torch.engine.autotune import (
        WRITER,
        WRITER_KEY,
        dcop_shape_key,
    )

    jax_dcop, torch_dcop = load_both("loft_scene.yml")
    path = tmp_path / "agg.json"
    path.write_text(json.dumps({dcop_shape_key(torch_dcop, "cpu"): {
        "aggregation": "sorted", WRITER_KEY: WRITER}}))
    monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE", str(path))
    out = _assert_same_result(jax_dcop, torch_dcop, 100,
                              aggregation="auto")
    assert out["metrics"]["aggregation"] == "sorted"
    assert out["metrics"]["aggregation_source"] == "cache"


def test_auto_measures_on_a_one_bucket_problem(tmp_path, monkeypatch):
    """Each package measures on its own (separate files); on one bucket
    every selectable strategy gives the same bits, so whatever each
    picks, the solves agree."""
    jax_dcop, torch_dcop = build_coloring_both(200)
    monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE", str(tmp_path / "j"))
    ref = jax_solve(jax_dcop, "maxsum", max_cycles=150,
                    algo_params={"aggregation": "auto"})
    monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE", str(tmp_path / "t"))
    out = torch_solve(torch_dcop, "maxsum", max_cycles=150,
                      algo_params={"aggregation": "auto"}, device="cpu")
    for key in ("assignment", "cost", "cycles", "status"):
        assert out[key] == ref[key], key
    assert out["metrics"]["aggregation_source"] == "measured"
    assert set(out["metrics"]["aggregation_timings_ms"]) == {
        "scatter", "sorted", "boundary", "ell"}
    again = torch_solve(torch_dcop, "maxsum", max_cycles=150,
                        algo_params={"aggregation": "auto"}, device="cpu")
    assert again["metrics"]["aggregation_source"] == "cache"
    assert again["assignment"] == out["assignment"]


def test_boundary_is_not_a_solve_option():
    from pydcop_tpu_torch.algorithms import AlgoParameterException

    dcop = load_both("coloring_chain.yaml")[1]
    with pytest.raises(AlgoParameterException):
        torch_solve(dcop, "maxsum", algo_params={"aggregation": "boundary"},
                    device="cpu")


@pytest.mark.parametrize("fixture,cycles", [("coloring_12_3.yml", 60),
                                            ("pref_ring_max.yaml", 40)])
def test_cli_cycle_metrics_hold_the_jax_cost_trace(tmp_path, fixture,
                                                   cycles):
    env = dict(os.environ, PYTHONPATH=REPO)
    path = os.path.join(INSTANCES, fixture)
    run_csv, end_csv = tmp_path / "run.csv", tmp_path / "end.csv"
    proc = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "--algo",
         "maxsum", "-c", str(cycles), "--device", "cpu", "--collect_on",
         "cycle_change", "--run_metrics", str(run_csv), "--end_metrics",
         str(end_csv), path],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout)
    jax_dcop = load_both(fixture)[0]
    ref = jax_build_engine(
        jax_dcop, {"damping": 0.5, "damping_nodes": "both",
                   "stability": 0.1, "noise": 0.01}).run_trace(
        max_cycles=max(result["cycle"], 1))
    with open(run_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["time", "cycle", "cost", "violation",
                             "msg_count", "msg_size", "status"]
    trace, summary = rows[:-1], rows[-1]
    assert len(trace) == result["cycle"]
    assert [int(r["cycle"]) for r in trace] == list(
        range(1, len(trace) + 1))
    assert [float(r["cost"]) for r in trace] == [
        float(c) for c in ref.metrics["cost_trace"]]
    assert all(r["status"] == "RUNNING" for r in trace)
    assert float(summary["cost"]) == result["cost"]
    assert summary["status"] == result["status"]
    with open(end_csv, newline="") as f:
        end_rows = list(csv.DictReader(f))
    assert end_rows == [summary]


@pytest.mark.gpu
def test_solve_on_the_card_matches_cpu():
    """On the card: the default-device solve runs through the CUDA
    kernel and agrees with the CPU solve on a fixture with a unique
    optimum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pydcop_tpu_torch.ops import _build

    dcop = load_both("coloring_12_3.yml")[1]
    before = _build.launch_counts["binary_factor_update"]
    out = torch_solve(dcop, "maxsum", max_cycles=60)
    assert _build.launch_counts["binary_factor_update"] - before == 60
    assert out["metrics"]["device"].startswith("cuda")
    assert out["cost"] == 5000.0
