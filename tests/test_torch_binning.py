"""The port's serving/binning.py (a copy: host numpy and ``hashlib``)
against the JAX package's, on the same compiled graphs, after
``tests/unit/test_envelope_battery.py``'s key and cost-model checks.

Tolerance: none.  Keys, signatures, labels, cell counts and the
pack-vs-solo records are ``==`` to the reference's; the graphs are
compiled by each package's own compiler from the same problem (the
compiled arrays are equal, ``tests/test_torch_compile.py``).  The pack
planner's fitted constants (``engine/autotune.py``'s pack fitting) are
``==`` to the reference's on the same samples; the port's stored fit
carries ``"writer": "pydcop_tpu_torch"`` and it never replays one the
reference stored.
"""

import numpy as np
import pytest
import torch

import pydcop_tpu.serving.binning as JB
import pydcop_tpu_torch.serving.binning as TB
from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu_torch.engine.compile import compile_dcop as torch_compile
from test_torch_compile import MIXED_YAML, build_coloring_both, load_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PROBLEMS = ["coloring_12_3.yml", "loft_scene.yml", "pref_ring_max.yaml",
            "coloring_ring_hard.yaml", MIXED_YAML, 30, 300]


def graphs(problem, **kw):
    """(reference graph, port graph) of one problem."""
    if isinstance(problem, int):
        jd, td = build_coloring_both(problem, seed=problem)
    else:
        jd, td = load_both(problem)
    return (jax_compile(jd, noise_level=0.01, **kw)[0],
            torch_compile(td, noise_level=0.01, **kw)[0])


LADDERS = ["DEFAULT_LADDER", "UNION_LADDER"]


@pytest.mark.parametrize("pad_to", [1, 8])
@pytest.mark.parametrize("problem", PROBLEMS)
def test_keys_and_cells_equal_reference(problem, pad_to):
    jg, tg = graphs(problem, pad_to=pad_to)
    assert TB.structure_signature(tg) == JB.structure_signature(jg)
    params = TB.normalize_params({"max_cycles": 50})
    assert params == JB.normalize_params({"max_cycles": 50})
    key = TB.bin_key(tg, params)
    assert key == JB.bin_key(jg, params)
    assert TB.bin_label(key) == JB.bin_label(key)
    for name in LADDERS:
        env = TB.envelope_key(tg, getattr(TB, name))
        ref = JB.envelope_key(jg, getattr(JB, name))
        assert tuple(env) == tuple(ref)
        assert TB.envelope_cells(env) == JB.envelope_cells(ref)
        assert TB.envelope_label(env) == JB.envelope_label(ref)
    assert TB.graph_cells(tg) == JB.graph_cells(jg)
    for d_env in (jg.dmax, jg.dmax + 2):
        assert TB.lane_cells(tg, d_env) == JB.lane_cells(jg, d_env)


@pytest.mark.parametrize("problem", PROBLEMS)
def test_affinity_key_equals_reference(problem):
    if isinstance(problem, int):
        jd, td = build_coloring_both(problem, seed=problem)
    else:
        jd, td = load_both(problem)
    for params in (None, {"max_cycles": 70, "prune": "auto"}):
        assert TB.affinity_key(td, params) == JB.affinity_key(jd, params)


def test_ladder_round_equals_reference():
    for n in (0, 1, 5, 8, 9, 33, 1000, 5000, 70000):
        for rungs in ((8, 16), TB.DEFAULT_LADDER.vars,
                      TB.UNION_LADDER.rows):
            assert TB.ladder_round(n, rungs) == JB.ladder_round(n, rungs)


@pytest.mark.parametrize("constants", [
    None, {"us_per_cycle": 9.0, "ns_per_cell_cycle": 3.0,
           "overhead_ms": 0.05}])
def test_cost_model_equals_reference(constants):
    members = [graphs(p) for p in PROBLEMS[:4]]
    real = [JB.graph_cells(j) for j, _ in members]
    assert real == [TB.graph_cells(t) for _, t in members]
    for cycles in (10, 200):
        priors = [TB.solve_prior_ms(c, cycles, constants=constants)
                  for c in real]
        assert priors == [JB.solve_prior_ms(c, cycles, constants=constants)
                          for c in real]
        assert (TB.solve_prior_ms(real[0], cycles, portfolio_ms=3.5)
                == JB.solve_prior_ms(real[0], cycles, portfolio_ms=3.5))
        d = max(j.dmax for j, _ in members)
        union = TB.lane_union_cells([t for _, t in members], d)
        assert union == JB.lane_union_cells([j for j, _ in members], d)
        for group in (real[:1], real[:2], real):
            ms = [p for p, _ in priors[:len(group)]]
            assert (TB.pack_decision(group, ms, union, cycles,
                                     constants=constants)
                    == JB.pack_decision(group, ms, union, cycles,
                                        constants=constants))


def test_normalize_params_equals_reference():
    for overrides in (None, {"damping": "0.7", "prune": "auto"},
                      {"algo": "dpop"}, {"max_cycles": "30"}):
        assert (TB.normalize_params(overrides)
                == JB.normalize_params(overrides))
    for bad in ({"damping_nodes": "all"}, {"algo": "dsa"}):
        with pytest.raises(ValueError):
            JB.normalize_params(bad)
        with pytest.raises(ValueError):
            TB.normalize_params(bad)


def test_ladders_and_constants_equal_reference():
    assert tuple(TB.DEFAULT_LADDER) == tuple(JB.DEFAULT_LADDER)
    assert tuple(TB.UNION_LADDER) == tuple(JB.UNION_LADDER)
    assert TB.PARAM_KEYS == JB.PARAM_KEYS
    assert TB.DEFAULT_PARAMS == JB.DEFAULT_PARAMS
    assert (TB.PACK_OVERHEAD_MS, TB.MODEL_US_PER_CYCLE,
            TB.MODEL_NS_PER_CELL_CYCLE) == (
        JB.PACK_OVERHEAD_MS, JB.MODEL_US_PER_CYCLE,
        JB.MODEL_NS_PER_CELL_CYCLE)
    assert np.array_equal(TB.SERVING_ALGOS, JB.SERVING_ALGOS)


# ------------------------------------------------------------------ #
# The pack planner's fitted constants (engine/autotune.py's pack
# fitting), fed the same dispatch samples in both packages.

import json  # noqa: E402

import pydcop_tpu.engine.autotune as JA  # noqa: E402
import pydcop_tpu_torch.engine.autotune as TA  # noqa: E402


def _samples(n, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        cells = int(rng.integers(1_000, 200_000))
        cycles = int(rng.integers(20, 300))
        execute_s = cycles * (5e-5 + cells * 2.5e-8) * rng.uniform(0.99,
                                                                  1.01)
        yield cells, cycles, execute_s, float(rng.uniform(0, 1e-3))


@pytest.fixture
def fresh_fits(monkeypatch):
    monkeypatch.delenv("PYDCOP_PACK_FIT", raising=False)
    JA._packfit_reset()
    TA._packfit_reset()
    yield
    JA._packfit_reset()
    TA._packfit_reset()


@pytest.mark.parametrize("n", [3, 8, 16, 40])
def test_fitted_constants_equal_reference(tmp_path, fresh_fits, n):
    ref_file, port_file = str(tmp_path / "ref.json"), str(tmp_path / "p.json")
    for cells, cycles, execute_s, overhead_s in _samples(n):
        JA.record_pack_sample("cpu", cells, cycles, execute_s, overhead_s,
                              cache_file=ref_file)
        TA.record_pack_sample("cpu", cells, cycles, execute_s, overhead_s,
                              cache_file=port_file)
    ref = JA.fitted_pack_constants("cpu", cache_file=ref_file)
    assert TA.fitted_pack_constants("cpu", cache_file=port_file) == ref
    assert (ref is None) == (n < JA._PACKFIT_MIN_SAMPLES), ref
    # A cold dispatch's zero wall and a sample with no cells are not fed.
    TA.record_pack_sample("cpu", 0, 10, 1.0, cache_file=port_file)
    TA.record_pack_sample("cpu", 10, 10, 0.0, cache_file=port_file)
    assert TA.fitted_pack_constants("cpu", cache_file=port_file) == ref
    if n >= 16:
        stored = json.loads(open(port_file).read())["packfit-v1|cpu"]
        assert stored["writer"] == "pydcop_tpu_torch"
        assert stored["fitted"] == json.loads(
            open(ref_file).read())["packfit-v1|cpu"]["fitted"]


def test_the_port_never_replays_a_reference_fit(tmp_path, fresh_fits):
    shared = str(tmp_path / "shared.json")
    for sample in _samples(16):
        JA.record_pack_sample("cpu", *sample, cache_file=shared)
    assert JA.fitted_pack_constants("cpu", cache_file=shared) is not None
    JA._packfit_reset()
    assert JA.fitted_pack_constants("cpu", cache_file=shared) is not None
    assert TA.fitted_pack_constants("cpu", cache_file=shared) is None
    for sample in _samples(16, seed=1):
        TA.record_pack_sample("cpu", *sample, cache_file=shared)
    TA._packfit_reset()
    assert TA.fitted_pack_constants("cpu", cache_file=shared) is not None


def test_pack_fit_off(tmp_path, fresh_fits, monkeypatch):
    monkeypatch.setenv("PYDCOP_PACK_FIT", "0")
    path = str(tmp_path / "off.json")
    for sample in _samples(20):
        TA.record_pack_sample("cpu", *sample, cache_file=path)
    assert not TA.pack_fit_enabled()
    assert TA.fitted_pack_constants("cpu", cache_file=path) is None
    assert not (tmp_path / "off.json").exists()
