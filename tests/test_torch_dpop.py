"""The port's DPOP (ops/dpop.py, engine/dpop.py, algorithms/dpop.py)
against ``pydcop_tpu`` on the CPU.

- Host planning: ``tree_stats``, ``cec_survivors`` (survivors
  ``np.array_equal``, rounds and counts) and ``compile_tree`` (every
  node's dims, shape, depth, parent and components, ``np.array_equal``)
  equal the reference's, with and without CEC, on the cases of
  ``tests/test_torch_pseudotree.py``.
- The UTIL step: the port's ``_kernel_for(signature)`` on torch tensors
  gives the reference's jitted ``_kernel_for(signature)``'s ``acc`` and
  ``util`` bit for bit (uint32 views): unary, binary and ternary
  components, up to five of them, min and max, mixed domain sizes,
  values over eight decades, subnormal entries (a lone component keeps
  them: XLA drops the ``zeros +``), signed zeros (the min orders -0.0
  below +0.0) and an ``inf - inf`` NaN.
- Whole solves: ``api.solve(dcop, "dpop", device="cpu")`` equals
  ``pydcop_tpu.api.solve(dcop, "dpop")`` — assignment, cost,
  violations, cycles, status and every metric (``msg_count``,
  ``msg_size``, ``kernel_calls``, ``levels``, ``cec_rounds``,
  ``cec_pruned``, ``engine``, ``optimal``, ``cold_start``,
  ``device_cost``) — for ``engine`` jit, numpy and auto and ``cec``
  on/off, following ``tests/unit/test_dpop_jit.py`` (trees, cyclic,
  max mode, forest, mixed domains, ternary, ``UtilTooLargeError``, auto
  on deep chains and wide trees) and
  ``tests/unit/test_exact_inference_battery.py`` (CEC on/off gives the
  same assignment, determinism across builds).
- ``DpopEngine`` equals the reference's engine (a second run is warm in
  both), ``dpop_feasibility`` gives the reference's verdicts, a traced
  solve records the reference's span names, the CLI's JSON equals
  ``pydcop solve --algo dpop``'s key for key, checkpointing raises, and
  without ``device="cpu"`` and without a card the solve raises.
"""

import collections
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import pydcop_tpu.computations_graph.pseudotree as j_pt
import pydcop_tpu.ops.dpop as J
import pydcop_tpu_torch.computations_graph.pseudotree as t_pt
import pydcop_tpu_torch.ops.dpop as T
from pydcop_tpu import api as japi
from pydcop_tpu import dcop_cli as jcli
from pydcop_tpu.engine.dpop import DpopEngine as JaxDpopEngine
from pydcop_tpu.engine.dpop import dpop_feasibility as j_feasibility
from pydcop_tpu_torch import api as tapi
from pydcop_tpu_torch import dcop_cli as tcli
from pydcop_tpu_torch.engine.dpop import DpopEngine, dpop_feasibility
from pydcop_tpu_torch.observability.trace import load_trace_file
from test_torch_compile import INSTANCES, load_both
from test_torch_pseudotree import (
    CASES,
    JAX_MODS,
    TORCH_MODS,
    both,
    random_dcop,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def graphs(case):
    jax_dcop, torch_dcop = CASES[case]()
    return (jax_dcop, torch_dcop, j_pt.build_computation_graph(jax_dcop),
            t_pt.build_computation_graph(torch_dcop))


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_planning_equals_reference(case):
    jax_dcop, _, jg, tg = graphs(case)
    mode = jax_dcop.objective
    assert T.tree_stats(tg) == J.tree_stats(jg)
    t_surv, t_meta = T.cec_survivors(tg, mode)
    j_surv, j_meta = J.cec_survivors(jg, mode)
    assert t_meta == j_meta
    assert list(t_surv) == list(j_surv)
    for name in j_surv:
        assert np.array_equal(t_surv[name], j_surv[name])
    assert T.tree_stats(tg, t_surv) == J.tree_stats(jg, j_surv)
    for survivors in (None, (t_surv, j_surv)):
        tp = T.compile_tree(tg, mode, None if survivors is None
                            else survivors[0])
        jp = J.compile_tree(jg, mode, None if survivors is None
                            else survivors[1])
        assert list(tp) == list(jp)
        for name, jplan in jp.items():
            tplan = tp[name]
            assert (tplan.dims, tplan.shape, tplan.parent, tplan.depth) == (
                jplan.dims, jplan.shape, jplan.parent, jplan.depth)
            assert list(tplan.components) == list(jplan.components)
            for axes, arr in jplan.components.items():
                assert tplan.components[axes].dtype == arr.dtype
                assert np.array_equal(tplan.components[axes], arr)


def _wide(rng, shape):
    return (rng.standard_normal(shape)
            * 10.0 ** rng.uniform(-4, 4, shape)).astype(np.float32)


def _components(shape, axes_tuples, n, rng, kind):
    comps = []
    for axes in axes_tuples:
        comp = _wide(rng, (n,) + tuple(shape[a] for a in axes))
        if kind == "subnormal":
            comp[rng.random(comp.shape) < 0.3] = np.float32(-1e-39)
            comp[rng.random(comp.shape) < 0.2] = np.float32(2e-39)
            comp[rng.random(comp.shape) < 0.2] = np.float32(1.2e-38)
        elif kind == "zeros":
            comp[rng.random(comp.shape) < 0.5] = -0.0
            comp[rng.random(comp.shape) < 0.2] = 0.0
        comps.append(comp)
    if kind == "inf_minus_inf":
        comps[0].reshape(n, -1)[:, 0] = np.inf
        comps[-1].reshape(n, -1)[:, 0] = -np.inf
        comps[-1].reshape(n, -1)[0, -1] = np.nan
    return comps


SIGNATURES = [
    ((3,), ((0,),)),
    ((4, 3), ((0,), (0, 1))),
    ((2, 5), ((0, 1),)),
    ((3, 2, 5), ((0,), (0, 1), (0, 2), (1, 2))),
    ((3, 4, 2), ((0,), (0, 1), (0, 1, 2), (1, 2), (2,))),
    ((5, 3, 3, 2), ((0,), (0, 1, 2), (0, 3), (1, 2, 3))),
]


@pytest.mark.parametrize("kind", ["signed", "subnormal", "zeros",
                                  "inf_minus_inf"])
@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("index", range(len(SIGNATURES)))
def test_util_step_equals_reference_kernel(index, mode, kind):
    shape, axes_tuples = SIGNATURES[index]
    rng = np.random.default_rng(index)
    for want_util in (True, False):
        sig = (shape, axes_tuples, mode, want_util)
        comps = _components(shape, axes_tuples, 7, rng, kind)
        j_acc, j_util = J._kernel_for(sig)(*comps)
        t_acc, t_util = T._kernel_for(sig)(
            *(torch.from_numpy(c) for c in comps))
        assert t_acc.dtype == torch.float32 and t_acc.shape == (7,) + shape
        np.testing.assert_array_equal(t_acc.numpy().view(np.uint32),
                                      np.asarray(j_acc).view(np.uint32))
        if not want_util:
            assert j_util is None and t_util is None
            continue
        np.testing.assert_array_equal(t_util.numpy().view(np.uint32),
                                      np.asarray(j_util).view(np.uint32))


def _same_result(out, ref):
    for key in ("assignment", "cost", "violations", "cycles", "status",
                "backend"):
        assert out[key] == ref[key], key
    assert out["metrics"] == ref["metrics"]


SOLVE_CASES = ["tree_wide", "tree_deep", "cyclic", "max_mode", "forest",
               "mixed_domains", "mixed_domains_unary", "ternary",
               "coloring_12_3", "secp_lamps", "pref_ring_max",
               "loft_scene"]


@pytest.mark.parametrize("cec", ["on", "off"])
@pytest.mark.parametrize("engine", ["jit", "numpy", "auto"])
@pytest.mark.parametrize("case", SOLVE_CASES)
def test_solve_equals_reference(case, engine, cec):
    jax_dcop, torch_dcop = CASES[case]()
    params = {"engine": engine, "cec": cec}
    ref = japi.solve(jax_dcop, "dpop", algo_params=params)
    out = tapi.solve(torch_dcop, "dpop", algo_params=params, device="cpu")
    _same_result(out, ref)
    if engine != "auto":
        assert out["metrics"]["engine"] == engine


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d", [2, 4])
def test_random_tree_solves_equal_reference(seed, d):
    """test_dpop_jit.py's tree parity cases (60 variables)."""
    jax_dcop, torch_dcop = both(random_dcop, 60, d, seed)
    for engine in ("jit", "numpy"):
        params = {"engine": engine}
        _same_result(
            tapi.solve(torch_dcop, "dpop", algo_params=params,
                       device="cpu"),
            japi.solve(jax_dcop, "dpop", algo_params=params))


def test_util_too_large_is_refused_as_the_reference_does():
    def clique(mods):
        objects, relations, dcop_mod = mods
        rng = np.random.default_rng(19)
        dom = objects.Domain("c", "", list(range(30)))
        dcop = dcop_mod.DCOP("wide", objective="min")
        vs = [objects.Variable(f"v{i}", dom) for i in range(8)]
        for v in vs:
            dcop.add_variable(v)
        k = 0
        for i in range(8):
            for j in range(i + 1, 8):
                dcop.add_constraint(relations.NAryMatrixRelation(
                    [vs[i], vs[j]], rng.random((30, 30)), f"c{k}"))
                k += 1
        return dcop

    jax_dcop, torch_dcop = clique(JAX_MODS), clique(TORCH_MODS)
    with pytest.raises(J.UtilTooLargeError):
        J.compile_tree(j_pt.build_computation_graph(jax_dcop), "min")
    with pytest.raises(T.UtilTooLargeError):
        T.compile_tree(t_pt.build_computation_graph(torch_dcop), "min")
    with pytest.raises(T.UtilTooLargeError):
        tapi.solve(torch_dcop, "dpop", algo_params={"engine": "jit",
                                                    "cec": "off"},
                   device="cpu")
    tg = t_pt.build_computation_graph(torch_dcop)
    jg = j_pt.build_computation_graph(jax_dcop)
    for cap in (None, 10 ** 6, 10 ** 12):
        assert (dpop_feasibility(tg, max_elements=cap)
                == j_feasibility(jg, max_elements=cap))


def test_auto_picks_numpy_on_deep_chains_and_jit_on_wide_trees():
    for (jax_dcop, torch_dcop), engine in (
            (both(random_dcop, 40, 3, 23, wide=False), "numpy"),
            (both(random_dcop, 300, 3, 29), "jit")):
        out = tapi.solve(torch_dcop, "dpop", device="cpu")
        ref = japi.solve(jax_dcop, "dpop")
        assert out["metrics"]["engine"] == ref["metrics"]["engine"] == engine
        _same_result(out, ref)


@pytest.mark.parametrize("objective", ["min", "max"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cec_gives_the_same_assignment_and_stats(seed, objective):
    jax_dcop, torch_dcop = both(random_dcop, 25, 4, seed, extra_edges=5,
                                objective=objective)
    tg = t_pt.build_computation_graph(torch_dcop)
    jg = j_pt.build_computation_graph(jax_dcop)
    a_off, s_off = T.solve_sweep(tg, mode=objective, cec=False)
    a_on, s_on = T.solve_sweep(tg, mode=objective, cec=True)
    assert a_on == a_off
    assert (a_on, s_on) == J.solve_sweep(jg, mode=objective, cec=True)
    assert (a_off, s_off) == J.solve_sweep(jg, mode=objective, cec=False)


def test_solves_are_deterministic_across_builds():
    _, first = both(random_dcop, 80, 3, 31, extra_edges=6)
    _, second = both(random_dcop, 80, 3, 31, extra_edges=6)
    a = tapi.solve(first, "dpop", algo_params={"engine": "jit"},
                   device="cpu")
    b = tapi.solve(second, "dpop", algo_params={"engine": "jit"},
                   device="cpu")
    assert a["assignment"] == b["assignment"]
    assert a["metrics"] == b["metrics"]


def test_engine_equals_reference_and_warms():
    _, _, jg, tg = graphs("cyclic")
    jeng, teng = JaxDpopEngine(jg, mode="min"), DpopEngine(
        tg, mode="min", device="cpu")
    for run in range(2):
        ref, out = jeng.run(), teng.run()
        assert out.assignment == ref.assignment
        assert (out.cycles, out.converged) == (ref.cycles, ref.converged)
        assert out.metrics == ref.metrics
        assert out.metrics["cold_start"] is (run == 0)
        assert 0.0 <= out.compile_time_s <= out.time_s
    assert teng.last_stats == jeng.last_stats


def _span_names(path):
    return collections.Counter(
        e["name"] for e in load_trace_file(path)
        if e.get("ph") in ("X", "i", "I"))


def test_traced_solve_records_the_reference_spans(tmp_path):
    jax_dcop, torch_dcop = CASES["tree_wide"]()
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    params = {"engine": "jit"}
    ref = japi.solve(jax_dcop, "dpop", algo_params=params, trace=jpath)
    out = tapi.solve(torch_dcop, "dpop", algo_params=params, trace=tpath,
                     device="cpu")
    assert out["assignment"] == ref["assignment"]
    names = _span_names(tpath)
    assert names == _span_names(jpath)
    assert names["dpop_sweep"] == 1


def test_cli_json_equals_reference_key_for_key():
    path = os.path.join(INSTANCES, "coloring_12_3.yml")
    outs = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["solve", "--algo", "dpop", *extra, path])
        assert rc in (0, None)
        outs.append(json.loads(buf.getvalue()))
    ref, out = outs
    assert sorted(out) == sorted(ref)
    for key in ref:
        if key not in ("time", "compile_time"):
            assert out[key] == ref[key], key


def test_checkpointing_and_missing_card_raise(tmp_path):
    _, torch_dcop = load_both("coloring_12_3.yml")
    with pytest.raises(NotImplementedError):
        tapi.solve(torch_dcop, "dpop", checkpoint_dir=str(tmp_path),
                   device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.solve(torch_dcop, "dpop")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DpopEngine(t_pt.build_computation_graph(torch_dcop))
