"""The port's portfolio racer (``engine/autotune.py``) against
``pydcop_tpu`` on the CPU (the solve and the divergences:
``tests/test_torch_portfolio_solve.py``).

Fixtures: those of ``tests/unit/test_workreduction_battery.py::
TestPortfolio`` (``coloring_dcop(n=30)`` and the 24-variable ring) and
``test_exact_inference_battery.py::TestPortfolioRouting`` (the domino
chain of 140 variables, the 10 x 10 clique past DPOP's race gate).

- Every race leg's cost (``race_cycles=30``) equals the reference's bit
  for bit: the MaxSum legs scored inside their jit with the graph
  closed over, the decimation leg scored against the unclamped graph,
  the local-search legs, and the DPOP leg scored op by op (the
  ``eager`` site of ``window_sum.gather_stages``).
- The DPOP gate gives the reference's verdicts.
- Under the same leg times (a fake clock in both races) the choice, the
  costs, the target and the timings are the reference's; so are the
  replay, the invalid-entry re-race and the keys.
"""

import contextlib
import json
import time

import numpy as np
import pytest
import torch

import pydcop_tpu.dcop.dcop as jd
import pydcop_tpu.dcop.objects as jo
import pydcop_tpu.dcop.relations as jr
import pydcop_tpu.engine.autotune as JA
import pydcop_tpu_torch.dcop.dcop as td
import pydcop_tpu_torch.dcop.objects as to
import pydcop_tpu_torch.dcop.relations as tr
import pydcop_tpu_torch.engine.autotune as TA
from pydcop_tpu.engine.compile import compile_dcop as jax_compile
from pydcop_tpu_torch.engine.compile import compile_dcop as torch_compile


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


MODS = {"jax": (jo, jr, jd), "torch": (to, tr, td)}


def coloring_dcop(pkg, n=30, seed=0, density=1.6):
    """The work-reduction battery's loopy 3-colouring."""
    o, r, d_ = MODS[pkg]
    rng = np.random.default_rng(seed)
    dom = o.Domain("c", "", [0, 1, 2])
    dcop = d_.DCOP(f"col{n}_{seed}", objective="min")
    vs = [o.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    eq = np.eye(3)
    seen, k = set(), 0
    while k < int(n * density):
        i, j = rng.choice(n, 2, replace=False)
        key = (min(i, j), max(i, j))
        if key in seen:
            continue
        seen.add(key)
        dcop.add_constraint(
            r.NAryMatrixRelation([vs[i], vs[j]], eq, f"c{k}"))
        k += 1
    dcop.add_agents([o.AgentDef("a0")])
    return dcop


def ring_instance(pkg, table_seed=2):
    """The battery's 24-variable ring with chords, seeded tables."""
    o, r, d_ = MODS[pkg]
    rng = np.random.default_rng(table_seed)
    dom = o.Domain("c", "", [0, 1, 2])
    dcop = d_.DCOP(f"ring{table_seed}", objective="min")
    vs = [o.Variable(f"v{i}", dom) for i in range(24)]
    for v in vs:
        dcop.add_variable(v)
    edges = [(i, (i + 1) % 24) for i in range(24)]
    edges += [(i, (i + 12) % 24) for i in range(0, 24, 3)]
    for k, (i, j) in enumerate(edges):
        dcop.add_constraint(r.NAryMatrixRelation(
            [vs[i], vs[j]],
            rng.integers(0, 10, (3, 3)).astype(float), f"c{k}"))
    dcop.add_agents([o.AgentDef("a0")])
    return dcop


def domino_chain(pkg, n=140):
    """The exact-inference battery's agreement chain with one weak
    link: only DPOP reaches the optimum (cost 1) in a race leg."""
    o, r, d_ = MODS[pkg]
    weak_at = n // 2
    dom = o.Domain("b", "", [0, 1])
    dcop = d_.DCOP("domino", objective="min")
    vs = [o.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(n - 1):
        m = (np.array([[0.0, 1.0], [1.0, 0.0]]) if i == weak_at
             else np.array([[0.0, 5.0], [5.0, 0.0]]))
        if i == 0:
            m = m + np.array([[0.0, 0.0], [3.0, 3.0]])
        if i == n - 2:
            m = m + np.array([[3.0, 0.0], [3.0, 0.0]])
        dcop.add_constraint(r.NAryMatrixRelation(
            [vs[i], vs[i + 1]], m, f"m{i}"))
    dcop.add_agents([o.AgentDef(f"a{i}") for i in range(n)])
    return dcop


def clique(pkg, n=10, d=10):
    """A 10-variable clique over 10 values: past DPOP's race gate."""
    o, r, d_ = MODS[pkg]
    dom = o.Domain("c", "", list(range(d)))
    dcop = d_.DCOP("clique", objective="min")
    vs = [o.Variable(f"x{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    rng = np.random.default_rng(3)
    k = 0
    for i in range(n):
        for j in range(i + 1, n):
            dcop.add_constraint(r.NAryMatrixRelation(
                [vs[i], vs[j]], rng.random((d, d)), f"c{k}"))
            k += 1
    dcop.add_agents([o.AgentDef("a0")])
    return dcop


FIXTURES = {
    "coloring30": coloring_dcop,
    "ring": ring_instance,
    "domino": domino_chain,
    "clique": clique,
}


def both(name):
    return FIXTURES[name]("jax"), FIXTURES[name]("torch")


def compiled(name):
    jax_dcop, torch_dcop = both(name)
    g, jmeta = jax_compile(jax_dcop, noise_level=0.01, use_cache=False)
    tg, tmeta = torch_compile(torch_dcop, noise_level=0.01,
                              use_cache=False)
    return (jax_dcop, g, jmeta), (torch_dcop, tg, tmeta)


def f32_bits(x: float) -> int:
    return int(np.float32(x).view(np.uint32))


@pytest.mark.parametrize("name", list(FIXTURES))
def test_dpop_gate_verdicts_equal_the_reference(name):
    import pydcop_tpu.computations_graph.pseudotree as j_pt
    import pydcop_tpu_torch.computations_graph.pseudotree as t_pt
    from pydcop_tpu.engine.dpop import dpop_feasibility as j_feas
    from pydcop_tpu_torch.engine.dpop import dpop_feasibility as t_feas

    jdcop, tdcop = both(name)
    ref = j_feas(j_pt.build_computation_graph(jdcop), mode="min",
                 cec=True, max_elements=JA.DPOP_RACE_MAX_ELEMENTS)
    out = t_feas(t_pt.build_computation_graph(tdcop), mode="min",
                 cec=True, max_elements=TA.DPOP_RACE_MAX_ELEMENTS)
    assert out == ref
    assert TA.DPOP_RACE_MAX_ELEMENTS == JA.DPOP_RACE_MAX_ELEMENTS


# Leg times (ms) the fake clock gives each race: maxsum_prune is the
# fastest leg, dsa the slowest.
FAKE_MS = {"maxsum": 7.0, "maxsum_prune": 3.0, "maxsum_decim": 5.0,
           "dsa": 11.0, "mgm": 4.0, "gdba": 6.0, "dpop": 2.0}


@contextlib.contextmanager
def fake_clock(monkeypatch, ms=FAKE_MS):
    """``time.perf_counter`` stands still but for each race leg, which
    advances it by the leg's ``ms`` per run in both packages."""
    clock = [1000.0]

    def wrap(name, run):
        def timed():
            cost = run()
            clock[0] += ms[name] / 1e3
            return cost
        return timed

    for mod in (JA, TA):
        original = mod._portfolio_runners

        def patched(*a, _original=original, **kw):
            return {n: wrap(n, r) for n, r in _original(*a, **kw).items()}

        monkeypatch.setattr(mod, "_portfolio_runners", patched)
        original_dpop = mod.dpop_portfolio_runner

        def patched_dpop(*a, _original=original_dpop, **kw):
            run = _original(*a, **kw)
            return None if run is None else wrap("dpop", run)

        monkeypatch.setattr(mod, "dpop_portfolio_runner", patched_dpop)
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    yield


def race_both(name, tmp_path, **kw):
    (jdcop, g, jmeta), (tdcop, tg, tmeta) = compiled(name)
    ref = JA.autotune_portfolio(
        g, race_cycles=30, cache_file=str(tmp_path / "j.json"), meta=jmeta,
        extra_runners={"dpop": JA.dpop_portfolio_runner(jdcop, g, jmeta)},
        **kw)
    out = TA.autotune_portfolio(
        tg, race_cycles=30, cache_file=str(tmp_path / "t.json"),
        meta=tmeta, device="cpu",
        extra_runners={"dpop": TA.dpop_portfolio_runner(
            tdcop, tg, tmeta, "cpu")}, **kw)
    return ref, out


@pytest.mark.parametrize("name", list(FIXTURES))
def test_race_equals_the_reference_under_the_same_times(
        name, tmp_path, monkeypatch):
    """Every leg's cost (``race_cycles=30``) bit for bit, and, under
    the same leg times, the reference's choice, timings and target."""
    with fake_clock(monkeypatch):
        ref, out = race_both(name, tmp_path)
    raced = {n for n, c in ref["portfolio_costs"].items() if c is not None}
    assert raced == set(TA.PORTFOLIO_CANDIDATES) - (
        {"dpop"} if name == "clique" else set())
    for leg, cost in ref["portfolio_costs"].items():
        assert f32_bits(out["portfolio_costs"][leg]) == f32_bits(cost), leg
    assert out == ref
    assert out["portfolio_source"] == "measured"
    if name == "domino":
        assert out["algo"] == "dpop"


def test_replay_then_invalid_entry_races_again(tmp_path):
    (_, g, jmeta), (_, tg, tmeta) = compiled("coloring30")
    cache = str(tmp_path / "tune.json")
    info = TA.autotune_portfolio(tg, race_cycles=30, cache_file=cache,
                                 meta=tmeta, device="cpu")
    assert info["portfolio_source"] == "measured"
    assert set(t for t, ms in info["portfolio_timings_ms"].items()
               if ms is not None) == set(TA.PORTFOLIO_CANDIDATES) - {"dpop"}
    replay = TA.autotune_portfolio(tg, race_cycles=30, cache_file=cache,
                                   device="cpu")
    assert replay["portfolio_source"] == "cache"
    assert replay["algo"] == info["algo"]
    assert TA.cached_portfolio_choice(info["portfolio_key"], cache) \
        == info["algo"]
    assert TA.cached_portfolio_timing_ms(info["portfolio_key"], cache) \
        == info["portfolio_timings_ms"][info["algo"]]
    key = TA.portfolio_key(TA.graph_shape_key(tg, "cpu"))
    assert key == info["portfolio_key"]
    with open(cache, "w") as f:
        json.dump({key: {"algo": "not-a-kernel",
                         TA.WRITER_KEY: TA.WRITER}}, f)
    again = TA.autotune_portfolio(tg, race_cycles=30, cache_file=cache,
                                  device="cpu")
    assert again["portfolio_source"] == "measured"


@pytest.mark.parametrize("name", list(FIXTURES))
def test_keys_equal_the_reference(name):
    (jdcop, g, _), (tdcop, tg, _) = compiled(name)
    for backend in ("cpu", "cuda"):
        key = TA.dcop_portfolio_key(tdcop, backend)
        assert key == JA.dcop_portfolio_key(jdcop, backend)
        assert key == TA.portfolio_key(TA.graph_shape_key(tg, backend))
        assert key == JA.portfolio_key(JA.graph_shape_key(g, backend))


def test_gate_on_a_tree_past_the_recursion_limit():
    """The flagship's DFS tree is deeper than Python's recursion limit:
    the reference's recursive ``node_depths`` raises there, the port's
    loop gives every depth (a chain of 3,000 variables: each node one
    deeper than its parent)."""
    import sys

    import pydcop_tpu.computations_graph.pseudotree as j_pt
    import pydcop_tpu_torch.computations_graph.pseudotree as t_pt

    def rooted_chain(pkg, n):
        """A chain whose last variable, with three leaves, is the root:
        the first variable is the deepest and comes first."""
        o, r, d_ = MODS[pkg]
        dom = o.Domain("b", "", [0, 1])
        dcop = d_.DCOP("chain", objective="min")
        vs = [o.Variable(f"v{i:05d}", dom) for i in range(n)]
        vs += [o.Variable(f"x{i}", dom) for i in range(3)]
        for v in vs:
            dcop.add_variable(v)
        pairs = [(i, i + 1) for i in range(n - 1)]
        pairs += [(n - 1, n + k) for k in range(3)]
        for k, (i, j) in enumerate(pairs):
            dcop.add_constraint(r.NAryMatrixRelation(
                [vs[i], vs[j]], np.eye(2), f"c{k}"))
        return dcop

    n = 3_000
    assert n > sys.getrecursionlimit()
    jdcop, tdcop = (rooted_chain(pkg, n) for pkg in ("jax", "torch"))
    tree = t_pt.build_computation_graph(tdcop)
    depths = t_pt.node_depths(tree)
    for node in tree.nodes:
        parent = node.parent
        assert depths[node.name] == (
            0 if parent is None else depths[parent] + 1)
    assert max(depths.values()) > sys.getrecursionlimit()
    with pytest.raises(RecursionError):
        j_pt.node_depths(j_pt.build_computation_graph(jdcop))
    small = rooted_chain("torch", 50), rooted_chain("jax", 50)
    ref = j_pt.node_depths(j_pt.build_computation_graph(small[1]))
    out = t_pt.node_depths(t_pt.build_computation_graph(small[0]))
    assert list(out.items()) == list(ref.items())


def test_gate_counts_tables_past_float64(monkeypatch):
    """A UTIL table of 3^700 entries: the reference's float64 product
    overflows and raises; the port counts it exactly (the gate then
    refuses the leg) and keeps the reference's counts below."""
    import pydcop_tpu.ops.dpop as J
    import pydcop_tpu_torch.ops.dpop as T

    for mod in (J, T):
        monkeypatch.setattr(mod, "_tree_layout", lambda graph, s=None: (
            ["a", "b"], {"a": 0, "b": 1}, {"a": [], "b": ["a"]},
            {"a": (None, (3,) * 700), "b": (None, (5, 7))}))
    stats = T.tree_stats(None)
    assert stats["max_elements"] == 3 ** 700
    assert stats["total_elements"] == 3 ** 700 + 35
    with pytest.raises(OverflowError):
        J.tree_stats(None)
    for mod in (J, T):
        monkeypatch.setattr(mod, "_tree_layout", lambda graph, s=None: (
            ["a"], {"a": 0}, {"a": []}, {"a": (None, (3,) * 33)}))
    assert T.tree_stats(None) == J.tree_stats(None)
