"""The port's dynamic DCOPs (engine/dynamic.py) against ``pydcop_tpu``
on the CPU.

Each case drives a reference ``DynamicMaxSumEngine`` and the port's
(``device="cpu"``) through the same runs and edits, and after every
step holds:

- the run results: assignment, cycles, ``converged``, recompiles;
- the state: every ``v2f``/``f2v`` message and count tensor bit for bit
  (uint32 views), ``stable`` and the cycle counter;
- the host graph (``var_costs``, each bucket's costs and var ids), the
  slots, the free rows, the clamps and ``recompile_count``;
- the placed graph: after every edit the port's in-place patched
  ``TorchFactorGraph`` equals ``to_device_graph`` of its host arrays,
  field by field.

The cases are ``tests/api/test_dynamic_device.py``'s ten, the
donated-versus-plain case of ``tests/unit/test_hotpath_battery.py`` and
the ``batch_edits`` cases of ``tests/unit/test_efficiency_battery.py``;
then checkpoints that cross between the packages both ways, and
``replay_scenario`` on a scenario with every action kind, a delay and a
decimation margin.
"""

import contextlib

import numpy as np
import pytest
import torch

import pydcop_tpu.dcop.objects as jo
import pydcop_tpu.dcop.relations as jr
import pydcop_tpu.engine.dynamic as JD
import pydcop_tpu_torch.dcop.objects as to
import pydcop_tpu_torch.dcop.relations as tr
import pydcop_tpu_torch.engine.dynamic as TD
from pydcop_tpu_torch.device import TorchFactorGraph, to_device_graph


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PKGS = {"jax": (jo, jr, JD), "torch": (to, tr, TD)}


def ring(pkg, n=12, seed=0, table=None):
    """The reference tests' ring of ``n`` variables with equality
    penalties (``table`` overrides the [3, 3] cost matrix)."""
    o, r, _ = PKGS[pkg]
    d3 = o.Domain("colors", "color", [0, 1, 2])
    variables = [o.Variable(f"v{i}", d3) for i in range(n)]
    eq = np.eye(3) if table is None else table
    constraints = [
        r.NAryMatrixRelation(
            [variables[i], variables[(i + 1) % n]], eq, f"c{i}")
        for i in range(n)
    ]
    return variables, constraints


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def same_graph(a: TorchFactorGraph, b: TorchFactorGraph):
    """Field by field, tensors equal in dtype, shape and bits."""
    for name in TorchFactorGraph._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name == "buckets":
            assert len(x) == len(y)
            for bx, by in zip(x, y):
                for f, tx, ty in zip(bx._fields, bx, by):
                    assert (tx is None) == (ty is None), f
                    if tx is not None:
                        assert tx.dtype == ty.dtype, f
                        assert torch.equal(tx, ty), f
        elif isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            assert x is not None and y is not None, name
            assert x.dtype == y.dtype and torch.equal(x, y), name
        else:
            assert x == y, name


class Twin:
    """A reference engine and the port's, driven together."""

    def __init__(self, build, **kw):
        self.vars = {}
        self.engines = {}
        for pkg in PKGS:
            variables, constraints = build(pkg)
            self.vars[pkg] = variables
            extra = {"device": "cpu"} if pkg == "torch" else {}
            self.engines[pkg] = PKGS[pkg][2].DynamicMaxSumEngine(
                variables, constraints, **kw, **extra)
        self.check()

    @property
    def j(self):
        return self.engines["jax"]

    @property
    def t(self):
        return self.engines["torch"]

    def run(self, *args, **kw):
        rj = self.j.run(*args, **kw)
        rt = self.t.run(*args, **kw)
        assert rt.assignment == rj.assignment
        assert rt.cycles == rj.cycles
        assert rt.converged == rj.converged
        assert rt.metrics["recompiles"] == rj.metrics["recompiles"]
        self.check()
        return rj, rt

    def edit(self, method, make_args=lambda pkg, twin: ()):
        """Call ``method`` on both engines with per-package arguments
        (``make_args(pkg, twin)``); returns both results."""
        out = {}
        for pkg, engine in self.engines.items():
            out[pkg] = getattr(engine, method)(*make_args(pkg, self))
        self.check()
        return out["jax"], out["torch"]

    def action(self, action_type, args):
        out = [PKGS[pkg][2].apply_action(engine, action_type, args)
               for pkg, engine in self.engines.items()]
        assert out[0] == out[1]
        self.check()
        return out[1]

    def check(self):
        j, t = self.j, self.t
        assert t.recompile_count == j.recompile_count
        assert t.slots == j.slots
        assert t._free == j._free
        assert t.clamps == j.clamps
        assert sorted(t.factors) == sorted(j.factors)
        assert np.array_equal(bits(t.graph.var_costs),
                              bits(j.graph.var_costs))
        assert np.array_equal(np.asarray(t.graph.var_valid),
                              np.asarray(j.graph.var_valid))
        assert len(t.graph.buckets) == len(j.graph.buckets)
        for bt, bj in zip(t.graph.buckets, j.graph.buckets):
            assert np.array_equal(bits(bt.costs), bits(bj.costs))
            assert np.array_equal(np.asarray(bt.var_ids),
                                  np.asarray(bj.var_ids))
        # The rule of the in-place patching.
        same_graph(t.placed, to_device_graph(t.graph, "cpu"))
        if j._state is None or t._state is None:
            assert (j._state is None) == (t._state is None)
            return
        for field in ("v2f", "f2v", "v2f_count", "f2v_count"):
            for a, b in zip(getattr(t._state, field),
                            getattr(j._state, field)):
                assert a.dtype == {np.dtype(np.float32): torch.float32,
                                   np.dtype(np.int8): torch.int8}[
                                       np.asarray(b).dtype]
                assert np.array_equal(bits(a.numpy()), bits(b)), field
        assert bool(t._state.stable) == bool(j._state.stable)
        assert int(t._state.cycle) == int(j._state.cycle)


def relation(pkg, twin, names, table, name):
    """An NAryMatrixRelation over the twin's variables ``names``."""
    r = PKGS[pkg][1]
    by_name = {v.name: v for v in twin.engines[pkg].variables}
    return r.NAryMatrixRelation([by_name[n] for n in names],
                                np.asarray(table, float), name)


# ------------------------------------------------------------------ #
# tests/api/test_dynamic_device.py


def test_split_run_equals_single_run():
    a = Twin(lambda p: ring(p), noise_seed=4)
    a.run(40, stop_on_convergence=False)
    ra = a.run(40, stop_on_convergence=False)[1]
    b = Twin(lambda p: ring(p), noise_seed=4)
    rb = b.run(80, stop_on_convergence=False)[1]
    assert ra.cycles == rb.cycles == 80
    assert ra.assignment == rb.assignment


def test_change_factor_no_recompile():
    tw = Twin(lambda p: ring(p, 6), noise_seed=1)
    tw.run(60)
    tw.edit("change_factor", lambda p, t: (
        "c0", relation(p, t, ["v0", "v1"], 1.0 - np.eye(3), "c0")))
    _, res = tw.run(120)
    assert res.metrics["recompiles"] == 0
    assert res.assignment["v0"] == res.assignment["v1"]


def test_remove_and_add_factor_within_slack():
    tw = Twin(lambda p: ring(p, 8), noise_seed=2, slack=0.5)
    tw.run(40)
    tw.edit("remove_factor", lambda p, t: ("c3",))
    tw.edit("add_factor", lambda p, t: (
        relation(p, t, ["v0", "v4"], np.eye(3), "chord"),))
    _, res = tw.run(80)
    assert res.metrics["recompiles"] == 0
    assert res.assignment["v0"] != res.assignment["v4"]


def test_add_beyond_slack_recompiles_and_warm_starts():
    tw = Twin(lambda p: ring(p, 8), noise_seed=3, slack=0.0)
    tw.run(60)
    added = 0
    while tw.t._free[0]:
        i = added + 1
        tw.edit("add_factor", lambda p, t: (relation(
            p, t, ["v0", f"v{i + 1}"], np.eye(3), f"x{added}"),))
        added += 1
    tw.edit("add_factor", lambda p, t: (
        relation(p, t, ["v2", "v6"], np.eye(3), "overflow"),))
    _, res = tw.run(120)
    assert res.metrics["recompiles"] >= 1


def test_add_variable_recompiles_and_links():
    tw = Twin(lambda p: ring(p, 6), noise_seed=5)
    tw.run(40)

    def new_factor(p, t):
        o, r, _ = PKGS[p]
        w = o.Variable("w0", o.Domain("colors", "color", [0, 1, 2]))
        v0 = t.engines[p].variables[0]
        return (r.NAryMatrixRelation([v0, w], np.eye(3), "cw"),)

    tw.edit("add_factor", new_factor)
    _, res = tw.run(120)
    assert res.assignment["w0"] != res.assignment["v0"]
    assert res.metrics["recompiles"] >= 1


def test_cost_continuity_across_noop_event():
    tw = Twin(lambda p: ring(p, 10), noise_seed=6)
    tw.run(50, stop_on_convergence=False)
    kept = {p: e.factors["c5"] for p, e in tw.engines.items()}
    tw.edit("remove_factor", lambda p, t: ("c5",))
    tw.edit("add_factor", lambda p, t: (kept[p],))
    tw.run(50, stop_on_convergence=False)


def test_checkpoint_resume_bit_exact(tmp_path):
    tw = Twin(lambda p: ring(p, 14, seed=9), noise_seed=9)
    tw.run(35, stop_on_convergence=False)
    tw.t.checkpoint(str(tmp_path / "state.npz"))
    again = Twin(lambda p: ring(p, 14, seed=9), noise_seed=9)
    again.edit("restore", lambda p, t: (str(tmp_path / "state.npz"),))
    resumed = again.run(35, stop_on_convergence=False)[1]
    single = Twin(lambda p: ring(p, 14, seed=9), noise_seed=9).run(
        70, stop_on_convergence=False)[1]
    assert resumed.cycles == single.cycles == 70
    assert resumed.assignment == single.assignment


def test_checkpoint_restore_rejects_mismatched_problem(tmp_path):
    variables, constraints = ring("torch", 10, seed=1)
    e1 = TD.DynamicMaxSumEngine(variables, constraints, noise_seed=1,
                                device="cpu")
    e1.run(10, stop_on_convergence=False)
    e1.checkpoint(str(tmp_path / "state.npz"))
    other = TD.DynamicMaxSumEngine(*ring("torch", 12, seed=1),
                                   noise_seed=1, device="cpu")
    with pytest.raises(ValueError):
        other.restore(str(tmp_path / "state.npz"))


def test_checkpoint_requires_a_run(tmp_path):
    eng = TD.DynamicMaxSumEngine(*ring("torch", 6), device="cpu")
    with pytest.raises(ValueError, match="never ran"):
        eng.checkpoint(str(tmp_path / "x.npz"))


def test_checkpoint_after_edits_remaps_rows(tmp_path):
    tw = Twin(lambda p: ring(p, 10, seed=2), noise_seed=2, slack=0.5)
    tw.run(25, stop_on_convergence=False)
    tw.edit("remove_factor", lambda p, t: ("c3",))
    tw.edit("add_factor", lambda p, t: (
        relation(p, t, ["v3", "v4"], 1.0 - np.eye(3), "c3"),))
    tw.run(25, stop_on_convergence=False)
    path = str(tmp_path / "edited.npz")
    tw.t.checkpoint(path)
    row_in_first = tw.t.slots["c3"]
    final = {p: list(e.factors.values()) for p, e in tw.engines.items()}
    fresh = Twin(lambda p: (tw.vars[p], final[p]), noise_seed=2,
                 slack=0.5)
    assert fresh.t.slots["c3"] != row_in_first
    fresh.edit("restore", lambda p, t: (path,))
    r2 = fresh.run(40, stop_on_convergence=False)[1]
    r1 = tw.run(40, stop_on_convergence=False)[1]
    assert r1.assignment == r2.assignment
    assert r2.assignment["v3"] == r2.assignment["v4"]


# ------------------------------------------------------------------ #
# tests/unit/test_hotpath_battery.py: donated versus plain


def test_dynamic_engine_donation_roundtrip():
    donated = Twin(lambda p: ring(p, 6), noise_seed=7, donate=True)
    plain = Twin(lambda p: ring(p, 6), noise_seed=7, donate=False)
    for _ in range(3):
        rd = donated.run(max_cycles=20)[1]
        rp = plain.run(max_cycles=20)[1]
        assert rd.assignment == rp.assignment
        assert rd.cycles == rp.cycles
    for tw in (donated, plain):
        tw.edit("remove_factor", lambda p, t: ("c2",))
        tw.edit("change_factor", lambda p, t: (
            "c0", relation(p, t, ["v0", "v1"], 5 * np.eye(3), "c0")))
    rd = donated.run(max_cycles=20)[1]
    rp = plain.run(max_cycles=20)[1]
    assert rd.assignment == rp.assignment
    assert rd.cycles == rp.cycles


def test_plain_edit_leaves_the_earlier_state_alone():
    """Without donation an edit writes into copies: a state tensor
    taken before the edit keeps its messages."""
    variables, constraints = ring("torch", 6)
    eng = TD.DynamicMaxSumEngine(variables, constraints, noise_seed=7,
                                 donate=False, device="cpu")
    eng.run(20)
    held = eng._state.f2v[0]
    before = held.clone()
    eng.remove_factor("c1")
    assert torch.equal(held, before)
    assert not torch.equal(eng._state.f2v[0], before)


# ------------------------------------------------------------------ #
# tests/unit/test_efficiency_battery.py: deferred edits


def ladder_ring(pkg, n=8, seed=4):
    """The efficiency battery's ring (integer tables from ``seed``)."""
    o, r, _ = PKGS[pkg]
    rng = np.random.default_rng(seed)
    dom = o.Domain("c", "", [0, 1, 2])
    vs = [o.Variable(f"v{i}", dom) for i in range(n)]
    cons = [r.NAryMatrixRelation(
        [vs[i], vs[(i + 1) % n]],
        rng.integers(0, 9, (3, 3)).astype(float), f"c{i}")
        for i in range(n)]
    return vs, cons


MUTATION_LADDER = [
    {"type": "change_factor", "name": "c0",
     "variables": ["v0", "v1"],
     "table": [[0, 7, 7], [7, 0, 7], [7, 7, 0]]},
    {"type": "remove_factor", "name": "c3"},
    {"type": "add_factor", "name": "cX",
     "variables": ["v2", "v5"],
     "table": [[1, 2, 3], [4, 5, 6], [7, 8, 9]]},
    {"type": "change_factor", "name": "cX",
     "variables": ["v2", "v5"],
     "table": [[9, 8, 7], [6, 5, 4], [3, 2, 1]]},
    {"type": "remove_factor", "name": "c5"},
    {"type": "add_factor", "name": "cY",
     "variables": ["v6", "v7"],
     "table": [[0, 1, 0], [1, 0, 1], [0, 1, 0]]},
]


def apply_all(tw: Twin, actions, batched: bool):
    """The actions on both engines, inside ``batch_edits`` when
    ``batched``; each package stops at its first error."""
    errors = {}
    for pkg, engine in tw.engines.items():
        ctx = engine.batch_edits() if batched else contextlib.nullcontext()
        errors[pkg] = []
        with ctx:
            for a in actions:
                args = {k: v for k, v in a.items() if k != "type"}
                try:
                    PKGS[pkg][2].apply_action(engine, a["type"], args)
                except Exception as exc:  # noqa: BLE001
                    errors[pkg].append(type(exc).__name__)
                    break
    tw.check()
    assert errors["jax"] == errors["torch"]
    return errors["torch"]


def same_engines(a: Twin, b: Twin):
    """The port's sequential and batched engines hold the same graph,
    placed graph and state."""
    ea, eb = a.t, b.t
    assert ea.slots == eb.slots
    same_graph(ea.placed, eb.placed)
    if ea._state is not None:
        for x, y in zip(ea._state, eb._state):
            if isinstance(x, tuple):
                assert all(torch.equal(p, q) for p, q in zip(x, y))


@pytest.mark.parametrize("warm", [False, True])
def test_batched_equals_sequential(warm):
    seq = Twin(lambda p: ladder_ring(p), noise_level=0.01, slack=0.5)
    bat = Twin(lambda p: ladder_ring(p), noise_level=0.01, slack=0.5)
    if warm:
        seq.run(max_cycles=30)
        bat.run(max_cycles=30)
    assert not apply_all(seq, MUTATION_LADDER, batched=False)
    assert not apply_all(bat, MUTATION_LADDER, batched=True)
    same_engines(seq, bat)
    if warm:
        ra = seq.run(max_cycles=60)[1]
        rb = bat.run(max_cycles=60)[1]
        assert ra.assignment == rb.assignment


def test_recompile_mid_batch_matches_sequential():
    actions = MUTATION_LADDER[:2] + [
        {"type": "add_variable", "name": "w0", "domain": [0, 1, 2]},
        {"type": "add_factor", "name": "cW",
         "variables": ["w0", "v0"],
         "table": [[0, 2, 2], [2, 0, 2], [2, 2, 0]]},
    ] + MUTATION_LADDER[2:4]
    seq = Twin(lambda p: ladder_ring(p), noise_level=0.01, slack=0.5)
    bat = Twin(lambda p: ladder_ring(p), noise_level=0.01, slack=0.5)
    seq.run(max_cycles=30)
    bat.run(max_cycles=30)
    assert not apply_all(seq, actions, batched=False)
    assert not apply_all(bat, actions, batched=True)
    same_engines(seq, bat)
    seq.run(max_cycles=40)


def test_failed_batch_partial_apply_matches():
    actions = MUTATION_LADDER[:3] + [
        {"type": "remove_factor", "name": "nope"},
    ] + MUTATION_LADDER[4:]
    seq = Twin(lambda p: ladder_ring(p), noise_level=0.01, slack=0.5)
    bat = Twin(lambda p: ladder_ring(p), noise_level=0.01, slack=0.5)
    seq.run(max_cycles=20)
    bat.run(max_cycles=20)
    assert apply_all(seq, actions, batched=False) == ["KeyError"]
    assert apply_all(bat, actions, batched=True) == ["KeyError"]
    same_engines(seq, bat)


def test_slack_reuse_remove_then_add_same_row():
    actions = [
        {"type": "remove_factor", "name": "c1"},
        {"type": "add_factor", "name": "cZ",
         "variables": ["v1", "v4"],
         "table": [[5, 0, 0], [0, 5, 0], [0, 0, 5]]},
    ]
    seq = Twin(lambda p: ladder_ring(p), noise_level=0.01, slack=0.1)
    bat = Twin(lambda p: ladder_ring(p), noise_level=0.01, slack=0.1)
    assert not apply_all(seq, actions, batched=False)
    assert not apply_all(bat, actions, batched=True)
    same_engines(seq, bat)


def test_one_copy_and_one_scope_rebuild_per_batch(monkeypatch):
    """Six actions on the one binary bucket: one host copy, one
    in-place patch and one scope rebuild at the flush."""
    tw = Twin(lambda p: ladder_ring(p), noise_level=0.01, slack=0.5)
    tw.run(max_cycles=20)
    copies = [0]
    original = TD.DynamicMaxSumEngine._materialize_bucket_rows

    def counting(self, costs, var_ids, rows):
        copies[0] += 1
        return original(self, costs, var_ids, rows)

    monkeypatch.setattr(TD.DynamicMaxSumEngine,
                        "_materialize_bucket_rows", counting)
    before = dict(tw.t.edit_stats)
    apply_all(tw, MUTATION_LADDER, batched=True)
    assert copies[0] == 1
    assert tw.t.edit_stats["scope_rebuilds"] \
        == before["scope_rebuilds"] + 1
    assert tw.t.edit_stats["row_patches"] == before["row_patches"] + 1
    # A cost-only edit leaves the scope arrays alone.
    agg_perm = tw.t.placed.agg_perm
    tw.action("change_factor", MUTATION_LADDER[0])
    assert tw.t.placed.agg_perm is agg_perm


# ------------------------------------------------------------------ #
# clamps, beliefs, decimation


def test_clamps_release_and_decimate_equal_the_reference():
    tw = Twin(lambda p: ladder_ring(p, 10, seed=1), noise_level=0.01)
    tw.run(30)
    bj, bt = tw.edit("beliefs")
    assert np.array_equal(bj, bt)
    cj, ct = tw.edit("decimate", lambda p, t: (0.0, 0.3))
    assert cj == ct and ct
    tw.run(30)
    rj, rt = tw.edit("release_clamps", lambda p, t: (ct[:2] + ["nope"],))
    assert rj == rt
    tw.edit("clamp_variables", lambda p, t: ({"v0": 2},))
    _, res = tw.run(40)
    assert res.assignment["v0"] == 2
    with pytest.raises(ValueError):
        tw.t.clamp_variables({"v1": 7})


# ------------------------------------------------------------------ #
# checkpoints across the packages


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_between_the_packages(tmp_path, writer):
    """One package's NPZ snapshot, taken after edits, restored into
    the other's engine built from the final factor set: both continue
    to the same state."""
    tw = Twin(lambda p: ladder_ring(p, 10, seed=3), noise_level=0.01,
              slack=0.5)
    tw.run(25, stop_on_convergence=False)
    apply_all(tw, MUTATION_LADDER, batched=False)
    tw.run(15, stop_on_convergence=False)
    path = str(tmp_path / "snap.npz")
    tw.engines[writer].checkpoint(path)
    final = {p: list(e.factors.values()) for p, e in tw.engines.items()}
    variables = {p: list(e.variables) for p, e in tw.engines.items()}
    fresh = Twin(lambda p: (variables[p], final[p]), noise_level=0.01,
                 slack=0.5)
    fresh.edit("restore", lambda p, t: (path,))
    r_fresh = fresh.run(30, stop_on_convergence=False)[1]
    r_tw = tw.run(30, stop_on_convergence=False)[1]
    assert r_fresh.assignment == r_tw.assignment
    assert r_fresh.cycles == r_tw.cycles


# ------------------------------------------------------------------ #
# replay_scenario


def scenario_pkgs():
    import pydcop_tpu.dcop.scenario as js
    import pydcop_tpu_torch.dcop.scenario as ts

    return {"jax": js, "torch": ts}


def full_scenario(mod):
    """Every action kind, a delay and an event beyond the slack."""
    E, A = mod.DcopEvent, mod.EventAction
    return mod.Scenario([
        E("e1", actions=[A("change_factor", name="c0",
                           table=[[0, 7, 7], [7, 0, 7], [7, 7, 0]])]),
        E("d1", delay=2.0),
        E("e2", actions=[A("remove_factor", name="c3"),
                         A("add_factor", name="cX",
                           variables=["v2", "v6"],
                           table=[[1, 2, 3], [4, 5, 6], [7, 8, 9]])]),
        E("e3", actions=[A("remove_agent", agent="a1"),
                         A("add_agent", agent="a9")]),
        E("e4", actions=[A("add_factor", name=f"o{k}",
                           variables=["v0", f"v{k + 2}"],
                           expression=f"3 if v0 == v{k + 2} else 0")
                         for k in range(4)]),
        E("e5", actions=[A("add_variable", name="w0",
                           domain=[0, 1, 2]),
                         A("add_factor", name="cw",
                           variables=["w0", "v1"],
                           table=[[0, 4, 4], [4, 0, 4], [4, 4, 0]])]),
    ])


def scenario_dcop(pkg):
    import pydcop_tpu.dcop.dcop as jd
    import pydcop_tpu_torch.dcop.dcop as td

    o, _, _ = PKGS[pkg]
    dcop = {"jax": jd, "torch": td}[pkg].DCOP("ring", objective="min")
    variables, constraints = ladder_ring(pkg, 10, seed=5)
    for c in constraints:
        dcop.add_constraint(c)
    dcop.add_agents([o.AgentDef(f"a{i}") for i in range(3)])
    return dcop


@pytest.mark.parametrize("margin", [None, 0.5])
def test_replay_scenario_equals_the_reference(margin):
    """Every event's record (but its wall time) and the final result
    equal the reference's; after each event the port's engine state is
    checked through ``on_event``."""
    mods = scenario_pkgs()
    recs = {"jax": [], "torch": []}
    engines = {}

    def keep(pkg):
        def on_event(rec):
            recs[pkg].append(rec)
            engine = engines.get(pkg)
            if engine is not None:
                same_graph(engine.placed,
                           to_device_graph(engine.graph, "cpu"))
        return on_event

    params = {"noise": 0.01, "slack": 0.3}
    ref = JD.replay_scenario(scenario_dcop("jax"),
                             full_scenario(mods["jax"]), params=params,
                             max_cycles=80, event_cycles=40,
                             decimation_margin=margin,
                             on_event=keep("jax"))
    dcop = scenario_dcop("torch")
    engines["torch"] = TD.build_dynamic_engine(dcop, params, device="cpu")
    out = TD.replay_scenario(dcop, full_scenario(mods["torch"]),
                             params=params, max_cycles=80,
                             event_cycles=40, decimation_margin=margin,
                             on_event=keep("torch"), device="cpu",
                             engine=engines["torch"])
    strip = [{k: v for k, v in r.items() if k != "wall_s"}
             for r in recs["jax"]]
    assert [{k: v for k, v in r.items() if k != "wall_s"}
            for r in recs["torch"]] == strip
    for r_ref, r_out in zip(ref["events"], out["events"]):
        assert set(r_ref) == set(r_out)
    for key in ref:
        if key != "events":
            assert out[key] == ref[key], key
    assert out["recompiles"] >= 2
    assert engines["torch"].edit_stats["scope_rebuilds"] >= 1


def test_engine_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.DynamicMaxSumEngine(*ring("torch", 4))


def test_replay_scenario_counts_violations_of_the_live_factors():
    """``tests/unit/test_session_battery.py``'s hard-constraint case: a
    removed hard constraint no longer binds; and the agent events'
    re-homing, orphans included, as in the reference."""
    import pydcop_tpu.dcop.dcop as jd
    import pydcop_tpu_torch.dcop.dcop as td

    mods = scenario_pkgs()
    outs = {}
    for pkg, dcop_mod in (("jax", jd), ("torch", td)):
        o, r, _ = PKGS[pkg]
        dom = o.Domain("c", "", [0, 1])
        dcop = dcop_mod.DCOP("hard", objective="min")
        a, b = o.Variable("a", dom), o.Variable("b", dom)
        dcop.add_variable(a)
        dcop.add_variable(b)
        hard = np.array([[float("inf"), 0.0], [0.0, float("inf")]])
        dcop.add_constraint(r.NAryMatrixRelation([a, b], hard, "hard"))
        dcop.add_constraint(r.NAryMatrixRelation(
            [a, b], np.array([[0.0, 1.0], [1.0, 2.0]]), "soft"))
        dcop.add_agents([o.AgentDef("a0"), o.AgentDef("a1")])
        E, A = mods[pkg].DcopEvent, mods[pkg].EventAction
        scenario = mods[pkg].Scenario([
            E("e0", actions=[A("remove_factor", name="hard")]),
            E("e1", actions=[A("remove_agent", agent="a0"),
                             A("remove_agent", agent="a1")]),
        ])
        extra = {"device": "cpu"} if pkg == "torch" else {}
        outs[pkg] = PKGS[pkg][2].replay_scenario(
            dcop, scenario, params={"noise": 0.0}, max_cycles=200, **extra)
    ref, out = outs["jax"], outs["torch"]
    assert out["assignment"] == {"a": 0, "b": 0}
    assert out["violations"] == 0 and out["factors"] == ["soft"]
    assert out["orphaned"]
    for key in ref:
        if key != "events":
            assert out[key] == ref[key], key
