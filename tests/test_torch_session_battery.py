"""The reference's ``tests/unit/test_session_battery.py``, case for
case, against the port (``pydcop_tpu_torch``) on the CPU: every
service, engine and front end runs with ``device="cpu"``.  The
reference's text:

Battery for stateful solve sessions:

- the DynamicMaxSumEngine mutation ladder: remove_factor →
  add_factor with name reuse on a freed slack row (zero recompiles),
  add_factor past the slack budget and add_variable (the
  recompile-carrying-messages path — warm cycle counter survives),
  checkpoint/restore mid-mutation equal to uninterrupted;
- decimation clamps: pinning, release on TOUCHED variables only,
  clamp survival across a recompile;
- the acceptance pair: in-shape events apply with ZERO recompiles
  (the ``recompiles`` metric asserts it) and post-event session
  assignments are cost-equivalent (≤ 1e-6 rel) to a fresh
  ``api.solve`` of the mutated problem on integer tables;
- the session service: open → events → close in-process and over
  real HTTP (PATCH durability, SSE stream, DELETE final, 404/409/400
  surfaces, session limit 429, idempotent close);
- journal + crash replay: pending_sessions bookkeeping, compaction
  retention of open sessions, SIGKILL-equivalent replay equal to the
  uninterrupted run, checkpointed-state restore, graceful park →
  recover;
- session-scoped tracing: ``pydcop trace query --request`` material —
  one well-nested tagged tree per session;
- scenario replay (``pydcop solve --scenario`` machinery) over
  generated factor scenarios, and the sentinel's session families.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pydcop_tpu_torch import api
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation
from pydcop_tpu_torch.engine.dynamic import (
    apply_action,
    build_dynamic_engine,
    replay_scenario,
)
from pydcop_tpu_torch.observability.trace import tracer
from pydcop_tpu_torch.serving import journal as journal_mod
from pydcop_tpu_torch.serving.journal import (
    pending_sessions,
    scan_journal,
    session_ckpt_record,
    session_close_record,
    session_event_record,
    session_open_record,
)
from pydcop_tpu_torch.serving.service import SolveService
from pydcop_tpu_torch.serving.sessions import (
    SessionClosed,
    SessionLimit,
    normalize_session_params,
    scenario_yaml_to_events,
    validate_events,
)

import torch_serving_common as common

# Strict-parity session parameters: tree topologies + a tight
# stability threshold make warm re-convergence land on exactly the
# fresh solve's fixpoint (the approx-match suppression otherwise
# tolerates up to ``stability`` of per-edge drift, which can flip
# near-tie argmins on integer tables).
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _cold_dispatch_caches(monkeypatch, tmp_path):
    """Both packages' dispatch caches empty, a private autotune cache,
    and the pack model's online fit isolated
    (``torch_serving_common.isolated``)."""
    with common.isolated(monkeypatch, tmp_path):
        yield


PARITY_PARAMS = {"noise": 0.01, "stability": 0.001,
                 "max_cycles": 600, "segment_cycles": 100}


def _generated_factor_scenario(dcop, n_events, seed):
    """The reference's scenario generator and the port's copy
    (``generators/scenario_gen.py``) run on this DCOP with the same
    seed; their scenarios must write the same YAML, whose events are
    then read back through the port's ``load_scenario``."""
    from pydcop_tpu.dcop.yamldcop import load_dcop as reference_load
    from pydcop_tpu.dcop.yamldcop import yaml_scenario as reference_yaml
    from pydcop_tpu.generators.scenario_gen import (
        generate_factor_scenario,
    )
    from pydcop_tpu_torch.dcop.yamldcop import (
        dcop_yaml,
        load_scenario,
        yaml_scenario,
    )
    from pydcop_tpu_torch.generators.scenario_gen import (
        generate_factor_scenario as port_generate_factor_scenario,
    )

    text = reference_yaml(generate_factor_scenario(
        reference_load(dcop_yaml(dcop)), n_events, seed=seed))
    port_text = yaml_scenario(port_generate_factor_scenario(
        dcop, n_events, seed=seed))
    assert port_text == text
    return load_scenario(text)


def _ring(n: int, seed: int, name: str = "ring") -> DCOP:
    """Ring coloring, integer tables (the serve-plane's stock
    instance)."""
    rng = np.random.default_rng(seed)
    dom = Domain("c", "", [0, 1, 2])
    dcop = DCOP(f"{name}{n}_{seed}", objective="min")
    vs = [Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for k in range(n):
        table = rng.integers(0, 10, size=(3, 3)).astype(float)
        dcop.add_constraint(NAryMatrixRelation(
            [vs[k], vs[(k + 1) % n]], table, f"c{k}"))
    dcop.add_agents([AgentDef("a0"), AgentDef("a1")])
    return dcop


def _path(n: int, seed: int) -> DCOP:
    """Path (tree) coloring: max-sum is exact here, so warm and fresh
    solves must agree to the last ulp on integer tables."""
    rng = np.random.default_rng(seed)
    dom = Domain("c", "", [0, 1, 2])
    dcop = DCOP(f"path{n}_{seed}", objective="min")
    vs = [Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for k in range(n - 1):
        table = rng.integers(0, 10, size=(3, 3)).astype(float)
        dcop.add_constraint(NAryMatrixRelation(
            [vs[k], vs[k + 1]], table, f"c{k}"))
    dcop.add_agents([AgentDef("a0")])
    return dcop


def _table(rng, shape=(3, 3)):
    return rng.integers(0, 10, size=shape).astype(float)


def _mutated_dcop(engine) -> DCOP:
    mutated = DCOP("mutated", objective="min")
    for v in engine.variables:
        mutated.add_variable(v)
    for c in engine.factors.values():
        mutated.add_constraint(c)
    mutated.add_agents([AgentDef("a0")])
    return mutated


def _fresh_cost(engine, max_cycles=600, noise=0.01,
                stability=0.001) -> float:
    """Cost of a FRESH api.solve over the engine's current (mutated)
    factor set — the acceptance comparison's right-hand side."""
    res = api.solve(_mutated_dcop(engine), "maxsum",
                    max_cycles=max_cycles,
                    algo_params={"noise": noise,
                                 "stability": stability}, device="cpu")
    return res["cost"]


def _exact_cost(engine) -> float:
    """DPOP (exact) optimum of the mutated problem — the warm
    session's quality reference on tree topologies."""
    return api.solve(_mutated_dcop(engine), "dpop", device="cpu")["cost"]


@pytest.fixture(autouse=True)
def _restore_observability_flags():
    """The crash-simulation tests kill a started service's scheduler
    directly (no ``stop()``) — exactly how a real crash looks, but
    ``SolveService.start()`` latches ``metrics_registry.active`` and
    ``profiler.enabled`` process-wide and only ``stop()`` restores
    them.  Without this restore the flags leak ``True`` into every
    battery that runs after this one (test_perf_intel_battery's
    session-leak test was the first casualty)."""
    from pydcop_tpu_torch.observability.metrics import (
        registry as global_registry,
    )
    from pydcop_tpu_torch.observability.profiler import profiler

    was_active = global_registry.active
    was_profiling = profiler.enabled
    yield
    global_registry.active = was_active
    profiler.enabled = was_profiling


def _service(**kw) -> SolveService:
    kw.setdefault("batch_window_s", 0.02)
    kw.setdefault("max_batch", 8)
    return SolveService(**kw, device="cpu")


def _wait_converged(svc, sid, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = svc.sessions.status(sid)
        if st["last"] is not None and st["last"].get("converged"):
            return st
        time.sleep(0.05)
    raise AssertionError(f"session {sid} never converged")


# ------------------------------------------------------------------ #
# engine mutation ladder


class TestMutationLadder:
    def test_remove_then_add_reuses_name_and_slack_row(self):
        rng = np.random.default_rng(1)
        eng = build_dynamic_engine(_ring(8, 1), {"noise": 0.0}, device="cpu")
        eng.run(max_cycles=300)
        before = eng.recompile_count
        old_slot = eng.slots["c3"]
        eng.remove_factor("c3")
        assert "c3" not in eng.slots
        scope = [eng.variables[eng.var_index[n]]
                 for n in ("v3", "v4")]
        eng.add_factor(NAryMatrixRelation(scope, _table(rng), "c3"))
        assert eng.recompile_count == before, \
            "name-reuse add_factor must take a slack row, not " \
            "recompile"
        assert eng.slots["c3"][0] == old_slot[0]
        res = eng.run(max_cycles=300)
        assert res.converged
        assert res.metrics["recompiles"] == 0

    def test_add_factor_past_slack_budget_recompiles(self):
        rng = np.random.default_rng(2)
        eng = build_dynamic_engine(_ring(8, 2),
                                   {"noise": 0.0, "slack": 0.0}, device="cpu")
        eng.run(max_cycles=200)
        # slack=0 still leaves >= 1 spare row (the +1 floor); burn
        # the free list, then one more forces the recompile path.
        bi = eng._arity_bucket[2]
        free = len(eng._free[bi])
        before = eng.recompile_count
        for i in range(free + 1):
            a, b = eng.variables[i], eng.variables[(i + 3) % 8]
            eng.add_factor(NAryMatrixRelation(
                [a, b], _table(rng), f"extra{i}"))
        assert eng.recompile_count == before + 1, \
            "only the past-slack add may recompile"
        res = eng.run(max_cycles=300)
        assert res.converged

    def test_add_variable_recompiles_carrying_messages(self):
        rng = np.random.default_rng(3)
        eng = build_dynamic_engine(_ring(8, 3), {"noise": 0.0}, device="cpu")
        first = eng.run(max_cycles=300)
        assert first.converged
        cycle_before = int(first.cycles)
        before = eng.recompile_count
        new_var = Variable("v8", Domain("d", "", [0, 1, 2]))
        eng.add_variable(new_var)
        assert eng.recompile_count == before + 1
        # Warm carry-over: the trajectory continues, it does not
        # restart at cycle 0.
        res = eng.run(max_cycles=300)
        assert res.cycles > cycle_before
        anchor = eng.variables[eng.var_index["v0"]]
        eng.add_factor(NAryMatrixRelation(
            [anchor, new_var], _table(rng), "tie"))
        res = eng.run(max_cycles=300)
        assert res.converged
        assert "v8" in res.assignment

    def test_checkpoint_restore_mid_mutation_equals_uninterrupted(
            self, tmp_path):
        rng = np.random.default_rng(4)
        t1, t2 = _table(rng), _table(rng)
        base = _ring(10, 4)

        def run_a():
            eng = build_dynamic_engine(base, {"noise": 0.0}, device="cpu")
            eng.run(max_cycles=300)
            eng.change_factor("c2", NAryMatrixRelation(
                list(eng.factors["c2"].dimensions), t1, "c2"))
            eng.run(max_cycles=300)
            return eng

        uninterrupted = run_a()
        path = str(tmp_path / "mid.npz")
        uninterrupted.checkpoint(path)
        uninterrupted.change_factor("c5", NAryMatrixRelation(
            list(uninterrupted.factors["c5"].dimensions), t2, "c5"))
        final_a = uninterrupted.run(max_cycles=300)

        # Interrupted twin: rebuild, re-apply the pre-checkpoint
        # mutation structurally, restore the snapshot, continue.
        eng_b = build_dynamic_engine(base, {"noise": 0.0}, device="cpu")
        eng_b.change_factor("c2", NAryMatrixRelation(
            list(eng_b.factors["c2"].dimensions), t1, "c2"))
        eng_b.restore(path)
        eng_b.change_factor("c5", NAryMatrixRelation(
            list(eng_b.factors["c5"].dimensions), t2, "c5"))
        final_b = eng_b.run(max_cycles=300)
        assert final_a.assignment == final_b.assignment
        assert uninterrupted.cost(final_a.assignment) == \
            eng_b.cost(final_b.assignment)

    def test_restore_rejects_mismatched_factor_set(self, tmp_path):
        eng = build_dynamic_engine(_ring(8, 5), {"noise": 0.0}, device="cpu")
        eng.run(max_cycles=100)
        path = str(tmp_path / "ck.npz")
        eng.checkpoint(path)
        eng.remove_factor("c1")
        with pytest.raises(ValueError, match="only in checkpoint"):
            eng.restore(path)


# ------------------------------------------------------------------ #
# decimation clamps


class TestDecimationClamps:
    def test_clamp_pins_variable_through_the_solve(self):
        eng = build_dynamic_engine(_ring(8, 6), {"noise": 0.0}, device="cpu")
        eng.run(max_cycles=200)
        eng.clamp_variables({"v2": 1})
        res = eng.run(max_cycles=200)
        assert res.assignment["v2"] == \
            eng.variables[eng.var_index["v2"]].domain[1]

    def test_release_touched_only(self):
        rng = np.random.default_rng(7)
        eng = build_dynamic_engine(_ring(8, 7), {"noise": 0.0}, device="cpu")
        eng.run(max_cycles=300)
        clamped = eng.decimate(margin=0.0, max_fraction=1.0)
        assert clamped, "decimate clamped nothing on a converged run"
        info = apply_action(eng, "change_factor", {
            "name": "c0", "table": _table(rng).tolist()})
        released = eng.release_clamps(info["touched"])
        assert set(released) == set(info["touched"]) & set(clamped)
        still = set(clamped) - set(info["touched"])
        assert still <= set(eng.clamps), \
            "untouched clamps must survive the event"
        for name in info["touched"]:
            assert name not in eng.clamps

    def test_clamps_survive_recompile(self):
        eng = build_dynamic_engine(_ring(8, 8), {"noise": 0.0}, device="cpu")
        eng.run(max_cycles=200)
        eng.clamp_variables({"v1": 2})
        eng.add_variable(Variable("v8", Domain("d", "", [0, 1, 2])))
        assert "v1" in eng.clamps
        res = eng.run(max_cycles=200)
        assert res.assignment["v1"] == \
            eng.variables[eng.var_index["v1"]].domain[2]

    def test_clamp_validation_is_all_or_nothing(self):
        eng = build_dynamic_engine(_ring(8, 58), {"noise": 0.0}, device="cpu")
        eng.run(max_cycles=100)
        with pytest.raises(ValueError, match="out of domain"):
            eng.clamp_variables({"v0": 1, "v1": 99})
        assert eng.clamps == {}, \
            "a rejected mapping must not record partial clamps"

    def test_cost_skips_hard_violations_like_solution_cost(self):
        dom = Domain("c", "", [0, 1])
        dcop = DCOP("hardcost", objective="min")
        a, b = Variable("a", dom), Variable("b", dom)
        dcop.add_variable(a)
        dcop.add_variable(b)
        hard = np.array([[float("inf"), 1.0], [1.0, 2.0]])
        dcop.add_constraint(NAryMatrixRelation([a, b], hard, "h"))
        dcop.add_agents([AgentDef("a0")])
        eng = build_dynamic_engine(dcop, {"noise": 0.0}, device="cpu")
        # The violated-hard assignment: cost finite (inf skipped —
        # the DCOP.solution_cost convention), so session JSON/SSE
        # surfaces never carry an unserializable Infinity.
        assert eng.cost({"a": 0, "b": 0}) == 0.0
        assert eng.cost({"a": 0, "b": 1}) == 1.0
        ref_cost, _viol = dcop.solution_cost({"a": 0, "b": 0})
        assert eng.cost({"a": 0, "b": 0}) == ref_cost

    def test_beliefs_shape_and_clamp_bias(self):
        eng = build_dynamic_engine(_ring(8, 9), {"noise": 0.0}, device="cpu")
        eng.run(max_cycles=100)
        bel = eng.beliefs()
        assert bel.shape == (8, 3)
        eng.clamp_variables({"v0": 0})
        bel = eng.beliefs()
        assert np.argmin(bel[0]) == 0


# ------------------------------------------------------------------ #
# acceptance: zero recompiles + cost parity with a fresh solve


class TestInShapeParityAcceptance:
    def test_events_zero_recompiles_and_fresh_solve_cost_parity(self):
        """Acceptance: five in-shape change_factor events
        through a real session — every one applies with ZERO
        recompiles (the ``recompiles`` metric) and the post-event
        session assignment is cost-equivalent (≤ 1e-6 rel) to a
        fresh ``api.solve`` of the mutated problem on integer
        tables — equivalent OR BETTER: a cold max-sum start can land
        in a worse fixpoint than the warm one (measured: fresh 21 vs
        warm 15 on a seeded tree), so the warm session is
        additionally held to the EXACT (DPOP) optimum, the stronger
        bound that makes 'better' checkable rather than a shrug."""
        rng = np.random.default_rng(10)
        svc = _service().start()
        try:
            sess = svc.sessions.open(_path(12, 10),
                                     params=PARITY_PARAMS,
                                     session_id="parity")
            for i in range(5):
                out = svc.sessions.apply_events("parity", [{
                    "type": "change_factor",
                    "name": f"c{int(rng.integers(11))}",
                    "table": _table(rng).tolist(),
                }], wait=30.0)
                assert out["applied"] is True
                assert out["recompiles"] == 0, \
                    "in-shape event must not recompile"
                st = _wait_converged(svc, "parity")
                session_cost = st["last"]["cost"]
                fresh = _fresh_cost(sess.engine)
                exact = _exact_cost(sess.engine)
                tol = 1e-6 * max(1.0, abs(fresh))
                assert session_cost <= fresh + tol, \
                    f"event {i}: session {session_cost} worse than " \
                    f"fresh {fresh}"
                assert session_cost == pytest.approx(exact), \
                    f"event {i}: session {session_cost} != exact " \
                    f"{exact}"
            final = svc.sessions.close("parity")
            assert final["recompiles"] == 0
            assert final["event_batches"] == 5
        finally:
            svc.stop(drain=False)

    def test_growth_event_recompiles_and_still_matches(self):
        """The re-key path: add_variable + a tying factor recompiles
        exactly once, carries messages, and the re-converged session
        still matches a fresh solve of the grown problem."""
        rng = np.random.default_rng(11)
        svc = _service().start()
        try:
            sess = svc.sessions.open(_path(10, 11),
                                     params=PARITY_PARAMS,
                                     session_id="grow")
            out = svc.sessions.apply_events("grow", [
                {"type": "add_variable", "name": "nv",
                 "domain": [0, 1, 2]},
                {"type": "add_factor", "name": "nc",
                 "variables": ["v9", "nv"],
                 "table": _table(rng).tolist()},
            ], wait=30.0)
            assert out["applied"] is True
            assert out["recompiles"] == 1
            st = _wait_converged(svc, "grow")
            fresh = _fresh_cost(sess.engine)
            tol = 1e-6 * max(1.0, abs(fresh))
            assert st["last"]["cost"] <= fresh + tol
            assert st["last"]["cost"] == pytest.approx(
                _exact_cost(sess.engine))
        finally:
            svc.stop(drain=False)


# ------------------------------------------------------------------ #
# session service, in-process


class TestSessionService:
    def test_open_events_close_lifecycle(self):
        rng = np.random.default_rng(12)
        svc = _service().start()
        try:
            svc.sessions.open(_ring(8, 12), params={"noise": 0.0},
                              session_id="life")
            st = _wait_converged(svc, "life")
            assert st["status"] == "OPEN"
            out = svc.sessions.apply_events("life", [{
                "type": "change_factor", "name": "c1",
                "table": _table(rng).tolist()}], wait=30.0)
            assert out["seq"] == 1 and out["applied"] is True
            assert out["result"]["cost"] is not None
            final = svc.sessions.close("life")
            assert final["status"] == "CLOSED"
            assert final["event_batches"] == 1
            assert final["events_applied"] == 1
            # Idempotent close.
            again = svc.sessions.close("life")
            assert again == final
            stats = svc.stats()["sessions"]
            assert stats["opened"] == 1 and stats["closed"] == 1
            assert stats["active"] == 0
        finally:
            svc.stop(drain=False)

    def test_wire_validation_rejects_malformed_batches(self):
        with pytest.raises(ValueError, match="non-empty"):
            validate_events([])
        with pytest.raises(ValueError, match="unknown type"):
            validate_events([{"type": "explode"}])
        with pytest.raises(ValueError, match="'table' or an"):
            validate_events([{"type": "change_factor", "name": "c"}])
        with pytest.raises(ValueError, match="'domain'"):
            validate_events([{"type": "add_variable", "name": "x"}])
        with pytest.raises(ValueError, match="'agent'"):
            validate_events([{"type": "remove_agent"}])

    def test_semantic_event_error_fails_batch_not_session(self):
        rng = np.random.default_rng(13)
        svc = _service().start()
        try:
            svc.sessions.open(_ring(8, 13), params={"noise": 0.0},
                              session_id="sem")
            out = svc.sessions.apply_events("sem", [{
                "type": "change_factor", "name": "no_such",
                "table": _table(rng).tolist()}], wait=30.0)
            assert out["applied"] is False
            assert "error" in out
            # The session survives and keeps serving.
            st = svc.sessions.status("sem")
            assert st["status"] == "OPEN"
            out = svc.sessions.apply_events("sem", [{
                "type": "change_factor", "name": "c0",
                "table": _table(rng).tolist()}], wait=30.0)
            assert out["applied"] is True
        finally:
            svc.stop(drain=False)

    def test_failed_batch_still_serves_fresh_state(self):
        """A batch whose second action fails semantically has its
        FIRST action live in the engine: the post-batch segment must
        still run so the session never serves the stale pre-event
        assignment (review regression)."""
        rng = np.random.default_rng(61)
        svc = _service().start()
        try:
            sess = svc.sessions.open(_ring(8, 61),
                                     params={"noise": 0.0},
                                     session_id="partial")
            out = svc.sessions.apply_events("partial", [
                {"type": "change_factor", "name": "c0",
                 "table": _table(rng).tolist()},
                {"type": "change_factor", "name": "no_such",
                 "table": _table(rng).tolist()},
            ], wait=30.0)
            assert out["applied"] is False and "error" in out
            # The partial batch still produced a segment result
            # computed AFTER c0's new table landed.
            assert out["result"] is not None
            assert out["result"]["batch_seq"] == 1
            assert sess.events_applied == 1
        finally:
            svc.stop(drain=False)

    def test_terminal_sessions_evicted_past_session_keep(self):
        svc = _service(session_keep=2).start()
        try:
            for i in range(4):
                svc.sessions.open(_ring(6, 70 + i),
                                  params={"noise": 0.0},
                                  session_id=f"evict{i}")
                svc.sessions.close(f"evict{i}")
            with pytest.raises(KeyError):
                svc.sessions.status("evict0")
            # Newest terminal results stay pollable.
            assert svc.sessions.status("evict3")["status"] == "CLOSED"
            with svc.sessions._lock:
                assert len(svc.sessions._sessions) <= 2
        finally:
            svc.stop(drain=False)

    def test_open_limit_is_atomic_under_concurrent_opens(self):
        svc = _service(session_max=3).start()
        try:
            opened, rejected = [], []
            lock = threading.Lock()

            def worker(i):
                try:
                    sess = svc.sessions.open(
                        _ring(6, 80 + i), params={"noise": 0.0})
                    with lock:
                        opened.append(sess.id)
                except SessionLimit:
                    with lock:
                        rejected.append(i)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert len(opened) == 3 and len(rejected) == 5, \
                (opened, rejected)
            assert svc.sessions.active_count() == 3
        finally:
            svc.stop(drain=False)

    def test_session_limit_and_unknown_ids(self):
        svc = _service(session_max=1).start()
        try:
            svc.sessions.open(_ring(6, 14), params={"noise": 0.0})
            with pytest.raises(SessionLimit):
                svc.sessions.open(_ring(6, 15),
                                  params={"noise": 0.0})
            with pytest.raises(KeyError):
                svc.sessions.status("ghost")
            with pytest.raises(KeyError):
                svc.sessions.apply_events("ghost", [
                    {"type": "remove_factor", "name": "c0"}])
        finally:
            svc.stop(drain=False)

    def test_events_against_closed_session_409(self):
        rng = np.random.default_rng(16)
        svc = _service().start()
        try:
            svc.sessions.open(_ring(6, 16), params={"noise": 0.0},
                              session_id="done")
            svc.sessions.close("done")
            with pytest.raises(SessionClosed):
                svc.sessions.apply_events("done", [{
                    "type": "change_factor", "name": "c0",
                    "table": _table(rng).tolist()}])
        finally:
            svc.stop(drain=False)

    def test_scenario_yaml_spelling(self):
        from pydcop_tpu_torch.dcop.yamldcop import yaml_scenario

        dcop = _ring(8, 17)
        scenario = _generated_factor_scenario(dcop, 4, seed=17)
        events = scenario_yaml_to_events(yaml_scenario(scenario))
        assert events, "flattened scenario lost its actions"
        assert validate_events(events) == events
        svc = _service().start()
        try:
            svc.sessions.open(dcop, params={"noise": 0.0},
                              session_id="scen")
            out = svc.sessions.apply_events("scen", events,
                                            wait=30.0)
            assert out["applied"] is True
            assert out["events"] == len(events)
        finally:
            svc.stop(drain=False)

    def test_param_normalization_rejects_junk(self):
        with pytest.raises(ValueError, match="unknown session"):
            normalize_session_params({"frobnicate": 1})
        with pytest.raises(ValueError, match="bad session"):
            normalize_session_params({"damping": "high"})
        with pytest.raises(ValueError, match="positive"):
            normalize_session_params({"segment_cycles": 0})
        params = normalize_session_params(
            {"decimation_margin": "1.5"})
        assert params["decimation_margin"] == 1.5
        # margin <= 0 is the knob's documented OFF value (same
        # contract as maxsum decimation_plan_from_params) — it must
        # not flip to clamp-everything on the session surface.
        assert normalize_session_params(
            {"decimation_margin": 0.0})["decimation_margin"] is None
        assert normalize_session_params(
            {"decimation_margin": -1})["decimation_margin"] is None

    def test_decimation_session_clamps_and_event_releases(self):
        rng = np.random.default_rng(18)
        svc = _service().start()
        try:
            sess = svc.sessions.open(
                _ring(10, 18),
                params={"noise": 0.0, "decimation_margin": 0.5},
                session_id="dec")
            _wait_converged(svc, "dec")
            deadline = time.monotonic() + 10
            while not sess.engine.clamps \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            assert sess.engine.clamps, \
                "converged decimation session never clamped"
            before = dict(sess.engine.clamps)
            out = svc.sessions.apply_events("dec", [{
                "type": "change_factor", "name": "c0",
                "table": _table(rng).tolist()}], wait=30.0)
            assert out["applied"] is True
            touched = {"v0", "v1"}
            for name in touched:
                assert name not in sess.engine.clamps or \
                    name not in before, \
                    "touched clamp survived the event"
        finally:
            svc.stop(drain=False)


# ------------------------------------------------------------------ #
# HTTP wire


class TestSessionHTTP:
    def _request(self, url, method="GET", body=None, timeout=30):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Content-Type": "application/json"}
            if data else {})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())

    def test_full_wire_lifecycle_with_sse(self):
        from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

        rng = np.random.default_rng(19)
        handle = api.serve(port=0, batch_window_s=0.02, device="cpu")
        url = handle.url
        try:
            code, ack = self._request(
                url + "/session", "POST",
                {"dcop": dcop_yaml(_ring(8, 19)),
                 "params": {"noise": 0.0, "max_cycles": 300}})
            assert code == 201 and ack["session_id"]
            sid, tid = ack["session_id"], ack["trace_id"]
            assert tid

            events = []
            stream_done = threading.Event()

            def reader():
                try:
                    with urllib.request.urlopen(
                            url + f"/session/{sid}/events",
                            timeout=60) as r:
                        for line in r:
                            if line.startswith(b"data: "):
                                events.append(json.loads(line[6:]))
                                if events[-1].get("status") in (
                                        "CLOSED", "ERROR"):
                                    break
                finally:
                    stream_done.set()

            t = threading.Thread(target=reader, daemon=True)
            t.start()
            code, out = self._request(
                url + f"/session/{sid}/events", "PATCH",
                {"events": [{"type": "change_factor", "name": "c0",
                             "table": _table(rng).tolist()}],
                 "wait": True})
            assert code == 200 and out["applied"] is True
            assert out["recompiles"] == 0
            code, st = self._request(url + f"/session/{sid}")
            assert code == 200 and st["seq"] == 1
            code, final = self._request(
                url + f"/session/{sid}", "DELETE")
            assert code == 200 and final["status"] == "CLOSED"
            assert stream_done.wait(20), "SSE stream never ended"
            phases = {e.get("phase") for e in events}
            assert "segment" in phases and "closed" in phases
            assert any("assignment" in e for e in events
                       if e.get("phase") == "segment"), \
                "SSE segments must carry anytime assignments"
        finally:
            handle.stop()

    def test_wire_error_surfaces(self):
        from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

        handle = api.serve(port=0, batch_window_s=0.02, device="cpu")
        url = handle.url
        try:
            code, _ = self._request(url + "/session/ghost")
            assert code == 404
            code, _ = self._request(url + "/session/ghost", "DELETE")
            assert code == 404
            code, _ = self._request(
                url + "/session/ghost/events", "PATCH",
                {"events": [{"type": "remove_factor",
                             "name": "c0"}]})
            assert code == 404
            code, _ = self._request(url + "/session", "POST",
                                    {"dcop": "   "})
            assert code == 400
            code, ack = self._request(
                url + "/session", "POST",
                {"dcop": dcop_yaml(_ring(6, 20)),
                 "params": {"noise": 0.0}})
            assert code == 201
            sid = ack["session_id"]
            code, _ = self._request(
                url + f"/session/{sid}/events", "PATCH",
                {"events": [{"type": "explode"}]})
            assert code == 400
            # Malformed scenario yaml is a 400 'bad events', never a
            # 404 — the loader's KeyError must not masquerade as an
            # unknown session (review regression).
            code, body = self._request(
                url + f"/session/{sid}/events", "PATCH",
                {"scenario": "events:\n - actions:\n    - name: c1"})
            assert code == 400, (code, body)
            assert "bad events" in body["error"]
            code, _ = self._request(
                url + f"/session/{sid}", "DELETE")
            assert code == 200
        finally:
            handle.stop()


# ------------------------------------------------------------------ #
# journal records + crash replay


class TestSessionJournal:
    def test_pending_sessions_bookkeeping(self):
        records = [
            session_open_record("a", "yaml-a", {}),
            session_event_record("a", 1, [{"type": "x"}]),
            session_open_record("b", "yaml-b", {}),
            session_ckpt_record("a", 1, "/p/a.npz", cycle=40),
            session_event_record("a", 2, [{"type": "y"}]),
            session_close_record("b", "CLOSED"),
        ]
        pending = pending_sessions(records)
        assert [p["open"]["id"] for p in pending] == ["a"]
        (sess,) = pending
        assert sess["ckpt"]["seq"] == 1
        # Events at AND past the checkpoint seq both survive: the
        # pre-ckpt ones rebuild the factor layout structurally.
        assert [r["seq"] for r in sess["events"]] == [1, 2]

    def test_newest_checkpoint_wins(self):
        records = [
            session_open_record("a", "y", {}),
            session_ckpt_record("a", 1, "/p/1.npz"),
            session_ckpt_record("a", 3, "/p/3.npz"),
            session_ckpt_record("a", 2, "/p/2.npz"),
        ]
        (sess,) = pending_sessions(records)
        assert sess["ckpt"]["seq"] == 3

    def test_compaction_preserves_open_drops_closed(self, tmp_path):
        journal_dir = str(tmp_path)
        jnl = journal_mod.RequestJournal(journal_dir)
        jnl.append(session_open_record("keep", "y1", {}))
        jnl.append(session_event_record("keep", 1, [{"type": "t"}]))
        jnl.append(session_open_record("gone", "y2", {}))
        jnl.append(session_close_record("gone", "CLOSED"))
        jnl.close()
        jnl2, pending, sessions, _results = \
            journal_mod.RequestJournal.recover_full(journal_dir)
        jnl2.close()
        assert pending == []
        assert [s["open"]["id"] for s in sessions] == ["keep"]
        records, _, torn = scan_journal(jnl2.path)
        assert not torn
        assert [(r["kind"], r["id"]) for r in records] == [
            ("session_open", "keep"), ("session_event", "keep")]

    def test_crash_replay_equals_uninterrupted(self):
        """The crash acceptance, in-process: a journaled
        session absorbs 3 event batches, the process 'dies' (the
        scheduler is killed and the journal handle slammed shut with
        no close record), and a recover=True start resumes the
        session, applies nothing twice, and lands on exactly the
        uninterrupted run's final cost."""
        import tempfile

        rng = np.random.default_rng(21)
        tables = [_table(rng).tolist() for _ in range(3)]
        journal_dir = tempfile.mkdtemp(prefix="sess_battery_")
        svc = _service(journal_dir=journal_dir).start()
        svc.sessions.open(_path(10, 21), params=PARITY_PARAMS,
                          session_id="crash")
        for i, tb in enumerate(tables):
            out = svc.sessions.apply_events("crash", [{
                "type": "change_factor", "name": f"c{i}",
                "table": tb}], wait=30.0)
            assert out["applied"] is True
        st = _wait_converged(svc, "crash")
        uninterrupted = st["last"]["cost"]
        # kill -9 equivalent: no close record, no park, no drain.
        svc._scheduler.shutdown(timeout=10)
        svc._journal._f.close()

        svc2 = _service(journal_dir=journal_dir,
                        recover=True).start()
        try:
            st = svc2.sessions.status("crash")
            assert st["replayed"] is True
            assert st["seq"] == 3 and st["applied_seq"] == 3
            st = _wait_converged(svc2, "crash")
            assert st["last"]["cost"] == uninterrupted
            final = svc2.sessions.close("crash")
            assert final["cost"] == uninterrupted
        finally:
            svc2.stop(drain=False)
        # Closed is closed: a third recover must not resurrect it.
        svc3 = _service(journal_dir=journal_dir,
                        recover=True).start()
        try:
            with pytest.raises(KeyError):
                svc3.sessions.status("crash")
        finally:
            svc3.stop(drain=False)

    def test_checkpointed_recovery_restores_warm_state(self):
        import tempfile

        rng = np.random.default_rng(22)
        journal_dir = tempfile.mkdtemp(prefix="sess_ck_battery_")
        svc = _service(journal_dir=journal_dir,
                       session_checkpoint_every_events=1).start()
        svc.sessions.open(_path(10, 22), params=PARITY_PARAMS,
                          session_id="warm")
        for i in range(2):
            svc.sessions.apply_events("warm", [{
                "type": "change_factor", "name": f"c{i}",
                "table": _table(rng).tolist()}], wait=30.0)
        st = _wait_converged(svc, "warm")
        expected = st["last"]["cost"]
        ckpt = os.path.join(journal_dir, "session_warm.npz")
        assert os.path.exists(ckpt), "per-event checkpoint missing"
        kinds = [r["kind"] for r in
                 scan_journal(svc._journal.path)[0]]
        assert kinds.count("session_ckpt") >= 2
        svc._scheduler.shutdown(timeout=10)
        svc._journal._f.close()

        svc2 = _service(journal_dir=journal_dir,
                        recover=True).start()
        try:
            sess = svc2.sessions._sessions["warm"]
            # The restored engine starts from the checkpointed
            # cycle count, not from zero.
            assert sess.last_cycle > 0, \
                "recovery ignored the engine-state checkpoint"
            st = _wait_converged(svc2, "warm")
            assert st["last"]["cost"] == expected
        finally:
            svc2.stop(drain=False)

    def test_graceful_park_then_recover(self):
        import tempfile

        journal_dir = tempfile.mkdtemp(prefix="sess_park_")
        svc = _service(journal_dir=journal_dir).start()
        svc.sessions.open(_ring(8, 23), params={"noise": 0.0},
                          session_id="park")
        _wait_converged(svc, "park")
        summary = svc.stop()
        assert summary["parked_sessions"] == 1
        st = svc.sessions.status("park")
        assert st["status"] == "REPLAYABLE"
        svc2 = _service(journal_dir=journal_dir,
                        recover=True).start()
        try:
            st = svc2.sessions.status("park")
            assert st["status"] == "OPEN" and st["replayed"]
            final = svc2.sessions.close("park")
            assert final["status"] == "CLOSED"
        finally:
            svc2.stop(drain=False)

    def test_journal_less_stop_fails_open_sessions(self):
        svc = _service().start()
        svc.sessions.open(_ring(6, 24), params={"noise": 0.0},
                          session_id="lost")
        _wait_converged(svc, "lost")
        summary = svc.stop()
        assert summary["parked_sessions"] == 1
        st = svc.sessions.status("lost")
        assert st["status"] == "ERROR"

    def test_replay_tolerates_failed_batch_like_live(self):
        """A batch that failed semantically in live operation (acked,
        journaled, batch-scoped error) must fail IDENTICALLY on
        crash replay — earlier actions stand, later acked batches
        still apply, and the recovered final equals the
        uninterrupted run (review regression: replay used to abort
        the whole session at the first bad batch)."""
        import tempfile

        rng = np.random.default_rng(62)
        good1 = _table(rng).tolist()
        good2 = _table(rng).tolist()
        journal_dir = tempfile.mkdtemp(prefix="sess_tol_")
        svc = _service(journal_dir=journal_dir).start()
        svc.sessions.open(_path(10, 62), params=PARITY_PARAMS,
                          session_id="tol")
        out = svc.sessions.apply_events("tol", [{
            "type": "change_factor", "name": "c0",
            "table": good1}], wait=30.0)
        assert out["applied"] is True
        out = svc.sessions.apply_events("tol", [{
            "type": "change_factor", "name": "ghost",
            "table": good1}], wait=30.0)
        assert out["applied"] is False
        out = svc.sessions.apply_events("tol", [{
            "type": "change_factor", "name": "c1",
            "table": good2}], wait=30.0)
        assert out["applied"] is True
        st = _wait_converged(svc, "tol")
        uninterrupted = st["last"]["cost"]
        svc._scheduler.shutdown(timeout=10)
        svc._journal._f.close()

        svc2 = _service(journal_dir=journal_dir,
                        recover=True).start()
        try:
            st = svc2.sessions.status("tol")
            assert st["status"] == "OPEN", \
                "failed batch aborted the whole session replay"
            assert st["applied_seq"] == 3
            st = _wait_converged(svc2, "tol")
            assert st["last"]["cost"] == uninterrupted
        finally:
            svc2.stop(drain=False)

    def test_concurrent_patches_journal_in_seq_order(self):
        """Racing PATCH threads must reach the journal in seq order
        (review regression: seq was assigned under the lock but
        journaled outside it, so replay order could diverge from
        live apply order) — and the recovered state must equal the
        crashed process's."""
        import tempfile

        rng = np.random.default_rng(63)
        tables = [_table(rng).tolist() for _ in range(6)]
        journal_dir = tempfile.mkdtemp(prefix="sess_race_")
        svc = _service(journal_dir=journal_dir).start()
        svc.sessions.open(_path(10, 63), params=PARITY_PARAMS,
                          session_id="race")
        threads = [
            threading.Thread(
                target=svc.sessions.apply_events,
                args=("race", [{"type": "change_factor",
                                "name": f"c{i}",
                                "table": tables[i]}]))
            for i in range(6)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        records, _, _ = scan_journal(svc._journal.path)
        seqs = [r["seq"] for r in records
                if r["kind"] == "session_event"]
        assert seqs == sorted(seqs) and len(set(seqs)) == 6, \
            f"journal seq order broken: {seqs}"
        st = _wait_converged(svc, "race")
        live_cost = st["last"]["cost"]
        svc._scheduler.shutdown(timeout=10)
        svc._journal._f.close()
        svc2 = _service(journal_dir=journal_dir,
                        recover=True).start()
        try:
            st = _wait_converged(svc2, "race")
            assert st["last"]["cost"] == live_cost
        finally:
            svc2.stop(drain=False)

    def test_patch_ack_is_durable_before_return(self):
        import tempfile

        rng = np.random.default_rng(25)
        journal_dir = tempfile.mkdtemp(prefix="sess_dur_")
        svc = _service(journal_dir=journal_dir).start()
        try:
            svc.sessions.open(_ring(8, 25), params={"noise": 0.0},
                              session_id="dur")
            svc.sessions.apply_events("dur", [{
                "type": "change_factor", "name": "c0",
                "table": _table(rng).tolist()}])
            # No wait: the record must ALREADY be on disk when
            # apply_events returned, applied or not.
            records, _, _ = scan_journal(svc._journal.path)
            kinds = [r["kind"] for r in records]
            assert "session_event" in kinds
        finally:
            svc.stop(drain=False)


# ------------------------------------------------------------------ #
# tracing


class TestSessionTracing:
    def test_session_tree_is_queryable_by_trace_id(self):
        from pydcop_tpu_torch.observability.trace import query_request

        rng = np.random.default_rng(26)
        tracer.enable()
        svc = _service().start()
        try:
            sess = svc.sessions.open(_ring(8, 26),
                                     params={"noise": 0.0},
                                     session_id="traced")
            svc.sessions.apply_events("traced", [{
                "type": "change_factor", "name": "c0",
                "table": _table(rng).tolist()}], wait=30.0)
            svc.sessions.close("traced")
            events = tracer.events()
            tid = sess.trace_id
        finally:
            svc.stop(drain=False)
            tracer.disable()
        tree = query_request(events, tid)
        assert tree["events"] > 0
        names = set(tree["names"])
        assert {"session_open", "session_events",
                "session_segment"} <= names, names

        def _flat(nodes):
            for node in nodes:
                yield node
                yield from _flat(node["children"])

        for node in _flat(tree["tree"]):
            args = node["args"]
            assert (args.get("trace_id") == tid
                    or tid in (args.get("trace_ids") or [])), \
                f"{node['name']} span missing the session tag"

    def test_event_batch_has_its_own_queryable_id(self):
        from pydcop_tpu_torch.observability.trace import query_request

        rng = np.random.default_rng(27)
        tracer.enable()
        svc = _service().start()
        try:
            svc.sessions.open(_ring(8, 27), params={"noise": 0.0},
                              session_id="batchtid")
            out = svc.sessions.apply_events("batchtid", [{
                "type": "change_factor", "name": "c0",
                "table": _table(rng).tolist()}], wait=30.0)
            events = tracer.events()
        finally:
            svc.stop(drain=False)
            tracer.disable()
        tree = query_request(events, out["trace_id"])
        assert "session_events" in tree["names"]


# ------------------------------------------------------------------ #
# scenario replay (the --scenario machinery)


class TestScenarioReplay:
    def test_generated_factor_scenario_replays(self):

        dcop = _ring(10, 28)
        scenario = _generated_factor_scenario(dcop, 8, seed=28)
        out = replay_scenario(dcop, scenario,
                              params={"noise": 0.0},
                              max_cycles=300, device="cpu")
        assert out["event_count"] == 8
        assert len(out["events"]) == 8
        # In-shape events never recompile; only grow events may.
        for rec in out["events"]:
            if set(rec["actions"]) <= {"change_factor",
                                       "remove_factor"}:
                assert rec["recompiles"] == 0, rec
        assert np.isfinite(out["cost"])
        # Every original variable (plus any grown ones) is assigned.
        assert set(v for v in dcop.variables) <= \
            set(out["assignment"])

    def test_agent_removal_scenario_re_homes(self):
        from pydcop_tpu_torch.dcop.scenario import (
            DcopEvent,
            EventAction,
            Scenario,
        )

        dcop = _ring(8, 29)
        scenario = Scenario([
            DcopEvent("e0", actions=[
                EventAction("remove_agent", agent="a1")]),
            DcopEvent("d0", delay=5.0),
        ])
        out = replay_scenario(dcop, scenario,
                              params={"noise": 0.0},
                              max_cycles=200, device="cpu")
        assert out["orphaned"] == []
        assert out["converged"]

    def test_all_agents_removed_orphans_not_crashes(self):
        from pydcop_tpu_torch.dcop.scenario import (
            DcopEvent,
            EventAction,
            Scenario,
        )

        dcop = _ring(6, 30)
        scenario = Scenario([
            DcopEvent("e0", actions=[
                EventAction("remove_agent", agent="a0"),
                EventAction("remove_agent", agent="a1")]),
        ])
        out = replay_scenario(dcop, scenario,
                              params={"noise": 0.0},
                              max_cycles=200, device="cpu")
        assert out["orphaned"], \
            "orphaned computations must be reported"
        assert out["converged"]

    def test_removed_hard_constraint_not_counted_as_violation(self):
        """A hard (inf) constraint the scenario removes no longer
        binds the solution: the replay's violation count must come
        from the LIVE factor set, not the original problem's tables
        (review regression)."""
        from pydcop_tpu_torch.dcop.scenario import (
            DcopEvent,
            EventAction,
            Scenario,
        )

        dom = Domain("c", "", [0, 1])
        dcop = DCOP("hard", objective="min")
        a, b = Variable("a", dom), Variable("b", dom)
        dcop.add_variable(a)
        dcop.add_variable(b)
        # Hard: a and b must differ.  Soft: both prefer value 0.
        hard = np.array([[float("inf"), 0.0], [0.0, float("inf")]])
        dcop.add_constraint(NAryMatrixRelation([a, b], hard, "hard"))
        dcop.add_constraint(NAryMatrixRelation(
            [a, b], np.array([[0.0, 1.0], [1.0, 2.0]]), "soft"))
        dcop.add_agents([AgentDef("a0")])
        scenario = Scenario([DcopEvent("e0", actions=[
            EventAction("remove_factor", name="hard")])])
        out = replay_scenario(dcop, scenario, params={"noise": 0.0},
                              max_cycles=200, device="cpu")
        # Without the hard constraint, (0, 0) is optimal — it would
        # violate the REMOVED constraint, and must not count.
        assert out["assignment"] == {"a": 0, "b": 0}
        assert out["violations"] == 0
        assert out["factors"] == ["soft"]

    def test_scenario_yaml_round_trip(self):
        from pydcop_tpu_torch.dcop.yamldcop import (
            load_scenario,
            yaml_scenario,
        )

        dcop = _ring(8, 31)
        scenario = _generated_factor_scenario(dcop, 5, seed=31)
        loaded = load_scenario(yaml_scenario(scenario))
        assert len(loaded) == len(scenario)
        out = replay_scenario(dcop, loaded, params={"noise": 0.0},
                              max_cycles=200, device="cpu")
        assert out["event_count"] == 5
