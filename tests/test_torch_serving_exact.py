"""The serving cases of ``tests/unit/test_exact_inference_battery.py``
(``TestDpopServingHTTP``, ``TestSessionOracle``), case for case,
against the port (``pydcop_tpu_torch``) on the CPU: ``algo: "dpop"``
requests through ``api.serve(device="cpu")`` — optimal, equal to the
solo solve, the over-width structure a structured 400 — and the
session oracle tier (a DPOP certification of a quiesced session).
"""

import itertools
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pydcop_tpu_torch import api
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation

import torch_serving_common as common


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host."""
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


def _random_dcop(n, d, seed, extra_edges=0, objective="min",
                 integer=True, lo=0, hi=20):
    """Random spanning tree + optional extra edges, integer tables by
    default (integer optima make cost equality exact, not approx)."""
    rng = np.random.default_rng(seed)
    dom = Domain("c", "", list(range(d)))
    dcop = DCOP("t", objective=objective)
    vs = [Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)

    def table(shape):
        if integer:
            return rng.integers(lo, hi, shape).astype(float)
        return rng.random(shape)

    k = 0
    for i in range(1, n):
        p = rng.integers(0, i)
        dcop.add_constraint(NAryMatrixRelation(
            [vs[p], vs[i]], table((d, d)), f"c{k}"))
        k += 1
    for _ in range(extra_edges):
        i, j = rng.choice(n, size=2, replace=False)
        dcop.add_constraint(NAryMatrixRelation(
            [vs[i], vs[j]], table((d, d)), f"c{k}"))
        k += 1
    dcop.add_agents([AgentDef(f"a{i}") for i in range(n)])
    return dcop


def _domino_chain(n=140, weak_at=None):
    """The portfolio battery structure: a binary agreement chain with
    one weak link in the middle and opposing biases pinned at the two
    ends.  The optimum (cost 1: break at the weak link) needs
    end-to-end propagation — more cycles than any iterative
    candidate's race leg gets — so DPOP is the only candidate whose
    race answer lands within cost tolerance of the best."""
    weak_at = n // 2 if weak_at is None else weak_at
    dom = Domain("b", "", [0, 1])
    dcop = DCOP("domino", objective="min")
    vs = [Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for i in range(n - 1):
        m = (np.array([[0.0, 1.0], [1.0, 0.0]]) if i == weak_at
             else np.array([[0.0, 5.0], [5.0, 0.0]]))
        if i == 0:
            m = m + np.array([[0.0, 0.0], [3.0, 3.0]])   # v0 -> 0
        if i == n - 2:
            m = m + np.array([[3.0, 0.0], [3.0, 0.0]])   # v_last -> 1
        dcop.add_constraint(NAryMatrixRelation(
            [vs[i], vs[i + 1]], m, f"m{i}"))
    dcop.add_agents([AgentDef(f"a{i}") for i in range(n)])
    return dcop


def _dpop(dcop, engine="jit", cec="on"):
    from pydcop_tpu_torch.algorithms import AlgorithmDef
    from pydcop_tpu_torch.algorithms.dpop import solve_on_device

    algo = AlgorithmDef.build_with_default_param(
        "dpop", {"engine": engine, "cec": cec}, mode=dcop.objective)
    return solve_on_device(dcop, algo, device="cpu")


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _wide_clique_yaml(n=12, d=10):
    lines = ["name: wide", "objective: min", "domains:",
             "  d: {values: [" + ", ".join(map(str, range(d))) + "]}",
             "variables:"]
    for i in range(n):
        lines.append(f"  x{i}: {{domain: d}}")
    lines.append("constraints:")
    for i, j in itertools.combinations(range(n), 2):
        lines.append(f"  c{i}_{j}: {{type: intention, function: "
                     f"\"1 if x{i} == x{j} else 0\"}}")
    lines.append("agents: [a0]")
    return "\n".join(lines)


class TestDpopServingHTTP:
    def test_dpop_request_is_optimal_and_matches_solo(self):
        from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml

        dcop = _random_dcop(10, 3, 21)
        yaml_src = dcop_yaml(dcop)
        with api.serve(port=0, batch_window_s=0.02, device="cpu") as handle:
            code, res = _post(handle.url + "/solve",
                              {"dcop": yaml_src, "wait": True,
                               "params": {"algo": "dpop"}})
            assert code == 200 and res["status"] == "FINISHED"
            assert res["optimal"] is True, \
                "exact dispatches must certify their result"
            solo = _dpop(dcop)
            assert {k: v for k, v in res["assignment"].items()} == \
                {k: v for k, v in solo.assignment.items()}
            stats = _get(handle.url + "/stats")
            assert stats["dpop_dispatches"] >= 1
            # The iterative default never carries the flag.
            code2, res2 = _post(handle.url + "/solve",
                                {"dcop": yaml_src, "wait": True})
            assert code2 == 200 and "optimal" not in res2

    def test_over_width_is_structured_400_not_breaker_500(self):
        with api.serve(port=0, batch_window_s=0.02,
                       breaker_failures=1, device="cpu") as handle:
            code, res = _post(handle.url + "/solve",
                              {"dcop": _wide_clique_yaml(),
                               "wait": True,
                               "params": {"algo": "dpop"}})
            assert code == 400, \
                "an over-width exact request is a client error"
            assert res["status"] == "rejected_width"
            assert res["max_elements"] > res["max_elements_cap"]
            assert res["retry"] is False
            # The breaker never saw it (breaker_failures=1 would have
            # opened on a single dispatch failure): healthy service,
            # iterative requests still served.
            stats = _get(handle.url + "/stats")
            assert stats["breaker_state"] == "closed"
            code2, res2 = _post(
                handle.url + "/solve",
                {"dcop": _wide_clique_yaml(), "wait": True,
                 "params": {"algo": "maxsum", "max_cycles": 20}})
            assert code2 == 200 and res2["status"] == "FINISHED"

    def test_unknown_algo_param_rejected(self):
        with api.serve(port=0, batch_window_s=0.02, device="cpu") as handle:
            code, res = _post(handle.url + "/solve",
                              {"dcop": _wide_clique_yaml(4, 2),
                               "wait": True,
                               "params": {"algo": "simplex"}})
            assert code == 400
            assert "algo" in res["error"]


# ------------------------------------------------------------------ #
# the session oracle


class TestSessionOracle:
    def _open(self, svc, dcop, params):
        return svc.sessions.open(dcop, params=params)

    def _wait_quiesced(self, svc, sid, timeout=30.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = svc.sessions.status(sid)
            last = st["last"]
            if last is not None and (last.get("converged")
                                     or st.get("budget", 1) == 0):
                return st
            time.sleep(0.05)
        raise AssertionError(f"session {sid} never quiesced")

    def _wait_certified(self, svc, n=1, timeout=30.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            stats = svc.sessions.stats()
            if stats["certifications"] >= n:
                return stats
            time.sleep(0.05)
        raise AssertionError("oracle never certified "
                             f"(stats: {svc.sessions.stats()})")

    def test_quiesced_session_is_certified_with_delta_in_stats(self):
        from pydcop_tpu_torch.serving.service import SolveService

        svc = SolveService(batch_window_s=0.02,
                           session_certify_after=0.2, device="cpu").start()
        try:
            sess = self._open(svc, _random_dcop(10, 3, 31),
                              {"noise": 0.0, "max_cycles": 300})
            q = svc.sessions.subscribe(sess.id)
            self._wait_quiesced(svc, sess.id)
            stats = self._wait_certified(svc)
            cert = stats["last_certification"]
            assert cert["session"] == sess.id
            assert cert["delta"] >= 0.0
            assert stats["certify_after"] == pytest.approx(0.2)
            # The SSE stream carried the certified event.
            deadline = time.monotonic() + 10
            phases = []
            while time.monotonic() < deadline:
                try:
                    ev = q.get(timeout=0.5)
                except Exception:
                    continue
                phases.append(ev.get("phase"))
                if ev.get("phase") == "certified":
                    assert ev["optimal"] is True
                    assert ev["certified_cost"] == pytest.approx(
                        cert["certified_cost"])
                    assert "delta" in ev
                    break
            assert "certified" in phases, \
                f"no certified SSE event (saw {phases})"
        finally:
            svc.stop(drain=False)

    def test_improving_certification_updates_served_assignment(self):
        """On the domino chain the warm fixpoint is provably
        suboptimal within the cycle budget: the oracle's exact solve
        must IMPROVE the served answer in place — no recompile."""
        from pydcop_tpu_torch.serving.service import SolveService

        svc = SolveService(batch_window_s=0.02,
                           session_certify_after=0.2, device="cpu").start()
        try:
            dcop = _domino_chain(60, weak_at=30)
            sess = self._open(svc, dcop, {
                "noise": 0.0, "max_cycles": 30,
                "segment_cycles": 15})
            # Certification only happens after quiescence — waiting
            # for it subsumes waiting for the fixpoint.
            stats = self._wait_certified(svc)
            cert = stats["last_certification"]
            assert cert["improved"] is True
            assert cert["delta"] > 0
            assert cert["certified_cost"] == pytest.approx(1.0)
            assert cert["fixpoint_cost"] > cert["certified_cost"]
            st1 = svc.sessions.status(sess.id)
            assert st1["last"]["cost"] == pytest.approx(1.0), \
                "the served answer must upgrade to the optimum"
            assert st1["last"]["optimal"] is True
            cost, violations = dcop.solution_cost(
                st1["last"]["assignment"])
            assert violations == 0 and cost == pytest.approx(1.0)
            assert st1["recompiles"] == 0, \
                "certification must never recompile the warm engine"
            assert stats["certified_improved"] >= 1
        finally:
            svc.stop(drain=False)

    def test_oracle_off_by_default(self):
        from pydcop_tpu_torch.serving.service import SolveService

        svc = SolveService(batch_window_s=0.02, device="cpu").start()
        try:
            sess = self._open(svc, _random_dcop(8, 3, 37),
                              {"noise": 0.0, "max_cycles": 200})
            self._wait_quiesced(svc, sess.id)
            time.sleep(0.5)
            stats = svc.sessions.stats()
            assert stats["certify_after"] is None
            assert stats["certifications"] == 0
        finally:
            svc.stop(drain=False)
