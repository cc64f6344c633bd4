"""A port fleet of two CPU workers (``api.serve(port=0, replicas=2,
device="cpu")``) against the port's single ``SolveService`` and the
reference's solo solve: the end-to-end halves of
``tests/unit/test_fleet_battery.py``, ``test_elastic_fleet_battery.py``
and ``test_fleettrace_battery.py`` that fall inside the fixed-size
fleet, on one module-scoped fleet.

Tolerance: none.  Every answer through the router equals the port's
single service's answer to the same request and the reference's solo
``api.solve`` (assignment and cost; a stacked member reports the
stack's cycle count in both packages, so cycles are compared with the
single service only where both dispatched the request alone).  Also
held: the async path riding the pin table, the router's ``/stats`` keys
equal to the reference router's, ``/healthz``, 404/400 answers, a
session opened, PATCHed, streamed and closed through the router equal
to the same session on an in-process service, ``POST /admin/migrate``
moving a live session, the fleet surfaces (``/fleet/metrics``
conservation against the router's ledger, the pooled ``/fleet/profile``,
``/fleet/trace``, live and offline ``fleet forensics``), a lost
``/solve`` response retried and deduplicated as one execution in the
forensics tree, and ``python -m pydcop_tpu_torch serve --replicas 2
--device cpu`` draining to exit 0 on SIGTERM (its own fleet).
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.request

import pytest
import torch

import torch_fleet_common as fleet_common
import torch_serving_common as common
from torch_fleet_common import poll

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"max_cycles": 60}
# The router validates a session's params as the affinity key's (the
# reference's rule), which knows no ``segment_cycles``: the segment is
# the service default, 50 cycles.
SESSION_PARAMS = {"max_cycles": 50, "noise": 0.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    with fleet_common.cpu_fleet(tmp_path_factory.mktemp("fleet"),
                                batch_window_s=0.05,
                                max_batch=8) as handle:
        yield handle


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    with common.isolated(monkeypatch, tmp_path):
        yield


def _post(url, body, timeout=120):
    return common.http(url + "/solve", "POST", body, timeout=timeout)


def _reference_solo(yaml_src, params=PARAMS):
    from pydcop_tpu import api as ref_api

    return ref_api.solve(common.load("jax", yaml_src), "maxsum",
                         backend="device", **params)


def _answers_equal(got, want):
    assert got["status"] == want["status"] == "FINISHED", got
    assert (got["assignment"], got["cost"]) == (want["assignment"],
                                                want["cost"])


def test_two_replica_fleet_serves_like_one_service(fleet):
    yamls = ([common.ring_yaml(9, 30 + s) for s in range(3)]
             + [common.ring_yaml(12, 60 + s, chords=2) for s in range(3)])
    results = [None] * len(yamls)

    def client(i):
        results[i] = _post(fleet.url, {"dcop": yamls[i], "wait": True,
                                       "timeout": 120, "params": PARAMS})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(yamls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert all(r is not None and r[0] == 200 for r in results), results
    single, _ = common.serve_stream("torch", yamls, params=PARAMS,
                                    batch_window_s=0.01, max_batch=1)
    for y, (_, got), one in zip(yamls, results, single):
        _answers_equal(got, one)
        _answers_equal(got, _reference_solo(y))
        if got["batch"]["n_real"] == 1:
            assert common.key_fields(got) == common.key_fields(one)
    stats = fleet.router.stats()
    assert sum(w["forwarded"] for w in stats["workers"]) \
        == stats["routed"] >= len(yamls)
    assert stats["affinity_hit_fraction"] > 0


def test_async_submit_rides_the_pin_table(fleet):
    yaml_src = common.ring_yaml(10, 5)
    code, ack = _post(fleet.url, {"dcop": yaml_src, "params": PARAMS,
                                  "request_id": "client-chosen"})
    assert code == 202 and ack["id"].startswith("f"), ack
    assert fleet.router.pinned(ack["id"]) is not None
    code, body = fleet_common.await_result(fleet.url, ack["id"])
    assert code == 200
    _answers_equal(body, _reference_solo(yaml_src))


def test_stats_keys_equal_the_reference_router(fleet):
    import pydcop_tpu.serving.router as ref_router

    ref = ref_router.FleetRouter(replicas=2)
    ref.replicas.append(ref_router.Replica(0, None, "/dev/null"))
    want = ref.stats()
    code, doc = common.http(fleet.url + "/stats")
    assert code == 200 and doc["up"] == 2 and doc["replicas"] == 2
    assert sorted(doc) == sorted(want)
    assert sorted(doc["fairness"]) == sorted(want["fairness"])
    for worker in doc["workers"]:
        assert sorted(set(worker) - {"stats"}) \
            == sorted(want["workers"][0])
        assert worker["stats"]["efficiency"]["backend"] == "cpu"
    assert doc["compile_cache"]["dir"].endswith("kernels")


def test_healthz_and_link_verdicts(fleet):
    code, doc = common.http(fleet.url + "/healthz")
    assert code == 200 and doc["status"] == "ok", doc
    assert [link["verdict"] for link in doc["fleet"]["links"]] \
        == ["ok", "ok"]


def test_unknown_result_404_and_bad_body_400(fleet):
    assert common.http(fleet.url + "/result/nope")[0] == 404
    assert _post(fleet.url, {"dcop": "   "})[0] == 400
    assert _post(fleet.url, {"dcop": "not: [valid"})[0] == 400
    assert common.http(fleet.url + "/nowhere", "POST", {})[0] == 404


def _session_batches(n_vars, seed, n):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [[{"type": "change_factor",
              "name": f"c{int(rng.integers(n_vars))}",
              "table": rng.integers(0, 10, size=(3, 3))
              .astype(float).tolist()}] for _ in range(n)]


def _in_process_session(yaml_src, batches):
    """The same session on an in-process port service: each batch's
    segment result and the final close."""
    from pydcop_tpu_torch.serving.service import SolveService

    svc = SolveService(device="cpu", batch_window_s=0.01,
                       speculate=False).start()
    try:
        sess = svc.sessions.open(common.load("torch", yaml_src),
                                 params=SESSION_PARAMS)
        patches = [svc.sessions.apply_events(sess.id, b, wait=120)
                   ["result"] for b in batches]
        return patches, svc.sessions.close(sess.id, wait=120)
    finally:
        svc.stop(drain=False)


SEGMENT_KEYS = ("cycle", "cost", "converged", "assignment")


def test_session_through_the_router(fleet):
    yaml_src = common.small_yaml(24, 3)
    batches = _session_batches(24, 7, 3)
    code, opened = common.http(fleet.url + "/session", "POST", {
        "dcop": yaml_src, "params": SESSION_PARAMS})
    assert code == 201, opened
    sid = opened["session_id"]
    owner = fleet.router.pinned(sid, fleet.router._session_pins)
    assert owner is not None
    stream = urllib.request.urlopen(
        fleet.url + f"/session/{sid}/events", timeout=30)
    first = stream.readline()
    while not first.startswith(b"data:"):
        first = stream.readline()
    patches = []
    for batch in batches:
        code, out = common.http(fleet.url + f"/session/{sid}/events",
                                "PATCH", {"events": batch, "wait": True,
                                          "timeout": 60})
        assert code == 200 and out["applied"], out
        patches.append(out["result"])
    code, status = common.http(fleet.url + f"/session/{sid}")
    assert code == 200 and status["session_id"] == sid
    code, final = common.http(fleet.url + f"/session/{sid}", "DELETE")
    assert code == 200 and final["status"] == "CLOSED", final
    rest = stream.read()
    stream.close()
    assert b'"phase": "closed"' in rest
    want_patches, want_final = _in_process_session(yaml_src, batches)
    for got, want in zip(patches, want_patches):
        assert [got[k] for k in SEGMENT_KEYS] \
            == [want[k] for k in SEGMENT_KEYS]
    for k in ("assignment", "cost", "cycles", "converged",
              "events_applied"):
        assert final[k] == want_final[k], k


def test_admin_migrate_moves_a_live_session(fleet):
    router = fleet.router
    yaml_src = common.small_yaml(24, 4)
    batches = _session_batches(24, 8, 2)
    code, opened = common.http(fleet.url + "/session", "POST", {
        "dcop": yaml_src, "params": SESSION_PARAMS})
    assert code == 201, opened
    sid = opened["session_id"]
    before = router.pinned(sid, router._session_pins)
    code, out = common.http(fleet.url + f"/session/{sid}/events",
                            "PATCH", {"events": batches[0], "wait": True,
                                      "timeout": 60})
    assert code == 200 and out["seq"] == 1, out
    assert common.http(fleet.url + "/admin/migrate", "POST", {})[0] == 400
    assert common.http(fleet.url + "/admin/migrate", "POST",
                       {"session_id": "nope"})[0] == 404
    code, moved = common.http(fleet.url + "/admin/migrate", "POST",
                              {"session_id": sid})
    assert code == 200, moved
    after = router.pinned(sid, router._session_pins)
    assert after is not before and router.session_epoch(sid) == 2
    assert router.stats()["migrations"] >= 1
    code, out = common.http(fleet.url + f"/session/{sid}/events",
                            "PATCH", {"events": batches[1], "wait": True,
                                      "timeout": 60})
    assert code == 200 and out["seq"] == 2, out
    code, final = common.http(fleet.url + f"/session/{sid}", "DELETE")
    # ``events_applied`` counts what the new owner applied: the bundle
    # is rebased, its problem already holds the first batch (the
    # reference's rule, sessions.py's rebuild).
    assert code == 200 and final["status"] == "CLOSED", final
    assert final["events_applied"] == 1, final


def _ok_total(url):
    code, doc = common.http(url + "/fleet/metrics?format=json")
    assert code == 200, doc
    fam = doc["metrics"].get("pydcop_requests_total", {"samples": []})
    return sum(s["value"] for s in fam["samples"]
               if s["labels"].get("status") == "ok")


def test_fleet_metrics_conserve_the_router_ledger(fleet):
    ok_before = _ok_total(fleet.url)
    routed_before = fleet.router.stats()["routed"]
    for i in range(4):
        code, out = _post(fleet.url, {
            "dcop": common.ring_yaml(7 + i % 2, 40 + i),
            "params": PARAMS, "wait": True, "timeout": 120})
        assert code == 200 and out["status"] == "FINISHED", out
    assert fleet.router.stats()["routed"] - routed_before == 4
    poll(lambda: _ok_total(fleet.url) - ok_before == 4, 15,
         what="the replicas' ok counters")
    req = urllib.request.urlopen(fleet.url + "/fleet/metrics", timeout=30)
    text = req.read()
    assert b'replica="replica-' in text and b"pydcop_requests_total" in text


def test_fleet_profile_pools_both_replicas(fleet):
    code, doc = common.http(fleet.url + "/fleet/profile")
    assert code == 200 and doc["n_replicas"] == 2
    assert set(doc["replicas"]) == {"replica-0", "replica-1"}
    for rep in doc["replicas"].values():
        assert rep["backend"]["backend"] in ("cpu", "unknown")
    ledger = doc["ledger"]
    total = max(float(ledger["total_s"]), 1e-9)
    assert abs(float(ledger["unaccounted_abs_s"])) <= 0.05 * total


def _forensics(url, rid, names):
    def ready():
        code, doc = common.http(url + f"/fleet/forensics/{rid}")
        return doc if code == 200 and names <= set(doc["names"]) else None

    return poll(ready, 15, every=0.25, what=f"forensics of {rid}")


def test_live_forensics_and_the_command(fleet, capsys):
    from pydcop_tpu_torch.commands import fleet as fleet_cmd

    code, ack = _post(fleet.url, {"dcop": common.ring_yaml(9, 77),
                                  "params": PARAMS, "wait": True,
                                  "timeout": 120})
    assert code == 200, ack
    rid = ack["id"]
    doc = _forensics(fleet.url, rid, {"router_request",
                                      "router_route_pick",
                                      "serve_submit", "serve_dispatch"})
    assert doc["request_id"] == rid and doc["trace_id"] == ack["trace_id"]
    assert doc["well_nested"] and doc["lanes"] >= 2
    args = argparse.Namespace(request_id=rid, url=fleet.url, trace=None,
                              timeout=10.0, as_json=True)
    assert fleet_cmd.run_forensics(args) == 0
    assert json.loads(capsys.readouterr().out)["trace_id"] \
        == ack["trace_id"]
    args = argparse.Namespace(request_id="x", url=None, trace=None,
                              timeout=10.0, as_json=False)
    assert fleet_cmd.run_forensics(args) == 2
    assert common.http(fleet.url + "/fleet/forensics/nosuchid")[0] == 404


def test_offline_forensics_command(fleet, tmp_path, capsys):
    from pydcop_tpu_torch.commands import fleet as fleet_cmd

    code, ack = _post(fleet.url, {"dcop": common.ring_yaml(8, 55),
                                  "params": PARAMS, "wait": True,
                                  "timeout": 120})
    assert code == 200, ack
    rid = ack["id"]
    _forensics(fleet.url, rid, {"serve_dispatch"})
    code, trace_doc = common.http(fleet.url + "/fleet/trace")
    assert code == 200 and trace_doc["version"] == 1
    path = tmp_path / "fleet_trace.json"
    path.write_text(json.dumps(trace_doc))
    args = argparse.Namespace(request_id=rid, url=None, trace=[str(path)],
                              timeout=10.0, as_json=True)
    assert fleet_cmd.run_forensics(args) == 0
    offline = json.loads(capsys.readouterr().out)
    assert offline["request_id"] == rid and offline["well_nested"]
    assert "router_route_pick" in offline["names"]
    args.as_json = False
    assert fleet_cmd.run_forensics(args) == 0
    out = capsys.readouterr().out
    assert "[route-pick]" in out and f"request {rid}" in out
    args.request_id = "nope"
    assert fleet_cmd.run_forensics(args) == 1


def test_lost_response_is_retried_and_executed_once(fleet):
    """A /solve whose response is lost after execution: the router
    retries against the same replica, the worker deduplicates on the
    minted id, and the forensics tree shows one execution."""
    from pydcop_tpu_torch.serving import netfault

    netfault.install("seed=20;link=router>replica-*,path=/solve,"
                     "lose_response=1.0,times=1")
    try:
        code, ack = _post(fleet.url, {"dcop": common.ring_yaml(10, 20),
                                      "params": {"max_cycles": 100},
                                      "deadline_s": 30.0})
        assert code == 202, ack
        assert netfault.counters().get("lose_response") == 1
    finally:
        netfault.clear()
    rid = ack["id"]
    code, out = fleet_common.await_result(fleet.url, rid)
    assert code == 200 and out["status"] == "FINISHED"
    doc = _forensics(fleet.url, rid, {"router_retry", "serve_dedupe",
                                      "serve_dispatch",
                                      "netfault_injected"})
    assert doc["well_nested"]

    def flat(nodes):
        for node in nodes:
            yield node
            yield from flat(node["children"])

    executes = [n for n in flat(doc["tree"])
                if n["name"] == "serve_dispatch" and n["ph"] == "X"]
    assert len(executes) == 1
    assert fleet.router.stats()["retries"] >= 1


def test_cli_fleet_serves_and_drains(tmp_path):
    """``serve --replicas 2 --device cpu`` answers like the reference
    and drains every worker to exit 0 on SIGTERM."""
    port_file = tmp_path / "port"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               PYDCOP_FLIGHT_DIR=str(tmp_path / "bundles"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "pydcop_tpu_torch", "serve", "--device",
         "cpu", "--replicas", "2", "--port", "0", "--port_file",
         str(port_file), "--batch_window", "0.01", "--cycles", "40",
         "--journal_dir", str(tmp_path / "journal")],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        poll(lambda: port_file.exists() or proc.poll() is not None, 120,
             what="the fleet's port file")
        assert port_file.exists(), proc.communicate(timeout=10)
        url = f"http://127.0.0.1:{int(port_file.read_text())}"
        yaml_src = common.ring_yaml(10, 3)
        code, body = _post(url, {"dcop": yaml_src, "wait": True})
        assert code == 200, body
        _answers_equal(body, _reference_solo(yaml_src,
                                             {"max_cycles": 40}))
        code, stats = common.http(url + "/stats")
        assert stats["up"] == 2 and stats["routed"] == 1
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            _, err = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
    assert proc.returncode == 0, err
    assert "replica-0=0, replica-1=0" in err
