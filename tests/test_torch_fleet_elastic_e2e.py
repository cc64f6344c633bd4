"""The elastic fleet end to end on one CPU fleet (two journaled workers,
``min_replicas=2``, ``max_replicas=3``, the SLO armed at run time as
the reference's bench arms it): the process half of
``tests/unit/test_elastic_fleet_battery.py`` that the chip phase's
rehearsal (``test_torch_fleet_elastic_chip_phase.py``) does not hold.

- A scale-up: one worker spawned with the router's ``--device`` on
  ``replica-2``, its prewarm replaying the admission exemplars before it
  is routed anything; then requests it owns answer as the reference's
  solo solves, as affinity hits.
- That worker's SIGKILL: the router restarts it in its slot (index 2,
  past the fleet's first N) on its own journal segment.
- ``serve --join``: a process the router did not spawn, routed a
  request it owns, SIGKILLed (down, never restarted, its session
  adopted onto a survivor from the journal it announced), then started
  again on the same port: it re-announces and revives in the same slot,
  routed to again.
- A scale-up still in flight when the fleet stops leaves no process.

Every wait is a poll on a condition with a deadline; every process a
test starts is killed in its teardown.
"""

import os
import signal
import subprocess
import sys

import pytest
import torch

import bench
import chip_smoke
import torch_fleet_common as fleet_common
import torch_serving_common as common
import pydcop_tpu_torch.dcop.dcop as dcop_mod
import pydcop_tpu_torch.dcop.objects as objects
import pydcop_tpu_torch.dcop.relations as relations
from torch_fleet_common import poll

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"max_cycles": 60}


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
    tmp = tmp_path_factory.mktemp("elastic")
    with fleet_common.cpu_fleet(tmp, batch_window_s=0.05, max_batch=16,
                                min_replicas=2, max_replicas=3) as handle:
        handle.tmp = tmp
        handle.router.autoscale_interval_s = 0.2
        yield handle
        for replica in handle.router.replicas:
            if replica.proc is not None and replica.proc.poll() is None:
                replica.proc.kill()


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    with common.isolated(monkeypatch, tmp_path):
        yield


def _owned_by(router, index, n=2):
    """``n`` ring problems whose rendezvous pick is replica ``index``."""
    out = []
    for size in range(6, 40):
        yaml_src = common.ring_yaml(size, 100 + size)
        if chip_smoke.rendezvous_owner(router, yaml_src, PARAMS) == index:
            out.append(yaml_src)
            if len(out) == n:
                return out
    pytest.fail(f"no ring structure lands on replica {index}")


def _solve(url, yaml_src):
    code, body = common.http(url + "/solve", "POST", {
        "dcop": yaml_src, "params": PARAMS, "wait": True, "timeout": 120})
    assert code == 200 and body["status"] == "FINISHED", body
    return body


def _reference(yamls):
    ref, _ = common.serve_stream("jax", yamls, params=PARAMS)
    return [(r["assignment"], r["cost"]) for r in ref]


def test_scale_up_prewarms_then_serves_like_the_reference(fleet):
    router = fleet.router
    warmups = [common.ring_yaml(n, 1) for n in (7, 9, 11)]
    for yaml_src in warmups:
        _solve(fleet.url, yaml_src)
    digests = set(list(router._exemplars)[-4:])
    router.slo_p99_ms = 0.001
    try:
        poll(lambda: router.scale_ups == 1, 180, what="the scale-up")
    finally:
        router.slo_p99_ms = None
    new = router.replicas[2]
    assert (new.index, new.managed, new.status, new.forwarded) \
        == (2, True, "up", 0)
    assert new.warm == digests and len(digests) == 3
    assert new.journal_dir == os.path.join(str(fleet.tmp), "journal",
                                           "replica-2")
    args = new.proc.args
    assert args[args.index("--device") + 1] == "cpu"
    code, stats = common.http(new.url + "/stats")
    assert stats["completed"] == 3, "the prewarm replayed every exemplar"
    owned = _owned_by(router, 2)
    hits = router.affinity_hits
    got = [_solve(fleet.url, y) for y in owned + warmups]
    assert [router.pinned(r["id"]).index for r in got[:2]] == [2, 2]
    assert router.affinity_hits > hits
    assert [(r["assignment"], r["cost"]) for r in got] \
        == _reference(owned + warmups)


def test_a_scaled_up_replica_restarts_in_its_slot(fleet):
    router = fleet.router
    new = router.replicas[2]
    os.kill(new.proc.pid, signal.SIGKILL)
    poll(lambda: new.restarts == 1 and new.status == "up", 180,
         what="the scaled-up replica's restart")
    assert len(router.replicas) == 3 and "--recover" in new.proc.args
    yaml_src = _owned_by(router, 2, n=1)[0]
    body = _solve(fleet.url, yaml_src)
    assert router.pinned(body["id"]) is new
    assert [(body["assignment"], body["cost"])] == _reference([yaml_src])


def _join(fleet, port, journal):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    log = open(os.path.join(str(fleet.tmp), f"remote-{port}.log"), "ab")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "pydcop_tpu_torch.dcop_cli", "serve",
             "--port", str(port), "--device", "cpu", "--join", fleet.url,
             "--journal_dir", journal, "--host_id", "remote0",
             "--batch_window", "0.05"],
            env=env, cwd=REPO, stdout=log, stderr=log,
            start_new_session=True)
    finally:
        log.close()


@pytest.fixture
def remote_procs():
    procs = []
    yield procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_a_joined_worker_dies_is_adopted_and_revives(fleet, remote_procs,
                                                      monkeypatch):
    router = fleet.router
    port = chip_smoke.free_port()
    journal = os.path.join(str(fleet.tmp), "remote")
    remote_procs.append(_join(fleet, port, journal))

    def joined():
        return next((r for r in router.replicas
                     if not r.managed and r.status == "up"), None)

    remote = poll(joined, 120, what="the join")
    index = remote.index
    code, stats = common.http(fleet.url + "/stats")
    doc = stats["workers"][index]
    assert (doc["managed"], doc["host_id"], doc["journal_dir"]) \
        == (False, "remote0", journal)

    # A session and a request the joined worker owns.
    params = chip_smoke.session_params_for(
        router, chip_smoke.elastic_session_problem(
            objects, relations, dcop_mod, 4301, 3)[0], index)
    yaml_b, batches, expected = chip_smoke.elastic_session_problem(
        objects, relations, dcop_mod, 4301, 3, params)
    sid = chip_smoke.elastic_session(fleet.url, router, yaml_b, params,
                                     batches, index, "join")
    owned = _owned_by(router, index, n=1)
    body = _solve(fleet.url, owned[0])
    assert router.pinned(body["id"]).index == index
    assert [(body["assignment"], body["cost"])] == _reference(owned)

    deaths, adopted = router.deaths, router.adopted_sessions
    os.kill(remote_procs[0].pid, signal.SIGKILL)
    remote_procs[0].wait(timeout=30)
    poll(lambda: remote.status == "down" and router.deaths == deaths + 1,
         60, what="the death verdict")
    poll(lambda: router.adopted_sessions == adopted + 1, 60,
         what="the adoption")
    assert router.pinned(sid, router._session_pins).index != index
    ack = chip_smoke.elastic_patch_acked(fleet.url, sid, batches[2])
    final = chip_smoke.elastic_close_session(fleet.url, sid)
    # The reference engine's uninterrupted cost under the same params.
    monkeypatch.setattr(bench, "FLEET_ELASTIC_SESSION_PARAMS", params)
    ref_expected = bench._elastic_session_problem(4301, 3)[2]
    assert ack["seq"] == 3 and final["cost"] == expected == ref_expected
    assert remote.restarts == 0 and remote.proc is None
    assert remote.status == "down"

    # Started again on the same port: it re-announces, the slot revives.
    remote_procs.append(_join(fleet, port, journal))
    poll(lambda: remote.status == "up", 120, what="the revival")
    assert len(router.replicas) == index + 1 and not remote.managed
    body = _solve(fleet.url, owned[0])
    assert router.pinned(body["id"]) is remote


def test_stop_during_a_scale_up_leaves_no_process(fleet):
    router = fleet.router
    router.max_replicas = len([r for r in router.replicas
                               if r.managed and not r.retired]) + 1
    n = len(router.replicas)
    router.record_latency(1e6)
    router.slo_p99_ms = 0.001
    poll(lambda: len(router.replicas) > n
         and router.replicas[n].proc is not None, 60,
         what="the second scale-up's spawn")
    fleet.stop()
    poll(lambda: not router._scaling, 60, what="the scale thread's end")
    for replica in router.replicas:
        assert replica.proc is None or replica.proc.poll() is not None, \
            replica.summary()
