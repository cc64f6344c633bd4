"""A worker of a two-worker CPU fleet killed with SIGKILL: the kill
half of ``tests/unit/test_elastic_fleet_battery.py`` on one
module-scoped, journaled fleet.

- A burst of acknowledged requests, then SIGKILL of the worker that
  owns most of them while they are still pending (the batch window is
  5 s): the router declares it dead, restarts it on its journal segment
  with ``--recover``, and every acknowledged request is answered — the
  killed worker's share by the restart's replay — equal to the port's
  single service and the reference's solo solve.
- A session whose owner is killed: an SSE stream through the router
  ends in a clean EOF (never a hang), the session comes back (adopted
  by the survivor or replayed by the restart), and the acknowledged
  event batch survives (the next PATCH is seq 2).

Every wait is a poll on a condition with a deadline.  The reference's
ForwardNotSent reroute is held deterministically in
``test_torch_fleet_policy.py`` (a refused connect to a stub replica)
instead of racing the prober here.
"""

import collections
import os
import signal
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import torch_fleet_common as fleet_common
import torch_serving_common as common
from torch_fleet_common import poll

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
    with fleet_common.cpu_fleet(tmp_path_factory.mktemp("fleet"),
                                batch_window_s=5.0,
                                max_batch=16) as handle:
        yield handle


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    with common.isolated(monkeypatch, tmp_path):
        yield


def _kill(fleet, replica):
    """SIGKILL ``replica``; returns once its restart is serving."""
    restarts = replica.restarts
    os.kill(replica.proc.pid, signal.SIGKILL)
    poll(lambda: replica.restarts == restarts + 1
         and replica.status == "up", 120,
         what=f"replica {replica.index}'s restart")


def test_sigkill_mid_burst_loses_no_acknowledged_request(fleet):
    router = fleet.router
    keys = [(s, 50 + s) for s in range(0, 24, 2)]
    yamls = {key: common.mixed_yaml(*key) for key in keys}
    acks = {}
    for key in keys:
        code, ack = common.http(fleet.url + "/solve", "POST", {
            "dcop": yamls[key], "params": PARAMS})
        assert code == 202, ack
        acks[key] = ack["id"]
    owners = collections.Counter(router.pinned(rid).index
                                 for rid in acks.values())
    victim = router.replicas[owners.most_common(1)[0][0]]
    code, vstats = common.http(victim.url + "/stats")
    assert vstats["completed"] == 0, "the burst ran before the kill"
    _kill(fleet, victim)
    answered = {key: fleet_common.await_result(fleet.url, rid)
                for key, rid in acks.items()}
    assert {key: code for key, (code, _) in answered.items()} \
        == {key: 200 for key in keys}
    single, _ = common.serve_stream(
        "torch", [yamls[k] for k in keys], params=PARAMS)
    reference, _ = common.serve_stream(
        "jax", [yamls[k] for k in keys], params=PARAMS)
    for key, one, ref in zip(keys, single, reference):
        got = answered[key][1]
        assert got["status"] == "FINISHED"
        assert (got["assignment"], got["cost"]) \
            == (one["assignment"], one["cost"]) \
            == (ref["assignment"], ref["cost"]), key
    stats = router.stats()
    assert stats["deaths"] >= 1 and stats["up"] == 2
    code, doc = common.http(fleet.url + "/stats")
    restarted = doc["workers"][victim.index]
    assert restarted["restarts"] == 1
    assert restarted["stats"]["replayed"] == owners[victim.index]


def _session_batches(seed, n):
    rng = np.random.default_rng(seed)
    return [[{"type": "change_factor", "name": f"c{int(rng.integers(9))}",
              "table": rng.integers(0, 10, size=(3, 3))
              .astype(float).tolist()}] for _ in range(n)]


def test_session_survives_its_owner_kill(fleet):
    router = fleet.router
    url = fleet.url
    code, opened = common.http(url + "/session", "POST", {
        "dcop": common.ring_yaml(10, 1707),
        "params": {"noise": 0.01, "stability": 0.001,
                   "max_cycles": 500}})
    assert code == 201, opened
    sid = opened["session_id"]
    batches = _session_batches(2, 2)
    code, ack = common.http(url + f"/session/{sid}/events", "PATCH",
                            {"events": batches[0], "wait": True,
                             "timeout": 30.0})
    assert code == 200 and ack["seq"] == 1, ack

    stream = urllib.request.urlopen(url + f"/session/{sid}/events",
                                    timeout=60)
    assert stream.status == 200
    ended = threading.Event()

    def drain():
        try:
            while stream.read(65536):
                pass
        except OSError:
            pass
        ended.set()

    threading.Thread(target=drain, daemon=True).start()
    victim = router.pinned(sid, router._session_pins)
    t_kill = time.monotonic()
    _kill(fleet, victim)
    assert ended.wait(30), "the SSE stream hung past the probe window"
    assert time.monotonic() - t_kill < 150
    stream.close()

    def reconnected():
        try:
            with urllib.request.urlopen(url + f"/session/{sid}/events",
                                        timeout=10) as again:
                return again.status == 200
        except OSError:
            return False

    poll(reconnected, 120, every=0.2, what="the SSE reconnect")

    def patched():
        code, out = common.http(url + f"/session/{sid}/events", "PATCH",
                                {"events": batches[1], "wait": True,
                                 "timeout": 30.0})
        assert code in (200, 409, 503), (code, out)
        return out if code == 200 else None

    assert poll(patched, 120, every=0.2, what="the second PATCH")["seq"] \
        == 2
    code, final = common.http(url + f"/session/{sid}", "DELETE")
    assert code == 200, final
