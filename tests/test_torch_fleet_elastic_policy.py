"""The port's elastic fleet (``pydcop_tpu_torch/serving/router.py``)
against the reference's, with no worker process: the policy and control
plane halves of ``tests/unit/test_elastic_fleet_battery.py``.

Tolerance: none.  On routers built with the same synthetic replicas
(the reference's ``_policy_router``) the two packages give the same
``autoscale_decision`` streams and quiet streaks — the reference's seven
``TestAutoscalePolicy`` cases, and seeded random sequences of
latencies, queue depths, ``in_flight`` and statuses compared step by
step — the same ``/stats`` ``autoscale`` block, the same
``pydcop_slo_burn_rate`` value, the same ``register_remote`` documents
and failures against a stub replica over HTTP, the same unmanaged death
transitions, and the same scale-down victims and aborts.  Also here:
the reference's ``TestControlPlane`` cases on the port, the prewarm's
replay order with the slot held out of the candidate set, and a spawn
that races ``stop()`` killed before it can outlive the fleet.
"""

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import torch_serving_common as common
import pydcop_tpu.serving.migration as ref_migration
import pydcop_tpu.serving.router as ref_router
import pydcop_tpu_torch.serving.migration as port_migration
import pydcop_tpu_torch.serving.router as port_router
from pydcop_tpu_torch import api
from pydcop_tpu_torch.commands import serve as serve_cmd
from pydcop_tpu_torch.engine.multihost import fleet_host_id

MODS = {"ref": ref_router, "port": port_router}
MIGRATION = {"ref": ref_migration, "port": port_migration}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    with common.isolated(monkeypatch, tmp_path):
        yield


def _policy_router(mod, n=2, **kw):
    """The reference battery's ``_policy_router``: synthetic UP
    replicas, no process, no monitor thread."""
    router = mod.FleetRouter(replicas=max(n, 1), **kw)
    for k in range(n):
        replica = mod.Replica(k, None, f"/dev/null-{k}",
                              host_id=f"host{k % max(router.hosts, 1)}")
        replica.status = mod.UP
        replica.port = 1
        router.replicas.append(replica)
    return router


def _on_both(case, **kw):
    """Run ``case(router)`` on both packages' routers; returns the
    two observations."""
    return [case(_policy_router(mod, **kw)) for mod in MODS.values()]


# ------------------------------------------------------------------ #
# the autoscale policy: the reference's seven cases on both routers


def _latencies(router, ms, n):
    for _ in range(n):
        router.record_latency(ms)


def test_inert_unless_armed():
    def case(router):
        _latencies(router, 1000.0, 50)
        return router.autoscale_decision()

    assert _on_both(case, n=2, slo_p99_ms=100) == [None, None]


def test_scales_up_on_p99_breach():
    def case(router):
        _latencies(router, 250.0, 50)
        return router.autoscale_decision()

    assert _on_both(case, n=2, slo_p99_ms=100, min_replicas=2,
                    max_replicas=4) == ["up", "up"]


def test_scales_up_on_deep_queues_without_latency():
    def case(router):
        for r in router.replicas:
            r.queue_depth = 10
        return router.rolling_p99(), router.autoscale_decision()

    assert _on_both(case, n=2, slo_p99_ms=100, min_replicas=2,
                    max_replicas=4) == [(None, "up")] * 2


def test_respects_the_ceiling():
    def case(router):
        _latencies(router, 250.0, 50)
        return router.autoscale_decision()

    assert _on_both(case, n=4, slo_p99_ms=100, max_replicas=4) \
        == [None, None]


def test_scales_down_only_after_quiet_streak():
    def case(router):
        _latencies(router, 10.0, 50)
        return [(router.autoscale_decision(), router._quiet_checks)
                for _ in range(3)]

    want = [(None, 1), (None, 2), ("down", 0)]
    assert _on_both(case, n=3, slo_p99_ms=100, min_replicas=2,
                    max_replicas=4, scale_down_quiet_checks=3) \
        == [want, want]


def test_breach_resets_the_quiet_streak():
    def case(router):
        seen = []
        _latencies(router, 10.0, 50)
        seen.append(router.autoscale_decision())
        _latencies(router, 250.0, 100)
        seen.append(router.autoscale_decision())
        # Flush the whole rolling window (deque maxlen): while any
        # breach sample is still inside it, "up" stays correct.
        _latencies(router, 10.0, 600)
        seen.append(router.autoscale_decision())
        return seen, router._quiet_checks

    assert _on_both(case, n=3, slo_p99_ms=100, min_replicas=2,
                    max_replicas=4, scale_down_quiet_checks=2) \
        == [([None, "up", None], 1)] * 2


def test_respects_the_floor():
    def case(router):
        _latencies(router, 10.0, 50)
        return router.autoscale_decision(), router._quiet_checks

    assert _on_both(case, n=2, slo_p99_ms=100, min_replicas=2,
                    max_replicas=4, scale_down_quiet_checks=1) \
        == [(None, 0)] * 2


# ------------------------------------------------------------------ #
# seeded random sequences, decision by decision


def _random_config(rng):
    n = int(rng.integers(1, 5))
    kw = {"slo_p99_ms": float(rng.choice([50.0, 100.0, 400.0])),
          "max_replicas": n + int(rng.integers(0, 3)),
          "scale_down_quiet_checks": int(rng.integers(1, 5))}
    if rng.random() < 0.7:
        kw["min_replicas"] = int(rng.integers(1, n + 1))
    return n, kw


def _random_step(rng, n):
    kind = rng.choice(["lat", "queue", "flight", "status", "retire",
                       "remote", "clear", "none"],
                      p=[.30, .15, .15, .15, .03, .03, .07, .12])
    if kind == "lat":
        return ("lat", float(rng.choice([5.0, 30.0, 60.0, 120.0,
                                         900.0], p=[.4, .2, .2, .1, .1])),
                int(rng.integers(1, 40)))
    if kind == "queue":
        return ("queue", int(rng.integers(n)), int(rng.integers(0, 9)))
    if kind == "flight":
        return ("flight", int(rng.integers(n)), int(rng.integers(0, 3)))
    if kind in ("status", "retire", "remote"):
        return (str(kind), int(rng.integers(n)),
                str(rng.choice(["up", "down", "starting",
                                "restarting", "draining"])))
    return (str(kind),)


def _apply(router, step):
    kind = step[0]
    if kind == "lat":
        _latencies(router, step[1], step[2])
    elif kind == "queue":
        router.replicas[step[1]].queue_depth = step[2]
    elif kind == "flight":
        router.replicas[step[1]].in_flight = step[2]
    elif kind == "status":
        router.replicas[step[1]].status = step[2]
    elif kind == "retire":
        router.replicas[step[1]].retired = True
    elif kind == "remote":
        router.replicas[step[1]].managed = False
    elif kind == "clear":
        # What a scale-up or a scale-down does to the window.
        router._lat.clear()


@pytest.mark.parametrize("seed", range(8))
def test_random_sequences_decide_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    n, kw = _random_config(rng)
    ref = _policy_router(ref_router, n, **kw)
    port = _policy_router(port_router, n, **kw)
    decisions = []
    for _ in range(300):
        step = _random_step(rng, n)
        for router in (ref, port):
            _apply(router, step)
        got = [(r.autoscale_decision(), r._quiet_checks,
                r.rolling_p99()) for r in (ref, port)]
        assert got[0] == got[1], (step, got)
        decisions.append(got[1][0])
    # The sequences reach every verdict somewhere across the seeds;
    # each one reaches at least two.
    assert len(set(decisions)) >= 2, decisions


# ------------------------------------------------------------------ #
# /stats' autoscale block and the SLO burn rate


def test_stats_autoscale_block_equals_the_reference():
    ref, port = (_policy_router(mod, 3, slo_p99_ms=80.0, min_replicas=2,
                                max_replicas=5) for mod in MODS.values())
    rng = np.random.default_rng(11)
    for ms in rng.random(300) * 200:
        for router in (ref, port):
            router.record_latency(float(ms))
    for router in (ref, port):
        router.scale_ups, router.scale_downs = 2, 1
    assert port.stats()["autoscale"] == ref.stats()["autoscale"] == {
        "slo_p99_ms": 80.0, "min_replicas": 2, "max_replicas": 5,
        "rolling_p99_ms": ref.rolling_p99(), "scale_ups": 2,
        "scale_downs": 1}
    assert port.stats() == ref.stats()
    unarmed = [_policy_router(mod, 2).stats() for mod in MODS.values()]
    assert "autoscale" not in unarmed[1] and unarmed[0] == unarmed[1]


def _burn_rate(mod, latencies, slo):
    """Run the monitor loop over replicas it does not probe (mid-start)
    until it has set the gauge; returns the gauge's value."""
    router = _policy_router(mod, 2, slo_p99_ms=slo, heartbeat_s=0.01)
    for r in router.replicas:
        r.status = mod.STARTING
    for ms in latencies:
        router.record_latency(ms)
    gauge = mod.metrics_registry.get("pydcop_slo_burn_rate")
    gauge.set(-1.0)
    loop = threading.Thread(target=router._monitor_loop, daemon=True)
    loop.start()
    deadline = time.monotonic() + 10
    while gauge.value() == -1.0 and time.monotonic() < deadline:
        time.sleep(0.01)
    router._stopping.set()
    loop.join(timeout=5)
    return gauge.value()


@pytest.mark.parametrize("latencies,slo", [
    ([], 100.0), ([40.0] * 10, 100.0), (list(range(1, 301)), 70.0)])
def test_burn_rate_equals_the_reference(latencies, slo):
    got = [_burn_rate(mod, latencies, slo) for mod in MODS.values()]
    assert got[0] == got[1] != -1.0
    p99 = (sorted(latencies)[min(int(0.99 * len(latencies)),
                                 len(latencies) - 1)]
           if latencies else None)
    assert got[1] == (round(p99 / slo, 6) if p99 else 0.0)


# ------------------------------------------------------------------ #
# the reference's TestControlPlane on the port


def test_fleet_host_id_env_override(monkeypatch):
    monkeypatch.setenv("PYDCOP_HOST_ID", "rack7")
    assert fleet_host_id() == "rack7"
    monkeypatch.delenv("PYDCOP_HOST_ID")
    assert fleet_host_id() == socket.gethostname()


def test_register_remote_rejects_bad_address():
    for mod in MODS.values():
        router = _policy_router(mod, 1)
        with pytest.raises(ValueError):
            router.register_remote("not-an-address")
        assert len(router.replicas) == 1


def test_join_excludes_local_fleet():
    # Refused before the device is resolved: the same ValueError on a
    # host without a card.
    with pytest.raises(ValueError, match="join="):
        api.serve(replicas=2, join="http://127.0.0.1:1/")


def _serve_parser():
    import argparse

    parser = argparse.ArgumentParser()
    serve_cmd.set_parser(parser.add_subparsers())
    return parser


def test_elastic_cli_knobs_parse():
    args = _serve_parser().parse_args(
        ["serve", "--hosts", "2", "--join", "http://127.0.0.1:9",
         "--host_id", "hostX", "--slo_p99_ms", "250",
         "--min_replicas", "2", "--max_replicas", "6"])
    assert (args.hosts, args.join, args.host_id, args.slo_p99_ms,
            args.min_replicas, args.max_replicas, args.device) == (
        2, "http://127.0.0.1:9", "hostX", 250.0, 2, 6, "cuda")


def test_cli_rejects_join_with_local_fleet():
    args = _serve_parser().parse_args(
        ["serve", "--join", "http://127.0.0.1:9", "--replicas", "2"])
    assert serve_cmd.run_cmd(args) == 2


def test_announce_join_retries_then_gives_up():
    # Nothing listens on this port: every attempt fails and the
    # worker stays standalone instead of crashing.
    assert api._announce_join("http://127.0.0.1:9", "http://127.0.0.1:8",
                              host_id="h") is False


# ------------------------------------------------------------------ #
# remote membership against a stub replica


class _StubReplica(BaseHTTPRequestHandler):
    """A joined worker: /healthz answers ``status`` (200 or 503), every
    POST is recorded and acknowledged."""

    health = 200
    posts: list = []

    def do_GET(self):  # noqa: N802 — stdlib name
        self._send({"status": "ok", "serving": {"queue_depth": 0}},
                   code=self.health if self.path == "/healthz" else 200)

    def do_POST(self):  # noqa: N802 — stdlib name
        raw = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).posts.append((self.path, json.loads(raw)))
        self._send({})

    def _send(self, doc, code=200):
        raw = json.dumps(doc).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def log_message(self, *args):
        pass


@pytest.fixture
def stub():
    handler = type("Stub", (_StubReplica,), {"posts": [], "health": 200})
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    server.handler = handler
    yield server
    server.shutdown()
    server.server_close()


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_register_remote_admits_with_the_reference_document(
        stub, tmp_path):
    url = f"http://127.0.0.1:{stub.server_address[1]}"
    seen = []
    for name, mod in MODS.items():
        router = _policy_router(mod, 2, heartbeat_s=0.5)
        router._run_dir = str(tmp_path / name)
        doc = router.register_remote(url + "/", "rack9",
                                     journal_dir=str(tmp_path))
        remote = router.replicas[2]
        seen.append((doc, remote.managed, remote.status, remote.host,
                     remote.port, remote.host_id, remote.journal_dir,
                     remote.index, remote.proc,
                     remote.log_path.endswith("remote-2.log"),
                     router.up_count(), remote.summary()))
    assert seen[0] == seen[1]
    assert seen[1][0] == {"index": 2, "status": "up", "heartbeat_s": 0.5}
    assert seen[1][1:3] == (False, "up")


def test_register_remote_probe_failures(stub, tmp_path):
    stub.handler.health = 404
    for mod in MODS.values():
        router = _policy_router(mod, 1)
        router._run_dir = str(tmp_path)
        with pytest.raises(RuntimeError, match="admission probe"):
            router.register_remote(f"127.0.0.1:{_closed_port()}")
        assert router.replicas[1].status == mod.DOWN
        assert not router.replicas[1].managed
        with pytest.raises(RuntimeError, match="answered /healthz"):
            router.register_remote(
                f"http://127.0.0.1:{stub.server_address[1]}")
        assert router.replicas[2].status == mod.STARTING
        # A 503 (admission shedding) is alive: admitted.
        stub.handler.health = 503
        assert router.register_remote(
            f"http://127.0.0.1:{stub.server_address[1]}")["index"] == 2
        stub.handler.health = 404


def test_reannounce_revives_the_same_index_with_its_pins(stub, tmp_path):
    url = f"http://127.0.0.1:{stub.server_address[1]}"
    seen = []
    for mod in MODS.values():
        router = _policy_router(mod, 2)
        router._run_dir = str(tmp_path)
        router.register_remote(url, "rack1")
        remote = router.replicas[2]
        router.pin("req-1", remote)
        router.pin("sess-1", remote, router._session_pins)
        router.record_fence(2, "sess-0", 4)
        remote.status = mod.DOWN
        remote.death_handled = True
        doc = router.register_remote(url, "rack2")
        seen.append((doc, len(router.replicas), remote.status,
                     remote.host_id, remote.death_handled,
                     router.pinned("req-1").index,
                     router.pinned("sess-1", router._session_pins).index,
                     router._fences))
    assert seen[0] == seen[1]
    assert seen[1][:5] == ({"index": 2, "status": "up",
                            "heartbeat_s": 0.25}, 3, "up", "rack2", False)
    # The fence was flushed to the healed slot before it served.
    fences = [body for path, body in stub.handler.posts
              if path == "/admin/fence_session"]
    assert len(fences) == 2 and fences[0] == fences[1]
    assert seen[1][7] == {}


@pytest.mark.parametrize("journal", [False, True])
def test_unmanaged_death_goes_down_and_is_adopted(
        stub, tmp_path, monkeypatch, journal):
    url = f"http://127.0.0.1:{stub.server_address[1]}"
    seen = []
    for name, mod in MODS.items():
        adopted = []
        monkeypatch.setattr(
            MIGRATION[name], "adopt_dead_sessions",
            lambda router, dead, adopted=adopted: adopted.append(
                dead.index) or 3)
        router = _policy_router(mod, 2)
        router._run_dir = str(tmp_path)
        router.register_remote(url, "rack1", journal_dir=(
            str(tmp_path) if journal else None))
        remote = router.replicas[2]
        spawned = []
        monkeypatch.setattr(router, "_restart", spawned.append)
        router._declare_dead(remote, proc_dead=False, missed=9.0)
        if journal:
            deadline = time.monotonic() + 10
            while router.adopted_sessions != 3 \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
        seen.append((remote.status, remote.restarts, router.deaths,
                     remote.death_handled, spawned, adopted,
                     router.adopted_sessions, router.up_count()))
        # A second verdict in the same episode is not taken.
        router._probe(remote)
        assert router.deaths == 1
    assert seen[0] == seen[1]
    assert seen[1] == ("down", 0, 1, True, [], [2] if journal else [],
                       3 if journal else 0, 2)


def test_a_down_remote_revives_in_the_prober(stub, tmp_path):
    url = f"http://127.0.0.1:{stub.server_address[1]}"
    for mod in MODS.values():
        router = _policy_router(mod, 0)
        router._run_dir = str(tmp_path)
        router.register_remote(url)
        remote = router.replicas[0]
        remote.status, remote.death_handled = mod.DOWN, True
        router._probe(remote)
        assert (remote.status, remote.death_handled) == (mod.UP, False)


# ------------------------------------------------------------------ #
# scale-down: the victim, the drain and its abort


def _drain_router(mod):
    router = _policy_router(mod, 4, slo_p99_ms=100, min_replicas=2,
                            max_replicas=6)
    router.replicas[3].in_flight = 1          # busy: not the victim
    router.replicas[1].managed = False        # remote: never drained
    for sid, k in (("s0", 2), ("s1", 0), ("s2", 2)):
        router.pin(sid, router.replicas[k], router._session_pins)
    return router


@pytest.mark.parametrize("fails", [False, True])
def test_scale_down_drains_the_last_idle_replica(monkeypatch, fails):
    seen = []
    for name, mod in MODS.items():
        moved = []

        def migrate(router, sid, moved=moved):
            if fails and sid == "s2":
                raise RuntimeError("import refused")
            moved.append(sid)
            router.pin(sid, router.replicas[0], router._session_pins)
            return {"session_id": sid}

        monkeypatch.setattr(MIGRATION[name], "migrate_session", migrate)
        router = _drain_router(mod)
        router._lat.append(5.0)
        router._scale_down()
        victim = router.replicas[2]
        seen.append((moved, victim.status, victim.retired,
                     router.scale_downs, router.n_replicas,
                     list(router._lat),
                     [r.status for r in router.replicas],
                     router.health_summary()))
    assert seen[0] == seen[1]
    if fails:
        assert seen[1][:5] == (["s0"], "up", False, 0, 4)
    else:
        assert seen[1][:6] == (["s0", "s2"], "down", True, 1, 3, [])


def test_scale_down_keeps_the_floor_and_busy_replicas(monkeypatch):
    for name, mod in MODS.items():
        monkeypatch.setattr(MIGRATION[name], "migrate_session",
                            lambda *a: pytest.fail("no drain expected"))
        router = _policy_router(mod, 2, slo_p99_ms=100, min_replicas=2,
                                max_replicas=4)
        router._scale_down()                 # at the floor
        router = _policy_router(mod, 3, slo_p99_ms=100, min_replicas=2,
                                max_replicas=4)
        for r in router.replicas:
            r.in_flight = 1                  # nobody idle
        router._scale_down()
        assert [r.status for r in router.replicas] == [mod.UP] * 3
        assert router.scale_downs == 0


# ------------------------------------------------------------------ #
# scale-up: the slot, the prewarm replay and a spawn racing stop()


class _FakeProc:
    pid = 4242

    def __init__(self):
        self.killed = False

    def poll(self):
        return -9 if self.killed else None

    def kill(self):
        self.killed = True

    def wait(self, timeout=None):
        return -9


def test_scale_up_prewarms_before_taking_traffic(monkeypatch, tmp_path):
    seen = []
    for mod in MODS.values():
        router = _policy_router(mod, 2, slo_p99_ms=100, max_replicas=3,
                                journal_dir=str(tmp_path / "jnl"),
                                hosts=2)
        router._run_dir = str(tmp_path)
        for k in range(6):
            router.note_exemplar(f"d{k}", f"yaml{k}",
                                 {"max_cycles": k} if k % 2 else None)
        router.record_latency(900.0)
        calls = []

        def spawn(replica, recover, calls=calls):
            calls.append(("spawn", replica.index, recover,
                          replica.journal_dir, replica.host_id))

        def ready(replica, deadline, calls=calls):
            calls.append(("ready", replica.index))
            replica.port, replica.status = 1, mod.UP

        def forward(replica, method, path, body, timeout=0.0,
                    trace=None, calls=calls, router=router):
            calls.append(("forward", replica.index, method, path,
                          json.loads(body), timeout, replica.status,
                          [r.index for r in router.candidates()]))
            return 200, "application/json", b"{}"

        monkeypatch.setattr(router, "_spawn", spawn)
        monkeypatch.setattr(router, "_wait_ready", ready)
        monkeypatch.setattr(router, "_forward", forward)
        router._scale_up()
        new = router.replicas[2]
        calls = [c[:3] + (c[3].replace(str(tmp_path), "T"),) + c[4:]
                 if c[0] == "spawn" else c for c in calls]
        seen.append((calls, new.status, sorted(new.warm),
                     router.scale_ups, router.n_replicas,
                     list(router._lat)))
    assert seen[0] == seen[1]
    calls = seen[1][0]
    assert calls[:2] == [("spawn", 2, False, "T/jnl/replica-2", "host0"),
                         ("ready", 2)]
    replays = calls[2:]
    assert [c[4]["dcop"] for c in replays] == ["yaml2", "yaml3", "yaml4",
                                               "yaml5"]
    # Held out of the candidate set while the exemplars replay.
    assert all(c[6] == "starting" and 2 not in c[7] for c in replays)
    assert all(c[4]["wait"] is True for c in replays)
    assert seen[1][1:] == ("up", ["d2", "d3", "d4", "d5"], 1, 3, [])


def test_a_spawn_racing_stop_is_killed(monkeypatch, tmp_path):
    procs = []

    def popen(cmd, env, **kw):
        procs.append(_FakeProc())
        return procs[-1]

    monkeypatch.setattr(port_router.subprocess, "Popen", popen)
    router = port_router.FleetRouter(replicas=1, device="cpu")
    router._run_dir = str(tmp_path)
    replica = port_router.Replica(3, None, str(tmp_path / "r3.log"))
    router._stopping.set()
    with pytest.raises(RuntimeError, match="fleet stopping"):
        router._spawn(replica, recover=False)
    assert procs[0].killed
