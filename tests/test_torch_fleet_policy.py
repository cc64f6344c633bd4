"""The port's fleet router (``pydcop_tpu_torch/serving/router.py``)
against the reference's, with no worker process: the policy and
bookkeeping halves of ``tests/unit/test_fleet_battery.py``,
``test_elastic_fleet_battery.py``, ``test_netfault_battery.py`` and
``test_fleettrace_battery.py`` that fall inside the fixed-size fleet.

Tolerance: none.  The phi-accrual estimator, ``pooled_rollup``, the
rendezvous scores, ``pick`` sequences (affinity hits, spillover,
breaker shedding, round robin), ``stats()`` documents, epochs and
fences are equal between the two packages' routers built with
synthetic UP replicas (the reference's ``_bench_router``).  Also here:
the weighted-fair admission queue, the elastic fleet's knobs and their
checks in the router, ``api.serve`` and the CLI (the policy itself:
``test_torch_fleet_elastic_policy.py``), the device rule (no card: ``api.serve(replicas=2)`` raises before
any worker is spawned), the worker command the router spawns, the
seam lints (no raw socket I/O in the port's ``serving/``, a trace
context at every forwarding call site), a connect-refused forward
re-sent to a survivor (a stub replica over HTTP), and two processes
building one kernel library at once.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import torch_serving_common as common
import pydcop_tpu.serving.router as ref_router
import pydcop_tpu_torch.serving.router as port_router
from pydcop_tpu_torch import api
from pydcop_tpu_torch import dcop_cli
from pydcop_tpu_torch.commands import serve as serve_cmd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _bench_router(mod, n=3, **kw):
    """A router with synthetic UP replicas and no processes:
    pick()/pin()/stats() are pure bookkeeping."""
    router = mod.FleetRouter(replicas=n, **kw)
    for k in range(n):
        replica = mod.Replica(k, None, f"/dev/null-{k}",
                              host_id=f"host{k % router.hosts}")
        replica.status = mod.UP
        replica.port = 1  # non-None: counts as addressable
        router.replicas.append(replica)
    return router


def _both(n=3, **kw):
    return _bench_router(ref_router, n, **kw), _bench_router(
        port_router, n, **kw)


def _step(router, op, arg):
    """One scripted operation; returns what it observed."""
    if op == "pick":
        detail = {}
        try:
            replica, hit = router.pick(arg, detail=detail)
        except (ref_router.FleetUnavailable,
                port_router.FleetUnavailable):
            return "shed"
        return replica.index, hit, detail
    replica = router.replicas[arg]
    if op == "release":
        router.release(replica)
    elif op == "deep":
        replica.in_flight += 10
    elif op == "breaker":
        replica.breaker_open = not replica.breaker_open
    else:  # "up" / "down"
        replica.status = op
    return None


def _script(seed, n_ops=200, n_digests=9, n_replicas=3):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["pick", "pick", "pick", "release", "deep",
                           "breaker", "down", "up"],
                          p=[.3, .2, .1, .25, .04, .04, .03, .04])
        if kind == "pick":
            ops.append(("pick", None if rng.random() < 0.1
                        else f"digest-{rng.integers(n_digests)}"))
        else:
            ops.append((kind, int(rng.integers(n_replicas))))
    return ops


# ------------------------------------------------------------------ #
# the phi-accrual estimator and pooled_rollup


@pytest.mark.parametrize("seed", range(6))
def test_phi_accrual_equals_the_reference(seed):
    from pydcop_tpu.resilience.health import PhiAccrualEstimator as Ref
    from pydcop_tpu_torch.resilience.health import (
        PhiAccrualEstimator as Port,
    )

    rng = np.random.default_rng(seed)
    expected = float(rng.choice([0.05, 0.25, 1.0]))
    window = int(rng.integers(2, 25))
    ref, port = Ref(expected, window=window), Port(expected, window=window)
    anchor = now = float(rng.random() * 100)
    observed = []
    for _ in range(60):
        for t in (now, now + expected * rng.random() * 12):
            observed.append([
                (est.phi(t, anchor), est.missed(t, anchor),
                 est.mean_interval()) for est in (ref, port)])
        # Regular beats, jitter, long gaps and clock hiccups.
        now += float(max(rng.normal(expected, expected * 0.4),
                         -0.01 if rng.random() < 0.1 else 0.0)
                     + (expected * 9 if rng.random() < 0.05 else 0.0))
        ref.beat(now)
        port.beat(now)
    for ref_row, port_row in observed:
        assert ref_row == port_row
    assert (ref.beats, ref.last_beat) == (port.beats, port.last_beat)


def _rollup_doc(rng):
    def comps(keys):
        return {k: float(rng.random() * 3) for k in keys
                if rng.random() < 0.8}

    return {
        "backends": {b: {"attainment": (None if rng.random() < 0.2
                                        else float(rng.random())),
                         "execute_s": float(rng.random() * 4)}
                     for b in ("cpu", "cuda") if rng.random() < 0.7},
        "ledger": {"components_s": comps(("execute", "queue", "plan")),
                   "counts": {"requests": int(rng.integers(9))},
                   "total_s": float(rng.random() * 9),
                   "unaccounted_abs_s": float(rng.random() * 0.1)},
        "waste_by_cause": comps(("padding", "envelope_s")),
        "jit": {"cold_dispatches": int(rng.integers(4)),
                "warm_dispatches": int(rng.integers(20)),
                "cold_compile_s": float(rng.random())},
        "pipeline": {"overlap_s": float(rng.random()),
                     "execute_s": float(rng.random() * 3),
                     "dispatches": int(rng.integers(12))},
    }


@pytest.mark.parametrize("n_replicas", [0, 1, 2, 5])
def test_pooled_rollup_equals_the_reference(n_replicas):
    from pydcop_tpu.observability.efficiency import pooled_rollup as ref
    from pydcop_tpu_torch.observability.efficiency import (
        pooled_rollup as port,
    )

    rng = np.random.default_rng(n_replicas)
    docs = {f"replica-{k}": _rollup_doc(rng) for k in range(n_replicas)}
    if n_replicas == 5:
        docs["replica-4"] = {}
    assert port(docs) == ref(docs)


def test_pooled_rollup_sums_and_weights_attainment():
    from pydcop_tpu_torch.observability.efficiency import pooled_rollup

    docs = {
        "replica-0": {"backends": {"cuda": {"attainment": 0.2,
                                            "execute_s": 3.0}},
                      "ledger": {"components_s": {"execute": 3.0},
                                 "counts": {"requests": 4}}},
        "replica-1": {"backends": {"cuda": {"attainment": 0.6,
                                            "execute_s": 1.0}},
                      "ledger": {"components_s": {"execute": 1.0},
                                 "counts": {"requests": 2}}},
    }
    pooled = pooled_rollup(docs)
    assert pooled["attainment"] == pytest.approx(0.3)
    assert pooled["ledger"]["counts"]["requests"] == 6
    assert pooled_rollup({})["attainment"] is None


SNAPS = {
    "replica-0": {
        "pydcop_requests_total": {
            "kind": "counter",
            "samples": [{"labels": {"status": "ok"}, "value": 3.0},
                        {"labels": {"status": "deduped"}, "value": 1.0}]},
        "pydcop_request_latency_seconds": {
            "kind": "histogram",
            "samples": [{"labels": {}, "count": 3, "sum": 0.3,
                         "buckets": {0.1: 1, 1.0: 3}, "exemplars": {}}]},
    },
    "replica-1": {
        "pydcop_requests_total": {
            "kind": "counter",
            "samples": [{"labels": {"status": "ok"}, "value": 2.0}]},
    },
}


def test_merged_snapshots_equal_the_reference_and_conserve():
    """What ``/fleet/metrics`` serves: every replica's samples kept
    under a ``replica`` label (summed ok counts = the router's
    ledger), rendered as the reference renders them."""
    from pydcop_tpu.observability import metrics as ref
    from pydcop_tpu_torch.observability import metrics as port

    merged = port.merge_snapshots(SNAPS)
    assert merged == ref.merge_snapshots(SNAPS)
    assert port.render_snapshot_prometheus(merged) \
        == ref.render_snapshot_prometheus(merged)
    per_replica = {s["labels"]["replica"]: s["value"]
                   for s in merged["pydcop_requests_total"]["samples"]
                   if s["labels"]["status"] == "ok"}
    assert per_replica == {"replica-0": 3.0, "replica-1": 2.0}


# ------------------------------------------------------------------ #
# rendezvous and the routing policy, both routers side by side


def test_rendezvous_scores_equal_the_reference():
    digests = [f"structure-{i}" for i in range(64)] + ["", "ü"]
    for d in digests:
        for k in range(6):
            assert (port_router._rendezvous_score(d, k)
                    == ref_router._rendezvous_score(d, k))


def test_rendezvous_spreads_and_remaps_only_dead_keys():
    digests = [f"structure-{i}" for i in range(128)]
    owners = {d: max(range(4), key=lambda k: port_router
                     ._rendezvous_score(d, k)) for d in digests}
    assert all(list(owners.values()).count(k) > 0 for k in range(4))
    after = {d: max([0, 1, 3], key=lambda k: port_router
                    ._rendezvous_score(d, k)) for d in digests}
    assert all(after[d] == owners[d] for d in digests if owners[d] != 2)


@pytest.mark.parametrize("affinity", ["structure", "round_robin"])
@pytest.mark.parametrize("seed", range(4))
def test_pick_sequences_and_stats_equal_the_reference(affinity, seed):
    ref, port = _both(3, affinity=affinity, spill_slack=2 + seed % 2,
                      hosts=1 + seed % 2)
    for op, arg in _script(seed):
        assert _step(port, op, arg) == _step(ref, op, arg), (op, arg)
    assert port.stats() == ref.stats()
    assert port.health_summary() == ref.health_summary()
    assert port.link_verdicts() == ref.link_verdicts()


def test_affinity_hits_accumulate():
    router = _bench_router(port_router)
    first, hit0 = router.pick("digest-a")
    router.release(first)
    second, hit1 = router.pick("digest-a")
    router.release(second)
    assert (hit0, hit1) == (False, True) and second is first
    assert router.stats()["affinity_hit_fraction"] == 0.5


def test_spillover_past_slack():
    router = _bench_router(port_router, spill_slack=2)
    primary, _ = router.pick("digest-b")
    primary.in_flight = 10
    chosen, _ = router.pick("digest-b")
    assert chosen is not primary and chosen.in_flight == 1
    assert router.spillovers == 1


def test_breaker_aware_shedding():
    router = _bench_router(port_router, n=2)
    router.replicas[0].breaker_open = True
    chosen, _ = router.pick("digest-c")
    assert chosen is router.replicas[1]
    router.replicas[1].status = port_router.DOWN
    with pytest.raises(port_router.FleetUnavailable):
        router.pick("digest-c")
    assert router.stats()["shed"] == 1


def test_pin_table_bounded(monkeypatch):
    monkeypatch.setattr(port_router, "PIN_KEEP", 64)
    router = _bench_router(port_router, n=1)
    replica = router.replicas[0]
    for i in range(64 + 10):
        router.pin(f"r{i}", replica)
    assert len(router._pins) == 64
    assert router.pinned("r0") is None
    assert router.pinned("r73") is replica


def test_rejects_bad_config():
    for kw in ({"replicas": 0}, {"affinity": "sticky"}, {"hosts": 0}):
        with pytest.raises(ValueError):
            port_router.FleetRouter(**kw)


def test_forward_error_and_gray_threshold_equal_the_reference():
    ref, port = _both(2, probe_timeout_s=2.0)
    for router in (ref, port):
        router.mark_forward_error(router.replicas[1])
        router.replicas[0].gray = True
    assert port.gray_threshold_ms() == ref.gray_threshold_ms() == 700.0
    assert port.health_summary() == ref.health_summary()
    assert port.stats() == ref.stats()


def test_latency_window_and_exemplars_equal_the_reference():
    ref, port = _both(2)
    rng = np.random.default_rng(3)
    assert port.rolling_p99() is ref.rolling_p99() is None
    for i, ms in enumerate(rng.random(700) * 100):
        for router in (ref, port):
            router.record_latency(float(ms))
            router.note_exemplar(f"d{i % 11}", f"yaml{i}", {"i": i})
    assert port.rolling_p99() == ref.rolling_p99()
    assert list(port._exemplars.items()) == list(ref._exemplars.items())
    port._maybe_autoscale()      # unarmed: inert, as the reference's
    assert port.stats() == ref.stats()


# ------------------------------------------------------------------ #
# the weighted-fair admission queue


def test_fair_quiet_tenant_overtakes_a_flood():
    fair = port_router.FairScheduler(fair_share=1)
    assert fair.acquire("A", up=1)
    order, lock = [], threading.Lock()

    def worker(tenant):
        assert fair.acquire(tenant, up=1, timeout=30)
        with lock:
            order.append(tenant)
        fair.release()

    def wait_queued(n):
        deadline = time.monotonic() + 10
        while fair.stats()["queued"] < n:
            assert time.monotonic() < deadline
            time.sleep(0.01)

    flood = [threading.Thread(target=worker, args=("A",))
             for _ in range(4)]
    for t in flood:
        t.start()
    wait_queued(4)
    late = threading.Thread(target=worker, args=("B",))
    late.start()
    wait_queued(5)
    fair.release()
    for t in flood + [late]:
        t.join(timeout=30)
    assert len(order) == 5 and order.index("B") <= 1, order


def test_fair_rejection_is_shaping_and_capacity_scales():
    fair = port_router.FairScheduler(fair_share=2)
    for _ in range(4):
        assert fair.acquire("A", up=2, timeout=0.5)
    assert fair.acquire("B", up=2, timeout=0.05) is False
    assert fair.acquire("A", up=3, timeout=0.5)
    stats = fair.stats()
    assert (stats["admitted"], stats["rejected"], stats["active"],
            stats["tenants"]) == (5, 1, 5, 2)
    ref = ref_router.FairScheduler(fair_share=2)
    assert sorted(ref.stats()) == sorted(stats)


# ------------------------------------------------------------------ #
# epochs and fences (the router is the epoch authority)


def test_epochs_and_fences_equal_the_reference():
    ref, port = _both(1)
    for router in (ref, port):
        router.note_session("s1")
        router.record_fence(0, "s1", 3)
        router.record_fence(0, "s1", 2)
        router.record_fence(0, "s2", 4)
    seen = [(r.bump_epoch("s1"), r.bump_epoch("s1", floor=7),
             r.bump_epoch("s1", floor=3), r.session_epoch("s1"),
             r.session_epoch("s9"), r._fences) for r in (ref, port)]
    assert seen[0] == seen[1]
    assert seen[1][:5] == (2, 7, 8, 8, 1)
    assert port._fences[0] == {"s1": 3, "s2": 4}


# ------------------------------------------------------------------ #
# the elastic fleet's knobs and their checks


# What each knob's check refuses (the reference's constructor checks;
# an SLO of 0 leaves the autoscaler unarmed).
BAD_KNOB = {"slo_p99_ms": 0, "min_replicas": 0, "max_replicas": 1}


@pytest.mark.parametrize("name,value", [("slo_p99_ms", 50.0),
                                        ("min_replicas", 1),
                                        ("max_replicas", 4)])
def test_router_refuses_the_autoscaler_knobs(name, value):
    """Each knob is taken as the reference's router takes it, and a
    bad value is refused as the reference refuses it."""
    ref = ref_router.FleetRouter(replicas=2, **{name: value})
    port = port_router.FleetRouter(replicas=2, **{name: value})
    assert getattr(port, name) == getattr(ref, name) == value
    bad = {name: BAD_KNOB[name]}
    if name == "slo_p99_ms":
        assert port_router.FleetRouter(replicas=2, **bad).slo_p99_ms \
            is ref_router.FleetRouter(replicas=2, **bad).slo_p99_ms is None
        return
    for mod in (ref_router, port_router):
        with pytest.raises(ValueError, match=name):
            mod.FleetRouter(replicas=2, **bad)


def test_router_refuses_remote_join_and_the_armed_autoscaler():
    """An unreachable remote is refused (its slot left down), and the
    armed autoscaler refuses to grow past its ceiling — on both
    routers."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        closed = s.getsockname()[1]
    for mod in (ref_router, port_router):
        router = _bench_router(mod, n=1, slo_p99_ms=10.0, max_replicas=2)
        with pytest.raises(RuntimeError, match="admission probe"):
            router.register_remote(f"http://127.0.0.1:{closed}")
        assert router.replicas[1].status == mod.DOWN
        for _ in range(20):
            router.record_latency(500.0)
        router.replicas[1].status = mod.UP
        router.replicas[1].managed = True
        assert router.autoscale_decision() is None
        router.replicas[1].managed = False
        assert router.autoscale_decision() == "up"


@pytest.mark.parametrize("name,value", [("join", "http://x:1"),
                                        ("slo_p99_ms", 50.0),
                                        ("min_replicas", 1),
                                        ("max_replicas", 4)])
def test_api_and_cli_refuse_the_elastic_knobs(name, value, monkeypatch):
    """``join`` with a local fleet is refused (``ValueError``, exit 2)
    as the reference refuses it; the autoscaler's knobs reach the
    fleet's router from ``api.serve`` and from the CLI."""
    flag = [f"--{name}", str(value)]
    if name == "join":
        with pytest.raises(ValueError, match="join="):
            api.serve(port=0, replicas=2, device="cpu", join=value)
        assert dcop_cli.main(["serve", "--device", "cpu", "--port", "0",
                              "--replicas", "2", *flag]) == 2
        return
    captured = []

    class FakeRouter:
        def __init__(self, **kw):
            captured.append(kw)
            raise RuntimeError("stop here")

    monkeypatch.setattr(port_router, "FleetRouter", FakeRouter)
    with pytest.raises(RuntimeError, match="stop here"):
        api.serve(port=0, replicas=2, device="cpu", **{name: value})
    with pytest.raises(RuntimeError, match="stop here"):
        dcop_cli.main(["serve", "--device", "cpu", "--port", "0",
                       "--replicas", "2", *flag])
    assert [kw[name] for kw in captured] == [value, value]
    assert all(kw["device"] == "cpu" for kw in captured)


def _router_front_end(router):
    return port_router.RouterFrontEnd(router, port=0).start()


def test_join_route_answers_501_and_an_empty_fleet_503():
    """``POST /fleet/join`` answers as the reference's route: 400 for a
    bad body or address, 503 (retry) for an endpoint that does not
    answer its admission probe.  An empty fleet answers 503."""
    router = port_router.FleetRouter(replicas=2)
    front = _router_front_end(router)
    try:
        code, body = common.http(front.url + "/fleet/join", "POST",
                                 {"url": "http://127.0.0.1:9"})
        assert code == 503 and body["retry"] is True
        assert "admission probe" in body["error"]
        for bad in ({"host_id": "h"}, {"url": "no-port"}):
            code, body = common.http(front.url + "/fleet/join", "POST",
                                     bad)
            assert code == 400, body
        code, body = common.http(front.url + "/solve", "POST", {
            "dcop": common.ring_yaml(6, 1), "wait": True})
        assert code == 503 and body["retry"] is True
        code, body = common.http(front.url + "/solve", "POST",
                                 {"dcop": "   "})
        assert code == 400
        code, body = common.http(front.url + "/result/nope")
        assert code == 404
        code, body = common.http(front.url + "/healthz")
        assert code == 503 and body["status"] == "failing"
    finally:
        front.stop()


# ------------------------------------------------------------------ #
# the device rule and the worker command


def test_fleet_without_a_card_raises_before_spawning(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    spawned = []
    monkeypatch.setattr(port_router.subprocess, "Popen",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.serve(port=0, replicas=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.serve(port=0, replicas=2, device="cuda")
    assert spawned == []


class _FakeProc:
    pid = 4242

    def poll(self):
        return None


def test_worker_command_carries_device_cache_and_recover(
        monkeypatch, tmp_path):
    seen = []

    def popen(cmd, env, **kw):
        seen.append((cmd, env, kw))
        return _FakeProc()

    monkeypatch.setattr(port_router.subprocess, "Popen", popen)
    journal = tmp_path / "jnl" / "replica-0"
    journal.mkdir(parents=True)
    (journal / "requests.jnl").write_bytes(b"")
    router = port_router.FleetRouter(
        replicas=1, worker_args=["--cycles", "40"],
        journal_dir=str(tmp_path / "jnl"),
        compile_cache_dir=str(tmp_path / "libs"), device="cpu")
    router._run_dir = str(tmp_path)
    replica = port_router.Replica(0, str(journal),
                                  str(tmp_path / "replica-0.log"))
    router._spawn(replica, recover=False)
    cmd, env, kw = seen[0]
    assert cmd[1:4] == ["-m", "pydcop_tpu_torch.dcop_cli", "serve"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert cmd[cmd.index("--journal_dir") + 1] == str(journal)
    assert "--recover" in cmd and cmd[-2:] == ["--cycles", "40"]
    assert env["PYDCOP_COMPILE_CACHE_DIR"] == str(tmp_path / "libs")
    assert kw["start_new_session"] is True
    assert replica.status == port_router.STARTING and not replica.warm


def test_serve_cli_knobs_parse():
    import argparse

    parser = argparse.ArgumentParser()
    serve_cmd.set_parser(parser.add_subparsers())
    args = parser.parse_args(
        ["serve", "--replicas", "4", "--affinity", "round_robin",
         "--compile_cache_dir", "/tmp/aot", "--heartbeat", "0.5",
         "--spill_slack", "7", "--port_file", "/tmp/p", "--hosts", "2",
         "--params_json", '{"prune": 1}', "--device", "cpu"])
    assert (args.replicas, args.affinity, args.compile_cache_dir,
            args.heartbeat, args.spill_slack, args.port_file,
            args.hosts, args.params_json, args.device) == (
        4, "round_robin", "/tmp/aot", 0.5, 7, "/tmp/p", 2,
        '{"prune": 1}', "cpu")
    with pytest.raises(SystemExit):
        parser.parse_args(["serve", "--affinity", "sticky"])


def test_fleet_forwards_full_default_params_and_the_device(monkeypatch):
    captured = {}

    class FakeRouter:
        def __init__(self, **kw):
            captured.update(kw)
            raise RuntimeError("stop here")

    monkeypatch.setattr(port_router, "FleetRouter", FakeRouter)
    with pytest.raises(RuntimeError, match="stop here"):
        api.serve(replicas=2, device="cpu", default_params={
            "max_cycles": 99, "damping": 0.7, "stability": 0.05,
            "prune": 1}, hosts=2)
    args = captured["worker_args"]
    assert args[args.index("--cycles") + 1] == "99"
    assert args[args.index("--damping") + 1] == "0.7"
    assert json.loads(args[args.index("--params_json") + 1]) == {
        "stability": 0.05, "prune": 1}
    assert captured["device"] == "cpu" and captured["hosts"] == 2


def test_cli_recover_and_join_checks_exit_2():
    for argv in (["--replicas", "2", "--recover", "--journal_dir", "d"],
                 ["--replicas", "2", "--join", "http://127.0.0.1:9"]):
        assert dcop_cli.main(["serve", "--device", "cpu", "--port", "0",
                              *argv]) == 2


# ------------------------------------------------------------------ #
# seams


def _static_check():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "static_check", os.path.join(REPO, "tools", "static_check.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_router_notsent_is_the_seam_class():
    from pydcop_tpu_torch.serving import netfault

    assert port_router.ForwardNotSent is netfault.NotSent


def test_port_serving_has_no_raw_socket_io():
    static_check = _static_check()
    serving = os.path.join(REPO, "pydcop_tpu_torch", "serving")
    bad = []
    for fname in sorted(os.listdir(serving)):
        if not fname.endswith(".py") \
                or fname in static_check._SEAM_ALLOWLIST:
            continue
        with open(os.path.join(serving, fname), encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                code = line.split("#", 1)[0]
                bad += [(fname, lineno, tok)
                        for tok in static_check._SOCKET_TOKENS
                        if tok in code]
    assert bad == []


def test_every_forward_carries_a_trace_context():
    static_check = _static_check()
    path = os.path.join(REPO, "pydcop_tpu_torch", "serving", "router.py")
    src = open(path, encoding="utf-8").read()
    calls = list(static_check._call_sites(src, "_forward"))
    streams = list(static_check._call_sites(src, "open_stream"))
    assert len(calls) >= 10 and len(streams) == 1
    assert all("trace=" in call for _, call in calls)
    assert all("headers=" in call for _, call in streams)


class _StubReplica(BaseHTTPRequestHandler):
    """A replica that acks every /solve: what the survivor answers."""

    def do_GET(self):  # noqa: N802 — stdlib name
        # /healthz answers ok; /metrics.json an empty registry.
        self._send({"status": "ok"} if self.path == "/healthz" else {})

    def do_POST(self):  # noqa: N802 — stdlib name
        body = json.loads(self.rfile.read(
            int(self.headers["Content-Length"])))
        if self.path != "/solve":
            self._send({})
            return
        self._send({"id": body["request_id"], "status": "PENDING"},
                   code=202)

    def _send(self, doc, code=200):
        raw = json.dumps(doc).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def log_message(self, *args):
        pass


def _closed_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_refused_connect_is_resent_to_a_survivor():
    """A submit whose pick refuses the connect (zero bytes sent) is
    re-picked onto the healthy replica, never failed: the ack the
    client gets comes from the survivor, with the router-minted id."""
    stub = ThreadingHTTPServer(("127.0.0.1", 0), _StubReplica)
    thread = threading.Thread(target=stub.serve_forever, daemon=True)
    thread.start()
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop
    from pydcop_tpu_torch.serving import binning

    router = _bench_router(port_router, n=2)
    yaml_src = common.ring_yaml(6, 1)
    # The structure's rendezvous owner is the dead slot.
    digest = binning.affinity_key(load_dcop(yaml_src), {})
    owner = max((0, 1), key=lambda k: port_router._rendezvous_score(
        digest, k))
    dead, live = router.replicas[owner], router.replicas[1 - owner]
    dead.port = _closed_port()
    live.port = stub.server_address[1]
    front = _router_front_end(router)
    try:
        code, ack = common.http(front.url + "/solve", "POST",
                                {"dcop": yaml_src})
    finally:
        front.stop()
        stub.shutdown()
        stub.server_close()
    assert code == 202 and ack["id"].startswith("f"), ack
    assert router.reroutes == 1 and dead.status == port_router.DOWN
    assert router.pinned(ack["id"]) is live
    assert (dead.in_flight, live.in_flight) == (0, 0)


def test_trace_knob(monkeypatch):
    from pydcop_tpu_torch.observability import fleettrace

    for value, on in (("0", False), ("off", False), ("1", True)):
        monkeypatch.setenv("PYDCOP_FLEET_TRACE", value)
        assert fleettrace.enabled() is on
    monkeypatch.setenv("PYDCOP_FLEET_TRACE", "0")
    state = fleettrace.configure_shipper(
        "http://127.0.0.1:1", source="replica-0", enable=True)
    assert state["enabled"] is False and fleettrace.shipper() is None


def test_disabled_fleet_trace_answers_503_and_keeps_serving(monkeypatch):
    """With the knob off the front end attaches no collector: the trace
    surfaces answer 503, the serving wire and the metric scrape keep
    working."""
    monkeypatch.setenv("PYDCOP_FLEET_TRACE", "0")
    stub = ThreadingHTTPServer(("127.0.0.1", 0), _StubReplica)
    threading.Thread(target=stub.serve_forever, daemon=True).start()
    router = _bench_router(port_router, n=1)
    router.replicas[0].port = stub.server_address[1]
    front = _router_front_end(router)
    try:
        assert router.collector is None
        code, ack = common.http(front.url + "/solve", "POST",
                                {"dcop": common.ring_yaml(6, 2)})
        assert code == 202 and ack["id"].startswith("f")
        assert common.http(front.url + "/fleet/trace")[0] == 503
        assert common.http(front.url + "/fleet/forensics/x")[0] == 503
        code, doc = common.http(front.url + "/fleet/metrics?format=json")
        assert code == 200 and "router" in doc["sources"]
    finally:
        front.stop()
        stub.shutdown()
        stub.server_close()


# ------------------------------------------------------------------ #
# the loader the router and every worker parse requests with


FIXTURES = sorted(
    f for f in os.listdir(os.path.join(REPO, "tests", "instances"))
    if f.endswith((".yml", ".yaml")) and not f.startswith("scenario"))


@pytest.mark.parametrize("fixture", FIXTURES)
def test_port_loader_gives_the_reference_problem(fixture):
    """The port's ``load_dcop`` (libyaml's parser, one variable table)
    reads every fixture as the reference's does: the same problem
    written back out."""
    from pydcop_tpu.dcop import yamldcop as ref
    from pydcop_tpu_torch.dcop import yamldcop as port

    path = os.path.join(REPO, "tests", "instances", fixture)
    want = ref.dcop_yaml(ref.load_dcop_from_file(path))
    assert port.dcop_yaml(port.load_dcop_from_file(path)) == want


def test_port_loader_reads_a_flagship_request():
    """A 10,000-variable request as the router receives it."""
    import chip_smoke
    import pydcop_tpu_torch.dcop.dcop as dcop_mod
    import pydcop_tpu_torch.dcop.objects as objects
    import pydcop_tpu_torch.dcop.relations as relations
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml, load_dcop

    want = chip_smoke.build_flagship(objects, relations, dcop_mod, 10_000)
    got = load_dcop(dcop_yaml(want))
    assert sorted(got.variables) == sorted(want.variables)
    assert sorted(got.constraints) == sorted(want.constraints)
    for name, c in want.constraints.items():
        assert got.constraints[name].scope_names == c.scope_names
        assert np.array_equal(got.constraints[name].matrix, c.matrix)


# ------------------------------------------------------------------ #
# two processes building one kernel library at once


_BUILD_SCRIPT = textwrap.dedent("""
    import sys
    from pathlib import Path
    from pydcop_tpu_torch.ops import _build
    _build.CSRC = Path(sys.argv[1])
    _build.set_build_dir(sys.argv[2])
    _build.build(["probe"])
    print(_build._lib_path("probe").read_bytes().decode())
""")

# An nvcc stand-in: waits until both builds have started (a marker
# file each in the directory it is given), then writes its output in
# two halves with a pause between, so the two builds overlap mid-write.
_FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import os, sys, time
    marks = {marks!r}
    open(os.path.join(marks, str(os.getpid())), "w").close()
    deadline = time.monotonic() + 60
    while len(os.listdir(marks)) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    out = sys.argv[sys.argv.index("-o") + 1]
    with open(out, "w") as f:
        f.write("first-half;")
        f.flush()
        time.sleep(0.5)
        f.write("second-half")
""")


def test_two_processes_building_one_library(tmp_path):
    """Two cold processes may both run ``nvcc`` for the same library:
    each writes its own temporary file and renames it into place, so
    neither ever sees a half-written library and no temporary file is
    left behind."""
    csrc, build, bin_dir, marks = (
        tmp_path / d for d in ("csrc", "build", "bin", "marks"))
    for d in (csrc, bin_dir, marks):
        d.mkdir()
    (csrc / "probe.cu").write_text("// probe\n")
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable,
                                      marks=str(marks)))
    nvcc.chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}"
               f"{os.environ['PATH']}", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_SCRIPT, str(csrc), str(build)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert len(os.listdir(marks)) == 2      # both ran the compiler
    assert [out.strip() for out, _ in outs] == [
        "first-half;second-half"] * 2
    built = os.listdir(build)
    assert len(built) == 1 and built[0].startswith("probe-"), built
