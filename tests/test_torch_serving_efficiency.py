"""The reference's serving cases of
``tests/unit/test_efficiency_battery.py`` — ``TestServiceLedgers``,
``TestPipelinedFlush`` and ``TestSpeculativeCompiles`` — case for case,
against the port (``pydcop_tpu_torch``) on the CPU, every service with
``device="cpu"``.

The pipelined cases run the port's launch/collect path
(``engine/batch.py``'s ``launch_*``/``collect_*``, on the CPU a
synchronous call behind the same interface).  The speculation case
holds the port's speculator (``serving/speculate.py``) to the
reference's discipline: its jobs run off the scheduler thread, never
mark a key warm, and its key equals the live dispatch's.  The
reference's case reads JAX's compile cache; its counterpart here,
``test_library_cache_*``, reads the kernel-library cache
(``ops/_build.py`` through ``engine/aotcache.py``) with a stand-in
``nvcc`` (the CPU tests run without one).
"""

import stat
import threading

import numpy as np
import pytest
import torch

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation
from pydcop_tpu_torch.engine import aotcache
from pydcop_tpu_torch.engine import batch as engine_batch
from pydcop_tpu_torch.engine.compile import compile_dcop
from pydcop_tpu_torch.observability import efficiency
from pydcop_tpu_torch.observability.efficiency import ledger_component_sum
from pydcop_tpu_torch.observability.metrics import registry
from pydcop_tpu_torch.ops import _build
from pydcop_tpu_torch.serving.service import SolveService

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


MAX_CYCLES = 40
PARAMS = {"max_cycles": MAX_CYCLES}
LEDGER_TOL = 0.05


@pytest.fixture(autouse=True)
def _fresh_plane():
    registry.reset()
    efficiency.tracker.clear()
    yield
    registry.reset()
    efficiency.tracker.clear()


def _ring(n: int, seed: int, d: int = 3) -> DCOP:
    rng = np.random.default_rng(seed)
    dom = Domain("c", "", list(range(d)))
    dcop = DCOP(f"ring{n}_{seed}_{d}", objective="min")
    vs = [Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for k in range(n):
        table = rng.integers(0, 10, size=(d, d)).astype(float)
        dcop.add_constraint(NAryMatrixRelation(
            [vs[k], vs[(k + 1) % n]], table, f"c{k}"))
    dcop.add_agents([AgentDef("a0")])
    return dcop


def _assert_ledger_sums(ledger, tol=LEDGER_TOL):
    assert isinstance(ledger, dict) and ledger.get("total_s", 0) > 0
    gap = abs(ledger_component_sum(ledger) - ledger["total_s"])
    assert gap <= tol * ledger["total_s"], ledger


class TestServiceLedgers:
    def _serve_burst(self, dcops, service_kw=None, params=None):
        service = SolveService(batch_window_s=0.05, max_batch=16,
                               **(service_kw or {}), device="cpu").start()
        try:
            ids = [service.submit(d, params=params or PARAMS)
                   for d in dcops]
            results = [service.result(i, wait=60) for i in ids]
        finally:
            service.stop()
        assert all(r is not None and r["status"] == "FINISHED"
                   for r in results), results
        return results

    def test_solo_and_binned_ledgers_sum(self):
        # 3 same-structure (one binned dispatch) + 1 other (solo).
        results = self._serve_burst(
            [_ring(6, s) for s in range(3)] + [_ring(10, 9)])
        for res in results:
            _assert_ledger_sums(res["ledger"])
        kinds = {res["batch"]["packing"] for res in results}
        assert "structure" in kinds

    def test_envelope_packed_ledgers_sum(self):
        # Distinct structures, prune=1 keeps them off the lane path,
        # zero modeled overhead forces the pack.
        results = self._serve_burst(
            [_ring(n, n) for n in (6, 9, 12)],
            service_kw={"envelope_overhead_ms": 1e6, "lane_pack": False},
            params={"max_cycles": MAX_CYCLES})
        for res in results:
            _assert_ledger_sums(res["ledger"])
        assert any(res["batch"]["packing"] == "envelope"
                   for res in results), [
                       r["batch"] for r in results]

    def test_lane_packed_ledgers_sum(self):
        results = self._serve_burst(
            [_ring(n, n) for n in (6, 9, 12)],
            service_kw={"envelope_overhead_ms": 1e6})
        for res in results:
            _assert_ledger_sums(res["ledger"])
        assert any(res["batch"]["packing"] == "lane"
                   for res in results), [
                       r["batch"] for r in results]

    def test_finished_requests_feed_the_rollup(self):
        self._serve_burst([_ring(6, s) for s in range(2)])
        roll = efficiency.tracker.rollup()
        assert roll["ledger"]["counts"].get("request", 0) >= 2
        assert roll["backends"], roll

    def test_session_segment_ledgers_sum(self):
        service = SolveService(batch_window_s=0.01, device="cpu").start()
        try:
            sess = service.sessions.open(
                _ring(8, 3), params={"max_cycles": 120,
                                     "segment_cycles": 30})
            out = service.sessions.apply_events(
                sess.id,
                [{"type": "change_factor", "name": "c0",
                  "variables": ["v0", "v1"],
                  "table": [[0, 5, 5], [5, 0, 5], [5, 5, 0]]}],
                wait=30.0)
            assert out["applied"] is True
            ledger = out["result"]["ledger"]
            _assert_ledger_sums(ledger)
            status = service.sessions.status(sess.id)
            _assert_ledger_sums(status["last"]["ledger"])
        finally:
            service.stop()
        assert efficiency.tracker.rollup()["ledger"]["counts"].get(
            "session", 0) >= 1

    def test_expired_request_still_carries_summing_ledger(self):
        service = SolveService(batch_window_s=0.01, device="cpu").start()
        try:
            req_id = service.submit(_ring(6, 0), params=PARAMS,
                                    deadline_s=1e-9)
            res = service.result(req_id, wait=30)
        finally:
            service.stop()
        if res is not None and res["status"] == "EXPIRED":
            _assert_ledger_sums(res["ledger"], tol=0.5)


# ------------------------------------------------------------------ #
# surfaces: /profile, /metrics labels, profile report
# ------------------------------------------------------------------ #

class TestPipelinedFlush:
    """Ledger honesty and terminal ordering when dispatch k+1
    launches before dispatch k decodes (the pipelined flush path)."""

    def _pipelined_burst(self, dcops, service_kw=None):
        """Warm pass (compiles every program synchronously), then the
        measured burst on warm programs — only warm dispatches take
        the pipelined launch/collect path."""
        kw = dict({"pipeline": True}, **(service_kw or {}))
        service = SolveService(batch_window_s=0.05, max_batch=16,
                               **kw, device="cpu").start()
        completions = []
        orig_pub = service._publish_lifecycle

        def pub(event, req):
            if event == "finished":
                completions.append(req.id)
            return orig_pub(event, req)

        service._publish_lifecycle = pub
        try:
            ids = [service.submit(d, params=PARAMS) for d in dcops]
            warm = [service.result(i, wait=60) for i in ids]
            assert all(r["status"] == "FINISHED" for r in warm), warm
            completions.clear()
            ids = [service.submit(d, params=PARAMS) for d in dcops]
            results = [service.result(i, wait=60) for i in ids]
            assert all(r["status"] == "FINISHED"
                       for r in results), results
            reqs = {i: service._requests[i] for i in ids}
            stats = service.stats()
        finally:
            service.stop()
        return ids, results, reqs, stats, completions

    def test_multibin_pipelined_ledgers_and_ordering(self):
        # Two structures x 2 requests: two bins per flush, so the
        # second bin's device call launches while the first bin's
        # arrays are still in flight (scheduler pending depth 2).
        dcops = ([_ring(6, s) for s in range(2)]
                 + [_ring(9, s) for s in range(2)])
        ids, results, reqs, stats, completions = \
            self._pipelined_burst(dcops)
        assert stats["pipeline"]["enabled"]
        assert stats["pipeline"]["pipelined_dispatches"] >= 2, stats
        roll = efficiency.tracker.rollup()
        assert roll["pipeline"]["dispatches"] >= 2
        assert 0.0 <= roll["pipeline_overlap_fraction"] <= 1.0
        for res in results:
            # Sum-to-latency holds on the pipelined path, and decode
            # is attributed to the owning request (its own host
            # post-processing wall, never zeroed by the overlap).
            _assert_ledger_sums(res["ledger"])
            assert res["ledger"]["decode_s"] > 0.0, res["ledger"]
        # Terminal callbacks fire in pickup order: the order the
        # scheduler dispatched (t_dispatch), not decode-completion
        # races.
        pickup = sorted(ids, key=lambda i: reqs[i].t_dispatch)
        assert completions == pickup, (completions, pickup)

    def test_pipelined_envelope_and_lane_ledgers(self):
        mixed = [_ring(5, 0), _ring(6, 1), _ring(7, 2)]
        for kw in ({"envelope_overhead_ms": 1e6, "lane_pack": False},
                   {"envelope_overhead_ms": 1e6}):
            efficiency.tracker.clear()
            _ids, results, _reqs, stats, _comp = \
                self._pipelined_burst(mixed, service_kw=kw)
            assert stats["pipeline"]["pipelined_dispatches"] >= 1
            kinds = {r["batch"]["packing"] for r in results}
            assert kinds <= {"envelope", "lane"}, kinds
            for res in results:
                _assert_ledger_sums(res["ledger"])

    def test_no_pipeline_knob_stays_synchronous(self):
        dcops = [_ring(6, s) for s in range(2)]
        _ids, results, _reqs, stats, _comp = self._pipelined_burst(
            dcops, service_kw={"pipeline": False})
        assert stats["pipeline"]["pipelined_dispatches"] == 0
        for res in results:
            _assert_ledger_sums(res["ledger"])

    def test_stubbed_run_batch_never_pipelines(self):
        # A test double stubbing the device call IS the contract
        # under test for a pile of batteries: the pipelined path must
        # step aside for it.
        service = SolveService(batch_window_s=0.02, pipeline=True,
                               device="cpu")
        calls = []
        orig = SolveService._run_batch

        def stub(reqs, params):
            calls.append(len(reqs))
            return orig(service, reqs, params)

        service._run_batch = stub
        service.start()
        try:
            i = service.submit(_ring(6, 0), params=PARAMS)
            r1 = service.result(i, wait=60)
            i = service.submit(_ring(6, 1), params=PARAMS)
            r2 = service.result(i, wait=60)
        finally:
            stats = service.stats()
            service.stop()
        assert r1["status"] == r2["status"] == "FINISHED"
        assert len(calls) == 2, calls
        assert stats["pipeline"]["pipelined_dispatches"] == 0


class TestSpeculativeCompiles:
    """Speculation discipline: background builds never run on the
    device-owning scheduler thread, are compile-only (trace-span
    asserted), and a speculated program's first real dispatch counts
    as a hit."""

    def test_speculation_off_thread_and_hits(self):
        from pydcop_tpu_torch.observability.trace import tracer
        from pydcop_tpu_torch.serving import binning

        tracer.enable()
        service = SolveService(batch_window_s=0.05, max_batch=16,
                               pipeline=True, speculate=True,
                               device="cpu").start()
        try:
            sched_ident = service._scheduler_ident
            assert sched_ident is not None
            # Phase 1: a recurring solo structure seeds the arrival
            # histogram; the speculator AOT-builds the bin rungs its
            # traffic will need (bs=2 among them).  The structure is
            # unique to this test (ring 11) — a key another battery
            # test already dispatched would be live-warm, which the
            # speculator rightly refuses to rebuild (and whose first
            # dispatch here would not be cold, so no hit either).
            for s in range(2):
                i = service.submit(_ring(11, s), params=PARAMS)
                assert service.result(i, wait=60)[
                    "status"] == "FINISHED"
            graph, _ = compile_dcop(_ring(11, 0), pad_to=1,
                                    aggregation="scatter")
            p = binning.normalize_params(PARAMS)
            prep = engine_batch._prepare_stacked(
                [graph, graph], p["max_cycles"], p["damping"],
                p["damping_nodes"], p["stability"],
                service.bin_sizes, False, None)
            expected = str(prep.key)
            import time as _time

            deadline = _time.time() + 120
            spec = service._speculator
            while (_time.time() < deadline
                   and expected not in spec.compiled_keys):
                _time.sleep(0.2)
            assert expected in spec.compiled_keys, spec.stats()
            # Phase 2: the predicted bin-of-2 arrives; its program is
            # cold in the jit cache but speculatively built — a hit.
            ids = [service.submit(_ring(11, s), params=PARAMS)
                   for s in (7, 8)]
            results = [service.result(i, wait=60) for i in ids]
            assert all(r["status"] == "FINISHED" for r in results)
            stats = service.stats()
            assert stats["speculation"]["enabled"]
            assert stats["speculation"][
                "speculative_compiles_total"] >= 1
            assert stats["speculation"]["hits"] >= 1, stats
            # Discipline: every compile ran off the scheduler thread.
            assert spec.records, "no compile records"
            for rec in spec.records:
                assert rec["thread_ident"] != sched_ident, rec
                assert rec["compile_only"], rec
            # Trace-span asserted too: speculative_compile spans
            # carry their thread and the compile-only flag, and none
            # ever ran on the dispatch-owning thread.
            spans = [e for e in tracer.events()
                     if e.get("name") == "speculative_compile"]
            assert spans, "no speculative_compile spans recorded"
            for ev in spans:
                assert ev["args"]["compile_only"] is True
                assert ev["args"]["thread"] != sched_ident
        finally:
            service.stop()
            tracer.disable()
            tracer.clear()


# ------------------------------------------------------------------ #
# The kernel-library cache (the counterpart of the reference's compile
# cache), with a stand-in nvcc that writes its output after a pause
# and logs each call.


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` (the CPU tests have none) and a fresh library
    directory; ``ops/_build.py``'s directory and loaded libraries and
    ``engine/aotcache.py``'s state are restored afterwards."""
    log = tmp_path / "nvcc.log"
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f"echo call >> {log}\n"
        "sleep 0.3\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then shift; echo lib > \"$1\"; fi\n"
        "  shift\n"
        "done\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    saved_dir = _build.BUILD_DIR
    saved_state = dict(aotcache._state)
    aotcache.enable_persistent_compile_cache(str(tmp_path / "libs"))
    yield log
    _build.set_build_dir(saved_dir)
    aotcache._state.clear()
    aotcache._state.update(saved_state)


def _calls(log) -> int:
    return len(log.read_text().split()) if log.exists() else 0


def test_library_cache_counts_misses_then_hits(fake_nvcc):
    """A library built into the cache directory is a miss; asked for
    again, a hit — counted for the process and for the thread."""
    before = dict(_build.cache_counts)
    mine = aotcache.counters()
    _build.build(["lane_sum"])
    _build.build(["lane_sum"])
    assert _calls(fake_nvcc) == 1
    assert _build.cache_counts["misses"] == before["misses"] + 1
    assert _build.cache_counts["hits"] == before["hits"] + 1
    now = aotcache.counters()
    assert now["misses"] - mine["misses"] == 1
    assert now["hits"] - mine["hits"] == 1
    stats = aotcache.stats()
    assert stats["enabled"] and stats["entries"] == 1


def test_library_cache_two_threads_build_once(fake_nvcc):
    """Two threads asking for the same library run one nvcc: the
    second waits on the library's lock and finds it built."""
    barrier = threading.Barrier(2)

    def go():
        barrier.wait()
        _build.build(["window_sum"])

    threads = [threading.Thread(target=go) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert _calls(fake_nvcc) == 1


def test_library_cache_split_cold_call(fake_nvcc, monkeypatch):
    """A cold call whose libraries all came from the cache reports its
    load time as compile; one that built a library, or saw no cache
    activity, keeps the whole interval (None)."""
    _build.build(["segment_sum"])              # now in the cache
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_libs", {})
    before = aotcache.counters()
    _build.load("segment_sum")                 # a hit, then loaded
    after = aotcache.counters()
    split = aotcache.split_cold_call(5.0, before, after)
    assert split is not None and 0.0 <= split <= 5.0
    assert split == pytest.approx(after["load_s"] - before["load_s"])
    before = aotcache.counters()
    _build.load("var_update")                  # a miss: built
    assert aotcache.split_cold_call(
        5.0, before, aotcache.counters()) is None
    same = aotcache.counters()
    assert aotcache.split_cold_call(5.0, same, same) is None


def test_build_on_other_thread_leaves_solve_compile_unchanged(
        fake_nvcc, monkeypatch):
    """The build seconds a solve reports as its compile time are its
    own thread's: a build that another thread runs to completion
    inside the solve's window (the speculative builder's case) leaves
    the solve's ``compile_time_s`` at its CPU value, 0."""
    from pydcop_tpu_torch.engine.runner import MaxSumEngine
    from pydcop_tpu_torch.ops import maxsum as maxsum_ops

    real = maxsum_ops.run_maxsum
    built = []

    def run_with_side_build(*args, **kwargs):
        t = threading.Thread(
            target=lambda: built.append(_build.build(["threefry"])))
        t.start()
        t.join(timeout=30)
        return real(*args, **kwargs)

    monkeypatch.setattr(maxsum_ops, "run_maxsum", run_with_side_build)
    total_before = _build.build_seconds
    graph, meta = compile_dcop(_ring(6, 0), noise_level=0.01)
    res = MaxSumEngine(graph, meta, device="cpu").run(max_cycles=10)
    assert built and built[0] > 0.0
    assert _build.build_seconds > total_before
    assert res.compile_time_s == 0.0
