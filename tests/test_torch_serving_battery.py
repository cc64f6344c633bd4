"""The reference's ``tests/unit/test_serving_battery.py``, case for
case, against the port (``pydcop_tpu_torch``) on the CPU: every
service, engine and front end runs with ``device="cpu"``.  The
reference's text:

Battery for the multi-tenant solve service (pydcop_tpu_torch/serving):
binning correctness (two structures never share a dispatch;
same-structure requests coalesce), batch results bit-identical to
solo engine runs, backpressure 429s at the high-water mark, breaker
opening on repeated dispatch failure (and /healthz reflecting it),
the bin-padding accounting in engine/batch, the /healthz
accelerator-probe surfacing, and a concurrent-client soak with no
lost or duplicated responses."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation
from pydcop_tpu_torch.engine import batch as engine_batch
from pydcop_tpu_torch.engine.compile import compile_dcop
from pydcop_tpu_torch.engine.runner import MaxSumEngine
from pydcop_tpu_torch.serving import binning
from pydcop_tpu_torch.serving.admission import (
    AdmissionController,
    AdmissionPolicy,
    QueueFull,
    ServiceUnavailable,
)
from pydcop_tpu_torch.serving.service import SolveService

import torch_serving_common as common


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


MAX_CYCLES = 40
PARAMS = {"max_cycles": MAX_CYCLES}


def _instance(n: int, seed: int, chords: bool = False) -> DCOP:
    """Ring (optionally chorded) coloring with random cost tables:
    same (n, chords) -> same structure bin; seed varies the tables."""
    rng = np.random.default_rng(seed)
    dom = Domain("c", "", [0, 1, 2])
    dcop = DCOP(f"s{n}_{seed}_{chords}", objective="min")
    vs = [Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    edges = [(i, (i + 1) % n) for i in range(n)]
    if chords:
        edges += [(i, (i + n // 2) % n) for i in range(0, n, 3)]
    for k, (i, j) in enumerate(edges):
        table = rng.integers(0, 10, size=(3, 3)).astype(float)
        dcop.add_constraint(
            NAryMatrixRelation([vs[i], vs[j]], table, f"c{k}"))
    dcop.add_agents([AgentDef("a0")])
    return dcop


def _service(**kw) -> SolveService:
    kw.setdefault("batch_window_s", 0.1)
    kw.setdefault("max_batch", 8)
    return SolveService(**kw, device="cpu")


# ------------------------------------------------------------------ #
# binning


class TestBinning:
    def test_same_structure_same_key(self):
        g1, _ = compile_dcop(_instance(10, 0), noise_level=0.01)
        g2, _ = compile_dcop(_instance(10, 7), noise_level=0.01)
        params = binning.normalize_params(PARAMS)
        assert binning.bin_key(g1, params) == binning.bin_key(
            g2, params)

    def test_different_topology_different_key(self):
        """Same variable count and shapes can still be different
        structures (chords move scope indices): keys must differ."""
        g1, _ = compile_dcop(_instance(12, 0), noise_level=0.01)
        g2, _ = compile_dcop(
            _instance(12, 0, chords=True), noise_level=0.01)
        params = binning.normalize_params(PARAMS)
        assert binning.bin_key(g1, params) != binning.bin_key(
            g2, params)

    def test_different_params_different_key(self):
        g, _ = compile_dcop(_instance(10, 0), noise_level=0.01)
        p1 = binning.normalize_params({"max_cycles": 40})
        p2 = binning.normalize_params({"max_cycles": 50})
        assert binning.bin_key(g, p1) != binning.bin_key(g, p2)

    def test_unknown_param_rejected(self):
        with pytest.raises(ValueError, match="unknown solver param"):
            binning.normalize_params({"cycles": 10})

    def test_bin_label_is_short(self):
        g, _ = compile_dcop(_instance(10, 0), noise_level=0.01)
        key = binning.bin_key(g, binning.normalize_params(PARAMS))
        assert len(binning.bin_label(key)) < 40


# ------------------------------------------------------------------ #
# bin padding (engine/batch)


class TestBinPadding:
    def test_bin_size_ladder(self):
        assert engine_batch.bin_size_for(3, (1, 2, 4, 8)) == 4
        assert engine_batch.bin_size_for(4, (1, 2, 4, 8)) == 4
        assert engine_batch.bin_size_for(9, (1, 2, 4, 8)) == 9

    def test_pad_fraction_reported_in_metrics(self):
        graphs = [compile_dcop(_instance(8, s), noise_level=0.01)[0]
                  for s in range(3)]
        _, _, batch_result = engine_batch.run_stacked(
            graphs, max_cycles=10, pad_to_bins=(1, 2, 4, 8), device="cpu")
        metrics = batch_result.metrics
        assert metrics["batch_size"] == 4
        assert metrics["n_real"] == 3
        assert metrics["pad_fraction"] == pytest.approx(0.25)

    def test_no_padding_zero_fraction(self):
        graphs = [compile_dcop(_instance(8, s), noise_level=0.01)[0]
                  for s in range(4)]
        _, _, batch_result = engine_batch.run_stacked(
            graphs, max_cycles=10, pad_to_bins=(1, 2, 4, 8), device="cpu")
        assert batch_result.metrics["pad_fraction"] == 0.0
        assert batch_result.metrics["batch_size"] == 4

    def test_padded_results_match_unpadded(self):
        """Padding lanes must not leak into real lanes: values for
        the first n_real instances are identical with and without
        padding."""
        graphs = [compile_dcop(_instance(8, s), noise_level=0.01)[0]
                  for s in range(3)]
        v_pad, c_pad, _ = engine_batch.run_stacked(
            graphs, max_cycles=10, pad_to_bins=(1, 2, 4, 8), device="cpu")
        v_raw, c_raw, _ = engine_batch.run_stacked(
            graphs, max_cycles=10, device="cpu")
        assert np.array_equal(v_pad, v_raw)
        assert np.array_equal(c_pad, c_raw)

    def test_solve_maxsum_batch_carries_batch_metrics(self):
        dcops = [_instance(8, s) for s in range(3)]
        results = engine_batch.solve_maxsum_batch(
            dcops, max_cycles=10, pad_to_bins=(1, 2, 4, 8), device="cpu")
        assert all(r["batch"]["pad_fraction"] == pytest.approx(0.25)
                   for r in results)


# ------------------------------------------------------------------ #
# admission


class TestAdmission:
    def test_high_water_rejects(self):
        ctl = AdmissionController(AdmissionPolicy(high_water=3))
        ctl.admit(2)
        with pytest.raises(QueueFull):
            ctl.admit(3)

    def test_breaker_opens_after_failures_and_recovers(self):
        # Long reset for the rejection phase: the breaker-open flight
        # bundle dump (process-global, always-on) can take > 50 ms in
        # a full suite run, and a tiny reset window would already be
        # HALF-OPEN by the time admit() runs (observed flake).
        ctl = AdmissionController(AdmissionPolicy(
            high_water=10, breaker_failures=2, breaker_reset_s=30.0))
        ctl.admit(0)
        ctl.record_dispatch(ok=False)
        ctl.admit(0)  # one failure: still closed
        ctl.record_dispatch(ok=False)
        assert ctl.breaker_state == "open"
        with pytest.raises(ServiceUnavailable):
            ctl.admit(0)
        # Recovery phase on its own controller with a short reset
        # (its bundle is rate-limited away by the first trip above).
        ctl = AdmissionController(AdmissionPolicy(
            high_water=10, breaker_failures=2, breaker_reset_s=0.05))
        ctl.record_dispatch(ok=False)
        ctl.record_dispatch(ok=False)
        time.sleep(0.06)
        # Half-open admits; a successful probe dispatch closes it.
        ctl.admit(0)
        ctl.record_dispatch(ok=True)
        assert ctl.breaker_state == "closed"


# ------------------------------------------------------------------ #
# service dispatch semantics


class TestServiceDispatch:
    def test_same_structure_requests_coalesce(self):
        with _service(batch_window_s=0.3) as svc:
            ids = [svc.submit(_instance(10, s), params=PARAMS)
                   for s in range(5)]
            results = [svc.result(i, wait=60) for i in ids]
        assert all(r["status"] == "FINISHED" for r in results)
        assert svc.dispatches < 5
        assert svc.batched_dispatches >= 1
        # Shared-dispatch evidence on the results themselves.
        assert any(r["batch"]["n_real"] > 1 for r in results)

    def test_two_structures_never_share_a_dispatch(self):
        seen_bins = []
        with _service(batch_window_s=0.3) as svc:
            real_dispatch = svc.dispatch

            def spy(reqs):
                seen_bins.append({r.bin for r in reqs})
                real_dispatch(reqs)

            svc.dispatch = spy
            ids = [svc.submit(_instance(10, s), params=PARAMS)
                   for s in range(3)]
            ids += [svc.submit(_instance(14, s), params=PARAMS)
                    for s in range(3)]
            results = [svc.result(i, wait=60) for i in ids]
        assert all(r["status"] == "FINISHED" for r in results)
        assert len(seen_bins) >= 2
        # Every dispatch was bin-pure.
        assert all(len(bins) == 1 for bins in seen_bins)

    def test_results_bit_identical_to_solo_solves(self):
        dcops = [_instance(12, s) for s in range(4)]
        with _service(batch_window_s=0.3) as svc:
            ids = [svc.submit(d, params=PARAMS) for d in dcops]
            results = [svc.result(i, wait=60) for i in ids]
        for dcop, res in zip(dcops, results):
            graph, meta = compile_dcop(dcop, noise_level=0.01)
            solo = MaxSumEngine(graph, meta, device="cpu").run(
                max_cycles=MAX_CYCLES, stop_on_convergence=False)
            assert res["assignment"] == solo.assignment
            assert res["cost"] == dcop.solution_cost(
                res["assignment"])[0]

    def test_latency_accounting_present(self):
        with _service() as svc:
            rid = svc.submit(_instance(10, 0), params=PARAMS)
            res = svc.result(rid, wait=60)
        lat = res["latency"]
        assert lat["total_s"] > 0
        assert lat["dispatch_s"] > 0
        assert lat["total_s"] >= lat["dispatch_s"]

    def test_unknown_request_id_raises(self):
        with _service() as svc:
            with pytest.raises(KeyError):
                svc.result("nope")

    def test_submit_rejects_unknown_param(self):
        with _service() as svc:
            with pytest.raises(ValueError, match="unknown solver"):
                svc.submit(_instance(8, 0), params={"bogus": 1})

    def test_unhashable_param_rejected_and_service_survives(self):
        """An unhashable param value must fail the SUBMIT (400), not
        reach the scheduler's bin map and kill its thread — after the
        rejection the service still serves."""
        from pydcop_tpu_torch.observability.metrics import (
            registry as reg,
        )

        with _service() as svc:
            before = reg.value("pydcop_requests_total",
                               status="rejected_bad_request")
            with pytest.raises(ValueError, match="bad solver param"):
                svc.submit(_instance(8, 0),
                           params={"damping": [0.5]})
            with pytest.raises(ValueError, match="damping_nodes"):
                svc.submit(_instance(8, 0),
                           params={"damping_nodes": "everything"})
            # Bad submits are ledger entries too.
            assert reg.value(
                "pydcop_requests_total",
                status="rejected_bad_request") == before + 2
            rid = svc.submit(_instance(8, 1), params=PARAMS)
            assert svc.result(rid, wait=60)["status"] == "FINISHED"

    def test_decode_failure_fails_request_not_scheduler(self):
        """A result decode that raises (bad meta) errors that one
        request; batch-mates and later requests still complete."""
        with _service(batch_window_s=0.3) as svc:
            poisoned = _instance(10, 0)
            healthy = [_instance(10, s) for s in (1, 2)]
            ids = {}
            ids[poisoned.name] = svc.submit(poisoned, params=PARAMS)
            for d in healthy:
                ids[d.name] = svc.submit(d, params=PARAMS)
            # Poison AFTER submit: break the stored request's meta so
            # only the decode (scheduler-side) fails.
            with svc._lock:
                req = svc._requests[ids[poisoned.name]]
            req.meta = None
            bad = svc.result(ids[poisoned.name], wait=60)
            assert bad["status"] == "ERROR"
            assert "decode failed" in bad["error"]
            for d in healthy:
                res = svc.result(ids[d.name], wait=60)
                assert res["status"] == "FINISHED"
            # Scheduler alive: a fresh request still serves.
            rid = svc.submit(_instance(10, 9), params=PARAMS)
            assert svc.result(rid, wait=60)["status"] == "FINISHED"

    def test_result_retention_prunes_completed(self):
        with _service(result_keep=3) as svc:
            ids = [svc.submit(_instance(8, s), params=PARAMS)
                   for s in range(3)]
            for i in ids:
                assert svc.result(i, wait=60) is not None
            # A 4th submit evicts the oldest completed result.
            last = svc.submit(_instance(8, 9), params=PARAMS)
            assert svc.result(last, wait=60) is not None
            with pytest.raises(KeyError):
                svc.result(ids[0])


# ------------------------------------------------------------------ #
# backpressure + breaker through the service


class TestBackpressure:
    def test_429_at_high_water_no_lost_requests(self):
        gate = threading.Event()
        svc = _service(
            max_queue=16, batch_window_s=0.01, max_batch=2,
            admission=AdmissionPolicy(high_water=3))
        real_run = svc._run_batch

        def slowed(reqs, params):
            gate.wait(30)
            return real_run(reqs, params)

        svc._run_batch = slowed
        svc.start()
        try:
            accepted, rejected = [], 0
            for s in range(10):
                try:
                    accepted.append(
                        svc.submit(_instance(8, s), params=PARAMS))
                except QueueFull:
                    rejected += 1
            assert rejected >= 1
            gate.set()
            results = [svc.result(i, wait=60) for i in accepted]
            assert all(r is not None and r["status"] == "FINISHED"
                       for r in results)
            # The ledger balances: every submit is accounted.
            assert svc.completed == len(accepted)
        finally:
            gate.set()
            svc.stop(drain=False)

    def test_breaker_opens_and_healthz_reflects_it(self):
        svc = _service(
            batch_window_s=0.01,
            admission=AdmissionPolicy(
                high_water=64, breaker_failures=2,
                breaker_reset_s=60.0))

        def failing(reqs, params):
            raise RuntimeError("engine down")

        svc._run_batch = failing
        svc.start()
        from pydcop_tpu_torch.serving.http import ServeFrontEnd

        front = ServeFrontEnd(svc, port=0).start()
        try:
            for s in range(2):
                rid = svc.submit(_instance(8, s), params=PARAMS)
                res = svc.result(rid, wait=30)
                assert res["status"] == "ERROR"
                assert "dispatch failed" in res["error"]
            assert svc.admission.breaker_state == "open"
            with pytest.raises(ServiceUnavailable):
                svc.submit(_instance(8, 5), params=PARAMS)
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(
                    front.url + "/healthz", timeout=10)
            assert err.value.code == 503
            body = json.loads(err.value.read())
            assert body["status"] == "failing"
            assert body["serving"]["breaker_state"] == "open"
        finally:
            front.stop()
            svc.stop(drain=False)

    def test_dispatch_failure_fails_batch_not_service(self):
        """One poisoned dispatch must not wedge the scheduler: later
        (recovered) dispatches still serve."""
        svc = _service(
            batch_window_s=0.01,
            admission=AdmissionPolicy(
                high_water=64, breaker_failures=5))
        real_run = svc._run_batch
        fail_once = [True]

        def flaky(reqs, params):
            if fail_once[0]:
                fail_once[0] = False
                raise RuntimeError("transient")
            return real_run(reqs, params)

        svc._run_batch = flaky
        svc.start()
        try:
            r1 = svc.submit(_instance(8, 0), params=PARAMS)
            assert svc.result(r1, wait=30)["status"] == "ERROR"
            r2 = svc.submit(_instance(8, 1), params=PARAMS)
            assert svc.result(r2, wait=60)["status"] == "FINISHED"
        finally:
            svc.stop(drain=False)


# ------------------------------------------------------------------ #
# HTTP front end


class TestHttpFrontEnd:
    def test_post_solve_wait_and_poll(self):
        from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml
        from pydcop_tpu_torch.serving.http import ServeFrontEnd

        svc = _service(batch_window_s=0.05)
        svc.start()
        front = ServeFrontEnd(svc, port=0).start()
        try:
            yaml_src = dcop_yaml(_instance(10, 3))
            req = urllib.request.Request(
                front.url + "/solve",
                data=json.dumps({
                    "dcop": yaml_src, "wait": True,
                    "params": PARAMS}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
                body = json.loads(resp.read())
            assert body["status"] == "FINISHED"
            assert body["assignment"]

            # Async submit + poll.
            req = urllib.request.Request(
                front.url + "/solve",
                data=json.dumps({"dcop": yaml_src,
                                 "params": PARAMS}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 202
                rid = json.loads(resp.read())["id"]
            deadline = time.monotonic() + 30
            status = None
            while time.monotonic() < deadline:
                with urllib.request.urlopen(
                        front.url + f"/result/{rid}",
                        timeout=10) as resp:
                    if resp.status == 200:
                        status = json.loads(resp.read())["status"]
                        break
                time.sleep(0.05)
            assert status == "FINISHED"

            # /stats and /metrics mounted alongside.
            with urllib.request.urlopen(front.url + "/stats",
                                        timeout=10) as resp:
                stats = json.loads(resp.read())
            assert stats["completed"] >= 2
            with urllib.request.urlopen(front.url + "/metrics",
                                        timeout=10) as resp:
                text = resp.read().decode()
            assert "pydcop_requests_total" in text
            assert "pydcop_request_latency_seconds" in text
        finally:
            front.stop()
            svc.stop(drain=False)

    def test_bad_bodies_400_unknown_404(self):
        from pydcop_tpu_torch.serving.http import ServeFrontEnd

        svc = _service()
        svc.start()
        front = ServeFrontEnd(svc, port=0).start()
        try:
            for payload in (b"", b"not json",
                            json.dumps({"nope": 1}).encode(),
                            json.dumps({"dcop": "::bad"}).encode()):
                req = urllib.request.Request(
                    front.url + "/solve", data=payload,
                    headers={"Content-Type": "application/json"})
                with pytest.raises(urllib.error.HTTPError) as err:
                    urllib.request.urlopen(req, timeout=10)
                assert err.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(front.url + "/result/zzz",
                                       timeout=10)
            assert err.value.code == 404
        finally:
            front.stop()
            svc.stop(drain=False)


# ------------------------------------------------------------------ #
# /healthz accelerator-probe surfacing


class TestHealthzProbeDiagnostics:
    def test_probe_failure_root_cause_in_health_body(self, monkeypatch):
        import os

        from pydcop_tpu_torch.observability.server import health_verdict
        from pydcop_tpu_torch.utils.cleanenv import DIAG_ENV, record_diag

        monkeypatch.setenv(DIAG_ENV, "[]")
        assert "accelerator_probe" not in health_verdict()
        record_diag("probe", tag="t", attempt=1, of=1, ok=False,
                    error="timeout after 60s", seconds=60.0)
        record_diag("cpu_fallback", tag="t")
        verdict = health_verdict()
        probe = verdict["accelerator_probe"]
        assert probe["failures"] == 2
        assert probe["last_event"] == "cpu_fallback"
        assert any(e.get("error") == "timeout after 60s"
                   for e in probe["recent"])
        # Informational only: probe trouble never flips the status.
        assert verdict["status"] == "ok"
        assert os.environ[DIAG_ENV]  # log survives for later bodies

    def test_successful_probes_keep_body_small(self, monkeypatch):
        from pydcop_tpu_torch.observability.server import health_verdict
        from pydcop_tpu_torch.utils.cleanenv import DIAG_ENV, record_diag

        monkeypatch.setenv(DIAG_ENV, "[]")
        record_diag("probe", tag="t", attempt=1, of=1, ok=True,
                    error=None, seconds=1.0)
        assert "accelerator_probe" not in health_verdict()


class TestConcurrentSoak:
    N_CLIENTS = 6
    PER_CLIENT = 4

    def test_no_lost_or_duplicated_responses(self):
        """Every client gets exactly its own results back: ids are
        unique, every request finishes, and each response decodes the
        submitting client's own problem (variable names prove the
        structure; no cross-wiring)."""
        sizes = (10, 13)  # two structure bins, interleaved clients
        with _service(batch_window_s=0.05, max_batch=4,
                      max_queue=256) as svc:
            received = {}
            errors = []
            lock = threading.Lock()

            def client(cid):
                n = sizes[cid % len(sizes)]
                try:
                    for k in range(self.PER_CLIENT):
                        dcop = _instance(n, seed=cid * 100 + k)
                        rid = svc.submit(dcop, params=PARAMS)
                        res = svc.result(rid, wait=120)
                        with lock:
                            received[(cid, k)] = (rid, n, res)
                except Exception as exc:  # noqa: BLE001
                    with lock:
                        errors.append((cid, repr(exc)))

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(self.N_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
        assert not errors, errors
        assert len(received) == self.N_CLIENTS * self.PER_CLIENT
        ids = [rid for rid, _, _ in received.values()]
        assert len(set(ids)) == len(ids)  # no duplicated ids
        for (cid, k), (rid, n, res) in received.items():
            assert res is not None, f"lost response {cid}/{k}"
            assert res["status"] == "FINISHED"
            assert res["id"] == rid
            # The assignment covers exactly this client's variables.
            assert set(res["assignment"]) == {
                f"v{i}" for i in range(n)}
        # Ledger: everything completed, nothing failed.
        assert svc.completed >= self.N_CLIENTS * self.PER_CLIENT
        assert svc.failed == 0
