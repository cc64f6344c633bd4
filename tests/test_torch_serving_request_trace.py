"""The reference's ``tests/unit/test_request_trace_battery.py``, case for
case, against the port (``pydcop_tpu_torch``) on the CPU: every
service, engine and front end runs with ``device="cpu"``.  The
reference's text:

Battery for the request-scoped observability plane:

- **trace context**: ``tracer.context`` binds args (a request's
  ``trace_id``, a dispatch's ``trace_ids``) onto the current thread so
  every span/instant recorded underneath carries them; ``complete``
  records a span from explicit endpoints (the queue wait that starts
  on the submitting thread and ends on the scheduler);
- **request query**: ``query_request`` filters a trace to one
  request's events and rebuilds a well-nested span tree — asserted
  end-to-end through a real ``SolveService`` submit→dispatch→engine
  path and through the ``pydcop trace query`` CLI;
- **latency exemplars**: histogram buckets remember the last trace_id
  per native bucket, exposed in OpenMetrics exemplar syntax and
  resolvable by quantile (the p99 spike → trace hop);
- **flight recorder**: the always-on ring records while file tracing
  is off; anomaly triggers (guard trip, poison bin) dump postmortem
  bundles whose event tail contains the triggering instant (the
  anomaly acceptance, battery form); ``pydcop debug bundle``
  cuts one on demand, locally and over HTTP;
- **serve-plane SSE**: a client on ``/events`` sees a submitted
  request's full lifecycle (accepted → dispatched → finished) in
  order, each event carrying the trace_id;
- **/healthz journal backlog**: a journaled service reports
  ``pending_replayable`` + ``journal_bytes`` (replay debt before a
  restart);
- **TraceFileError regressions**: a trace file with a truncated
  header line or a corrupt clock anchor raises a clean error naming
  the file, never a KeyError mid-merge;
- **convergence health**: per-segment message residual and
  assignment-flip-rate, computed at segment boundaries only, landing
  in the gauges, the SSE payload and the result metrics.
"""

import glob
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation
from pydcop_tpu_torch.observability.flight import (
    FlightRecorder,
    ring_size_from_env,
    set_journal_provider,
)
from pydcop_tpu_torch.observability.metrics import MetricsRegistry
from pydcop_tpu_torch.observability.trace import (
    HEADER_KEY,
    TraceFileError,
    Tracer,
    event_matches_request,
    load_events_aligned,
    load_trace_file,
    merge_traces,
    query_request,
    tracer,
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


def _instance(n: int, seed: int) -> DCOP:
    """Ring coloring with seeded random tables (the serving battery
    fixture): carries an agent so it survives yaml round-trips."""
    rng = np.random.default_rng(seed)
    dom = Domain("c", "", [0, 1, 2])
    dcop = DCOP(f"rt{n}_{seed}", objective="min")
    vs = [Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for k, (i, j) in enumerate(
            [(i, (i + 1) % n) for i in range(n)]):
        table = rng.integers(0, 10, size=(3, 3)).astype(float)
        dcop.add_constraint(
            NAryMatrixRelation([vs[i], vs[j]], table, f"c{k}"))
    dcop.add_agents([AgentDef("a0")])
    return dcop


def _service(**kw) -> SolveService:
    kw.setdefault("batch_window_s", 0.05)
    kw.setdefault("max_batch", 8)
    return SolveService(**kw, device="cpu")


@pytest.fixture
def flight_ring(tmp_path):
    """A fresh recorder attached to the PROCESS tracer (where the
    engine/serving call sites record), restored afterwards."""
    prev = tracer.flight
    recorder = FlightRecorder(events=512,
                              bundle_dir=str(tmp_path / "bundles"))
    tracer.set_flight(recorder)
    yield recorder
    tracer.set_flight(prev)


# ------------------------------------------------------------------ #
# trace context + retroactive spans


class TestTraceContext:
    def test_context_tags_everything_underneath(self):
        t = Tracer()
        t.enable()
        with t.context(trace_id="abc123"):
            with t.span("outer", "x"):
                t.instant("mark", "x")
        with t.span("after", "x"):
            pass
        by_name = {e["name"]: e for e in t.events()}
        assert by_name["outer"]["args"]["trace_id"] == "abc123"
        assert by_name["mark"]["args"]["trace_id"] == "abc123"
        assert "trace_id" not in by_name["after"]["args"], \
            "context leaked past its with-block"

    def test_nested_context_inner_shadows_outer(self):
        t = Tracer()
        t.enable()
        with t.context(trace_id="outer", color="blue"):
            with t.context(trace_id="inner"):
                t.instant("deep", "x")
            t.instant("shallow", "x")
        by_name = {e["name"]: e for e in t.events()}
        assert by_name["deep"]["args"]["trace_id"] == "inner"
        assert by_name["deep"]["args"]["color"] == "blue"
        assert by_name["shallow"]["args"]["trace_id"] == "outer"

    def test_explicit_args_win_over_context(self):
        t = Tracer()
        t.enable()
        with t.context(kind="ctx"):
            t.instant("ev", "x", kind="explicit")
        (ev,) = t.events()
        assert ev["args"]["kind"] == "explicit"

    def test_complete_records_retroactive_span(self):
        t = Tracer()
        t.enable()
        t0 = time.perf_counter()
        t1 = t0 + 0.25
        t.complete("queue_wait", "serving", t0=t0, t1=t1,
                   trace_id="q1")
        (ev,) = t.events()
        assert ev["ph"] == "X"
        assert ev["dur"] == pytest.approx(0.25e6, rel=1e-6)
        assert ev["args"]["trace_id"] == "q1"


# ------------------------------------------------------------------ #
# request query


class TestQueryRequest:
    def _span(self, name, ts, dur, tid=1, **args):
        return {"name": name, "cat": "x", "ph": "X", "ts": ts,
                "dur": dur, "tid": tid, "args": args}

    def _instant(self, name, ts, tid=1, **args):
        return {"name": name, "cat": "x", "ph": "i", "ts": ts,
                "tid": tid, "args": args}

    def test_matches_direct_and_batch_tags(self):
        assert event_matches_request(
            self._span("a", 0, 1, trace_id="t1"), "t1")
        assert event_matches_request(
            self._span("a", 0, 1, trace_ids=["t0", "t1"]), "t1")
        assert not event_matches_request(
            self._span("a", 0, 1, trace_id="t2"), "t1")
        assert not event_matches_request(self._span("a", 0, 1), "t1")

    def test_tree_nests_by_containment_and_filters(self):
        events = [
            self._span("dispatch", 0, 100, trace_ids=["t1"]),
            self._span("engine", 10, 50, trace_ids=["t1"]),
            self._instant("chunk", 20, trace_ids=["t1"]),
            self._span("other_request", 200, 10, trace_id="t2"),
        ]
        tree = query_request(events, "t1")
        assert tree["events"] == 3 and tree["spans"] == 2
        assert tree["well_nested"]
        assert tree["names"] == sorted(["dispatch", "engine",
                                        "chunk"])
        (root,) = tree["tree"]
        assert root["name"] == "dispatch"
        (child,) = root["children"]
        assert child["name"] == "engine"
        assert child["children"][0]["name"] == "chunk"

    def test_cross_lane_request_stitches_in_time_order(self):
        events = [
            self._span("submit", 0, 10, tid=1, trace_id="t1"),
            self._span("dispatch", 20, 30, tid=2,
                       trace_ids=["t1"]),
        ]
        tree = query_request(events, "t1")
        assert tree["lanes"] == 2
        assert [n["name"] for n in tree["tree"]] == ["submit",
                                                     "dispatch"]

    def test_unknown_trace_id_is_empty_not_error(self):
        tree = query_request([self._span("a", 0, 1, trace_id="x")],
                             "nope")
        assert tree["events"] == 0 and tree["tree"] == []


class TestServeRequestTracing:
    """End to end, in-process: one submit through the
    real service leaves a queryable causal chain."""

    def test_submit_to_engine_chain_is_one_tagged_tree(self):
        tracer.enable()
        svc = _service()
        svc.start()
        try:
            rid = svc.submit(_instance(8, 3), params=PARAMS)
            result = svc.result(rid, wait=60.0)
            assert result is not None
            tid = result["trace_id"]
            assert tid and tid == svc.trace_id(rid)
            events = tracer.events()
        finally:
            svc.stop(drain=False)
            tracer.disable()
        tree = query_request(events, tid)
        assert tree["well_nested"], "request tree not well nested"
        names = set(tree["names"])
        assert {"serve_submit", "serve_queued", "serve_dispatch",
                "engine_segment"} <= names, names

        def _flat(nodes):
            for node in nodes:
                yield node
                yield from _flat(node["children"])

        for node in _flat(tree["tree"]):
            args = node["args"]
            assert (args.get("trace_id") == tid
                    or tid in (args.get("trace_ids") or [])), \
                f"{node['name']} span missing the request tag"

    def test_trace_query_cli_reconstructs_request(self, tmp_path,
                                                  capsys):
        from pydcop_tpu_torch.dcop_cli import main as cli_main

        tracer.enable()
        svc = _service()
        svc.start()
        try:
            rid = svc.submit(_instance(8, 4), params=PARAMS)
            result = svc.result(rid, wait=60.0)
            tid = result["trace_id"]
        finally:
            svc.stop(drain=False)
            path = str(tmp_path / "serve.jsonl")
            tracer.export_jsonl(path)
            tracer.disable()
        rc = cli_main(["trace", "query", "--request", tid,
                       "--json", path])
        assert rc == 0
        tree = json.loads(capsys.readouterr().out)
        assert tree["trace_id"] == tid and tree["well_nested"]
        assert "engine_segment" in tree["names"]
        # Unknown id: empty result, exit 1, not a crash.
        rc = cli_main(["trace", "query", "--request", "feedbeef",
                       "--json", path])
        assert rc == 1


# ------------------------------------------------------------------ #
# latency exemplars


class TestExemplars:
    def test_native_bucket_remembers_last_trace_id(self):
        reg = MetricsRegistry()
        h = reg.histogram("lat", "x", buckets=(0.1, 1.0, 10.0))
        h.observe(0.05, exemplar="early")
        h.observe(0.07, exemplar="late")  # same bucket: last wins
        h.observe(5.0, exemplar="slow")
        h.observe(0.5)                    # no exemplar: cell kept
        snap = h.snapshot()[0]["exemplars"]
        assert snap["0.1"]["trace_id"] == "late"
        assert snap["10"]["trace_id"] == "slow"
        assert "1" not in snap

    def test_openmetrics_counter_family_drops_total_suffix(self):
        """OpenMetrics forbids ``_total`` in a counter FAMILY name
        (it is the reserved sample suffix): family ``x`` exposes
        sample ``x_total``.  The classic dialect keeps the full name
        in both places."""
        reg = MetricsRegistry()
        reg.counter("req_total", "x").inc()
        om = reg.to_prometheus(openmetrics=True)
        assert "# TYPE req counter" in om
        assert "# HELP req x" in om
        assert "\nreq_total 1" in om
        classic = reg.to_prometheus()
        assert "# TYPE req_total counter" in classic

    def test_classic_text_format_stays_exemplar_free(self):
        """The v0.0.4 parser errors on exemplar suffixes (failing the
        whole scrape), so the classic dialect must never carry
        them."""
        reg = MetricsRegistry()
        h = reg.histogram("lat", "x", buckets=(0.1, 1.0))
        h.observe(0.05, exemplar="abc123")
        classic = reg.to_prometheus()
        assert " # {" not in classic
        assert "# EOF" not in classic

    def test_openmetrics_exposition_suffix(self):
        reg = MetricsRegistry()
        h = reg.histogram("lat", "x", buckets=(0.1, 1.0))
        h.observe(0.05, exemplar="abc123")
        text = reg.to_prometheus(openmetrics=True)
        assert text.rstrip().endswith("# EOF")
        bucket_lines = [ln for ln in text.splitlines()
                        if ln.startswith("lat_bucket")]
        tagged = [ln for ln in bucket_lines
                  if '# {trace_id="abc123"}' in ln]
        assert len(tagged) == 1, (
            "exactly the native bucket carries the exemplar: "
            f"{bucket_lines}")
        assert 'le="0.1"' in tagged[0]
        # The suffix parses as: value # {labels} ex_value ex_ts
        head, _, tail = tagged[0].partition(" # ")
        float(head.rsplit(" ", 1)[1])
        ex_value, ex_ts = tail.split("} ")[1].split(" ")
        assert float(ex_value) == pytest.approx(0.05)
        assert float(ex_ts) > 0

    def test_quantile_exemplar_finds_p99_bucket(self):
        reg = MetricsRegistry()
        h = reg.histogram("lat", "x", buckets=(0.1, 1.0, 10.0))
        for i in range(50):
            h.observe(0.05, exemplar=f"fast{i}")
        for i in range(5):  # ~9% slow: the p99 rank lands here
            h.observe(5.0, exemplar=f"slow{i}")
        p99 = h.quantile_exemplar(0.99)
        assert p99["trace_id"] == "slow4"
        assert p99["le"] == "10"
        p50 = h.quantile_exemplar(0.50)
        assert p50["trace_id"] == "fast49"

    def test_quantile_falls_back_to_nearest_holding_bucket(self):
        reg = MetricsRegistry()
        h = reg.histogram("lat", "x", buckets=(0.1, 1.0, 10.0))
        for _ in range(99):
            h.observe(0.05)           # no exemplars in p99's bucket
        h.observe(0.07, exemplar="only_tag")
        assert h.quantile_exemplar(0.99)["trace_id"] == "only_tag"

    def test_no_observations_is_none(self):
        reg = MetricsRegistry()
        h = reg.histogram("lat", "x", buckets=(1.0,))
        assert h.quantile_exemplar(0.99) is None
        h.observe(0.5)  # observed, but never with an exemplar
        assert h.quantile_exemplar(0.99) is None

    def test_metrics_endpoint_negotiates_openmetrics(self):
        from pydcop_tpu_torch.observability.metrics import registry
        from pydcop_tpu_torch.observability.server import TelemetryServer

        registry.histogram(
            "neg_test_seconds", "x",
            buckets=(1.0,)).observe(0.5, exemplar="negotiate1")
        server = TelemetryServer(port=0).start()
        try:
            req = urllib.request.Request(
                server.url + "/metrics",
                headers={"Accept": "application/openmetrics-text"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                assert "openmetrics-text" in \
                    resp.headers["Content-Type"]
                om = resp.read().decode()
            assert 'negotiate1' in om
            assert om.rstrip().endswith("# EOF")
            with urllib.request.urlopen(server.url + "/metrics",
                                        timeout=10) as resp:
                assert resp.headers["Content-Type"].startswith(
                    "text/plain")
                classic = resp.read().decode()
            assert " # {" not in classic, \
                "classic scrape must stay v0.0.4-parsable"
        finally:
            server.stop()

    def test_service_stats_expose_resolvable_exemplars(self):
        tracer.enable()
        svc = _service()
        svc.start()
        try:
            rid = svc.submit(_instance(8, 5), params=PARAMS)
            result = svc.result(rid, wait=60.0)
            tid = result["trace_id"]
            stats = svc.stats()
            events = tracer.events()
        finally:
            svc.stop(drain=False)
            tracer.disable()
        # The quantile face is populated (the histogram is process-
        # global, so WHICH request owns the p99 bucket depends on
        # suite history — serve_smoke asserts p99 ownership in a
        # fresh process).
        p99 = stats["latency_exemplars"]["p99"]
        assert p99 is not None and p99["trace_id"]
        # This request's observation left its exemplar in its native
        # bucket, one hop from the trace that resolves it.
        from pydcop_tpu_torch.observability.metrics import registry
        hist = registry.histogram("pydcop_request_latency_seconds")
        snap = hist.snapshot()[0]["exemplars"]
        assert any(cell["trace_id"] == tid for cell in snap.values())
        tree = query_request(events, tid)
        assert tree["events"] > 0 and "engine_segment" in tree["names"]


# ------------------------------------------------------------------ #
# flight recorder + postmortem bundles


class TestFlightRecorder:
    def test_ring_records_while_file_tracing_off(self, tmp_path):
        t = Tracer()
        recorder = FlightRecorder(events=8,
                                  bundle_dir=str(tmp_path))
        t.set_flight(recorder)
        assert t.active and not t.enabled
        for i in range(20):
            t.instant("tick", "x", i=i)
        assert t.events() == [], \
            "disabled session tracer must not buffer"
        ring = recorder.snapshot()
        assert len(ring) == 8, "ring not bounded at its capacity"
        assert [e["args"]["i"] for e in ring] == list(range(12, 20))

    def test_flight_only_threads_do_not_accumulate_buffers(self):
        """Regression: with the always-on ring attached and file
        tracing OFF (the production serve default, one HTTP handler
        thread per request), short-lived threads must not leave
        permanent registrations in the tracer — that is an unbounded
        leak under sustained traffic."""
        t = Tracer()
        t.set_flight(FlightRecorder(events=64))

        def worker(i):
            t.instant("req", "x", i=i)

        for i in range(50):
            th = threading.Thread(target=worker, args=(i,))
            th.start()
            th.join()
        assert len(t._buffers) == 0, \
            f"{len(t._buffers)} flight-only threads leaked"
        assert len(t.flight.snapshot()) == 50
        # A session started afterwards still registers lanes.
        t.enable()
        t.instant("session", "x")
        assert len(t._buffers) == 1
        assert t.events()[0]["name"] == "session"

    def test_snapshot_safe_under_concurrent_appends(self, tmp_path):
        """A bundle cut while other threads record must never lose
        the event tail to 'deque mutated during iteration' — the
        anomaly fires exactly when the process is busiest."""
        recorder = FlightRecorder(events=256,
                                  bundle_dir=str(tmp_path))
        stop = threading.Event()

        def hammer():
            i = 0
            while not stop.is_set():
                recorder.record({"name": "ev", "args": {"i": i}})
                i += 1

        threads = [threading.Thread(target=hammer)
                   for _ in range(4)]
        for th in threads:
            th.start()
        try:
            for _ in range(200):
                snap = recorder.snapshot()
                assert len(snap) <= 256
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=10)

    def test_bundle_retention_keeps_last_n(self, tmp_path):
        recorder = FlightRecorder(events=8,
                                  bundle_dir=str(tmp_path), keep=3)
        paths = [recorder.bundle("kind_a") for _ in range(5)]
        left = sorted(glob.glob(str(tmp_path / "bundle_*.json")))
        assert len(left) == 3
        assert set(left) == set(paths[-3:]), \
            "retention must evict oldest-first"

    def test_detached_recorder_restores_zero_overhead_gate(self):
        t = Tracer()
        t.set_flight(FlightRecorder(events=4))
        t.set_flight(None)
        assert not t.active
        t.instant("dropped", "x")
        assert t.events() == []

    def test_trigger_bundle_tail_contains_anomaly_instant(
            self, flight_ring):
        tracer.instant("before", "x", n=1)
        path = flight_ring.trigger("guard_trip", kind_detail="nan",
                                   cycle=14)
        assert path and os.path.exists(path)
        doc = json.load(open(path, encoding="utf-8"))
        assert doc["kind"] == "guard_trip"
        tail = doc["events"]
        assert tail[-1]["name"] == "anomaly"
        assert tail[-1]["args"]["kind"] == "guard_trip"
        assert any(e["name"] == "before" for e in tail), \
            "pre-anomaly context missing from the ring tail"
        # Diagnostics sections all present.
        for section in ("metrics", "healthz", "env",
                        "probe_diagnostics"):
            assert section in doc, f"bundle missing {section}"
        assert doc["pid"] == os.getpid()

    def test_trigger_storm_rate_limited_but_force_wins(
            self, flight_ring):
        first = flight_ring.trigger("guard_trip")
        second = flight_ring.trigger("guard_trip")
        assert first is not None and second is None
        assert flight_ring.suppressed == 1
        forced = flight_ring.trigger("recovery_exhausted",
                                     force=True)
        assert forced is not None and forced != first

    def test_journal_provider_folds_into_bundle(self, flight_ring):
        set_journal_provider(
            lambda: {"pending_replayable": 3, "journal_bytes": 512})
        try:
            doc = flight_ring.make_bundle("on_demand")
        finally:
            set_journal_provider(None)
        assert doc["journal"]["pending_replayable"] == 3
        assert "journal" not in flight_ring.make_bundle("on_demand")

    def test_provider_clear_is_identity_guarded(self, flight_ring):
        """A stopping service must not strip a sibling's journal
        registration from future bundles."""
        from pydcop_tpu_torch.observability.flight import (
            clear_journal_provider,
        )

        def service_a():
            return {"pending_replayable": 1}

        def service_b():
            return {"pending_replayable": 2}

        set_journal_provider(service_a)
        try:
            set_journal_provider(service_b)  # B takes over
            clear_journal_provider(service_a)  # A stops late
            doc = flight_ring.make_bundle("on_demand")
            assert doc["journal"]["pending_replayable"] == 2, \
                "A's late clear wiped B's registration"
            clear_journal_provider(service_b)
            assert "journal" not in flight_ring.make_bundle(
                "on_demand")
        finally:
            set_journal_provider(None)

    def test_sibling_service_stop_keeps_survivor_provider(
            self, flight_ring, tmp_path):
        """The SolveService wiring end-to-end: stop a second
        journaled service while the first still runs — the first's
        backlog still reaches bundles."""
        a = _service(journal_dir=str(tmp_path / "a")).start()
        b = _service(journal_dir=str(tmp_path / "b")).start()
        try:
            b.stop(drain=False)
            # B registered last (last-writer-wins) and cleared its
            # own registration on stop: no stale provider remains.
            doc = flight_ring.make_bundle("on_demand")
            assert doc.get("journal", {}).get("dir") != str(
                tmp_path / "b"), "stopped service left its provider"
        finally:
            a.stop(drain=False)

    @pytest.mark.parametrize("value,expect", [
        ("0", None), ("off", None), ("false", None), ("no", None),
        ("none", None), ("disabled", None), ("-3", None),
        ("1", 2048), ("garbage", 2048),
        ("4096", 4096),
    ])
    def test_ring_size_env_parsing(self, value, expect):
        assert ring_size_from_env(value) == expect


class TestAnomalyPostmortem:
    """The anomaly acceptance, battery form: injected
    failures produce bundles on disk whose tail holds the trigger."""

    def test_guard_trip_dumps_bundle_with_trigger_in_tail(
            self, flight_ring):
        from pydcop_tpu_torch.algorithms.maxsum import build_engine
        from pydcop_tpu_torch.resilience.recovery import RecoveryPolicy

        assert not tracer.enabled, \
            "this scenario proves the black box works with file " \
            "tracing OFF"
        dcop = _instance(8, 6)
        res = build_engine(dcop, {}, device="cpu").run_checkpointed(
            max_cycles=120, segment_cycles=7,
            recovery=RecoveryPolicy(trip_cycles=(14,),
                                    noise_seed=1))
        assert res.metrics["guard_trips"] == 1
        bundles = glob.glob(os.path.join(
            flight_ring.bundle_dir, "bundle_guard_trip_*.json"))
        assert len(bundles) == 1, bundles
        doc = json.load(open(bundles[0], encoding="utf-8"))
        anomalies = [e for e in doc["events"]
                     if e["name"] == "anomaly"]
        assert anomalies, "triggering instant missing from tail"
        assert anomalies[-1]["args"]["kind"] == "guard_trip"
        assert anomalies[-1]["args"]["cycle"] == 14
        # The ring held engine context from BEFORE the anomaly even
        # though no trace file was open.
        assert any(e["name"] == "engine_segment"
                   for e in doc["events"]), \
            "pre-anomaly engine spans missing from the black box"

    def test_poison_bin_isolation_dumps_bundle(self, flight_ring):
        svc = _service(batch_window_s=0.2)
        svc.start()
        real = svc._run_batch
        poison = set()

        def poisoned(reqs, params):
            if any(r.id in poison for r in reqs):
                raise RuntimeError("poison")
            return real(reqs, params)

        svc._run_batch = poisoned
        try:
            rids = [svc.submit(_instance(8, 10 + i), params=PARAMS)
                    for i in range(4)]
            poison.add(rids[1])
            for rid in rids:
                assert svc.result(rid, wait=60.0) is not None
        finally:
            svc.stop(drain=False)
        bundles = glob.glob(os.path.join(
            flight_ring.bundle_dir, "bundle_poison_bin_*.json"))
        assert bundles, "poison-bin isolation cut no bundle"
        doc = json.load(open(bundles[0], encoding="utf-8"))
        trigger = [e for e in doc["events"]
                   if e["name"] == "anomaly"
                   and e["args"]["kind"] == "poison_bin"]
        assert trigger, "poison_bin instant missing from tail"
        assert trigger[-1]["args"]["request"] == rids[1]
        assert trigger[-1]["args"]["retry_depth"] > 0


class TestDebugBundleCommand:
    def test_cli_cuts_local_bundle(self, flight_ring, tmp_path,
                                    capsys):
        from pydcop_tpu_torch.dcop_cli import main as cli_main

        out = str(tmp_path / "ondemand.json")
        rc = cli_main(["debug", "bundle", "--out", out])
        assert rc == 0
        doc = json.load(open(out, encoding="utf-8"))
        assert doc["kind"] == "on_demand"
        assert doc["info"]["via"] == "cli"
        assert out in capsys.readouterr().out

    def test_http_debug_bundle_roundtrip(self, flight_ring,
                                          tmp_path, capsys):
        from pydcop_tpu_torch.dcop_cli import main as cli_main
        from pydcop_tpu_torch.observability.server import TelemetryServer

        server = TelemetryServer(port=0).start()
        try:
            tracer.instant("served", "x")
            with urllib.request.urlopen(
                    server.url + "/debug/bundle", timeout=10) as r:
                doc = json.loads(r.read())
            assert doc["kind"] == "on_demand"
            assert doc["info"]["via"] == "http"
            assert os.path.exists(doc["path"])
            out = str(tmp_path / "remote.json")
            rc = cli_main(["debug", "bundle", "--url", server.url,
                           "--out", out])
            assert rc == 0
            saved = json.load(open(out, encoding="utf-8"))
            assert saved["pid"] == os.getpid()
        finally:
            server.stop()

    def test_http_503_when_recorder_detached(self):
        from pydcop_tpu_torch.observability.server import TelemetryServer

        prev = tracer.flight
        tracer.set_flight(None)
        server = TelemetryServer(port=0).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(
                    server.url + "/debug/bundle", timeout=10)
            assert err.value.code == 503
        finally:
            server.stop()
            tracer.set_flight(prev)


# ------------------------------------------------------------------ #
# serve-plane SSE lifecycle


class TestServeSSELifecycle:
    def test_client_sees_full_lifecycle_in_order(self):
        from pydcop_tpu_torch.serving.http import ServeFrontEnd

        svc = _service(batch_window_s=0.2)
        svc.start()
        front = ServeFrontEnd(svc, port=0).start()
        seen = []
        connected = threading.Event()
        done = threading.Event()

        def listen():
            req = urllib.request.Request(front.url + "/events")
            with urllib.request.urlopen(req, timeout=30) as resp:
                connected.set()
                for raw in resp:
                    line = raw.decode().strip()
                    if not line.startswith("data: "):
                        continue
                    event = json.loads(line[len("data: "):])
                    if event.get("event") == "request":
                        seen.append(event)
                        if event["phase"] in ("finished", "error"):
                            return

        listener = threading.Thread(target=listen, daemon=True)
        listener.start()
        assert connected.wait(10), "SSE stream never connected"
        try:
            body = json.dumps({
                "dcop": __import__(
                    "pydcop_tpu_torch.dcop.yamldcop",
                    fromlist=["dcop_yaml"]).dcop_yaml(
                        _instance(8, 7)),
                "wait": True, "timeout": 60, "params": PARAMS,
            }).encode()
            req = urllib.request.Request(
                front.url + "/solve", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                result = json.loads(resp.read())
            assert result["status"] == "FINISHED"
            listener.join(timeout=30)
            assert not listener.is_alive(), \
                "lifecycle stream never delivered a terminal phase"
        finally:
            done.set()
            front.stop()
            svc.stop(drain=False)
        phases = [e["phase"] for e in seen
                  if e["trace_id"] == result["trace_id"]]
        assert phases == ["accepted", "dispatched", "finished"], \
            f"lifecycle out of order: {phases} (all: {seen})"
        assert all(e["id"] == result["id"] for e in seen
                   if e["trace_id"] == result["trace_id"])


# ------------------------------------------------------------------ #
# /healthz journal backlog


class TestHealthzJournalBacklog:
    def test_journaled_service_reports_replay_debt(self, tmp_path):
        svc = _service(journal_dir=str(tmp_path / "jnl"))
        svc.start()
        try:
            health = svc.health_summary()
            assert health["journal"]["active"]
            assert health["journal"]["pending_replayable"] == 0
            rid = svc.submit(_instance(8, 8), params=PARAMS)
            assert svc.result(rid, wait=60.0) is not None
            health = svc.health_summary()
            assert health["journal"]["pending_replayable"] == 0
            assert health["journal"]["journal_bytes"] > 0, \
                "accepted+completed records must show on-disk size"
        finally:
            svc.stop(drain=False)

    def test_pending_request_counts_as_replayable(self, tmp_path):
        svc = _service(journal_dir=str(tmp_path / "jnl"),
                       batch_window_s=5.0)  # park it in the queue
        svc.start()
        try:
            svc.submit(_instance(8, 9), params=PARAMS)
            assert svc.health_summary()["journal"][
                "pending_replayable"] == 1
        finally:
            svc.stop(drain=False)

    def test_journalless_service_has_no_journal_field(self):
        svc = _service()
        svc.start()
        try:
            assert "journal" not in svc.health_summary()
        finally:
            svc.stop(drain=False)

    def test_http_healthz_carries_backlog(self, tmp_path):
        from pydcop_tpu_torch.serving.http import ServeFrontEnd

        svc = _service(journal_dir=str(tmp_path / "jnl"))
        svc.start()
        front = ServeFrontEnd(svc, port=0).start()
        try:
            with urllib.request.urlopen(front.url + "/healthz",
                                        timeout=10) as resp:
                health = json.loads(resp.read())
            journal = health["journal"]
            assert journal["pending_replayable"] == 0
            assert "journal_bytes" in journal
            assert health["serving"]["breaker_state"] == "closed"
            assert health["status"] == "ok"
        finally:
            front.stop()
            svc.stop(drain=False)


# ------------------------------------------------------------------ #
# TraceFileError regressions (satellite: clean errors, not KeyError)


class TestTraceFileErrors:
    def _good_trace(self, path, anchor=1000.0):
        rows = [
            {HEADER_KEY: {"anchor_unix_us": anchor,
                          "anchor_perf_us": 10.0,
                          "host": "h", "pid": 1}},
            {"name": "s", "cat": "x", "ph": "X", "ts": 20.0,
             "dur": 5.0, "id": 1, "parent": 0, "tid": 1,
             "args": {}},
        ]
        with open(path, "w", encoding="utf-8") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        return path

    def test_truncated_header_line_names_the_file(self, tmp_path):
        path = str(tmp_path / "torn.jsonl")
        with open(path, "w", encoding="utf-8") as f:
            f.write('{"%s": {"anchor_unix_us": 123' % HEADER_KEY)
        with pytest.raises(TraceFileError) as err:
            load_trace_file(path)
        assert "torn.jsonl" in str(err.value)
        assert "header" in str(err.value)

    def test_non_object_header_is_clean_error(self, tmp_path):
        path = str(tmp_path / "bad_header.jsonl")
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps({HEADER_KEY: 42}) + "\n")
        with pytest.raises(TraceFileError) as err:
            load_trace_file(path)
        assert "bad_header.jsonl" in str(err.value)

    def test_corrupt_anchor_fails_merge_cleanly(self, tmp_path):
        good = self._good_trace(str(tmp_path / "good.jsonl"))
        bad = str(tmp_path / "bad_anchor.jsonl")
        with open(bad, "w", encoding="utf-8") as f:
            f.write(json.dumps(
                {HEADER_KEY: {"anchor_unix_us": "garbage",
                              "anchor_perf_us": 10.0}}) + "\n")
            f.write(json.dumps(
                {"name": "s", "cat": "x", "ph": "X", "ts": 1.0,
                 "dur": 1.0, "id": 1, "parent": 0, "tid": 1,
                 "args": {}}) + "\n")
        out = str(tmp_path / "merged.json")
        with pytest.raises(TraceFileError) as err:
            merge_traces([good, bad], out)
        assert "bad_anchor.jsonl" in str(err.value)
        assert "anchor" in str(err.value)
        with pytest.raises(TraceFileError):
            load_events_aligned([good, bad])

    def test_nonfinite_anchor_is_corrupt_not_legacy(self, tmp_path):
        bad = self._good_trace(str(tmp_path / "nan.jsonl"),
                               anchor=float("nan"))
        good = self._good_trace(str(tmp_path / "good.jsonl"))
        with pytest.raises(TraceFileError) as err:
            merge_traces([good, bad], str(tmp_path / "out.json"))
        assert "nan.jsonl" in str(err.value)

    def test_headerless_file_still_loads_degraded(self, tmp_path):
        """An older trace (no header at all) is legacy, not
        corrupt: loading degrades instead of raising."""
        path = str(tmp_path / "legacy.jsonl")
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps(
                {"name": "s", "cat": "x", "ph": "X", "ts": 5.0,
                 "dur": 1.0, "id": 1, "parent": 0, "tid": 1,
                 "args": {}}) + "\n")
        assert len(load_trace_file(path)) == 1
        good = self._good_trace(str(tmp_path / "good.jsonl"))
        events = load_events_aligned([good, path])
        assert len(events) == 2


# ------------------------------------------------------------------ #
# convergence-health telemetry


class TestConvergenceHealth:
    def test_probe_collects_residual_and_flip_rate(self):
        from pydcop_tpu_torch.algorithms.maxsum import build_engine
        from pydcop_tpu_torch.observability.engine_probe import EngineProbe

        engine = build_engine(_instance(8, 11), {}, device="cpu")
        reg = MetricsRegistry()
        probe = EngineProbe(engine, registry=reg)
        sse_events = []
        probe.snapshotter.add_listener(sse_events.append)
        res = engine.run_checkpointed(
            max_cycles=60, segment_cycles=10, probe=probe,
            stop_on_convergence=False)
        assert len(probe.convergence) == res.metrics["segments"]
        first_cycle, first_res, first_flips = probe.convergence[0]
        assert first_res is None and first_flips is None, \
            "first segment has no previous segment to diff against"
        curve = probe.convergence_curve()
        assert curve, "no convergence points after segment 1"
        for cycle, residual, flips in curve:
            assert residual >= 0.0 and 0.0 <= flips <= 1.0
        # Damped max-sum settles: the last flip rate must be 0 once
        # the run has converged to a fixpoint-stable assignment.
        assert curve[-1][2] == 0.0
        # Gauges carry the latest values.
        assert reg.value("pydcop_msg_residual") == pytest.approx(
            curve[-1][1])
        assert reg.value("pydcop_flip_rate") == pytest.approx(
            curve[-1][2])
        # The SSE payload (per-chunk snapshot events) carries them.
        tagged = [e for e in sse_events if "residual" in e]
        assert tagged and all("flip_rate" in e for e in tagged)

    def test_solve_result_carries_convergence_curve(self, tmp_path):
        from pydcop_tpu_torch.api import solve

        res = solve(_instance(6, 12), "maxsum", max_cycles=60,
                    metrics_file=str(tmp_path / "m.jsonl"),
                    metrics_every=10, device="cpu")
        curve = res["metrics"]["convergence_curve"]
        assert curve and all(len(point) == 3 for point in curve)
