"""The port's observability modules (pydcop_tpu_torch/observability,
utils/cleanenv.py) against the reference's, on the CPU.

The pure-Python modules are the reference's own code under the port's
package name, so the reference battery's cases
(tests/unit/test_observability_battery.py, the solve-side cases of
test_efficiency_battery.py) run here against BOTH packages, and where
an output is a document (Prometheus text, JSONL snapshot rows, trace
files, the efficiency rollup) the two packages' documents for the same
calls are held equal.  The agent-runtime cases (event bus, stats shim,
websocket UI, message sites) wait for the agent runtime.

The torch-side pieces: the profiler's explicit unavailable marker on
the CPU (with its ``source``), the engine probe on a segmented run
(curve, one host transfer per boundary), the efficiency backend label
taken from the tensors' device, and the CUDA liveness probe, which on
a machine without a card records its failure and raises (no CPU
fallback).
"""

import importlib
import json
import re
import threading

import pytest
import torch

PACKAGES = ["pydcop_tpu", "pydcop_tpu_torch"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _tracers_off():
    """Every test starts and ends with both process tracers off."""
    tracers = [mod(p, "observability.trace").tracer for p in PACKAGES]
    for t in tracers:
        t.disable()
        t.clear()
    yield
    for t in tracers:
        t.disable()
        t.clear()


_PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\")*\})?"
    r" (-?[0-9.e+-]+|\+Inf)"
    r"( # \{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\"\}"
    r" -?[0-9.e+-]+( [0-9.]+)?)?$"
)


# ------------------------------------------------------------------ #
# tracer


@pytest.mark.parametrize("pkg", PACKAGES)
def test_span_nesting_and_parent_ids(pkg):
    t = mod(pkg, "observability.trace").Tracer()
    t.enable()
    with t.span("outer", "test", a=1):
        with t.span("inner", "test"):
            t.instant("point", "test", b=2)
    events = t.events()
    assert [e["name"] for e in events] == ["outer", "inner", "point"]
    outer, inner, point = events
    assert outer["parent"] == 0
    assert inner["parent"] == outer["id"]
    assert point["parent"] == inner["id"]
    assert inner["dur"] <= outer["dur"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_export_chrome_and_jsonl_load_and_nest(pkg, tmp_path):
    tr = mod(pkg, "observability.trace")
    t = tr.Tracer()
    t.enable()
    with t.span("a", "test"):
        with t.span("b", "test"):
            pass
        t.instant("x", "test", k="v")
    chrome, jsonl = str(tmp_path / "t.json"), str(tmp_path / "t.jsonl")
    t.export_chrome(chrome)
    t.export_jsonl(jsonl)
    data = json.load(open(chrome, encoding="utf-8"))
    assert {"a", "b", "x", "thread_name"} <= {
        e["name"] for e in data["traceEvents"]}
    events = tr.load_trace_file(chrome)
    tr.check_well_nested(events)
    rows = [json.loads(line) for line in open(jsonl)]
    assert "pydcop_trace_header" in rows[0]
    assert sorted(r["name"] for r in rows[1:]) == ["a", "b", "x"]


@pytest.mark.parametrize("writer", PACKAGES)
@pytest.mark.parametrize("reader", PACKAGES)
def test_each_package_reads_the_others_traces(writer, reader, tmp_path):
    """One reader serves both packages: a trace written by either
    loads, nests and summarises identically with either."""
    w = mod(writer, "observability.trace")
    r = mod(reader, "observability.trace")
    t = w.Tracer()
    t.enable()
    for i in range(3):
        with t.span("engine_segment", "engine", segment=i):
            with t.span("engine_call", "engine"):
                pass
        t.instant("chunk", "engine", cycle=10 * i)
    for fmt in ("chrome", "jsonl"):
        path = str(tmp_path / f"t.{fmt}")
        t.export(path, fmt)
        events = r.load_trace_file(path)
        r.check_well_nested(events)
        rows = r.summarize_spans(events)
        assert rows == w.summarize_spans(w.load_trace_file(path))
        assert {row["name"]: row["count"] for row in rows} == {
            "engine_segment": 3, "engine_call": 3, "chunk": 3}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_multithreaded_buffers(pkg):
    t = mod(pkg, "observability.trace").Tracer()
    t.enable()

    def work(i):
        for _ in range(50):
            t.instant(f"ev{i}", "test")

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    events = t.events()
    assert len(events) == 200
    assert len({e["tid"] for e in events}) == 4


@pytest.mark.parametrize("pkg", PACKAGES)
def test_check_well_nested_rejects_overlap(pkg):
    tr = mod(pkg, "observability.trace")
    events = [
        {"ph": "X", "name": "a", "ts": 0.0, "dur": 100.0, "tid": 1},
        {"ph": "X", "name": "b", "ts": 50.0, "dur": 100.0, "tid": 1},
    ]
    with pytest.raises(ValueError, match="overlaps"):
        tr.check_well_nested(events)


def test_summarize_merge_and_diff_equal_the_reference(tmp_path):
    """summarize_spans, merge_traces and diff_trace_summaries give the
    same documents in both packages on the same files."""
    ref = mod("pydcop_tpu", "observability.trace")
    port = mod("pydcop_tpu_torch", "observability.trace")
    paths = []
    for i in range(2):
        t = ref.Tracer()
        t.enable()
        for k in range(2 + i):
            with t.span("engine_segment", "engine", segment=k):
                pass
        path = str(tmp_path / f"p{i}.json")
        t.export(path, "chrome")
        paths.append(path)
    a, b = (ref.load_trace_file(p) for p in paths)
    assert port.summarize_spans(a) == ref.summarize_spans(a)
    assert port.diff_trace_summaries(a, b) == ref.diff_trace_summaries(a, b)
    out_p, out_r = str(tmp_path / "mp.json"), str(tmp_path / "mr.json")
    port.merge_traces(paths, out_p)
    ref.merge_traces(paths, out_r)
    ev_p = port.load_trace_file(out_p)
    ev_r = ref.load_trace_file(out_r)
    assert [(e["name"], e["ph"], e["tid"]) for e in ev_p] == \
        [(e["name"], e["ph"], e["tid"]) for e in ev_r]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_disabled_tracing_is_one_flag_check(pkg):
    tr = mod(pkg, "observability.trace")
    saved = tr.tracer.flight
    tr.tracer.set_flight(None)
    try:
        spans = {id(tr.tracer.span(f"s{i}", "t")) for i in range(50)}
        assert spans == {id(tr.NOOP_SPAN)}
        tr.tracer.instant("x", "t")
        assert tr.tracer.events() == []
    finally:
        tr.tracer.set_flight(saved)


# ------------------------------------------------------------------ #
# metrics registry


def _exercise(reg):
    reg.counter("msgs_total", "Messages").inc(
        3, type="value", direction="in")
    reg.gauge("depth", "Queue depth").set(7, agent="a1")
    h = reg.histogram("lat_seconds", "Latency", buckets=(0.1, 1.0))
    h.observe(0.05, op="send")
    h.observe(3.0, op="send")
    return reg


def test_prometheus_text_equals_the_reference():
    ref = _exercise(mod("pydcop_tpu", "observability.metrics")
                    .MetricsRegistry()).to_prometheus()
    port = _exercise(mod("pydcop_tpu_torch", "observability.metrics")
                     .MetricsRegistry()).to_prometheus()
    assert port == ref
    families = set()
    for line in port.strip().splitlines():
        if line.startswith("# HELP "):
            families.add(line.split()[2])
        elif not line.startswith("# TYPE "):
            assert _PROM_SAMPLE.match(line), line
    assert {"msgs_total", "depth", "lat_seconds"} <= families


@pytest.mark.parametrize("pkg", PACKAGES)
def test_registry_semantics(pkg):
    m = mod(pkg, "observability.metrics")
    reg = m.MetricsRegistry()
    c = reg.counter("c_total", "help")
    c.inc()
    c.inc(2.5, kind="x")
    assert c.value() == 1 and c.value(kind="x") == 2.5
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1)
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("c_total", "")
    assert reg.counter("c_total", "") is c
    g = reg.gauge("g", "")
    bound = g.bind(agent="a1")
    bound.set(3.0)
    bound.inc(1.0)
    assert g.value(agent="a1") == 4.0


def test_snapshot_rows_equal_the_reference(tmp_path):
    rows = {}
    for pkg in PACKAGES:
        reg = _exercise(mod(pkg, "observability.metrics").MetricsRegistry())
        path = str(tmp_path / f"{pkg}.jsonl")
        reg.write_snapshot(path, cycle=10)
        reg.write_snapshot(path, cycle=20)
        rows[pkg] = [json.loads(line) for line in open(path)]
        for r in rows[pkg]:
            r.pop("ts")
    assert rows["pydcop_tpu_torch"] == rows["pydcop_tpu"]
    assert [r["cycle"] for r in rows["pydcop_tpu"]] == [10, 20]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cycle_snapshotter_cadence(pkg, tmp_path):
    m = mod(pkg, "observability.metrics")
    reg = m.MetricsRegistry()
    path = str(tmp_path / "m.jsonl")
    snap = m.CycleSnapshotter(path, every=5, reg=reg)
    for cycle in (2, 3, 1, 8, 8):
        snap(cycle)
    rows = [json.loads(line) for line in open(path)]
    assert [r["cycle"] for r in rows] == [2, 8]
    assert reg.value("pydcop_cycles_total") == 8
    assert reg.value("pydcop_cycle") == 8


# ------------------------------------------------------------------ #
# efficiency (solve-side)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_ledgers(pkg):
    e = mod(pkg, "observability.efficiency")
    ledger = e.make_ledger(1.0, submit=0.1, queue=0.2, plan=0.05,
                           prep=0.05, compile=0.3, execute=0.25,
                           decode=0.05)
    assert ledger["total_s"] == 1.0
    assert abs(e.ledger_component_sum(ledger) - 1.0) < 1e-9
    assert e.make_ledger(1.0, execute=0.4)["unaccounted_s"] == \
        pytest.approx(0.6)
    with pytest.raises(ValueError, match="unknown ledger"):
        e.make_ledger(1.0, warp=0.5)
    assert e.make_ledger(0.5, queue=-0.1, execute=0.5)["queue_s"] == 0.0
    assert e.split_device_time(0.8, 0.8) == {"compile": 0.8,
                                             "execute": 0.0}
    assert e.split_device_time(0.8, 0.0) == {"compile": 0.0,
                                             "execute": 0.8}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_attainment(pkg, monkeypatch):
    e = mod(pkg, "observability.efficiency")
    monkeypatch.setenv("PYDCOP_PEAK_FLOPS", "1e9")
    monkeypatch.setenv("PYDCOP_PEAK_BYTES_PER_S", "1e10")
    entry = {"available": True, "flops": 1e5, "bytes_accessed": 2e5}
    att = e.attainment_from_cost(entry, cycles=100, execute_s=0.1,
                                 backend="cpu")
    assert att["flop_attainment"] == pytest.approx(0.1)
    assert att["bandwidth_attainment"] == pytest.approx(0.02)
    assert att["attainment"] == pytest.approx(0.1)
    assert att["peak_source"] == "env"
    assert e.attainment_from_cost({"available": False}, 10, 0.1,
                                  "cpu") is None
    assert e.attainment_from_cost(entry, 0, 0.1, "cpu") is None


def _filled_tracker(e):
    tracker = e.EfficiencyTracker()
    tracker.enabled = True
    entry = {"available": True, "flops": 1e6, "bytes_accessed": 1e6}
    for backend, structure, execute in (
            ("cpu", "sA", 0.2), ("cpu", "sA", 0.2), ("cpu", "sB", 0.1)):
        tracker.record_dispatch(
            key="k", structure=structure, backend=backend,
            time_s=execute, compile_s=0.0, cycles=50, n_real=1,
            batch_size=1, cost_entry=entry)
    tracker.record_jit("k", True, 0.5)
    tracker.record_jit("k", False, 0.1)
    tracker.record_ledger(e.make_ledger(1.0, queue=0.4, execute=0.6),
                          backend="cpu")
    return tracker


def test_rollup_equals_the_reference():
    """The same records give the same rollup document in both packages
    (the backend identity block aside: it names each package's own
    resolution)."""
    docs = {}
    for pkg in PACKAGES:
        doc = _filled_tracker(mod(pkg, "observability.efficiency")).rollup()
        doc.pop("backend")
        docs[pkg] = doc
    assert docs["pydcop_tpu_torch"] == docs["pydcop_tpu"]
    roll = docs["pydcop_tpu_torch"]
    assert roll["structures"][0]["structure"] == "sA"
    assert roll["waste_by_cause"]["compile_s"] == pytest.approx(0.5)
    assert roll["jit"] == {"cold_dispatches": 1, "warm_dispatches": 1,
                           "cold_compile_s": 0.5}


def test_backend_label_comes_from_the_tensors_device():
    from pydcop_tpu_torch.api import solve
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file
    from pydcop_tpu_torch.observability import efficiency

    import os

    fixture = os.path.join(os.path.dirname(__file__), "instances",
                           "coloring_12_3.yml")
    solve(load_dcop_from_file(fixture), "maxsum", max_cycles=10,
          device="cpu")
    info = efficiency.resolved_backend()
    assert info["backend"] == "cpu"
    assert info["n_devices"] == torch.cuda.device_count()
    assert efficiency.BACKEND_PEAKS["cuda"] == (9.894e14, 3.35e12)


# ------------------------------------------------------------------ #
# profiler, engine probe


def test_profiler_marks_the_cpu_unavailable_with_its_source():
    from pydcop_tpu_torch.observability.profiler import DeviceCostProfiler

    prof = DeviceCostProfiler()
    calls = []
    entry = prof.capture(("segment", 10), lambda: calls.append(1),
                         torch.device("cpu"), 10)
    assert entry["available"] is False
    assert entry["source"] == "torch.profiler"
    assert "CPU" in entry["reason"]
    assert calls == []           # nothing is run on the CPU
    assert prof.get(("segment", 10)) is entry


def test_profiler_failure_folds_into_a_marker():
    from pydcop_tpu_torch.observability.profiler import DeviceCostProfiler

    entry = DeviceCostProfiler().capture(
        "k", lambda: None, "not-a-device", 1)
    assert entry["available"] is False and entry["reason"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_probe_without_files_collects_points(pkg):
    """The reference battery's case, against each package: one chunk
    per segment, non-negative seconds, the curve ending at the run's
    last cycle; the two packages' curves are equal."""
    from pydcop_tpu.dcop.yamldcop import load_dcop_from_file as jload
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file as tload

    import os

    fixture = os.path.join(os.path.dirname(__file__), "instances",
                           "coloring_12_3.yml")
    maxsum = mod(pkg, "algorithms.maxsum")
    probe_mod = mod(pkg, "observability.engine_probe")
    metrics = mod(pkg, "observability.metrics")
    if pkg == "pydcop_tpu":
        engine = maxsum.build_engine(jload(fixture), {})
    else:
        engine = maxsum.build_engine(tload(fixture), {}, device="cpu")
    probe = probe_mod.EngineProbe(engine, registry=metrics.MetricsRegistry())
    res = engine.run_checkpointed(max_cycles=40, segment_cycles=10,
                                  probe=probe)
    assert len(probe.chunks) == res.metrics["segments"] == 4
    assert all(s >= 0 for _, _, _, s in probe.chunks)
    assert probe.cost_curve()[-1][0] == res.cycles
    assert len(probe.convergence_curve()) == 3


def test_probe_reads_the_host_once_per_boundary():
    """The boundary's scalars (cost, residual, flip rate) come to the
    host in one transfer."""
    from pydcop_tpu_torch.algorithms.maxsum import build_engine
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file
    from pydcop_tpu_torch.observability.engine_probe import EngineProbe
    from pydcop_tpu_torch.observability.metrics import MetricsRegistry

    import os

    fixture = os.path.join(os.path.dirname(__file__), "instances",
                           "coloring_12_3.yml")
    engine = build_engine(load_dcop_from_file(fixture), {}, device="cpu")
    probe = EngineProbe(engine, registry=MetricsRegistry())
    reads = []
    real = torch.Tensor.tolist

    def counting(self):
        reads.append(self.shape)
        return real(self)

    torch.Tensor.tolist = counting
    try:
        state = engine.init_state()
        from pydcop_tpu_torch.ops import maxsum as ops

        for _ in range(2):
            state, values = ops.run_maxsum_from(engine.graph, state, 5)
            reads.clear()
            probe._boundary(state, values)
            assert len(reads) == 1
    finally:
        torch.Tensor.tolist = real
    assert reads[0] == (3,)     # cost, residual, flip rate


# ------------------------------------------------------------------ #
# cleanenv, server, flight


def test_probelog_tail_and_diag_events(tmp_path, monkeypatch):
    from pydcop_tpu_torch.utils import cleanenv

    path = tmp_path / "probelog.jsonl"
    with open(path, "w") as f:
        for i in range(30):
            f.write(json.dumps({"unix": 1.0 + i, "event": "probe",
                                "ok": i % 2 == 0}) + "\n")
        f.write("not json\n")
    monkeypatch.setenv("PYDCOP_PROBELOG", str(path))
    tail = cleanenv.probelog_tail(5)
    assert len(tail) == 5 and tail[-1]["unix"] == 30.0
    monkeypatch.setenv("PYDCOP_PROBELOG", str(tmp_path / "none.jsonl"))
    assert cleanenv.probelog_tail() == []
    monkeypatch.setenv(cleanenv.DIAG_ENV, "[]")
    events = cleanenv.record_diag("probe", tag="t", ok=False,
                                  error="timeout after 1s")
    assert events[-1]["event"] == "probe"
    assert cleanenv.is_probe_failure(events[-1])
    assert cleanenv.diag_events() == events


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the failure path: needs no card")
def test_liveness_probe_raises_without_a_card(monkeypatch):
    from pydcop_tpu_torch.utils import cleanenv

    monkeypatch.setenv(cleanenv.DIAG_ENV, "[]")
    with pytest.raises(RuntimeError, match="did not initialise"):
        cleanenv.ensure_live_backend(tag="test", retries=1,
                                     probe_timeout=120)
    kinds = [e["event"] for e in cleanenv.diag_events()]
    assert kinds == ["probe", "backend_unavailable"]


def test_cli_guard_runs_for_cuda_only(monkeypatch):
    from pydcop_tpu_torch import dcop_cli
    from pydcop_tpu_torch.utils import cleanenv

    calls = []
    monkeypatch.setattr(cleanenv, "ensure_live_backend",
                        lambda **kw: calls.append(kw["tag"]))
    parser = dcop_cli.make_parser()
    dcop_cli._guard_backend(parser.parse_args(
        ["solve", "-a", "maxsum", "--device", "cpu", "x.yml"]))
    assert calls == []
    dcop_cli._guard_backend(parser.parse_args(
        ["solve", "-a", "maxsum", "x.yml"]))
    assert calls == ["cli_solve"]


def test_server_routes(tmp_path):
    import urllib.request

    from pydcop_tpu_torch.observability.metrics import registry
    from pydcop_tpu_torch.observability.server import TelemetryServer

    registry.counter("pydcop_test_total", "test").inc()
    server = TelemetryServer(port=0).start()
    try:
        bodies = {}
        for route in ("metrics", "healthz", "profile"):
            with urllib.request.urlopen(f"{server.url}/{route}",
                                        timeout=10) as resp:
                bodies[route] = resp.read().decode()
    finally:
        server.stop()
    assert "pydcop_test_total" in bodies["metrics"]
    assert json.loads(bodies["healthz"])["status"] == "ok"
    doc = json.loads(bodies["profile"])
    assert set(doc["waste_by_cause"]) == {
        "padding_s", "envelope_s", "compile_s", "queue_s"}


def test_flight_bundle_sections(tmp_path, monkeypatch):
    from pydcop_tpu_torch.observability.flight import FlightRecorder
    from pydcop_tpu_torch.observability.trace import tracer

    path = tmp_path / "probelog.jsonl"
    with open(path, "w") as f:
        f.write(json.dumps({"unix": 1.0, "event": "probe", "ok": False,
                            "error": "timeout after 20s"}) + "\n")
    monkeypatch.setenv("PYDCOP_PROBELOG", str(path))
    recorder = FlightRecorder(bundle_dir=str(tmp_path / "b"),
                              min_interval_s=0.0)
    saved = tracer.flight
    tracer.set_flight(recorder)
    try:
        written = recorder.trigger("guard_trip", trip_kind="injected")
    finally:
        tracer.set_flight(saved)
    doc = json.load(open(written))
    assert doc["kind"] == "guard_trip"
    assert doc["probe_log_tail"][0]["error"] == "timeout after 20s"
    assert "efficiency" in doc and "metrics" in doc
    assert any(e["name"] == "anomaly"
               and e["args"]["kind"] == "guard_trip" for e in doc["events"])
