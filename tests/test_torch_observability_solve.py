"""An observed solve of the port against the same observed solve of the
JAX reference (pydcop_tpu.api.solve with trace / metrics_file /
metrics_every), on the CPU.

Held equal between the two packages, on the same DCOP, seed and
parameters:

- the multiset of trace event names (spans and instants: ``solve``,
  ``compile_graph``, ``engine_segment``, ``jit_compile``,
  ``engine_call``, ``chunk``, ``xla_cost``, and with checkpoints and
  recovery ``checkpoint_write``, ``guard_trip``, ``recovery_rollback``);
- the values of every count-valued counter (jit calls by key and
  warmth, compile-cache lookups, layout builds, cycles, checkpoints,
  guard trips, recovery attempts) — the registries are reset before
  each pair of solves;
- the set of Prometheus metric names, except the profiler's family:
  XLA's cost analysis (``pydcop_xla_flops_total``/``bytes``/
  ``peak_bytes``) has no eager-torch counterpart, and on the CPU the
  port's profiler says so (``pydcop_xla_analysis_unavailable_total``
  and an ``available: False`` entry with ``source:
  "torch.profiler"``);
- ``metrics['cost_curve']`` bit for bit (its last point equals the
  solve's cost), and ``metrics['convergence_curve']``: the flip rate
  exactly, the residual to rtol 1e-6 (its sum over messages adds in
  another order).

Also: the port's ``trace summary`` run on a trace the reference wrote
gives the reference's rows; the live endpoint answers during a solve;
the flight recorder writes a bundle on a guard trip.  Durations are
never compared (they are wall times).
"""

import collections
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from pydcop_tpu import api as japi
from pydcop_tpu.dcop.yamldcop import load_dcop_from_file as jload
from pydcop_tpu.engine import compile as jcompile
from pydcop_tpu.observability.metrics import registry as jregistry
from pydcop_tpu_torch import api as tapi
from pydcop_tpu_torch.dcop.yamldcop import load_dcop_from_file as tload
from pydcop_tpu_torch.engine import compile as tcompile
from pydcop_tpu_torch.observability.metrics import registry as tregistry
from pydcop_tpu_torch.observability.trace import load_trace_file

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "instances", "coloring_12_3.yml")

# Counters whose values are counts (not seconds): held equal.
COUNT_COUNTERS = (
    "pydcop_jit_calls_total", "pydcop_compile_cache_total",
    "pydcop_layout_builds_total", "pydcop_cycles_total",
    "pydcop_checkpoints_total", "pydcop_guard_trips_total",
    "pydcop_recovery_attempts_total",
)
# The reference's XLA profiler family, and the port's counterpart.
PROFILER_FAMILY = ("pydcop_xla_flops_total", "pydcop_xla_bytes_total",
                   "pydcop_xla_peak_bytes",
                   "pydcop_xla_analysis_unavailable_total")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host, and torch's default of one thread per core
    in each of them oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path, monkeypatch):
    """Flight-recorder bundles of either package go under tmp_path,
    with no rate limit (a bundle per trigger)."""
    from pydcop_tpu.observability.flight import get_flight as jflight
    from pydcop_tpu_torch.observability.flight import get_flight as tflight

    for side, recorder in (("jax", jflight()), ("torch", tflight())):
        if recorder is not None:
            monkeypatch.setattr(recorder, "bundle_dir",
                                str(tmp_path / f"bundles_{side}"))
            monkeypatch.setattr(recorder, "min_interval_s", 0.0)


def _solve_both(tmp_path, name, **kw):
    """The same observed solve with each package (registries reset
    and structure caches emptied first, so both count the same compile
    cache outcome whatever ran earlier in the process); returns
    {"jax"|"torch": (result, trace events, metrics JSONL rows,
    Prometheus text)}."""
    out = {}
    for side, solve, load, reg, cache in (
            ("jax", japi.solve, jload, jregistry, jcompile.compile_cache),
            ("torch", tapi.solve, tload, tregistry, tcompile.compile_cache)):
        d = tmp_path / f"{name}_{side}"
        d.mkdir()
        trace = str(d / "t.json")
        metrics = str(d / "m.jsonl")
        extra = dict(kw)
        if "checkpoint_dir" in extra:
            extra["checkpoint_dir"] = str(d / "ck")
        if side == "torch":
            extra["device"] = "cpu"
        reg.reset()
        cache.clear()
        res = solve(load(FIXTURE), "maxsum", trace=trace,
                    metrics_file=metrics, **extra)
        rows = [json.loads(line) for line in open(metrics)]
        with open(metrics + ".prom") as f:
            prom = f.read()
        out[side] = (res, load_trace_file(trace), rows, prom)
    return out


def _names(events):
    return collections.Counter(e["name"] for e in events
                               if e.get("ph") in ("X", "i", "I"))


def _counts(rows):
    metrics = rows[-1]["metrics"]
    return {name: sorted((tuple(sorted(s["labels"].items())), s["value"])
                         for s in metrics[name]["samples"])
            for name in COUNT_COUNTERS if name in metrics}


def _prom_names(prom):
    return {line.split()[2] for line in prom.splitlines()
            if line.startswith("# TYPE ")}


CASES = {
    "one_segment": dict(max_cycles=60),
    "segments_of_10": dict(max_cycles=60, metrics_every=10),
    "checkpointed": dict(max_cycles=60, checkpoint_dir=True,
                         checkpoint_every=20, checkpoint_async=False),
    "damping_07": dict(max_cycles=60, metrics_every=15,
                       algo_params={"damping": 0.7}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_observed_solve_equals_the_reference(tmp_path, case):
    both = _solve_both(tmp_path, case, **CASES[case])
    (jres, jev, jrows, jprom), (tres, tev, trows, tprom) = (
        both["jax"], both["torch"])
    assert tres["assignment"] == jres["assignment"]
    assert tres["cost"] == jres["cost"]
    assert tres["cycles"] == jres["cycles"]
    assert _names(tev) == _names(jev)
    assert _counts(trows) == _counts(jrows)
    assert [r["cycle"] for r in trows] == [r["cycle"] for r in jrows]
    assert (_prom_names(tprom) - set(PROFILER_FAMILY)
            == _prom_names(jprom) - set(PROFILER_FAMILY))
    assert "pydcop_xla_analysis_unavailable_total" in _prom_names(tprom)
    jm, tm = jres["metrics"], tres["metrics"]
    assert tm["cost_curve"] == jm["cost_curve"]
    assert tm["cost_curve"][-1] == (tres["cycles"], tres["cost"])
    jc, tc = jm["convergence_curve"], tm["convergence_curve"]
    assert [(c, f) for c, _, f in tc] == [(c, f) for c, _, f in jc]
    np.testing.assert_allclose([r for _, r, _ in tc],
                               [r for _, r, _ in jc], rtol=1e-6)
    entries = tm["xla_cost"]
    assert set(entries) == set(jm["xla_cost"])
    for entry in entries.values():
        assert entry["available"] is False
        assert entry["source"] == "torch.profiler"
        assert entry["reason"]


def test_recovery_hooks_equal_the_reference(tmp_path):
    """Guard trips at cycles 20 and 40 walk the recovery ladder: the
    ``guard_trip`` instants, ``recovery_rollback`` spans, trip and
    attempt counters and the result equal the reference's, and each
    package's flight recorder wrote a bundle."""
    from pydcop_tpu.resilience.recovery import RecoveryPolicy as JPolicy
    from pydcop_tpu_torch.resilience.recovery import (
        RecoveryPolicy as TPolicy,
    )

    out = {}
    for side, solve, load, reg, policy in (
            ("jax", japi.solve, jload, jregistry, JPolicy),
            ("torch", tapi.solve, tload, tregistry, TPolicy)):
        d = tmp_path / side
        d.mkdir()
        reg.reset()
        extra = {"device": "cpu"} if side == "torch" else {}
        res = solve(load(FIXTURE), "maxsum", max_cycles=80,
                    metrics_every=10, trace=str(d / "t.json"),
                    metrics_file=str(d / "m.jsonl"),
                    recovery=policy(trip_cycles=(20, 40)), **extra)
        rows = [json.loads(line) for line in open(d / "m.jsonl")]
        out[side] = (res, load_trace_file(str(d / "t.json")), rows)
    (jres, jev, jrows), (tres, tev, trows) = out["jax"], out["torch"]
    assert tres["assignment"] == jres["assignment"]
    assert tres["metrics"]["recovery_actions"] == \
        jres["metrics"]["recovery_actions"]
    names = _names(tev)
    assert names == _names(jev)
    assert names["guard_trip"] == 2 and names["recovery_rollback"] == 2
    assert _counts(trows) == _counts(jrows)
    assert tres["metrics"]["cost_curve"] == jres["metrics"]["cost_curve"]
    for side in ("jax", "torch"):
        bundles = sorted(os.listdir(tmp_path / f"bundles_{side}"))
        assert sum("guard_trip" in b for b in bundles) == 2, side
    with open(tmp_path / "bundles_torch" / bundles[-1]) as f:
        doc = json.load(f)
    assert doc["kind"] == "guard_trip"
    assert any(e["name"] == "guard_trip" for e in doc["events"])


def test_async_write_failure_still_raises_when_observed(tmp_path):
    """The port raises an asynchronous checkpoint write failure (a
    deliberate divergence from the reference, ROADMAP); the observed
    path's hooks do not swallow it."""
    from pydcop_tpu_torch.resilience import checkpoint as tck

    real = tck._write_arrays

    def failing(*a, **k):
        raise OSError("disk full")

    tck._write_arrays = failing
    try:
        with pytest.raises(RuntimeError, match="async checkpoint write"):
            tapi.solve(tload(FIXTURE), "maxsum", max_cycles=40,
                       checkpoint_dir=str(tmp_path / "ck"),
                       checkpoint_every=20, checkpoint_async=True,
                       trace=str(tmp_path / "t.json"),
                       metrics_file=str(tmp_path / "m.jsonl"),
                       device="cpu")
    finally:
        tck._write_arrays = real


def test_port_trace_summary_reads_a_reference_trace(tmp_path, capsys):
    """``python -m pydcop_tpu_torch trace summary --json`` on a trace
    the reference wrote gives the reference's own rows."""
    from pydcop_tpu.commands import trace as jtrace
    from pydcop_tpu_torch.dcop_cli import main as tmain

    path = str(tmp_path / "ref.json")
    japi.solve(jload(FIXTURE), "maxsum", max_cycles=60, metrics_every=10,
               trace=path, metrics_file=str(tmp_path / "m.jsonl"))
    assert tmain(["trace", "summary", "--json", path]) == 0
    port_rows = json.loads(capsys.readouterr().out)
    parser = __import__("argparse").ArgumentParser()
    jtrace.set_parser(parser.add_subparsers())
    args = parser.parse_args(["trace", "summary", "--json", path])
    assert args.func(args) == 0
    ref_rows = json.loads(capsys.readouterr().out)
    assert port_rows == ref_rows
    assert {r["name"] for r in port_rows["rows"]} >= {
        "solve", "engine_segment", "chunk"}


def test_profile_report_reads_the_port_trace_and_metrics(tmp_path,
                                                         capsys):
    from pydcop_tpu_torch.dcop_cli import main as tmain

    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.jsonl")
    tapi.solve(tload(FIXTURE), "maxsum", max_cycles=60, metrics_every=20,
               trace=trace, metrics_file=metrics, device="cpu")
    assert tmain(["profile", "report", "--json", "--trace", trace,
                  "--metrics", metrics]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["mode"] == ["trace", "metrics"]
    spans = {c["span"]: c for c in report["trace"]["components"]}
    assert spans["engine_segment"]["count"] == 3
    assert spans["jit_compile"]["count"] == 1
    assert spans["engine_call"]["count"] == 2
    assert tmain(["profile", "report"]) == 0
    assert "backend: cpu" in capsys.readouterr().out


def test_live_endpoint_during_a_solve(tmp_path):
    """``serve_metrics=0``: while the solve runs, GET /metrics serves
    Prometheus text, /healthz ``ok`` and /profile the efficiency
    rollup labelled with the solve's backend."""
    from pydcop_tpu_torch.observability.engine_probe import EngineProbe
    from pydcop_tpu_torch.observability.server import TelemetryServer

    seen, servers = {}, []
    real_segment, real_start = EngineProbe.on_segment, TelemetryServer.start

    def start(self):
        servers.append(self)
        return real_start(self)

    def scrape(self, *a, **k):
        real_segment(self, *a, **k)
        if seen:
            return
        for route in ("metrics", "healthz", "profile"):
            with urllib.request.urlopen(f"{servers[0].url}/{route}",
                                        timeout=10) as resp:
                seen[route] = (resp.status, resp.read().decode())

    EngineProbe.on_segment = scrape
    TelemetryServer.start = start
    try:
        res = tapi.solve(tload(FIXTURE), "maxsum", max_cycles=40,
                         metrics_every=10, serve_metrics=0, device="cpu")
    finally:
        EngineProbe.on_segment = real_segment
        TelemetryServer.start = real_start
    assert res["cycles"] == 40
    status, text = seen["metrics"]
    assert status == 200 and "pydcop_cycles_total" in text
    status, body = seen["healthz"]
    assert status == 200 and json.loads(body)["status"] == "ok"
    status, body = seen["profile"]
    assert status == 200
    assert json.loads(body)["backend"]["backend"] == "cpu"


def test_warmup_keeps_the_plain_path(tmp_path):
    """``warmup=True``: traced, unsegmented, no curves (the
    reference's routing)."""
    trace = str(tmp_path / "t.json")
    res = tapi.solve(tload(FIXTURE), "maxsum", max_cycles=30, warmup=True,
                     trace=trace, device="cpu")
    assert "cost_curve" not in res["metrics"]
    names = _names(load_trace_file(trace))
    assert names["jit_compile"] == 1 and names["engine_call"] == 1
    assert "engine_segment" not in names
