"""The port's stateful sessions (``pydcop_tpu_torch/serving/
sessions.py``) against the JAX package's, on the CPU, over HTTP: the
same problem (``bench.py``'s ``build_dcop_small(48, 0)``) and the same
16 PATCHed scenario-event batches through both front ends.

Tolerance: none.  The session's SSE stream — every segment's cycle,
cost, assignment and convergence flag, then the closing event — and
the DELETE's final result are equal between the packages, and so is
every PATCH's post-event segment.  Each activation runs exactly one
segment (``segment_cycles == max_cycles``), so the stream's length does
not depend on timing.  The engines' checkpoint NPZ restores in the
other package's engine, which then runs on equal to the writer.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import torch_serving_common as common

SESSION_PARAMS = {"max_cycles": 60, "segment_cycles": 60, "noise": 0.0}
N_EVENTS = 16


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


def _event_batches(yaml_src, seed=1306):
    dcop = common.load("torch", yaml_src)
    names = sorted(dcop.constraints)
    rng = np.random.default_rng(seed)
    out = []
    for k in range(N_EVENTS):
        name = names[int(rng.integers(len(names)))]
        table = rng.integers(0, 10, size=(3, 3)).astype(float)
        batch = [{"type": "change_factor", "name": name,
                  "table": table.tolist()}]
        if k % 5 == 4:
            batch.append({"type": "remove_factor",
                          "name": names[int(rng.integers(len(names)))]})
        out.append(batch)
    return out


def _front_end(pkg, svc):
    if pkg == "jax":
        from pydcop_tpu.serving.http import ServeFrontEnd
    else:
        from pydcop_tpu_torch.serving.http import ServeFrontEnd
    return ServeFrontEnd(svc, port=0).start()


def _read_sse(url, events, first, done):
    """Collect every ``data:`` event of one SSE stream until the
    server ends it."""
    try:
        with urllib.request.urlopen(url, timeout=300) as resp:
            for raw in resp:
                line = raw.decode().strip()
                if not line.startswith("data:"):
                    continue
                events.append(json.loads(line[len("data:"):]))
                first.set()
    finally:
        first.set()
        done.set()


def _session_run(pkg, yaml_src, batches):
    svc = common.make_service(pkg, batch_window_s=0.01,
                              speculate=False).start()
    fe = _front_end(pkg, svc)
    try:
        code, opened = common.http(fe.url + "/session", "POST", {
            "dcop": yaml_src, "params": SESSION_PARAMS})
        assert code == 201, opened
        sid = opened["session_id"]
        events, first, done = [], threading.Event(), threading.Event()
        reader = threading.Thread(
            target=_read_sse,
            args=(fe.url + f"/session/{sid}/events", events, first,
                  done), daemon=True)
        reader.start()
        assert first.wait(120), "no first SSE event"
        patches = []
        for batch in batches:
            code, out = common.http(
                fe.url + f"/session/{sid}/events", "PATCH",
                {"events": batch, "wait": True, "timeout": 120})
            assert code == 200 and out["applied"], out
            patches.append(out)
        code, final = common.http(fe.url + f"/session/{sid}",
                                  "DELETE")
        assert code == 200, final
        assert done.wait(120), "the SSE stream did not end"
        reader.join(10)
    finally:
        fe.stop()
        svc.stop(drain=False)
    return events, patches, final


def _values(event):
    keys = ("phase", "status", "seq", "batch_seq", "cycle", "cost",
            "converged", "assignment", "recompiles", "clamped",
            "error")
    out = {k: event.get(k) for k in keys}
    if isinstance(event.get("final"), dict):
        out["final"] = common.stable_body(event["final"])
    return out


def test_session_sse_and_final_equal_reference():
    yaml_src = common.small_yaml(48, 0)
    batches = _event_batches(yaml_src)
    runs = {pkg: _session_run(pkg, yaml_src, batches)
            for pkg in common.PACKAGES}
    (ref_events, ref_patches, ref_final), (events, patches, final) = (
        runs["jax"], runs["torch"])
    assert [_values(e) for e in events] == \
        [_values(e) for e in ref_events]
    # One segment per activation: the opening one, one a batch, the
    # closing event.
    phases = [e["phase"] for e in events]
    assert phases == ["segment"] * (N_EVENTS + 1) + ["closed"], phases
    for a, b in zip(ref_patches, patches):
        assert common.stable_body(a["result"]) == \
            common.stable_body(b["result"])
        assert (a["seq"], a["events"], a["recompiles"]) == \
            (b["seq"], b["events"], b["recompiles"])
    assert common.stable_body(final) == common.stable_body(ref_final)
    assert final["status"] == "CLOSED"
    assert final["event_batches"] == N_EVENTS


def _engine(pkg, dcop_yaml_src):
    if pkg == "jax":
        from pydcop_tpu.engine.dynamic import build_dynamic_engine
        return build_dynamic_engine(common.load(pkg, dcop_yaml_src),
                                    {"noise": 0.0})
    from pydcop_tpu_torch.engine.dynamic import build_dynamic_engine
    return build_dynamic_engine(common.load(pkg, dcop_yaml_src),
                                {"noise": 0.0}, device="cpu")


@pytest.mark.parametrize("writer,reader",
                         [("jax", "torch"), ("torch", "jax")])
def test_checkpoint_npz_restores_across_packages(tmp_path, writer,
                                                 reader):
    """A session engine's checkpoint written by one package restores
    in the other's engine, which then runs the next segment to the
    writer's own result."""
    yaml_src = common.small_yaml(48, 0)
    src = _engine(writer, yaml_src)
    src.run(max_cycles=25)
    path = str(tmp_path / "session.npz")
    src.checkpoint(path)
    dst = _engine(reader, yaml_src)
    dst.restore(path)
    a = src.run(max_cycles=25)
    b = dst.run(max_cycles=25)
    assert (a.assignment, a.cycles, a.converged) == \
        (b.assignment, b.cycles, b.converged)
    assert src.cost(a.assignment) == dst.cost(b.assignment)
