"""The port's serving entry points and CLI on the CPU:
``api.serve`` and ``python -m pydcop_tpu_torch serve``, the elastic
fleet's knobs on a single service (as the reference: ``join``
announces the service to a router, the autoscaler's knobs are the
fleet's and a single service ignores them), the device rule, and the reference's global
options and ``solve`` flags the CLI gained with them (``-t/--timeout``,
``--output``, ``-v/--verbosity``, ``--version``;
``--flight_recorder_events``, ``--profile``).

``serve --device cpu`` runs in a child process: it binds port 0,
publishes it through ``--port_file``, answers ``POST /solve`` with the
reference's result for the same problem, and drains on SIGTERM.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

import torch_serving_common as common
from pydcop_tpu_torch import api
from pydcop_tpu_torch import dcop_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "instances", "coloring_12_3.yml")


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


# The elastic fleet's knobs (the fleet itself: tests/test_torch_fleet_*.py).
FLEET_KNOBS = [("join", "ROUTER"), ("min_replicas", 1),
               ("max_replicas", 4), ("slo_p99_ms", 50.0)]


class _StubRouter(BaseHTTPRequestHandler):
    """A fleet router's ``POST /fleet/join``: records the document."""

    joins: list = []

    def do_POST(self):  # noqa: N802 — stdlib name
        raw = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).joins.append((self.path, json.loads(raw)))
        out = json.dumps({"index": 2, "status": "up"}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *args):
        pass


@pytest.mark.parametrize("name,value", FLEET_KNOBS)
def test_fleet_knobs_raise_naming_the_roadmap_item(name, value, tmp_path):
    """A single service with one elastic knob serves as the reference's
    does: ``join`` announces its URL (and journal) to the router once
    the front end is bound; the autoscaler's knobs are the fleet's
    router's and a single service ignores them."""
    handler = type("Stub", (_StubRouter,), {"joins": []})
    stub = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=stub.serve_forever, daemon=True).start()
    if value == "ROUTER":
        value = f"http://127.0.0.1:{stub.server_address[1]}"
    try:
        handle = api.serve(port=0, device="cpu", speculate=False,
                           journal_dir=str(tmp_path / "jnl"),
                           host_id="rack3", **{name: value})
        url = handle.url
        try:
            code, body = common.http(handle.url + "/solve", "POST", {
                "dcop": common.ring_yaml(6, 1), "wait": True,
                "params": {"max_cycles": 20}})
        finally:
            handle.stop()
    finally:
        stub.shutdown()
        stub.server_close()
    assert code == 200 and body["status"] == "FINISHED"
    want = [("/fleet/join", {"url": url, "host_id": "rack3",
                             "journal_dir": str(tmp_path / "jnl")})]
    assert handler.joins == (want if name == "join" else [])


def test_serve_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.serve(port=0)
    with pytest.raises(RuntimeError, match="--device cpu"):
        dcop_cli.main(["serve", "--port", "0"])


def test_cli_fleet_flag_exits_2(caplog):
    """``--join`` with a local fleet exits 2 before anything starts, as
    the reference's ``serve`` does."""
    assert dcop_cli.main(["serve", "--device", "cpu", "--port", "0",
                          "--replicas", "2", "--max_replicas", "4",
                          "--join", "http://127.0.0.1:9"]) == 2
    assert "--join is for single-replica" in caplog.text


def test_api_serve_handle_solves_like_the_reference():
    handle = api.serve(port=0, device="cpu", batch_window_s=0.01,
                       speculate=False)
    try:
        assert handle.service.device.type == "cpu"
        code, body = common.http(handle.url + "/solve", "POST", {
            "dcop": common.ring_yaml(10, 3), "wait": True,
            "params": {"max_cycles": 40}})
    finally:
        summary = handle.stop()
    assert code == 200 and body["status"] == "FINISHED"
    assert summary == {"drained": 0, "replayable": 0,
                       "failed_pending": 0, "parked_sessions": 0}
    ref, _ = common.serve_stream("jax", [common.ring_yaml(10, 3)],
                                 params={"max_cycles": 40},
                                 batch_window_s=0.01)
    assert common.key_fields(body) == common.key_fields(ref[0])


def test_cli_serve_on_the_cpu_answers_and_drains(tmp_path):
    port_file = tmp_path / "port"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pydcop_tpu_torch", "serve", "--device",
         "cpu", "--port", "0", "--port_file", str(port_file),
         "--batch_window", "0.01", "--no_speculate", "--cycles", "40"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 120
        while not port_file.exists() and time.monotonic() < deadline:
            if proc.poll() is not None:
                break
            time.sleep(0.05)
        assert port_file.exists(), proc.communicate(timeout=10)
        url = f"http://127.0.0.1:{int(port_file.read_text())}"
        code, body = common.http(url + "/solve", "POST", {
            "dcop": open(FIXTURE).read(), "wait": True})
        assert code == 200 and body["status"] == "FINISHED", body
        code, stats = common.http(url + "/stats")
        assert code == 200 and stats["completed"] == 1
        assert stats["pipeline"]["enabled"]
        assert not stats["speculation"]["enabled"]
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
    assert "shut down — 0 request(s) drained" in err, err
    ref = api.solve(common.load("torch", open(FIXTURE).read()), "maxsum",
                    max_cycles=40, device="cpu")
    assert body["assignment"] == ref["assignment"]
    assert body["cost"] == ref["cost"]


def test_global_options(tmp_path, capsys):
    assert dcop_cli.main(["--version"]) == 0
    assert capsys.readouterr().out.startswith("pydcop-tpu-torch ")
    out = tmp_path / "result.json"
    assert dcop_cli.main(["-t", "5", "-v", "1", "--output", str(out),
                          "solve", "-a", "maxsum", "-c", "60",
                          "--device", "cpu", FIXTURE]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert json.loads(out.read_text()) == printed
    assert printed["cost"] == 5000.0
    assert dcop_cli.main([]) == 2


def test_solve_flight_recorder_and_profile_flags(tmp_path, capsys):
    from pydcop_tpu_torch.observability.trace import tracer

    prev = tracer.flight
    try:
        assert dcop_cli.main([
            "solve", "-a", "maxsum", "-c", "20", "--device", "cpu",
            "--flight_recorder_events", "64",
            "--profile", str(tmp_path / "prof"), FIXTURE]) == 0
        assert tracer.flight.ring.maxlen == 64
    finally:
        tracer.set_flight(prev)
    assert json.loads(capsys.readouterr().out)["cycle"] == 20
    traces = os.listdir(tmp_path / "prof")
    assert traces and all(t.endswith(".pt.trace.json") for t in traces)
