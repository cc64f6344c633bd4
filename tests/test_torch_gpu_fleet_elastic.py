"""On the card: the elastic fleet (``pydcop_tpu_torch/serving/
router.py``'s autoscaler and remote membership).

This file imports neither JAX nor the JAX package.  Every test is
marked ``gpu`` and decides inside itself whether a card is present;
without one it skips.  Where JAX is missing run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu_fleet_elastic.py

- A scale-up on the card: the new worker (a fresh process, a fresh
  CUDA context) replays the admission exemplars before it is routed
  anything; its own ``/profile`` names the card, counts kernel
  launches, and counts libraries loaded from the shared directory and
  none built.  A request it owns then equals its solo ``api.solve`` on
  the card and on the CPU.
- A joined worker on the card (``serve --join``, a process the router
  did not spawn): routed a request it owns, equal to the solo solves;
  its ``/profile`` names the card; after SIGKILL it is down and never
  restarted.

The workers inherit a private autotune cache and load the kernel
libraries from ``build/kernels/`` (built there once, before the fleet
starts); every process a test starts is killed in its teardown.
"""

import os
import signal
import subprocess
import sys
import time

import pytest
import torch

import chip_smoke
import torch_serving_common as common
from pydcop_tpu_torch import api
from pydcop_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"max_cycles": 60}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _poll(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while True:
        out = cond()
        if out:
            return out
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.05)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    _need_card()
    tmp = tmp_path_factory.mktemp("elastic")
    _build.build(_build.kernel_names())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYDCOP_AGG_AUTOTUNE_CACHE", str(tmp / "autotune.json"))
        mp.setenv("PYDCOP_FLIGHT_DIR", str(tmp / "bundles"))
        handle = api.serve(port=0, replicas=2,
                           journal_dir=str(tmp / "journal"),
                           compile_cache_dir=str(_build.BUILD_DIR),
                           batch_window_s=0.05, heartbeat_s=0.25,
                           min_replicas=2, max_replicas=3)
        handle.tmp = tmp
        handle.router.autoscale_interval_s = 0.25
        try:
            yield handle
        finally:
            handle.stop()
            for replica in handle.router.replicas:
                if replica.proc is not None and replica.proc.poll() is None:
                    replica.proc.kill()


def _owned(router, index):
    """A mixed structure whose rendezvous pick is replica ``index``."""
    for s in range(chip_smoke.MIXED_STRUCTS):
        yaml_src = common.mixed_yaml(s, 900 + s)
        if chip_smoke.rendezvous_owner(router, yaml_src, PARAMS) == index:
            return s, 900 + s, yaml_src
    pytest.fail(f"no mixed structure lands on replica {index}")


def _solve_owned(fleet, index):
    s, seed, yaml_src = _owned(fleet.router, index)
    code, got = common.http(fleet.url + "/solve", "POST", {
        "dcop": yaml_src, "params": PARAMS, "wait": True, "timeout": 300})
    assert code == 200 and got["status"] == "FINISHED", got
    assert fleet.router.pinned(got["id"]).index == index
    dcop = common.load("torch", yaml_src)
    for device in ("cuda", "cpu"):
        solo = api.solve(dcop, "maxsum", device=device, **PARAMS)
        assert (got["assignment"], got["cost"]) == (
            solo["assignment"], solo["cost"]), ((s, seed), device)


def _backend(url):
    code, doc = common.http(url + "/profile")
    assert code == 200, doc
    return doc["backend"]


def _on_the_card(backend):
    assert backend["backend"] == "cuda"
    assert backend["device_name"] == torch.cuda.get_device_name(0)
    assert any(n for name, n in backend["kernel_launches"].items()
               if name.startswith("binary_factor_update")), backend


@pytest.mark.gpu
def test_scale_up_prewarm_loads_libraries_and_builds_none(fleet):
    router = fleet.router
    for s in (2, 5):
        code, _ = common.http(fleet.url + "/solve", "POST", {
            "dcop": common.mixed_yaml(s, 1), "params": PARAMS,
            "wait": True, "timeout": 300})
        assert code == 200
    router.slo_p99_ms = 0.001
    try:
        _poll(lambda: router.scale_ups == 1, 300, "the scale-up")
    finally:
        router.slo_p99_ms = None
    new = router.replicas[2]
    assert (new.managed, new.status, new.forwarded) == (True, "up", 0)
    args = new.proc.args
    assert args[args.index("--device") + 1] == "cuda"
    backend = _backend(new.url)
    _on_the_card(backend)
    cache = backend["compile_cache"]
    assert cache["hits"] > 0 and cache["misses"] == 0, cache
    assert cache["dir"] == str(_build.BUILD_DIR)
    _solve_owned(fleet, 2)


@pytest.fixture
def remote_proc():
    procs = []
    yield procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


@pytest.mark.gpu
def test_a_joined_worker_serves_on_the_card(fleet, remote_proc):
    router = fleet.router
    port = chip_smoke.free_port()
    env = dict(os.environ, PYTHONPATH=REPO,
               PYDCOP_COMPILE_CACHE_DIR=str(_build.BUILD_DIR))
    with open(fleet.tmp / "remote.log", "ab") as log:
        remote_proc.append(subprocess.Popen(
            [sys.executable, "-m", "pydcop_tpu_torch.dcop_cli", "serve",
             "--port", str(port), "--join", fleet.url,
             "--journal_dir", str(fleet.tmp / "remote"),
             "--host_id", "remote0", "--batch_window", "0.05"],
            env=env, cwd=REPO, stdout=log, stderr=log,
            start_new_session=True))
    remote = _poll(lambda: next((r for r in router.replicas
                                 if not r.managed and r.status == "up"),
                                None), 300, "the join")
    _solve_owned(fleet, remote.index)
    _on_the_card(_backend(remote.url))
    os.kill(remote_proc[0].pid, signal.SIGKILL)
    remote_proc[0].wait(timeout=30)
    _poll(lambda: remote.status == "down", 60, "the death verdict")
    time.sleep(1.0)
    assert remote.status == "down" and remote.restarts == 0
    assert remote.proc is None
