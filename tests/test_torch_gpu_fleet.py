"""On the card: the fixed-size fleet (``pydcop_tpu_torch/serving/
router.py``, ``api.serve(replicas=2)``).

This file imports neither JAX nor the JAX package.  Every test is
marked ``gpu`` and decides inside itself whether a card is present;
without one it skips.  Where JAX is missing run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_gpu_fleet.py

- Two worker processes share the card behind the router; every answer
  to a burst of mixed structures equals its solo ``api.solve`` on the
  card and on the CPU (assignment and cost).
- Each worker's own ``/profile`` names the card and the kernel
  libraries it loaded, and counts its kernels' launches; its
  ``/stats`` says its dispatches ran on ``cuda``.
- A worker killed with SIGKILL mid-burst loses no acknowledged
  request: its restart replays its journal segment on the card, to the
  solo solves' answers.
- Two processes building one library at once with ``nvcc`` both load
  a whole library.

The workers inherit a private autotune cache and load the kernel
libraries from ``build/kernels/`` (built there once, before the fleet
starts).
"""

import collections
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import pytest
import torch

import torch_serving_common as common
from pydcop_tpu_torch import api
from pydcop_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"max_cycles": 60}
MIXED = [(s, seed) for s in range(0, 24, 3) for seed in (0, 1)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    _need_card()
    tmp = tmp_path_factory.mktemp("fleet")
    _build.build(_build.kernel_names())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYDCOP_AGG_AUTOTUNE_CACHE", str(tmp / "autotune.json"))
        mp.setenv("PYDCOP_FLIGHT_DIR", str(tmp / "bundles"))
        handle = api.serve(port=0, replicas=2,
                           journal_dir=str(tmp / "journal"),
                           compile_cache_dir=str(_build.BUILD_DIR),
                           batch_window_s=1.0, heartbeat_s=0.25)
        try:
            yield handle
        finally:
            summary = handle.stop()
    assert [w["exit"] for w in summary["workers"]] == [0, 0], summary


def _solo_equal(key, got):
    dcop = common.load("torch", common.mixed_yaml(*key))
    for device in ("cuda", "cpu"):
        solo = api.solve(dcop, "maxsum", device=device, **PARAMS)
        assert got["status"] == "FINISHED", got
        assert (got["assignment"], got["cost"]) == (
            solo["assignment"], solo["cost"]), (key, device)


def _burst(url, keys, wait):
    out = {}

    def one(key):
        body = {"dcop": common.mixed_yaml(*key), "params": PARAMS}
        if wait:
            body.update(wait=True, timeout=600)
        out[key] = common.http(url + "/solve", "POST", body, timeout=600)

    threads = [threading.Thread(target=one, args=(k,)) for k in keys]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert sorted(out) == sorted(keys), "a client did not finish"
    return out


def _await(url, rid, timeout=600):
    deadline = time.monotonic() + timeout
    while True:
        code, body = common.http(url + f"/result/{rid}", timeout=60)
        if code not in (202, 503):
            return code, body
        assert time.monotonic() < deadline, (rid, code, body)
        time.sleep(0.05)


@pytest.mark.gpu
def test_fleet_answers_equal_solo_card_and_cpu(fleet):
    out = _burst(fleet.url, MIXED, wait=True)
    for key, (code, body) in out.items():
        assert code == 200, body
        _solo_equal(key, body)
    stats = fleet.router.stats()
    assert stats["up"] == 2 and stats["routed"] >= len(MIXED)


@pytest.mark.gpu
def test_workers_report_the_card(fleet):
    _burst(fleet.url, MIXED[:4], wait=True)
    code, profile = common.http(fleet.url + "/fleet/profile")
    assert code == 200 and profile["n_replicas"] == 2
    kind = torch.cuda.get_device_name(0)
    for source, rep in profile["replicas"].items():
        backend = rep["backend"]
        assert backend["backend"] == "cuda", (source, backend)
        assert backend["device_name"] == kind
        assert "binary_factor_update" in backend["kernel_libraries"]
        # Its edge entry, or its lane entry for lane-packed flushes.
        assert any(n for name, n in backend["kernel_launches"].items()
                   if name.startswith("binary_factor_update")), backend
    code, stats = common.http(fleet.url + "/stats")
    for worker in stats["workers"]:
        assert worker["stats"]["efficiency"]["backend"] == "cuda"


@pytest.mark.gpu
def test_sigkill_mid_burst_loses_no_acknowledged_request(fleet):
    router = fleet.router
    keys = [(s, 40 + s) for s in range(12)]
    acks = {}
    for key, (code, ack) in _burst(fleet.url, keys, wait=False).items():
        assert code == 202, ack
        acks[key] = ack["id"]
    owners = collections.Counter(router.pinned(rid).index
                                 for rid in acks.values())
    victim = router.replicas[owners.most_common(1)[0][0]]
    restarts = victim.restarts
    os.kill(victim.proc.pid, signal.SIGKILL)
    deadline = time.monotonic() + 300
    while not (victim.restarts == restarts + 1 and victim.status == "up"):
        assert time.monotonic() < deadline, victim.summary()
        time.sleep(0.05)
    for key, rid in acks.items():
        code, body = _await(fleet.url, rid)
        assert code == 200, (key, body)
        _solo_equal(key, body)
    code, prof = common.http(fleet.url + "/fleet/profile")
    backend = prof["replicas"][f"replica-{victim.index}"]["backend"]
    assert backend["backend"] == "cuda"


_BUILD_SCRIPT = textwrap.dedent("""
    import sys
    import torch
    from pydcop_tpu_torch.ops import _build
    from pydcop_tpu_torch.ops.halo_sum import halo_sum, halo_sum_reference
    _build.set_build_dir(sys.argv[1])
    parts = [torch.randn(7, 3, device="cuda") for _ in range(4)]
    out = halo_sum(parts)
    assert torch.equal(out, halo_sum_reference(parts))
    print(_build.cache_counts["misses"])
""")


@pytest.mark.gpu
def test_two_processes_building_one_library_with_nvcc(tmp_path):
    _need_card()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_SCRIPT, str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    built = [n for n in os.listdir(tmp_path) if n.endswith(".so")]
    assert len(built) == 1 and built[0].startswith("halo_sum-"), built
