"""``chip_smoke.py``'s ``fleet`` phase rehearsed on the CPU at reduced
sizes (``card="cpu"``): a two-worker fleet behind the router, the serve
phase's mixed stream, a bin of flagship-shaped problems (1,500
variables here), and a burst of acknowledged requests with SIGKILL of
the worker that owns most of them — run to the end, every answer equal
to its solo solve and every acknowledged request answered after the
restart (the phase's own checks raise otherwise).  The elastic legs the
phase drives next on the same router are left out here
(``elastic=False``) and rehearsed on their own in
``test_torch_fleet_elastic_chip_phase.py``.  The card's name and the
kernels' launch counts are the card's business and are not checked
here.

The workers inherit a private autotune cache, flight-bundle directory
and ``OMP_NUM_THREADS=1``; the batch window is long enough (3 s) that
the burst is still pending at the kill on a host shared with other test
workers.
"""

import pytest
import torch

import chip_smoke
import torch_serving_common as common
import pydcop_tpu_torch.dcop.dcop as dcop_mod
import pydcop_tpu_torch.dcop.objects as objects
import pydcop_tpu_torch.dcop.relations as relations
from pydcop_tpu_torch.ops import _build


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """What the phase's workers inherit, and its sizes cut for the
    CPU."""
    with common.isolated(monkeypatch, tmp_path):
        monkeypatch.setenv("PYDCOP_FLIGHT_DIR", str(tmp_path / "bundles"))
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
        for name, value in (("SERVE_MIXED_REQUESTS", 16),
                            ("SERVE_MIXED_WINDOW_S", 3.0),
                            ("FLEET_BIN_MEMBERS", 2),
                            ("FLEET_KILL_REQUESTS", 8)):
            monkeypatch.setattr(chip_smoke, name, value)
        yield


def test_fleet_phase_runs_on_the_cpu():
    flagship = chip_smoke.build_flagship(objects, relations, dcop_mod,
                                         1_500)
    out = chip_smoke.phase_fleet(dict(
        torch=torch, _build=_build, objects=objects, relations=relations,
        dcop_mod=dcop_mod, dcop=flagship), card="cpu", elastic=False)
    assert out["worker_exits"] == [0, 0]
    assert out["mixed"]["requests"] == 16
    assert out["flagship_bin"]["members"] == 2
    # Same structure, same replica: the bin rides affinity.
    assert len(out["flagship_bin"]["replicas"]) == 1
    assert out["kill"]["requests"] == 8 and out["kill"]["lost"] == 0
    assert 1 <= out["kill"]["pending_at_kill"] <= out["kill"]["replayed"]
    assert out["affinity_hit_fraction"] > 0
    assert {w["backend"] for w in out["workers"].values()} == {"cpu"}
    assert sorted(w["restarts"] for w in out["workers"].values()) \
        == [0, 1]
    assert out["start_s"] > 0 and out["restart_s"] > 0
