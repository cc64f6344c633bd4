"""``chip_smoke.py``'s ``serve`` phase rehearsed on the CPU at reduced
sizes (``ctx["serve_device"] = "cpu"``): its five legs — a bin of 16
as one flush, warm and pipelined; the zipf mixed stream over HTTP with
lane-packed and envelope-padded bursts; a session read over SSE;
journal recovery after a stop without drain; a dpop request — run to
the end, every served answer equal to its solo solve (the phase's own
checks raise otherwise).  The launch counts are the card's business
and are not checked here.
"""

import pytest
import torch

import chip_smoke
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
    """Empty dispatch caches, a private portfolio cache and flight
    bundle directory, and the phase's sizes cut for the CPU."""
    import pydcop_tpu.engine.batch as reference_batch
    import pydcop_tpu_torch.engine.batch as port_batch

    reference_batch._warm.clear()
    port_batch._warm.clear()
    monkeypatch.setenv("PYDCOP_AGG_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setenv("PYDCOP_FLIGHT_DIR", str(tmp_path / "bundles"))
    for name, value in (("SERVE_BIN_VARS", 200), ("SERVE_BIN_CYCLES", 40),
                        # The bin's member count as the phase ran it
                        # until the card run was cut to 8 for time.
                        ("SERVE_BIN_MEMBERS", 16),
                        ("SERVE_MIXED_REQUESTS", 16),
                        ("SERVE_SESSION_EVENTS", 4),
                        ("SERVE_RECOVER_REQUESTS", 8),
                        # A burst must land in one flush on a host
                        # shared with the other test workers.
                        ("SERVE_MIXED_WINDOW_S", 3.0)):
        monkeypatch.setattr(chip_smoke, name, value)


def test_serve_phase_runs_on_the_cpu():
    out = chip_smoke.phase_serve(dict(
        torch=torch, _build=_build, objects=objects,
        relations=relations, dcop_mod=dcop_mod, serve_device="cpu"))
    assert out["dispatches"]["pipelined"] >= 1
    assert out["dispatches"]["envelope"] >= 1
    assert out["dispatches"]["lane"] >= 1
    assert out["bin"]["members"] == 16
    assert out["session"]["sse_events"] == 4 + 2
    assert out["recover"]["replayable_at_stop"] == 8
    assert out["recover"]["replayed"] == 8
    assert set(out["legs_s"]) == {"bin", "mixed", "session", "dpop",
                                  "recover"}
