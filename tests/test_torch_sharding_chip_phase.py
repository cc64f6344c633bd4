"""``chip_smoke.py``'s ``sharded`` phase rehearsed on the CPU at reduced
sizes (``card="cpu"``: the CPU against itself, nothing timed): meshes
naming the device 2, 4 and 8 times held equal to a second layout after
every cycle, the S = 4 run, the boundary partial and the halo reduction
against their plain versions (subnormals included), one ``trip_shard``
recovery, ``api.solve(shards=)`` above the device count refused, and
the scale arrays at S = 4 — run to the end (the phase's own checks
raise otherwise).  The launch counts are the card's business and are
not checked here.
"""

import pytest
import torch

import chip_smoke
import pydcop_tpu_torch.dcop.dcop as dcop_mod
import pydcop_tpu_torch.dcop.objects as objects
import pydcop_tpu_torch.dcop.relations as relations
from pydcop_tpu_torch import api
from pydcop_tpu_torch.algorithms import AlgorithmDef
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
def _cold_dispatch_caches():
    """Every test starts with both packages' batch dispatch caches
    empty, so ``cold_start`` compares like with like."""
    import pydcop_tpu.engine.batch as JB
    import pydcop_tpu_torch.engine.batch as TB

    JB._warm.clear()
    TB._warm.clear()


@pytest.fixture(autouse=True)
def _small(tmp_path, monkeypatch):
    """The scale leg cut for the CPU, a private flight bundle
    directory (the trip writes one)."""
    monkeypatch.setenv("PYDCOP_FLIGHT_DIR", str(tmp_path / "bundles"))
    monkeypatch.setattr(chip_smoke, "SCALE_VARS", 20_000)


def test_sharded_phase_runs_on_the_cpu():
    dcop = chip_smoke.build_flagship(objects, relations, dcop_mod, 1_500)
    params = AlgorithmDef.build_with_default_param("maxsum").params
    kw = dict(damping=0.5, damp_vars=True, damp_factors=True,
              stability=0.1)
    out = chip_smoke.phase_sharded(dict(
        torch=torch, _build=_build, dcop=dcop, params=params, kw=kw,
        api=api), card="cpu")
    assert set(out["flagship"]) == {"S2", "S4", "S8"}
    assert all(row["boundary_vars"] > 0
               for row in out["flagship"].values())
    assert out["main"]["cpu_equal"] and out["main"]["cycles"] == 40
    assert out["trip_shard"]["n_shards_after"] == 3
    assert out["trip_shard"]["lost_shards"] == [1]
    assert out["api_solve_above_card_count"].startswith("raises")
    assert out["scale"]["n_vars"] == 20_000
    assert set(out["halo_sum_timing"]) == {
        "flagship_S2", "flagship_S4", "flagship_S8", "scale_S4"}
    assert all(row["max_abs_err"] == 0.0
               for row in out["halo_sum_timing"].values())
