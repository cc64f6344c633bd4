"""``chip_smoke.py``'s elastic legs (``fleet_elastic_legs``) rehearsed
on the CPU at reduced sizes (``card="cpu"``), on a two-worker fleet
built as the ``fleet`` phase builds its router (``min_replicas=2``,
``max_replicas=3``, no SLO): one scale-up whose prewarm replays the
admission exemplars before the worker is routed anything, the mixed
stream through three workers, a ``serve --join`` process, a scale-down
that migrates a session at its exact uninterrupted cost, and the joined
worker's SIGKILL with its session adopted at its exact cost and no
acknowledged request lost.  Every answer equals its solo CPU solve, and
both sessions' costs equal the reference engine's uninterrupted cost.
The legs' own checks raise on any mismatch; the card's name, kernel
launches and library builds are the card's business and are not
checked here.

The workers (and the joined one) inherit a private autotune cache,
flight-bundle directory, journal and library directory and
``OMP_NUM_THREADS=1``; whatever is still running at the end is
stopped.
"""

import pytest
import torch

import bench
import chip_smoke
import torch_fleet_common as fleet_common
import pydcop_tpu_torch.dcop.dcop as dcop_mod
import pydcop_tpu_torch.dcop.objects as objects
import pydcop_tpu_torch.dcop.relations as relations
from pydcop_tpu_torch import api
from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_elastic_legs_run_on_the_cpu(tmp_path, monkeypatch):
    for name, value in (("SERVE_MIXED_REQUESTS", 24),
                        ("ELASTIC_REMOTE_BURST", 4)):
        monkeypatch.setattr(chip_smoke, name, value)
    flagship = chip_smoke.build_flagship(objects, relations, dcop_mod, 600)
    mixed = {}

    def mixed_dcop(s, seed):
        if (s, seed) not in mixed:
            mixed[(s, seed)] = chip_smoke.build_dcop_mixed(
                objects, relations, dcop_mod, s, seed)
        return mixed[(s, seed)]

    ctx = dict(torch=torch, objects=objects, relations=relations,
               dcop_mod=dcop_mod)
    with fleet_common.cpu_fleet(tmp_path, batch_window_s=0.05,
                                max_batch=16, envelope_overhead_ms=1e6,
                                min_replicas=2, max_replicas=3) as handle:
        # One admitted structure besides the flagship: the latency
        # window the armed SLO reads, and two exemplars to replay.
        code, _ = chip_smoke.serve_http(handle.url + "/solve", "POST", {
            "dcop": dcop_yaml(mixed_dcop(3, 1)), "wait": True,
            "params": {"max_cycles": chip_smoke.SERVE_MIXED_CYCLES}})
        assert code == 200
        out = chip_smoke.fleet_elastic_legs(
            ctx, handle, "cpu", dcop_yaml(flagship), mixed_dcop,
            str(tmp_path))
    exits = [w["exit"] for w in handle.summary["workers"]]
    assert exits == [0, 0, 0, None]
    answers = out.pop("answers")
    chip_smoke.check_fleet_answers(
        api, mixed_dcop, answers, ["cpu"], flagship=flagship,
        flagship_answers=[out.pop("flagship_answer")])
    assert (out["scale_ups"], out["scale_downs"]) == (1, 1)
    # One drain migration, one adoption.
    assert out["adopted_sessions"] == 1 and out["migrations"] == 2
    up = out["scale_up"]
    assert up["trigger"] == "p99" and up["replica"] == 2
    assert up["exemplars_replayed"] == 2
    assert sorted(up["stream"]["by_replica"]) == [0, 1, 2]
    assert out["join"]["replica"] == 3 and out["join"]["workers_up"] == 4
    down, death = out["scale_down"], out["remote_death"]
    assert death["lost"] == 0 and death["burst"] == 4
    # Both sessions end at the cost the reference's engine reaches
    # uninterrupted (bench.py's _elastic_session_problem under the
    # session's parameters).
    for leg, seed, n in ((down, 4201, 4), (death, 4301, 3)):
        params = dict(chip_smoke.ELASTIC_SESSION_PARAMS,
                      max_cycles=leg["session_max_cycles"])
        monkeypatch.setattr(bench, "FLEET_ELASTIC_SESSION_PARAMS", params)
        _yaml, batches, expected = bench._elastic_session_problem(seed, n)
        assert leg["final_cost"] == leg["uninterrupted_cost"] == expected
        assert batches == chip_smoke.elastic_session_problem(
            objects, relations, dcop_mod, seed, n, params)[1]
    assert death["session_adopted_by"] in (0, 1)
    assert {w["backend"] for w in out["workers"].values()} == {"cpu"}
