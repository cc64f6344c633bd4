"""The port's partitioned engine through its entry points, against the
JAX package's, on the CPU: ``tests/unit/test_sharding_battery.py``'s
``TestPartitionedEngine`` and ``TestShardTraceLanes`` case for case
(refusal messages included), ``api.solve(shards=)`` and ``solve
--shards`` against the reference's, the checkpointed mid-solve resume
of ``tests/api/test_sharded_parity.py``, the partitioned mesh's device
count and the refusals of the replicated-variable mesh.

Tolerance: none (assignments, costs, cycles, metrics and trace lanes
compared with ``==``), except where the reference battery itself
compares a device cost with the host's (``pytest.approx``).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import pydcop_tpu_torch.engine.runner as TR
from pydcop_tpu.api import solve as jax_solve
from pydcop_tpu_torch.algorithms.maxsum import build_engine
from pydcop_tpu_torch.api import solve
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import Domain, Variable
from pydcop_tpu_torch.dcop.relations import constraint_from_str
from pydcop_tpu_torch.engine.runner import ShardedMaxSumEngine
from torch_sharding_common import grid_both, loopy_both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def _cold_dispatch_caches():
    """Every test starts with both packages' batch dispatch caches
    empty, so ``cold_start`` compares like with like."""
    import pydcop_tpu.engine.batch as JB
    import pydcop_tpu_torch.engine.batch as TB

    JB._warm.clear()
    TB._warm.clear()


def _grid(side=8, seed=0):
    """The reference battery's integer grid coloring (bench.py's
    ``build_grid_dcop`` family), in the port."""
    return grid_both(side, decades=None, seed=seed)[1]


# --------------------------- partitioned engine --------------------- #
# The reference battery's TestPartitionedEngine, case for case.


class TestPartitionedEngine:
    def test_comm_accounting_is_cut_times_d(self):
        dcop = _grid(10)
        engine = build_engine(dcop, {"noise": 0.01}, shards=8,
                              device="cpu")
        m = engine.extra_metrics
        d = 3
        assert (m["halo_exchange_elems_per_superstep"]
                == m["boundary_vars"] * d)
        assert (m["replicated_allreduce_elems_per_superstep"]
                == (len(dcop.variables) + 1) * d)
        assert (m["halo_exchange_elems_per_superstep"]
                < m["replicated_allreduce_elems_per_superstep"])
        assert (m["halo_exchange_bytes_per_superstep"]
                == 4 * m["halo_exchange_elems_per_superstep"])

    def test_mixed_arity_parity(self):
        dom = Domain("d", "", [0, 1, 2])
        dcop = DCOP("mixed", objective="min")
        vs = [Variable(f"v{i}", dom) for i in range(12)]
        for v in vs:
            dcop.add_variable(v)
        for i in range(12):
            dcop.add_constraint(constraint_from_str(
                f"u{i}", f"(v{i} - 1)**2", [vs[i]]))
            dcop.add_constraint(constraint_from_str(
                f"b{i}", f"abs(v{i} - v{(i + 1) % 12})",
                [vs[i], vs[(i + 1) % 12]]))
        for i in range(0, 12, 3):
            scope = [vs[i], vs[(i + 1) % 12], vs[(i + 2) % 12]]
            dcop.add_constraint(constraint_from_str(
                f"t{i}", f"v{i} * v{(i + 1) % 12} * v{(i + 2) % 12}",
                scope))
        params = {"noise": 0.01}
        r1 = build_engine(dcop, params, device="cpu").run(
            max_cycles=40, stop_on_convergence=False)
        r8 = build_engine(dcop, params, shards=8, device="cpu").run(
            max_cycles=40, stop_on_convergence=False)
        assert r8.assignment == r1.assignment

    def test_constraint_free_graph(self):
        dom = Domain("d", "", [0, 1, 2])
        dcop = DCOP("free", objective="min")
        for i in range(8):
            dcop.add_variable(Variable(f"v{i}", dom))
        params = {"noise": 0.01}
        r1 = build_engine(dcop, params, device="cpu").run(max_cycles=5)
        r8 = build_engine(dcop, params, shards=8, device="cpu").run(
            max_cycles=5)
        assert r8.assignment == r1.assignment
        assert r8.metrics["boundary_vars"] == 0

    def test_guard_cost_matches_host(self):
        dcop = _grid(8, seed=2)
        engine = build_engine(dcop, {"noise": 0.01}, shards=8,
                              device="cpu")
        res = engine.run(max_cycles=30, stop_on_convergence=False)
        values = np.asarray([
            res.assignment[f"v{i}"] for i in range(len(dcop.variables))
        ], np.int32)
        device_cost = float(engine._ops.assignment_constraint_cost(
            engine.graph, torch.from_numpy(values)))
        host_cost, _ = dcop.solution_cost(res.assignment)
        assert device_cost == pytest.approx(host_cost)

    def test_maxsum_family_delegation(self):
        dcop = _grid(6)
        base = solve(dcop, "maxsum", max_cycles=30, shards=8,
                     device="cpu")
        for algo in ("amaxsum", "maxsum_dynamic"):
            res = solve(dcop, algo, max_cycles=30, shards=8,
                        device="cpu")
            assert res.assignment == base.assignment, algo
            assert res.cost == base.cost

    def test_decimation_rejected(self):
        with pytest.raises(ValueError, match="decimation"):
            build_engine(_grid(6), {"decimation": 10}, shards=8,
                         device="cpu")

    def test_lane_layout_rejected(self):
        with pytest.raises(ValueError, match="lane"):
            build_engine(_grid(6), {"layout": "lane"}, shards=8,
                         device="cpu")

    def test_non_scatter_aggregation_rejected(self):
        with pytest.raises(ValueError, match="scatter"):
            build_engine(_grid(6), {"aggregation": "ell"}, shards=8,
                         device="cpu")

    def test_too_many_shards_message(self):
        with pytest.raises(ValueError, match="xla_force_host_platform"):
            build_engine(_grid(6), {}, shards=64, device="cpu")


@pytest.mark.parametrize("kw,exc,match", [
    ({"params": {"decimation": 10}}, ValueError, "decimation"),
    ({"params": {"layout": "lane"}}, ValueError, "lane"),
    ({"params": {"aggregation": "sorted"}}, ValueError, "scatter"),
    ({"params": {}, "shards": 64}, ValueError, "xla_force_host_platform"),
    ({"params": {}, "n_devices": 2}, ValueError, "mutually exclusive"),
])
def test_refusals_equal_the_reference(kw, exc, match):
    """The same refusal, in the same order, as the reference's
    ``build_engine(..., shards=)``."""
    from pydcop_tpu.algorithms.maxsum import build_engine as jax_build

    jdcop, tdcop = grid_both(6, decades=None)
    kw = dict(kw)
    params = kw.pop("params")
    shards = kw.pop("shards", 8)
    with pytest.raises(exc, match=match) as jerr:
        jax_build(jdcop, params, shards=shards, **kw)
    with pytest.raises(exc, match=match) as terr:
        build_engine(tdcop, params, shards=shards, device="cpu", **kw)
    assert type(terr.value) is type(jerr.value)


def test_run_decimated_refused():
    engine = build_engine(_grid(6), {}, shards=2, device="cpu")
    with pytest.raises(ValueError, match="without shards"):
        engine.run_decimated()


def test_one_shard_mesh_refused():
    from pydcop_tpu_torch.engine.compile import compile_dcop
    from pydcop_tpu_torch.engine.sharding import make_mesh

    graph, meta = compile_dcop(_grid(4), noise_level=0.01)
    with pytest.raises(ValueError, match=">= 2 devices"):
        ShardedMaxSumEngine(graph, meta, mesh=make_mesh(devices=["cpu"]),
                            device="cpu")


def test_partitioned_mesh_counts_the_reference_devices(monkeypatch):
    """The CPU counts as many devices as the reference sees under the
    same environment (the repo's conftest forces 8); a count above it
    raises, as the reference's ``partitioned_mesh`` does, and so does a
    cuda mesh on a host without a card."""
    from pydcop_tpu_torch.engine.multihost import partitioned_mesh
    from pydcop_tpu_torch.engine.sharding import host_device_count

    assert host_device_count() == len(jax.devices()) == 8
    assert partitioned_mesh(8, "cpu").size == 8
    with pytest.raises(ValueError, match="only 8 device"):
        partitioned_mesh(9, "cpu")
    with pytest.raises(ValueError, match="shards >= 2"):
        partitioned_mesh(1, "cpu")
    monkeypatch.setenv("XLA_FLAGS", "")
    assert host_device_count() == 1
    with pytest.raises(ValueError, match="only 1 device"):
        partitioned_mesh(2, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            partitioned_mesh(4, "cuda")


def test_partitioned_mesh_on_one_card_raises(monkeypatch):
    """A one-card machine asked for shards=4 on "cuda" raises, as the
    reference does past its device count; a mesh naming the card
    several times is the explicit way to run S shards on it."""
    import pydcop_tpu_torch.engine.sharding as SH
    from pydcop_tpu_torch.engine.multihost import partitioned_mesh

    monkeypatch.setattr(SH, "available_devices",
                        lambda device="cuda": [torch.device("cuda", 0)])
    with pytest.raises(ValueError, match="only 1 device.*names it "
                                         "several times"):
        partitioned_mesh(4, "cuda")


# ------------------------- replicated mesh refusals ----------------- #


def test_replicated_mesh_refusals_name_the_roadmap_item():
    """``mesh``/``n_devices`` (the replicated-variable path) raise
    NotImplementedError naming ROADMAP.md Queue A item 6(b): in
    ``MaxSumEngine``, ``run_device_fn`` and ``api.solve``."""
    from pydcop_tpu_torch.engine.compile import compile_dcop
    from pydcop_tpu_torch.engine.sharding import make_mesh

    dcop = _grid(4)
    graph, meta = compile_dcop(dcop, noise_level=0.01)
    mesh = make_mesh(devices=["cpu", "cpu"])
    for kw in ({"mesh": mesh}, {"n_devices": 2}):
        with pytest.raises(NotImplementedError, match=r"item 6\(b\)"):
            TR.MaxSumEngine(graph, meta, device="cpu", **kw)
        with pytest.raises(NotImplementedError, match=r"item 6\(b\)"):
            TR.run_device_fn(graph, meta, lambda g: None, device="cpu",
                             **kw)
        with pytest.raises(NotImplementedError, match=r"item 6\(b\)"):
            solve(dcop, "dsa", max_cycles=5, device="cpu", **kw)


def test_shards_on_a_local_search_algorithm_refused():
    with pytest.raises(NotImplementedError, match="no partitioned engine"):
        solve(_grid(4), "dsa", max_cycles=5, shards=2, device="cpu")


# ------------------------- per-shard trace lanes -------------------- #


class TestShardTraceLanes:
    def _sharded_trace(self, tmp_path, name):
        path = str(tmp_path / name)
        solve(_grid(8), "maxsum", max_cycles=30, shards=8, trace=path,
              device="cpu")
        return path

    def test_engine_spans_tagged_and_instants_emitted(self, tmp_path):
        from pydcop_tpu_torch.observability.trace import load_trace_file

        events = load_trace_file(
            self._sharded_trace(tmp_path, "a.json"))
        segs = [e for e in events if e.get("name") == "engine_segment"]
        assert segs and all(
            e["args"].get("shards") == 8 for e in segs)
        shard_ids = {e["args"]["shard"] for e in events
                     if e.get("name") == "shard_segment"}
        assert shard_ids == set(range(8))

    def test_merge_separates_shard_lanes(self, tmp_path):
        from pydcop_tpu_torch.observability.trace import merge_traces

        a = self._sharded_trace(tmp_path, "a.json")
        b = self._sharded_trace(tmp_path, "b.json")
        out = str(tmp_path / "merged.json")
        info = merge_traces([a, b], out)
        assert info["aligned"]
        doc = json.load(open(out))
        events = doc["traceEvents"]
        lane_labels = {
            e["tid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "thread_name"
        }
        tids_per_file_shard = {}
        for e in events:
            if e.get("name") == "shard_segment":
                key = e["args"]["shard"]
                tids_per_file_shard.setdefault(key, set()).add(
                    e["tid"])
        all_shard_tids = set().union(*tids_per_file_shard.values())
        assert len(all_shard_tids) == 16
        for shard, tids in tids_per_file_shard.items():
            assert len(tids) == 2
            for tid in tids:
                assert f"[shard {shard}]" in lane_labels[tid]
        span_tids = {e["tid"] for e in events
                     if e.get("name") == "engine_segment"}
        assert span_tids.isdisjoint(all_shard_tids)


def test_shard_trace_events_equal_the_reference(tmp_path):
    """The same sharded traced solve in both packages: the same
    ``engine_segment`` span arguments and ``shard_segment`` instants."""
    from pydcop_tpu.observability.trace import (
        load_trace_file as jax_load,
    )
    from pydcop_tpu_torch.observability.trace import load_trace_file

    jdcop, tdcop = grid_both(8, decades=None)
    jax_solve(jdcop, "maxsum", max_cycles=30, shards=4,
              trace=str(tmp_path / "j.json"))
    solve(tdcop, "maxsum", max_cycles=30, shards=4,
          trace=str(tmp_path / "t.json"), device="cpu")

    def facts(events):
        segs = [(e["args"]["segment"], e["args"]["from_cycle"],
                 e["args"]["extra_cycles"], e["args"]["shards"])
                for e in events if e.get("name") == "engine_segment"]
        inst = sorted((e["args"]["shard"], e["args"]["owned_vars"],
                       e["args"]["halo_vars"])
                      for e in events if e.get("name") == "shard_segment")
        return segs, inst

    assert facts(load_trace_file(str(tmp_path / "t.json"))) == facts(
        jax_load(str(tmp_path / "j.json")))


@pytest.mark.parametrize("shards,problem", [
    (2, "grid"), (4, "grid"), (3, "mixed"), (8, "mixed")])
def test_observed_sharded_solve_equals_the_reference(tmp_path, shards,
                                                     problem):
    """An observed sharded solve (``metrics_file``, a probe every 10
    cycles): the cost curve (the shards' constraint costs reduced, then
    the variable costs) and the convergence curve (each shard's |delta|
    sum reduced across shards, as the reference sums a sharded array)
    equal the reference's bit for bit."""
    from torch_sharding_common import mixed_both

    jdcop, tdcop = (grid_both(7, decades=3, seed=3) if problem == "grid"
                    else mixed_both(40, decades=3, seed=shards))
    kw = dict(max_cycles=60, shards=shards, metrics_every=10)
    ref = jax_solve(jdcop, "maxsum",
                    metrics_file=str(tmp_path / "j.jsonl"), **kw)
    out = solve(tdcop, "maxsum", metrics_file=str(tmp_path / "t.jsonl"),
                device="cpu", **kw)
    assert out["metrics"]["cost_curve"] == ref["metrics"]["cost_curve"]
    assert out["metrics"]["convergence_curve"] == \
        ref["metrics"]["convergence_curve"]
    assert len(out["metrics"]["convergence_curve"]) >= 2


# ------------------------- api.solve and the CLI -------------------- #


@pytest.mark.parametrize("shards", [2, 3, 8])
@pytest.mark.parametrize("topo", ["grid", "loopy", "grid_float"])
def test_api_solve_with_shards_equals_the_reference(topo, shards):
    jdcop, tdcop = {
        "grid": lambda: grid_both(10, decades=None, seed=4),
        "loopy": lambda: loopy_both(decades=None, seed=0),
        "grid_float": lambda: grid_both(9, decades=3, seed=shards),
    }[topo]()
    ref = jax_solve(jdcop, "maxsum", max_cycles=60, shards=shards)
    out = solve(tdcop, "maxsum", max_cycles=60, shards=shards,
                device="cpu")
    for key in ("assignment", "cost", "violations", "cycles", "status"):
        assert out[key] == ref[key], key
    for key in ("n_shards", "edge_cut_fraction", "halo_vars_per_shard",
                "boundary_vars", "owned_vars_per_shard", "balance",
                "halo_exchange_elems_per_superstep",
                "replicated_allreduce_elems_per_superstep",
                "boundary_edges_per_shard_max",
                "local_factor_rows_per_shard", "total_flat_edges",
                "msg_count"):
        assert out["metrics"][key] == ref["metrics"][key], key


def test_checkpoint_resume_mid_solve_equals_the_reference(tmp_path):
    """``run_checkpointed`` on a sharded graph interrupted after two
    segments and resumed: the resumed run equals the uninterrupted one
    and the reference's (the halo slot rides the snapshot)."""
    from pydcop_tpu.algorithms.maxsum import build_engine as jax_build
    from pydcop_tpu_torch.resilience.checkpoint import (
        resume_from_checkpoint,
    )

    jdcop, tdcop = grid_both(10, decades=3, seed=4)
    params = {"noise": 0.01}
    kw = dict(max_cycles=60, segment_cycles=20, stop_on_convergence=False)
    jref = jax_build(jdcop, params, shards=8).run_checkpointed(**kw)
    ref = build_engine(tdcop, params, shards=8,
                       device="cpu").run_checkpointed(**kw)
    assert (ref.assignment, ref.cycles) == (jref.assignment, jref.cycles)
    interrupted = build_engine(
        tdcop, params, shards=8, device="cpu").run_checkpointed(
        checkpoint_dir=str(tmp_path), max_segments=2, **kw)
    assert interrupted.metrics["interrupted"]
    assert interrupted.cycles == 40
    resumed = resume_from_checkpoint(
        build_engine(tdcop, params, shards=8, device="cpu"),
        str(tmp_path), max_cycles=60, stop_on_convergence=False)
    assert resumed.metrics["resumed_from_cycle"] == 40
    assert resumed.cycles == ref.cycles
    assert resumed.assignment == ref.assignment


def test_cli_solve_with_shards_equals_the_reference(tmp_path):
    """``python -m pydcop_tpu_torch solve --shards 4`` against the
    reference's ``pydcop solve --shards 4`` on the same file, and the
    per-cycle metrics rows (``--collect_on cycle_change``) from the
    sharded traced run."""
    path = os.path.join(REPO, "tests", "instances", "coloring_12_3.yml")
    env = dict(os.environ, PYTHONPATH=REPO)

    def run(module, out_csv, *extra):
        proc = subprocess.run(
            [sys.executable, "-c",
             f"import sys; from {module} import main; "
             "sys.exit(main(sys.argv[1:]))", "solve", "-a", "maxsum",
             "-c", "60", "--shards", "4", "--collect_on", "cycle_change",
             "--run_metrics", str(out_csv), *extra, path],
            capture_output=True, text=True, env=env, cwd=REPO,
            timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        return json.loads(proc.stdout[proc.stdout.index("{"):])

    ref = run("pydcop_tpu.dcop_cli", tmp_path / "j.csv")
    out = run("pydcop_tpu_torch.dcop_cli", tmp_path / "t.csv",
              "--device", "cpu")
    for key in ("status", "assignment", "cost", "violation", "cycle",
                "msg_count", "backend"):
        assert out[key] == ref[key], key
    assert (tmp_path / "t.csv").read_text().splitlines()[:61] == \
        (tmp_path / "j.csv").read_text().splitlines()[:61]
