"""Shard-loss recovery of the port's partitioned engine
(``RecoveryPolicy(trip_shard=...)``, ``ShardedMaxSumEngine.
repartition_after_loss``, ``engine/sharding.py::
remap_partitioned_state``) against the JAX package's, on the CPU, after
``tests/unit/test_shardloss_battery.py``, case for case: trip parity,
the restart budget, loss sequences, exhaustion, the trace, the remap's
exactness — plus sharded snapshots written by one package and resumed
in the other, each way.

Tolerance: none.  A tripped run's assignment, cost, cycles and
accounting equal the untripped run's (integer tables, as the reference
battery holds them) and the reference's tripped run's; on float tables
(3 decades) the tripped run equals the reference's tripped run, and the
remapped state the reference's remapped state, leaf for leaf.
"""

import json

import jax
import numpy as np
import pytest
import torch

import pydcop_tpu.resilience.checkpoint as jck
import pydcop_tpu_torch.resilience.checkpoint as tck
from pydcop_tpu.algorithms.maxsum import build_engine as jax_build_engine
from pydcop_tpu.api import solve as jax_solve
from pydcop_tpu.resilience.recovery import RecoveryPolicy as JPolicy
from pydcop_tpu_torch.algorithms.maxsum import build_engine
from pydcop_tpu_torch.api import solve
from pydcop_tpu_torch.engine.partition import partition_compiled
from pydcop_tpu_torch.engine.runner import ShardedMaxSumEngine
from pydcop_tpu_torch.engine.sharding import _factor_row_maps
from pydcop_tpu_torch.resilience.recovery import (
    NoSurvivingDevices,
    RecoveryExhausted,
    RecoveryPolicy,
)
from torch_sharding_common import assert_same_leaves, both, loopy_both

MAX_CYCLES = 60
SEGMENT = 10


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


def _battery_loopy(mods, n_vars=24, n_edges=36, d=3, seed=0):
    """The reference battery's ``_loopy_dcop``, draw for draw: random
    loopy binary DCOP with integer tables (exact float32 sums)."""
    dcop_cls, agent_cls, dom_cls, var_cls, rel_cls = mods
    rng = np.random.default_rng(seed)
    dom = dom_cls("d", "", list(range(d)))
    dcop = dcop_cls("loopy", objective="min")
    vs = [var_cls(f"v{i}", dom) for i in range(n_vars)]
    for v in vs:
        dcop.add_variable(v)
    seen = set()
    k = 0
    while k < n_edges:
        i, j = rng.choice(n_vars, size=2, replace=False)
        key = (min(i, j), max(i, j))
        if key in seen:
            continue
        seen.add(key)
        m = rng.integers(0, 10, size=(d, d))
        dcop.add_constraint(
            rel_cls([vs[key[0]], vs[key[1]]], m, name=f"c{k}"))
        k += 1
    dcop.add_agents([agent_cls("a0")])
    return dcop


def _loopy(seed=0, decades=None):
    """The reference battery's loopy integer DCOP in both packages, or
    (``decades``) a float-table loopy DCOP."""
    if decades is not None:
        return loopy_both(decades=decades, seed=seed)
    return both(_battery_loopy, seed=seed)


def _run(dcop, shards, recovery=None):
    return build_engine(dcop, {}, shards=shards,
                        device="cpu").run_checkpointed(
        max_cycles=MAX_CYCLES, segment_cycles=SEGMENT, recovery=recovery)


def _jax_run(dcop, shards, recovery=None):
    return jax_build_engine(dcop, {}, shards=shards).run_checkpointed(
        max_cycles=MAX_CYCLES, segment_cycles=SEGMENT, recovery=recovery)


class TestShardTripParity:
    def test_single_trip_same_assignment_and_cost(self):
        jdcop, dcop = _loopy()
        ref = _run(dcop, shards=4)
        res = _run(dcop, shards=4,
                   recovery=RecoveryPolicy(trip_shard=((20, 1),)))
        assert res.assignment == ref.assignment
        m = res.metrics
        assert m["shard_losses"] == 1
        assert m["repartitions"] == 1
        assert m["lost_shards"] == [1]
        assert m["shard_recovery_s"] > 0
        assert m["n_shards"] == 3
        assert m["guard_violations"][0]["kind"] == "shard_loss"
        assert m["guard_violations"][0]["shard"] == 1
        jres = _jax_run(jdcop, 4, JPolicy(trip_shard=((20, 1),)))
        assert (res.assignment, res.cycles, res.converged) == (
            jres.assignment, jres.cycles, jres.converged)
        for key in ("shard_losses", "repartitions", "lost_shards",
                    "n_shards", "guard_violations", "recovery_actions",
                    "recovery_attempts", "guard_trips"):
            assert m[key] == jres.metrics[key], key

    def test_trip_does_not_consume_restart_budget(self):
        _, dcop = _loopy(seed=1)
        res = _run(dcop, shards=4, recovery=RecoveryPolicy(
            max_restarts=0, trip_shard=((20, 2),)))
        assert res.metrics["shard_losses"] == 1
        assert res.metrics["recovery_attempts"] == 0
        assert res.metrics["recovery_actions"] == ["repartition"]

    def test_loss_sequence_survives_and_accounts(self):
        jdcop, dcop = _loopy(seed=2)
        ref = _run(dcop, shards=4)
        res = _run(dcop, shards=4, recovery=RecoveryPolicy(
            trip_shard=((10, 3), (30, 0))))
        assert res.assignment == ref.assignment
        m = res.metrics
        assert m["shard_losses"] == 2
        assert m["repartitions"] == 2
        assert m["lost_shards"] == [3, 0]
        assert m["n_shards"] == 2
        jres = _jax_run(jdcop, 4, JPolicy(trip_shard=((10, 3), (30, 0))))
        assert res.assignment == jres.assignment
        assert m["lost_shards"] == jres.metrics["lost_shards"]

    def test_cost_parity_via_api_solve(self):
        jdcop, dcop = _loopy(seed=3)
        ref = solve(dcop, "maxsum", max_cycles=MAX_CYCLES, shards=2,
                    device="cpu")
        res = solve(dcop, "maxsum", max_cycles=MAX_CYCLES, shards=2,
                    recovery=RecoveryPolicy(trip_shard=((15, 0),)),
                    device="cpu")
        assert res["assignment"] == ref["assignment"]
        assert res["cost"] == ref["cost"]
        assert res["metrics"]["shard_losses"] == 1
        jres = jax_solve(jdcop, "maxsum", max_cycles=MAX_CYCLES, shards=2,
                         recovery=JPolicy(trip_shard=((15, 0),)))
        for key in ("assignment", "cost", "cycles", "status"):
            assert res[key] == jres[key], key


@pytest.mark.parametrize("trips", [((20, 1),), ((10, 3), (30, 0))])
def test_float_tripped_run_equals_the_reference(trips):
    """On float tables the repartitioned run reassociates the sums; the
    port's tripped run is the reference's tripped run bit for bit (the
    remapped snapshot, the recomputed halo, the new layout's supersteps):
    the same assignment, cycles and ``converged``."""
    jdcop, dcop = _loopy(seed=4, decades=3)
    res = _run(dcop, 4, RecoveryPolicy(trip_shard=trips))
    jres = _jax_run(jdcop, 4, JPolicy(trip_shard=trips))
    assert (res.assignment, res.cycles, res.converged) == (
        jres.assignment, jres.cycles, jres.converged)


class TestShardTripTrace:
    def test_trip_and_repartition_visible_in_trace(self, tmp_path):
        from pydcop_tpu_torch.observability.trace import (
            load_trace_file,
            tracer,
        )

        trace_path = str(tmp_path / "shardloss.trace.json")
        tracer.enable()
        try:
            _run(_loopy(seed=4)[1], shards=4,
                 recovery=RecoveryPolicy(trip_shard=((20, 1),)))
        finally:
            tracer.disable()
            tracer.export(trace_path, "chrome")
        events = load_trace_file(trace_path)
        trips = [e for e in events if e["name"] == "guard_trip"]
        assert any(e["args"].get("kind") == "shard_loss"
                   and e["args"].get("shard") == 1 for e in trips)
        rollbacks = [e for e in events
                     if e["name"] == "recovery_rollback"]
        assert any(e["args"].get("action") == "repartition"
                   and e["args"].get("lost_shard") == 1
                   for e in rollbacks)
        segs = [e["args"]["shards"] for e in events
                if e["name"] == "engine_segment"]
        assert 4 in segs and segs[-1] == 3

    def test_flight_recorder_fires_on_shard_loss(self, monkeypatch):
        from pydcop_tpu_torch.observability import flight

        fired = []
        monkeypatch.setattr(
            flight, "trigger",
            lambda kind, force=False, **info: fired.append((kind, info)))
        _run(_loopy(seed=4)[1], shards=3,
             recovery=RecoveryPolicy(trip_shard=((20, 2),)))
        assert [k for k, _ in fired] == ["shard_loss"]
        assert fired[0][1]["shard"] == 2


class TestShardTripExhaustion:
    def test_last_device_loss_exhausts_with_partial(self):
        _, dcop = _loopy(seed=5)
        with pytest.raises(RecoveryExhausted) as err:
            _run(dcop, shards=2, recovery=RecoveryPolicy(
                trip_shard=((10, 1), (11, 0))))
        exc = err.value
        assert "no surviving devices" in str(exc)
        assert exc.partial["assignment"] is not None
        assert set(exc.partial["assignment"]) == \
            {f"v{i}" for i in range(24)}
        assert [v.kind for v in exc.violations] == \
            ["shard_loss", "shard_loss"]
        assert isinstance(exc.__cause__, NoSurvivingDevices)

    def test_unsharded_engine_rejects_trip_shard(self):
        _, dcop = _loopy(seed=6)
        with pytest.raises(ValueError, match="repartition_after_loss"):
            build_engine(dcop, {}, device="cpu").run_checkpointed(
                max_cycles=MAX_CYCLES, segment_cycles=SEGMENT,
                recovery=RecoveryPolicy(trip_shard=((10, 0),)))

    def test_out_of_range_shard_rejected(self):
        _, dcop = _loopy(seed=7)
        with pytest.raises(ValueError, match="out of range"):
            _run(dcop, shards=2,
                 recovery=RecoveryPolicy(trip_shard=((10, 5),)))

    def test_malformed_trip_entry_rejected_at_policy(self):
        with pytest.raises(ValueError, match="cycle, shard"):
            RecoveryPolicy(trip_shard=((10,),))


class TestRepartitionStateRemap:
    def test_remap_preserves_messages_exactly(self):
        _, dcop = _loopy(seed=8)
        engine = build_engine(dcop, {}, shards=4, device="cpu")
        assert isinstance(engine, ShardedMaxSumEngine)
        engine.run(max_cycles=8)
        state, _ = engine._ops.run_maxsum_from(
            engine.graph, engine.init_state(), 8,
            stop_on_convergence=False)
        snap = state
        new_state = engine.repartition_after_loss(2, snap)
        assert engine.mesh.size == 3
        assert engine.partition.n_shards == 3
        old_part = partition_compiled(engine._source_graph, 4)
        old_maps = _factor_row_maps(engine._source_graph, old_part)
        new_maps = _factor_row_maps(engine._source_graph,
                                    engine.partition)

        def gather(blocked, maps, i):
            blocked = blocked.numpy()
            rows, per_shard = maps[i]
            out = np.zeros((rows.shape[0],) + blocked.shape[2:],
                           blocked.dtype)
            for s, sel in enumerate(per_shard):
                out[sel] = blocked[s, :sel.shape[0]]
            return out

        for i in range(len(engine._source_graph.buckets)):
            np.testing.assert_array_equal(
                gather(snap.f2v[i], old_maps, i),
                gather(new_state.f2v[i], new_maps, i))
            np.testing.assert_array_equal(
                gather(snap.v2f[i], old_maps, i),
                gather(new_state.v2f[i], new_maps, i))
        assert int(new_state.cycle) == int(snap.cycle)

    def test_remap_equals_the_reference(self):
        """The same snapshot remapped by both packages after losing the
        same shard: every leaf equal, the recomputed halo included."""
        from pydcop_tpu.engine.sharding import (
            remap_partitioned_state as jax_remap,
        )

        jdcop, dcop = _loopy(seed=9, decades=3)
        jeng = jax_build_engine(jdcop, {}, shards=4)
        teng = build_engine(dcop, {}, shards=4, device="cpu")
        jstate = jax.jit(lambda g, s: jeng._ops.run_maxsum_from(
            g, s, 9, stop_on_convergence=False))(
            jeng.graph, jeng._ops.init_state(jeng.graph))[0]
        tstate, _ = teng._ops.run_maxsum_from(
            teng.graph, teng.init_state(), 9, stop_on_convergence=False)
        assert_same_leaves(jstate, tstate, "before")
        old_jpart = jeng.partition
        jnew = jeng.repartition_after_loss(1, jstate)
        tnew = teng.repartition_after_loss(1, tstate)
        assert_same_leaves(jnew, tnew, "remapped")
        again = jax_remap(jeng._source_graph, old_jpart, jeng.partition,
                          jstate, jeng.graph, jeng._ops)
        assert_same_leaves(again, tnew, "remapped again")


# ------------------------------------------------------------------ #
# sharded snapshots across the two packages


def _leaves(path):
    with np.load(path) as data:
        meta = json.loads(str(data["__meta__"]))
        return [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]


def test_sharded_snapshot_crosses_packages(tmp_path):
    """A sharded snapshot written by the reference resumes in the port,
    and one written by the port resumes in the reference; each resumed
    run equals the uninterrupted runs, and the two packages' snapshots
    of the same cycle hold the same leaves and checksum."""
    jdcop, dcop = _loopy(seed=10, decades=3)
    kw = dict(max_cycles=MAX_CYCLES, segment_cycles=SEGMENT,
              stop_on_convergence=False)
    jfull = jck.CheckpointManager(str(tmp_path / "jfull"), every=SEGMENT,
                                  keep=100)
    tfull = tck.CheckpointManager(str(tmp_path / "tfull"), every=SEGMENT,
                                  keep=100)
    jref = jax_build_engine(jdcop, {}, shards=4).run_checkpointed(
        manager=jfull, **kw)
    tref = build_engine(dcop, {}, shards=4, device="cpu").run_checkpointed(
        manager=tfull, **kw)
    assert (tref.assignment, tref.cycles) == (jref.assignment, jref.cycles)
    jc, tc = jfull.checkpoints(), tfull.checkpoints()
    assert [c for c, _ in jc] == [c for c, _ in tc]
    for (_, jp), (_, tp) in zip(jc, tc):
        assert jck.read_meta(jp)["checksum"] == tck.read_meta(tp)["checksum"]
        for a, b in zip(_leaves(jp), _leaves(tp)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    jpart = str(tmp_path / "jpart")
    tpart = str(tmp_path / "tpart")
    jax_build_engine(jdcop, {}, shards=4).run_checkpointed(
        checkpoint_dir=jpart, max_segments=2, **kw)
    build_engine(dcop, {}, shards=4, device="cpu").run_checkpointed(
        checkpoint_dir=tpart, max_segments=2, **kw)
    in_port = tck.resume_from_checkpoint(
        build_engine(dcop, {}, shards=4, device="cpu"), jpart,
        max_cycles=MAX_CYCLES, stop_on_convergence=False)
    in_jax = jck.resume_from_checkpoint(
        jax_build_engine(jdcop, {}, shards=4), tpart,
        max_cycles=MAX_CYCLES, stop_on_convergence=False)
    for res in (in_port, in_jax):
        assert res.metrics["resumed_from_cycle"] == 2 * SEGMENT
        assert (res.assignment, res.cycles) == (jref.assignment,
                                                jref.cycles)
