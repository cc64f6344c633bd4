"""The port's guarded segments (``resilience/recovery.py`` and the
guard of ``MaxSumEngine.run_checkpointed``) against ``pydcop_tpu`` on
the CPU, mirroring the reference's self-heal battery
(``tests/unit/test_selfheal_battery.py``, guarded segments) on the same
instances, built by each package from its own objects.

Tolerance: none.  A guarded run equals the reference's in assignment,
cycles, ``converged``, every recovery metric (trips, attempts, actions,
violations), the engine's final damping and every final message (the
last snapshot's content checksum), through the whole escalation ladder:
the reseed noise is ``jax.random``'s, bit for bit.
"""

import json
import os
import subprocess
import sys

import jax  # noqa: F401  (imported first: JAX stays on the CPU)
import numpy as np
import pytest
import torch

import pydcop_tpu.resilience.recovery as jrec
import pydcop_tpu_torch.resilience.checkpoint as tck
import pydcop_tpu_torch.resilience.recovery as trec
from pydcop_tpu.api import solve as jax_solve
from pydcop_tpu_torch.api import solve
from pydcop_tpu_torch.ops import maxsum as ops
from pydcop_tpu_torch.utils.tree import tree_leaves
from test_torch_checkpoint import (
    REPO,
    assert_same_run,
    checksum,
    coloring_both,
    engines,
    managers,
    ring_both,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def guarded_both(tmp_path, dcops, jpolicy, tpolicy, **kw):
    """(reference result, port result, their final checksums, their
    engines' final damping) of the same guarded run with snapshots."""
    jeng, teng = engines(dcops)
    jman, tman = managers(tmp_path, kw.get("segment_cycles", 7), keep=1)
    ref = jeng.run_checkpointed(manager=jman, checkpoint_async=False,
                                recovery=jpolicy, **kw)
    out = teng.run_checkpointed(manager=tman, checkpoint_async=False,
                                recovery=tpolicy, **kw)
    return (ref, out, checksum(jman.latest()), checksum(tman.latest()),
            jeng.damping, teng.damping)


def test_no_trip_is_bit_identical_to_unguarded(tmp_path):
    """Guards are pure reads: with nothing injected the guarded run's
    final snapshot is the unguarded one's, byte for byte, and the
    reference's."""
    jeng, teng = engines(ring_both())
    plain = tck.CheckpointManager(str(tmp_path / "plain"), every=7)
    ref = teng.run_checkpointed(max_cycles=100, manager=plain,
                                checkpoint_async=False)
    jout, out, jsum, tsum, _, _ = guarded_both(
        tmp_path, ring_both(), jrec.RecoveryPolicy(),
        trec.RecoveryPolicy(), max_cycles=100, segment_cycles=7)
    assert out.metrics["guard_trips"] == 0
    assert (out.assignment, out.cycles, out.converged) == (
        ref.assignment, ref.cycles, ref.converged)
    assert tsum == checksum(plain.latest()) == jsum
    assert_same_run(jout, out)


@pytest.mark.parametrize("trips,stop,max_cycles", [
    ((14,), True, 120),
    ((7, 7), True, 200),
    ((20, 40, 60), False, 120),
    ((14, 14, 14, 28), False, 120),
])
def test_injected_trips_walk_the_ladder_like_jax(tmp_path, trips, stop,
                                                 max_cycles):
    """One trip (reseed), two at the same boundary (reseed, then the
    damping bump), and the whole ladder (reseed, bump, both; a fourth
    attempt at max_restarts=4): assignment, cycles, every metric,
    every final message and the bumped damping equal the reference's."""
    dcops = coloring_both(n=60, seed=3)
    jout, out, jsum, tsum, jdamp, tdamp = guarded_both(
        tmp_path, dcops,
        jrec.RecoveryPolicy(trip_cycles=trips, max_restarts=4),
        trec.RecoveryPolicy(trip_cycles=trips, max_restarts=4),
        max_cycles=max_cycles, segment_cycles=7,
        stop_on_convergence=stop)
    assert_same_run(jout, out)
    assert out.metrics["guard_trips"] == len(trips)
    assert out.metrics["recovery_actions"][:2] == [
        "reseed_noise", "damping_bump"][:len(trips)]
    assert tsum == jsum
    assert tdamp == jdamp
    if len(trips) > 1:
        assert tdamp == pytest.approx(min(0.5 + 0.2 * (len(trips) - 1),
                                          0.95))


def test_budget_exhaustion_carries_the_reference_partial():
    kw = dict(max_cycles=200, segment_cycles=7, stop_on_convergence=False)
    errs = []
    for eng, mod in zip(engines(ring_both()), (jrec, trec)):
        with pytest.raises(mod.RecoveryExhausted) as exc:
            eng.run_checkpointed(recovery=mod.RecoveryPolicy(
                trip_cycles=(14,) * 6, max_restarts=2), **kw)
        errs.append(exc.value)
    ref, err = errs
    assert err.attempts == ref.attempts == 3
    assert [v.as_dict() for v in err.violations] == [
        v.as_dict() for v in ref.violations]
    assert err.partial == ref.partial
    assert err.partial["cycle"] == 7
    assert set(err.partial["assignment"]) == {f"v{i}" for i in range(6)}


def test_nan_guard_detects_a_poisoned_state():
    _, teng = engines(ring_both())
    state = teng.init_state()
    values = torch.zeros((len(teng.meta.var_names),), dtype=torch.int32)
    # All six variables on one colour: seven violated constraints.
    assert teng._guard(teng.graph, state, values, True) == (True, 70.0)
    assert teng._guard(teng.graph, state, values, False) == (True, 0.0)
    v2f = list(state.v2f)
    v2f[0] = v2f[0].clone()
    v2f[0][0, 0, 0] = float("nan")
    poisoned = state._replace(v2f=tuple(v2f))
    finite, _ = teng._guard(teng.graph, poisoned, values, False)
    assert not finite
    rec = trec.RecoveryRun(trec.RecoveryPolicy(), teng)
    assert rec.check(7, finite, 0.0).kind == "nonfinite"


def test_planted_nan_rolls_back_like_jax(tmp_path, monkeypatch):
    """A NaN planted in the state at the end of the segment ending at
    cycle 14 trips the port's nonfinite guard; the reference, told the
    same verdict there, rolls back the same way: the recovered runs
    are equal to the last message."""
    planted = []
    real = ops.run_maxsum_from

    def poisoned(graph, state, extra, **kwargs):
        state, values = real(graph, state, extra, **kwargs)
        if not planted and int(state.cycle) == 14:
            f2v = list(state.f2v)
            f2v[0] = f2v[0].clone()
            f2v[0][1, 0, 0] = float("nan")
            state = state._replace(f2v=tuple(f2v))
            planted.append(14)
        return state, values

    real_check = jrec.RecoveryRun.check
    told = []

    def nan_once_check(self, end_cycle, finite, cost):
        if not told and end_cycle >= 14:
            told.append(end_cycle)
            return jrec.GuardViolation("nonfinite", end_cycle,
                                       "NaN/Inf in solver state")
        return real_check(self, end_cycle, finite, cost)

    monkeypatch.setattr(ops, "run_maxsum_from", poisoned)
    monkeypatch.setattr(jrec.RecoveryRun, "check", nan_once_check)
    jout, out, jsum, tsum, _, _ = guarded_both(
        tmp_path, coloring_both(n=60, seed=3), jrec.RecoveryPolicy(),
        trec.RecoveryPolicy(), max_cycles=120, segment_cycles=7)
    assert planted == [14] and told == [14]
    assert out.metrics["guard_violations"] == [
        {"kind": "nonfinite", "cycle": 14,
         "detail": "NaN/Inf in solver state"}]
    assert_same_run(jout, out)
    assert tsum == jsum


def test_retained_snapshot_survives_the_next_segment(monkeypatch):
    """Nothing in a segment writes into a state tensor: the retained
    (uncopied) snapshot still holds, at rollback, the bytes it held
    when it was validated."""
    _, teng = engines(coloring_both(n=60, seed=3))
    seen = {}
    real_retain = trec.RecoveryRun.retain
    real_rollback = trec.RecoveryRun.rollback

    def retain(self, state, values):
        real_retain(self, state, values)
        seen[int(state.cycle)] = [t.clone() for t in
                                  tree_leaves(state)]

    def rollback(self, violation):
        kept = seen[self.snapshot_cycle]
        for a, b in zip(tree_leaves(self.snapshot_state), kept):
            assert torch.equal(a, b)
        seen["checked"] = self.snapshot_cycle
        return real_rollback(self, violation)

    monkeypatch.setattr(trec.RecoveryRun, "retain", retain)
    monkeypatch.setattr(trec.RecoveryRun, "rollback", rollback)
    teng.run_checkpointed(max_cycles=60, segment_cycles=7,
                          stop_on_convergence=False,
                          recovery=trec.RecoveryPolicy(trip_cycles=(28,)))
    assert seen["checked"] == 21


def test_divergence_window_verdicts_equal_jax():
    jeng, teng = engines(ring_both())
    policy = dict(divergence_window=3, divergence_factor=2.0)
    ref = jrec.RecoveryRun(jrec.RecoveryPolicy(**policy), jeng)
    rec = trec.RecoveryRun(trec.RecoveryPolicy(**policy), teng)
    costs = [(10, 10.0), (20, 12.0), (30, 15.0), (40, 50.0), (50, 30.0),
             (60, 40.0), (70, float("inf"))]
    verdicts = [(rec.check(c, True, v), ref.check(c, True, v))
                for c, v in costs]
    for got, want in verdicts:
        assert (got is None) == (want is None)
        if got is not None:
            assert got.as_dict() == want.as_dict()
    assert verdicts[5][0].kind == "divergence"


def test_divergence_guard_in_a_run_equals_jax():
    """A window that every cost exceeds (negative slack) trips the
    divergence guard on every boundary once the window fills, until
    the budget is spent: the same violations and partial as the
    reference."""
    kw = dict(max_cycles=100, segment_cycles=5, stop_on_convergence=False)
    policy = dict(divergence_window=2, divergence_slack=-1.0,
                  max_restarts=2)
    errs = []
    for eng, mod in zip(engines(ring_both()), (jrec, trec)):
        with pytest.raises(mod.RecoveryExhausted) as exc:
            eng.run_checkpointed(recovery=mod.RecoveryPolicy(**policy),
                                 **kw)
        errs.append(exc.value)
    ref, err = errs
    assert [v.as_dict() for v in err.violations] == [
        v.as_dict() for v in ref.violations]
    assert {v.kind for v in err.violations} == {"divergence"}
    assert err.partial == ref.partial


def test_policy_checks():
    with pytest.raises(ValueError):
        trec.RecoveryPolicy(max_restarts=-1)
    with pytest.raises(ValueError):
        trec.RecoveryPolicy(noise_scale=-1.0)
    # trip_shard takes (cycle, shard) pairs, as the reference's does
    # (the device-loss path itself: tests/test_torch_shardloss.py).
    with pytest.raises(ValueError, match="cycle, shard"):
        trec.RecoveryPolicy(trip_shard=((10,),))
    assert trec.RecoveryPolicy(trip_shard=((10, 1),)).trip_shard == (
        (10, 1),)
    assert [trec.RecoveryPolicy().action_for(a) for a in (1, 2, 3, 4)] == [
        jrec.RecoveryPolicy().action_for(a) for a in (1, 2, 3, 4)]


def test_perturb_state_is_seeded_and_clears_stable():
    _, teng = engines(ring_both())
    state = teng.init_state()._replace(stable=torch.tensor(True))
    p1 = trec.perturb_state(state, 1e-3, seed=7)
    p2 = trec.perturb_state(state, 1e-3, seed=7)
    p3 = trec.perturb_state(state, 1e-3, seed=8)
    assert not bool(p1.stable)
    l1, l2, l3 = (tree_leaves(p) for p in (p1, p2, p3))
    assert all(torch.equal(a, b) for a, b in zip(l1, l2))
    assert any(not torch.equal(a, b) for a, b in zip(l1, l3))


def test_api_solve_with_recovery_equals_jax():
    jdcop, tdcop = ring_both()
    plain = solve(tdcop, "maxsum", max_cycles=100, device="cpu")
    ref = jax_solve(jdcop, "maxsum", max_cycles=100,
                    recovery=jrec.RecoveryPolicy(trip_cycles=(30,)))
    res = solve(tdcop, "maxsum", max_cycles=100, device="cpu",
                recovery=trec.RecoveryPolicy(trip_cycles=(30,)))
    for key in ("assignment", "cost", "cycles", "status"):
        assert res[key] == ref[key], key
    for key in ("guard_trips", "recovery_actions", "segment_cycles",
                "segments"):
        assert res["metrics"][key] == ref["metrics"][key], key
    quiet = solve(tdcop, "maxsum", max_cycles=100, device="cpu",
                  recovery=trec.RecoveryPolicy())
    assert quiet["assignment"] == plain["assignment"]
    assert quiet["metrics"]["guard_trips"] == 0


def test_cli_recovery_flags():
    path = os.path.join(REPO, "tests", "instances", "coloring_12_3.yml")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", "-a", "maxsum",
         "-c", "60", "--device", "cpu", "--recovery",
         "--recovery_max_restarts", "2", "--recovery_noise", "0.01",
         "--recovery_damping_bump", "0.1", path],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    from test_torch_compile import load_both

    ref = jax_solve(load_both("coloring_12_3.yml")[0], "maxsum",
                    max_cycles=60, recovery=jrec.RecoveryPolicy(
                        max_restarts=2, noise_scale=0.01,
                        damping_bump=0.1))
    assert out["cost"] == ref["cost"] == 5000.0
    assert out["assignment"] == ref["assignment"]
    assert out["cycle"] == ref["cycles"]
    assert np.isfinite(out["time"])
