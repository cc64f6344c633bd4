"""The port's checkpoint/resume (``resilience/checkpoint.py`` and
``MaxSumEngine.run_checkpointed``) against ``pydcop_tpu`` on the CPU,
mirroring the reference's resilience battery
(``tests/unit/test_resilience_battery.py`` and the integrity tests of
``tests/unit/test_selfheal_battery.py``) on the same small instances,
built by each package from its own objects.

Tolerance: none.  Assignments, cycles and ``converged`` are equal, and
so is every final message: a snapshot's content checksum (sha256 over
every leaf's dtype, shape and bytes) is the same number in both
packages at the same cycle, and loaded snapshots are ``np.array_equal``
leaf by leaf.  Snapshots written by either package resume in the
other.
"""

import json
import os
import subprocess
import sys

import jax  # noqa: F401  (imported first: JAX stays on the CPU)
import numpy as np
import pytest
import torch

import pydcop_tpu.dcop.dcop as jd
import pydcop_tpu.dcop.objects as jo
import pydcop_tpu.dcop.relations as jr
import pydcop_tpu.resilience.checkpoint as jck
import pydcop_tpu_torch.dcop.dcop as td
import pydcop_tpu_torch.dcop.objects as to
import pydcop_tpu_torch.dcop.relations as tr
import pydcop_tpu_torch.resilience.checkpoint as tck
from pydcop_tpu.algorithms.maxsum import build_engine as jax_build_engine
from pydcop_tpu.api import solve as jax_solve
from pydcop_tpu_torch.algorithms.maxsum import build_engine
from pydcop_tpu_torch.api import solve
from pydcop_tpu_torch.engine.runner import DecimationPlan
from pydcop_tpu_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING_KEYS = ("cycles_per_s", "cold_start")
# The reference's XLA cost attribution: in its metrics whenever its
# process-wide profiler is on, which a test run earlier in the same
# process may leave so.
REFERENCE_ONLY = {"xla_cost"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def ring_dcop(objects, relations, dcop_mod, n_vars=6):
    """The battery's loopy ring + one chord (a couple dozen cycles to
    converge: room to interrupt)."""
    d = objects.Domain("c", "", list(range(3)))
    dcop = dcop_mod.DCOP("ckpt", objective="min")
    variables = [objects.Variable(f"v{i}", d) for i in range(n_vars)]
    for v in variables:
        dcop.add_variable(v)
    edges = [(i, (i + 1) % n_vars) for i in range(n_vars)] + [(0, 3)]
    for i, j in edges:
        dcop.add_constraint(relations.constraint_from_str(
            f"c{i}_{j}", f"10 if v{i} == v{j} else 0",
            [variables[i], variables[j]],
        ))
    return dcop


def coloring_dcop(objects, relations, dcop_mod, n=36, seed=1,
                  density=1.6):
    """The work-reduction battery's loopy colouring (no unaries)."""
    rng = np.random.default_rng(seed)
    dom = objects.Domain("c", "", [0, 1, 2])
    dcop = dcop_mod.DCOP(f"col{n}_{seed}", objective="min")
    vs = [objects.Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    eq = np.eye(3)
    seen, k = set(), 0
    while k < int(n * density):
        i, j = rng.choice(n, 2, replace=False)
        key = (min(i, j), max(i, j))
        if key in seen:
            continue
        seen.add(key)
        dcop.add_constraint(
            relations.NAryMatrixRelation([vs[i], vs[j]], eq, f"c{k}"))
        k += 1
    dcop.add_agents([objects.AgentDef("a0")])
    return dcop


def ring_both(**kw):
    return ring_dcop(jo, jr, jd, **kw), ring_dcop(to, tr, td, **kw)


def coloring_both(**kw):
    return coloring_dcop(jo, jr, jd, **kw), coloring_dcop(to, tr, td, **kw)


def engines(dcops, params=None):
    """(JAX engine, port engine on the CPU) of the same problem."""
    jax_dcop, torch_dcop = dcops
    return (jax_build_engine(jax_dcop, dict(params or {})),
            build_engine(torch_dcop, dict(params or {}), device="cpu"))


def assert_same_run(jres, tres, skip=()):
    """Equal outcomes and metric values; the port's metrics are the
    reference's keys plus the device it ran on."""
    assert tres.assignment == jres.assignment
    assert tres.cycles == jres.cycles
    assert tres.converged == jres.converged
    assert set(tres.metrics) == (set(jres.metrics) - REFERENCE_ONLY
                                 | {"device"})
    for key, value in jres.metrics.items():
        if key not in TIMING_KEYS + tuple(skip) + tuple(REFERENCE_ONLY):
            assert tres.metrics[key] == value, key


def checksum(path):
    return tck.read_meta(path)["checksum"]


def leaves_of(path):
    with np.load(path) as data:
        meta = json.loads(str(data["__meta__"]))
        return [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]


def assert_same_snapshots(jax_manager, torch_manager):
    """Every snapshot of both directories: the same cycles, checksums
    and leaves (dtype, shape, bytes)."""
    jc, tc = jax_manager.checkpoints(), torch_manager.checkpoints()
    assert [c for c, _ in jc] == [c for c, _ in tc]
    assert jc
    for (_, jp), (_, tp) in zip(jc, tc):
        assert checksum(jp) == checksum(tp)
        for a, b in zip(leaves_of(jp), leaves_of(tp)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def managers(tmp_path, every, keep=100):
    return (jck.CheckpointManager(str(tmp_path / "jax"), every=every,
                                  keep=keep),
            tck.CheckpointManager(str(tmp_path / "torch"), every=every,
                                  keep=keep))


# ------------------------------------------------------------------ #
# format


def test_state_roundtrip_and_the_reference_checksum(tmp_path):
    """A mid-run state saved by each package: the same leaves in the
    same order with the same dtypes (``cycle`` int32 and ``stable``
    bool, both 0-d), hence the same checksum; the port loads it back
    bit for bit onto its template's device."""
    jeng, teng = engines(coloring_both())
    jstate, _ = jeng._segment_fn(9, False)(jeng.graph, jeng.init_state())
    from pydcop_tpu_torch.ops.maxsum import run_maxsum_from

    tstate, _ = run_maxsum_from(teng.graph, teng.init_state(), 9,
                                stop_on_convergence=False)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_state(jpath, jstate, cycle=9, extra={"tag": "t"})
    tck.save_state(tpath, tstate, cycle=9, extra={"tag": "t"})
    assert checksum(jpath) == checksum(tpath)
    tleaves = leaves_of(tpath)
    assert [str(a.dtype) for a in tleaves[-2:]] == ["bool", "int32"]
    assert [a.shape for a in tleaves[-2:]] == [(), ()]
    loaded, meta = tck.load_state(tpath, teng.init_state())
    assert meta["cycle"] == 9 and meta["extra"] == {"tag": "t"}
    assert meta["n_leaves"] == len(tree_leaves(tstate))
    for a, b in zip(tree_leaves(loaded), tree_leaves(tstate)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def test_manager_prunes_and_finds_latest(tmp_path):
    _, teng = engines(ring_both())
    manager = tck.CheckpointManager(str(tmp_path), every=5, keep=2)
    state = teng.init_state()
    for cycle in (5, 10, 15):
        manager.save(state, cycle)
    assert [c for c, _ in manager.checkpoints()] == [10, 15]
    assert manager.latest().endswith("ckpt_15.npz")
    assert [w["cycle"] for w in manager.writes] == [5, 10, 15]
    assert manager.writes[0]["bytes"] == sum(
        a.nbytes for a in leaves_of(manager.path_for(15)))
    with pytest.raises(ValueError):
        tck.CheckpointManager(str(tmp_path), every=0)
    with pytest.raises(ValueError):
        tck.CheckpointManager(str(tmp_path), keep=0)


def test_latest_skips_corrupt_snapshot(tmp_path):
    _, teng = engines(ring_both())
    manager = tck.CheckpointManager(str(tmp_path), every=5, keep=3)
    manager.save(teng.init_state(), 5)
    with open(manager.path_for(99), "wb") as f:
        f.write(b"not an npz")
    assert manager.latest().endswith("ckpt_5.npz")


def test_flipped_byte_detected(tmp_path):
    _, teng = engines(ring_both())
    manager = tck.CheckpointManager(str(tmp_path), every=5)
    path = manager.save(teng.init_state(), 5)
    assert len(tck.verify_checkpoint(path)["checksum"]) == 64
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        arrays = {k: data[k].copy() for k in data.files if k != "__meta__"}
    arrays["leaf_0"].reshape(-1).view(np.uint8)[0] ^= 0xFF
    with open(path, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **arrays)
    with pytest.raises(tck.CheckpointCorruptError):
        tck.verify_checkpoint(path)
    with pytest.raises(tck.CheckpointCorruptError):
        tck.load_state(path, teng.init_state())
    assert manager.latest() is None


def test_version_leaf_count_and_shape_mismatches_are_refused(tmp_path):
    """A caller error (another format version, another engine state,
    another problem) raises ValueError; it is never taken for
    corruption and skipped."""
    _, teng = engines(ring_both())
    state = teng.init_state()
    path = tck.save_state(str(tmp_path / "s.npz"), state, cycle=0)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    meta["version"] = 2
    bad = str(tmp_path / "v.npz")
    with open(bad, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **arrays)
    with pytest.raises(ValueError, match="version"):
        tck.load_state(bad, state)
    from pydcop_tpu_torch.engine.runner import decimation_template

    with pytest.raises(ValueError, match="leaves"):
        tck.load_state(path, decimation_template(teng, state))
    _, other = engines(ring_both(n_vars=7))
    with pytest.raises(ValueError, match="shape"):
        tck.load_state(path, other.init_state())


# ------------------------------------------------------------------ #
# segmented runs


@pytest.mark.parametrize("every", [7, 100])
def test_segmented_run_equals_single_run_and_jax(tmp_path, every):
    """Segments of 7 (many boundaries) and of 100 (one segment): the
    port's segmented run equals its single run and the reference's
    segmented run, snapshot for snapshot."""
    jeng, teng = engines(coloring_both())
    single = teng.run(max_cycles=100)
    jman, tman = managers(tmp_path, every)
    ref = jeng.run_checkpointed(max_cycles=100, manager=jman,
                                checkpoint_async=False)
    out = teng.run_checkpointed(max_cycles=100, manager=tman,
                                checkpoint_async=False)
    assert_same_run(ref, out)
    assert (out.assignment, out.cycles, out.converged) == (
        single.assignment, single.cycles, single.converged)
    assert out.metrics["segments"] == -(-out.cycles // every)
    assert_same_snapshots(jman, tman)


def test_async_writer_equals_sync_writer(tmp_path):
    """The asynchronous writer writes the same snapshots as the
    synchronous one (and as the reference), all on disk on return."""
    jeng, teng = engines(coloring_both())
    sync_man = tck.CheckpointManager(str(tmp_path / "sync"), every=5,
                                     keep=100)
    teng.run_checkpointed(max_cycles=60, manager=sync_man,
                          checkpoint_async=False,
                          stop_on_convergence=False)
    jman, tman = managers(tmp_path, 5)
    ref = jeng.run_checkpointed(max_cycles=60, manager=jman,
                                stop_on_convergence=False)
    out = teng.run_checkpointed(max_cycles=60, manager=tman,
                                stop_on_convergence=False)
    assert out.metrics["checkpoint_async"] is True
    assert out.metrics["checkpoints_written"] == 12
    assert_same_run(ref, out)
    assert_same_snapshots(jman, tman)
    assert [checksum(p) for _, p in sync_man.checkpoints()] == [
        checksum(p) for _, p in tman.checkpoints()]


@pytest.mark.parametrize("delay", [0.0, 0.5])
def test_async_write_failure_is_raised(tmp_path, monkeypatch, delay):
    """A failed background write surfaces as an error of the run, both
    when the loop meets it at its next submit and when only the final
    flush does (every write slower than the whole run: the reference's
    loop swallows that one)."""
    import time

    _, teng = engines(ring_both())

    def broken(*args, **kwargs):
        time.sleep(delay)
        raise OSError("disk full")

    monkeypatch.setattr(tck, "_save_arrays", broken)
    manager = tck.CheckpointManager(str(tmp_path), every=5)
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        teng.run_checkpointed(max_cycles=10, manager=manager,
                              checkpoint_async=True)


def test_full_writer_queue_blocks_and_is_counted(tmp_path, monkeypatch):
    """With writes slower than segments the bounded queue blocks the
    loop (backpressure, counted in the manager) and nothing is lost."""
    import threading

    _, teng = engines(ring_both())
    gate = threading.Event()
    real = tck._save_arrays

    def slow(*args, **kwargs):
        gate.wait(timeout=10)
        return real(*args, **kwargs)

    monkeypatch.setattr(tck, "_save_arrays", slow)
    manager = tck.CheckpointManager(str(tmp_path), every=1, keep=100)
    writer = tck.AsyncCheckpointWriter(manager, maxsize=1)
    state = teng.init_state()
    timer = threading.Timer(0.3, gate.set)
    timer.start()
    try:
        for cycle in range(1, 5):
            writer.submit(state, cycle)
        writer.close()
    finally:
        timer.cancel()
        gate.set()
    assert manager.blocked >= 1 and manager.blocked_s > 0
    assert [c for c, _ in manager.checkpoints()] == [1, 2, 3, 4]


def test_interrupt_resume_matches_uninterrupted_and_jax(tmp_path):
    """THE determinism criterion: interrupted at a segment boundary and
    resumed by a fresh engine equals the uninterrupted run, as in the
    reference."""
    jdcop, tdcop = ring_both()
    jeng, teng = engines((jdcop, tdcop))
    reference = teng.run(max_cycles=100)
    assert reference.cycles > 5
    manager = tck.CheckpointManager(str(tmp_path), every=5, keep=2)
    partial = teng.run_checkpointed(max_cycles=100, manager=manager,
                                    max_segments=1)
    assert partial.metrics["interrupted"]
    assert partial.cycles == 5
    assert manager.latest().endswith("ckpt_5.npz")
    resumed = tck.resume_from_checkpoint(
        build_engine(tdcop, {}, device="cpu"), manager, max_cycles=100)
    assert resumed.metrics["resumed_from_cycle"] == 5
    assert (resumed.assignment, resumed.cycles, resumed.converged) == (
        reference.assignment, reference.cycles, reference.converged)
    jman = jck.CheckpointManager(str(tmp_path / "jax"), every=5, keep=2)
    jeng.run_checkpointed(max_cycles=100, manager=jman, max_segments=1)
    jres = jck.resume_from_checkpoint(jax_build_engine(jdcop, {}), jman,
                                      max_cycles=100)
    assert_same_run(jres, resumed)
    assert checksum(jman.latest()) == checksum(manager.latest())


def test_resume_without_snapshot_starts_fresh(tmp_path):
    _, teng = engines(ring_both())
    result = tck.resume_from_checkpoint(teng, str(tmp_path),
                                        max_cycles=100)
    assert result.metrics["resumed_from_cycle"] == 0
    assert result.cycles == teng.run(max_cycles=100).cycles


def test_resume_at_the_budget_still_selects_values(tmp_path):
    """A snapshot at the cycle budget resumes into a zero-cycle segment
    that only selects the values (the reference's trick)."""
    jeng, teng = engines(coloring_both())
    jman, tman = managers(tmp_path, 10)
    jeng.run_checkpointed(max_cycles=30, manager=jman,
                          stop_on_convergence=False)
    teng.run_checkpointed(max_cycles=30, manager=tman,
                          stop_on_convergence=False)
    ref = jck.resume_from_checkpoint(jeng, jman, max_cycles=30,
                                     stop_on_convergence=False)
    out = tck.resume_from_checkpoint(teng, tman, max_cycles=30,
                                     stop_on_convergence=False)
    assert out.metrics["resumed_from_cycle"] == 30
    assert out.metrics["segments"] == 1 and out.cycles == 30
    assert_same_run(ref, out)


def test_truncated_newest_falls_back_on_resume(tmp_path):
    jeng, teng = engines(ring_both())
    reference = teng.run(max_cycles=100)
    manager = tck.CheckpointManager(str(tmp_path), every=5, keep=5)
    teng.run_checkpointed(max_cycles=100, manager=manager, max_segments=2)
    newest = manager.path_for(10)
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    resumed = tck.resume_from_checkpoint(teng, manager, max_cycles=100)
    assert resumed.metrics["resumed_from_cycle"] == 5
    assert resumed.assignment == reference.assignment
    assert resumed.cycles == reference.cycles


# ------------------------------------------------------------------ #
# across the two packages


@pytest.mark.parametrize("decimated", [False, True])
def test_jax_snapshot_resumes_in_the_port_and_back(tmp_path, decimated):
    """A snapshot written by the reference resumes in the port, and one
    written by the port resumes in the reference; each resumed run
    equals the other package's uninterrupted run, with the same final
    checksum (a decimated run's snapshots carry the clamp set too)."""
    jeng, teng = engines(coloring_both())
    kw = dict(max_cycles=400, segment_cycles=10)
    jkw, tkw = dict(kw), dict(kw)
    if decimated:
        from pydcop_tpu.engine.runner import DecimationPlan as JaxPlan

        jkw["decimation"] = JaxPlan(frac_per_round=0.2,
                                    cycles_per_round=10)
        tkw["decimation"] = DecimationPlan(frac_per_round=0.2,
                                           cycles_per_round=10)
    jfull, tfull = managers(tmp_path / "full", 10)
    jref = jeng.run_checkpointed(manager=jfull, **jkw)
    tref = teng.run_checkpointed(manager=tfull, **tkw)
    assert_same_run(jref, tref)
    assert_same_snapshots(jfull, tfull)

    jpart, tpart = managers(tmp_path / "part", 10)
    jeng.run_checkpointed(manager=jpart, max_segments=2, **jkw)
    teng.run_checkpointed(manager=tpart, max_segments=2, **tkw)
    # Cross over: the port resumes the reference's snapshot, and the
    # reference the port's.
    in_port = tck.resume_from_checkpoint(teng, jpart.directory, **tkw)
    in_jax = jck.resume_from_checkpoint(jeng, tpart.directory, **jkw)
    for res in (in_port, in_jax):
        assert res.metrics["resumed_from_cycle"] == 20
        assert (res.assignment, res.cycles, res.converged) == (
            jref.assignment, jref.cycles, jref.converged)
    final = f"ckpt_{jref.cycles}.npz"
    assert checksum(os.path.join(jpart.directory, final)) == checksum(
        os.path.join(tpart.directory, final)) == checksum(
        jfull.path_for(jref.cycles))


# ------------------------------------------------------------------ #
# entry points


def test_api_solve_checkpointed_and_resumed(tmp_path):
    jdcop, tdcop = ring_both()
    ref = jax_solve(jdcop, "maxsum", max_cycles=100,
                    checkpoint_dir=str(tmp_path / "jax"),
                    checkpoint_every=10)
    res = solve(tdcop, "maxsum", max_cycles=100,
                checkpoint_dir=str(tmp_path / "torch"),
                checkpoint_every=10, device="cpu")
    for key in ("assignment", "cost", "cycles", "status", "violations"):
        assert res[key] == ref[key], key
    assert set(res) == set(ref)
    assert res["metrics"]["checkpoints_written"] == ref["metrics"][
        "checkpoints_written"]
    assert (tmp_path / "torch" / f"ckpt_{res['cycles']}.npz").exists()
    again = solve(tdcop, "maxsum", max_cycles=100,
                  checkpoint_dir=str(tmp_path / "torch"),
                  checkpoint_every=10, resume=True, device="cpu")
    assert again["assignment"] == res["assignment"]
    assert again["metrics"]["resumed_from_cycle"] == res["cycles"]
    with pytest.raises(ValueError, match="checkpoint_dir"):
        solve(tdcop, "maxsum", resume=True, device="cpu")


def test_api_solve_checkpoint_options_raise_without_a_card():
    dcop = ring_both()[1]
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(dcop, "maxsum", max_cycles=10, checkpoint_dir="unused")


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "pydcop_tpu_torch", "solve", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


def test_cli_checkpoint_and_resume_flags(tmp_path):
    """``--checkpoint_dir --checkpoint_every --no-checkpoint_async
    --checkpoint_keep`` then ``--resume``: the reference's result, the
    kept snapshots, and a resume that reproduces it."""
    path = os.path.join(REPO, "tests", "instances", "coloring_12_3.yml")
    ck = str(tmp_path / "ck")
    out = _cli("-a", "maxsum", "-c", "60", "--device", "cpu",
               "--checkpoint_dir", ck, "--checkpoint_every", "20",
               "--no-checkpoint_async", "--checkpoint_keep", "3", path)
    from test_torch_compile import load_both

    ref = jax_solve(load_both("coloring_12_3.yml")[0], "maxsum",
                    max_cycles=60, checkpoint_dir=str(tmp_path / "j"),
                    checkpoint_every=20)
    assert out["cost"] == ref["cost"] == 5000.0
    assert out["assignment"] == ref["assignment"]
    assert out["cycle"] == ref["cycles"]
    assert sorted(os.listdir(ck)) == ["ckpt_20.npz", "ckpt_40.npz",
                                      "ckpt_60.npz"]
    again = _cli("-a", "maxsum", "-c", "60", "--device", "cpu",
                 "--checkpoint_dir", ck, "--resume", path)
    assert again["assignment"] == out["assignment"]
    assert again["cycle"] == out["cycle"]
