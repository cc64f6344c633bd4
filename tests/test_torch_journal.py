"""The port's request journal (``pydcop_tpu_torch/serving/journal.py``)
against the JAX package's: the record format is byte for byte the
reference's, and a journal either package's service writes, the other
package's service replays (``recover=True``).

Tolerance: none.  Encoded records are equal bytes; a replayed request
finishes with the assignment, cost and cycles the replaying package's
solo solve gives — and the writing package's too; a request the writer
finished resolves from the journal with the writer's result; a session
the writer parked (its open and event records and its checkpoint NPZ)
resumes in the reader, and closes with the final result the writer's
own recovery of the same journal gives.
"""

import os
import shutil
import threading

import pytest
import torch

import torch_serving_common as common

PARAMS = {"max_cycles": 40}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _cold_dispatch_caches(monkeypatch, tmp_path):
    """Both packages' dispatch caches empty, a private autotune cache,
    and the pack model's online fit isolated
    (``torch_serving_common.isolated``)."""
    with common.isolated(monkeypatch, tmp_path):
        yield


def _journal_mod(pkg):
    if pkg == "jax":
        import pydcop_tpu.serving.journal as mod
    else:
        import pydcop_tpu_torch.serving.journal as mod
    return mod


RECORDS = [
    ("accepted_record", ("r1", "name: x\n", {"max_cycles": 5}),
     {"deadline_s": 2.5, "t_submit": 12.0, "trace_id": "abc"}),
    ("completed_record", ("r1", "FINISHED"),
     {"result": {"id": "r1", "cost": 3.0, "assignment": {"v0": 1}}}),
    ("completed_record", ("r2", "ERROR"), {}),
    ("session_open_record", ("s1", "name: y\n", {"segment_cycles": 7}),
     {"trace_id": "t", "epoch": 3}),
    ("session_event_record",
     ("s1", 4, [{"type": "remove_factor", "name": "c1"}]),
     {"trace_id": "u"}),
    ("session_ckpt_record", ("s1", 4, "/x/session_s1.npz"),
     {"cycle": 90, "dcop": "name: z\n"}),
    ("session_close_record", ("s1", "CLOSED"), {}),
]


@pytest.mark.parametrize("name,args,kw", RECORDS,
                         ids=[f"{r[0]}-{i}" for i, r in enumerate(RECORDS)])
def test_records_encode_to_the_reference_bytes(name, args, kw):
    encoded = [_journal_mod(pkg).encode_record(
        getattr(_journal_mod(pkg), name)(*args, **kw))
        for pkg in common.PACKAGES]
    assert encoded[0] == encoded[1]


def _blocked_service(pkg, journal_dir):
    """A journaled service whose device call waits on a gate: requests
    submitted while it waits stay accepted-and-unfinished."""
    svc = common.make_service(pkg, batch_window_s=0.01, max_batch=8,
                              journal_dir=journal_dir, speculate=False)
    gate = threading.Event()
    entered = threading.Event()
    real = svc._run_batch

    def blocked(reqs, params, **kw):
        entered.set()
        gate.wait(60)
        return real(reqs, params, **kw)

    svc._run_batch = blocked
    return svc, gate, entered


def _write_crashed_journal(pkg, journal_dir):
    """Two requests finished, three accepted and left unfinished by a
    stop without drain; returns ``(yamls by id, finished results)``."""
    yamls = {f"done{i}": common.ring_yaml(9, i) for i in range(2)}
    yamls.update({f"left{i}": common.ring_yaml(11, 20 + i)
                  for i in range(3)})
    svc = common.make_service(pkg, batch_window_s=0.01,
                              journal_dir=journal_dir,
                              speculate=False).start()
    finished = {}
    try:
        for rid in ("done0", "done1"):
            svc.submit(common.load(pkg, yamls[rid]), params=PARAMS,
                       request_id=rid)
            finished[rid] = svc.result(rid, wait=120)
            assert finished[rid]["status"] == "FINISHED"
    finally:
        svc.stop(drain=False)
    svc, gate, entered = _blocked_service(pkg, journal_dir)
    svc.start()
    scheduler = svc._scheduler._thread
    try:
        svc.submit(common.load(pkg, yamls["left0"]), params=PARAMS,
                   request_id="left0")
        assert entered.wait(60), "the blocked dispatch never started"
        for rid in ("left1", "left2"):
            svc.submit(common.load(pkg, yamls[rid]), params=PARAMS,
                       request_id=rid)
        summary = svc.stop(drain=False, timeout=0.5)
        assert summary["replayable"] == 3, summary
    finally:
        gate.set()
        scheduler.join(60)
    assert not scheduler.is_alive()
    return yamls, finished


@pytest.mark.parametrize("writer,reader",
                         [("jax", "torch"), ("torch", "jax")])
def test_request_journal_replays_across_packages(tmp_path, writer,
                                                  reader):
    d = str(tmp_path / "journal")
    yamls, finished = _write_crashed_journal(writer, d)
    svc = common.make_service(reader, batch_window_s=0.05,
                              journal_dir=d, recover=True,
                              speculate=False).start()
    try:
        replayed = {rid: svc.result(rid, wait=120)
                    for rid in ("left0", "left1", "left2")}
        recovered = {rid: svc.result(rid) for rid in finished}
        assert svc.stats()["replayed"] == 3
    finally:
        svc.stop(drain=False)
    solos = {pkg: common.serve_stream(
        pkg, [yamls[r] for r in sorted(replayed)], params=PARAMS,
        batch_window_s=0.01, max_batch=1)[0]
        for pkg in common.PACKAGES}
    for i, rid in enumerate(sorted(replayed)):
        got = replayed[rid]
        assert got["status"] == "FINISHED", got
        for pkg in common.PACKAGES:
            assert common.key_fields(got) == \
                common.key_fields(solos[pkg][i]), (rid, pkg)
    for rid, result in finished.items():
        assert recovered[rid] == result


def _session_events(yaml_src, n_events, seed):
    """Seeded change_factor batches over the problem's factors."""
    import numpy as np

    dcop = common.load("torch", yaml_src)
    names = sorted(dcop.constraints)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_events):
        name = names[int(rng.integers(len(names)))]
        table = rng.integers(0, 10, size=(3, 3)).astype(float)
        batches.append([{"type": "change_factor", "name": name,
                         "table": table.tolist()}])
    return batches


def _park_session(pkg, journal_dir, yaml_src, batches):
    """Open a journaled session, apply the batches (waiting for each
    post-event segment) with a checkpoint after the second, stop: the
    session is parked REPLAYABLE with its checkpoint NPZ."""
    svc = common.make_service(pkg, batch_window_s=0.01,
                              journal_dir=journal_dir, speculate=False,
                              session_checkpoint_every_events=2).start()
    try:
        sess = svc.sessions.open(
            common.load(pkg, yaml_src),
            params={"max_cycles": 60, "segment_cycles": 60,
                    "noise": 0.0},
            session_id="s1")
        for batch in batches:
            out = svc.sessions.apply_events(sess.id, batch, wait=120)
            assert out["applied"], out
    finally:
        summary = svc.stop(drain=False)
    assert summary["parked_sessions"] == 1
    assert os.path.exists(os.path.join(journal_dir, "session_s1.npz"))


def _resume_and_close(pkg, journal_dir, extra):
    svc = common.make_service(pkg, batch_window_s=0.01,
                              journal_dir=journal_dir, recover=True,
                              speculate=False).start()
    try:
        status = svc.sessions.status("s1")
        assert status["replayed"] and status["seq"] == 3, status
        out = svc.sessions.apply_events("s1", extra, wait=120)
        assert out["applied"], out
        return svc.sessions.close("s1", wait=120), out["result"]
    finally:
        svc.stop(drain=False)


@pytest.mark.parametrize("writer,reader",
                         [("jax", "torch"), ("torch", "jax")])
def test_session_journal_and_checkpoint_resume_across_packages(
        tmp_path, writer, reader):
    """The writer parks a session (open + 3 event batches, checkpoint
    NPZ after the second); the reader's recovery resumes it from the
    writer's journal and NPZ, takes one more batch and closes with the
    final result the writer's own recovery gives."""
    yaml_src = common.small_yaml(48, 0)
    batches = _session_events(yaml_src, 4, seed=1306)
    d = str(tmp_path / "journal")
    _park_session(writer, d, yaml_src, batches[:3])
    copy = str(tmp_path / "copy")
    shutil.copytree(d, copy)
    final_reader, seg_reader = _resume_and_close(reader, d, batches[3])
    # The checkpoint record holds the NPZ's path under ``d``, and the
    # close retired it: put the writer's snapshot back for the second
    # recovery.
    shutil.copy(os.path.join(copy, "session_s1.npz"),
                os.path.join(d, "session_s1.npz"))
    final_writer, seg_writer = _resume_and_close(writer, copy,
                                                 batches[3])
    for key in ("status", "assignment", "cost", "cycles", "converged",
                "events_applied", "event_batches"):
        assert final_reader[key] == final_writer[key], key
    for key in ("cycle", "cost", "assignment", "converged"):
        assert seg_reader[key] == seg_writer[key], key
    assert final_reader["status"] == "CLOSED"
