"""The reference's ``tests/unit/test_ftserve_battery.py``, case for
case, against the port (``pydcop_tpu_torch``) on the CPU: every
service, engine and front end runs with ``device="cpu"``.  The
reference's text:

Battery for the fault-tolerant request plane:

- the durable request journal (length-prefixed + crc32 records, torn
  tails truncated past the last valid record, compaction on recovery);
- crash recovery: ``recover=True`` replays exactly the
  accepted-but-unfinished entries through the normal queue, completed
  work never resurrects, unloadable records fail terminally instead
  of replaying forever;
- per-request deadlines: already-expired work is dropped before
  binning (terminal EXPIRED, ``rejected_deadline`` in the ledger,
  504 on the wire) and never contaminates a fresh batch;
- poison isolation: a failed multi-request bin dispatch bisects until
  the poison request fails ALONE and its bin-mates succeed, with
  ``pydcop_serve_dispatch_retries_total`` accounting and the breaker
  fed only by the isolated singleton failure;
- graceful drain under concurrent load: 6 submitter threads racing
  ``stop(drain=True)`` — every acknowledged request either completes
  or stays journaled-replayable, zero lost, zero duplicated;
- the front-end regression: a malformed ``timeout``/``deadline_s``
  in the POST /solve body is a 400 (``rejected_bad_request``), never
  a silent coercion to the default.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.dcop.objects import AgentDef, Domain, Variable
from pydcop_tpu_torch.dcop.relations import NAryMatrixRelation
from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml
from pydcop_tpu_torch.serving.journal import (
    RequestJournal,
    accepted_record,
    completed_record,
    encode_record,
    pending_requests,
    scan_journal,
)
from pydcop_tpu_torch.serving.service import SolveService

import torch_serving_common as common


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread: the suite runs in several worker
    processes on one host."""
    import torch

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


MAX_CYCLES = 40
PARAMS = {"max_cycles": MAX_CYCLES}


def _instance(n: int, seed: int) -> DCOP:
    """Ring coloring with random tables: same n -> same structure
    bin; seed varies the tables.  Carries an agent so the instance
    survives the journal's dcop_yaml round-trip."""
    rng = np.random.default_rng(seed)
    dom = Domain("c", "", [0, 1, 2])
    dcop = DCOP(f"ft{n}_{seed}", objective="min")
    vs = [Variable(f"v{i}", dom) for i in range(n)]
    for v in vs:
        dcop.add_variable(v)
    for k, (i, j) in enumerate(
            [(i, (i + 1) % n) for i in range(n)]):
        table = rng.integers(0, 10, size=(3, 3)).astype(float)
        dcop.add_constraint(
            NAryMatrixRelation([vs[i], vs[j]], table, f"c{k}"))
    dcop.add_agents([AgentDef("a0")])
    return dcop


def _service(**kw) -> SolveService:
    kw.setdefault("batch_window_s", 0.05)
    kw.setdefault("max_batch", 8)
    return SolveService(**kw, device="cpu")


def _wait_done(svc, rid, timeout=30.0):
    result = svc.result(rid, wait=timeout)
    assert result is not None, f"request {rid} never finished"
    return result


# ------------------------------------------------------------------ #
# journal file format


class TestJournalFormat:
    def test_roundtrip_scan(self, tmp_path):
        path = str(tmp_path / "requests.jnl")
        recs = [accepted_record("a", "yaml: 1", {"max_cycles": 10}),
                completed_record("a", "FINISHED"),
                accepted_record("b", "yaml: 2", {},
                                deadline_s=2.5, t_submit=1.0)]
        with open(path, "wb") as f:
            for rec in recs:
                f.write(encode_record(rec))
        out, valid, torn = scan_journal(path)
        assert out == recs
        assert valid == os.path.getsize(path)
        assert not torn

    def test_missing_file_is_empty_journal(self, tmp_path):
        out, valid, torn = scan_journal(str(tmp_path / "nope.jnl"))
        assert out == [] and valid == 0 and not torn

    @pytest.mark.parametrize("tail", [
        b"\xff",                       # lone garbage byte
        b"\x00\x00\x00\x08\x00\x00",   # header cut mid-way
        encode_record({"kind": "accepted", "id": "t"})[:-3],  # torn
        b"\x00\x00\x00\x04\xde\xad\xbe\xefABCD",  # crc mismatch
        b"\xff\xff\xff\xff\x00\x00\x00\x00",      # absurd length
    ])
    def test_torn_tail_detected_and_bounded(self, tmp_path, tail):
        """Every corruption class truncates to the last VALID record
        — the prefix is never lost, the tail never parses."""
        path = str(tmp_path / "requests.jnl")
        good = [accepted_record("a", "y", {}),
                accepted_record("b", "y", {})]
        blob = b"".join(encode_record(r) for r in good)
        with open(path, "wb") as f:
            f.write(blob + tail)
        out, valid, torn = scan_journal(path)
        assert out == good
        assert valid == len(blob)
        assert torn

    def test_pending_set_semantics(self):
        recs = [accepted_record("a", "y", {}),
                accepted_record("b", "y", {}),
                completed_record("a", "FINISHED"),
                accepted_record("c", "y", {}),
                completed_record("zombie", "ERROR")]
        pending = pending_requests(recs)
        assert [r["id"] for r in pending] == ["b", "c"]

    def test_recover_truncates_and_compacts(self, tmp_path):
        d = str(tmp_path)
        jnl = RequestJournal(d)
        jnl.append(accepted_record("a", "y", {}))
        jnl.append(accepted_record("b", "y", {}))
        jnl.append(completed_record("a", "FINISHED"))
        jnl.close()
        with open(jnl.path, "ab") as f:
            f.write(b"torn-mid-append")
        jnl2, pending = RequestJournal.recover(d)
        assert [r["id"] for r in pending] == ["b"]
        jnl2.close()
        # Compacted: only the pending record survives on disk, the
        # torn tail is gone; a second recovery sees the same set.
        out, _, torn = scan_journal(jnl2.path)
        assert [r["id"] for r in out] == ["b"] and not torn
        jnl3, pending2 = RequestJournal.recover(d)
        jnl3.close()
        assert [r["id"] for r in pending2] == ["b"]

    def test_append_after_close_raises(self, tmp_path):
        jnl = RequestJournal(str(tmp_path))
        jnl.close()
        with pytest.raises(RuntimeError):
            jnl.append(accepted_record("a", "y", {}))


# ------------------------------------------------------------------ #
# service-side journaling + crash recovery replay


class TestJournalRecovery:
    def test_submit_journals_before_ack(self, tmp_path):
        d = str(tmp_path)
        svc = _service(journal_dir=d)
        svc.start()
        try:
            rid = svc.submit(_instance(8, 0), params=PARAMS)
            # The accepted record is on disk the moment submit
            # returns — that IS the durability promise behind the 202.
            recs, _, _ = scan_journal(svc._journal.path)
            assert [r for r in recs
                    if r["kind"] == "accepted" and r["id"] == rid]
            result = _wait_done(svc, rid)
            assert result["status"] == "FINISHED"
            recs, _, _ = scan_journal(svc._journal.path)
            assert [r for r in recs
                    if r["kind"] == "completed" and r["id"] == rid]
        finally:
            svc.stop(drain=False)

    def test_crash_replay_loses_zero_acknowledged(self, tmp_path):
        """Crash-equivalent journal (accepted records, one completed,
        a torn tail) + ``recover=True``: exactly the unfinished
        requests replay through the queue, complete with their
        ORIGINAL ids, and match the solo solve."""
        from pydcop_tpu_torch import api

        d = str(tmp_path)
        dcops = {f"q{i}": _instance(8, 10 + i) for i in range(4)}
        jnl = RequestJournal(d)
        for rid, dcop in dcops.items():
            jnl.append(accepted_record(rid, dcop_yaml(dcop), PARAMS))
        jnl.append(completed_record("q0", "FINISHED"))
        jnl.close()
        with open(jnl.path, "ab") as f:
            f.write(b"\x00\x00\x00\x09torn")
        svc = _service(journal_dir=d, recover=True)
        svc.start()
        try:
            for rid in ("q1", "q2", "q3"):
                result = _wait_done(svc, rid)
                assert result["status"] == "FINISHED"
                solo = api.solve(dcops[rid], "maxsum",
                                 max_cycles=MAX_CYCLES, device="cpu")
                assert result["assignment"] == solo["assignment"]
            # The pre-crash completion must NOT resurrect.
            with pytest.raises(KeyError):
                svc.result("q0")
            assert svc.replayed == 3
            assert svc.stats()["replayed"] == 3
        finally:
            svc.stop(drain=False)
        # Once everything replayed-and-finished, a fresh recovery
        # has nothing to do: completions were journaled too.
        jnl2, pending = RequestJournal.recover(d)
        jnl2.close()
        assert pending == []

    def test_unloadable_record_fails_terminally(self, tmp_path):
        """A journaled request whose yaml no longer loads is failed
        (journaled terminal), not dropped and not replayed forever."""
        d = str(tmp_path)
        jnl = RequestJournal(d)
        jnl.append(accepted_record("bad", ":: not dcop yaml", PARAMS))
        jnl.append(accepted_record("ok", dcop_yaml(_instance(8, 3)),
                                   PARAMS))
        jnl.close()
        svc = _service(journal_dir=d, recover=True)
        svc.start()
        try:
            assert _wait_done(svc, "ok")["status"] == "FINISHED"
            assert svc.replayed == 1
        finally:
            svc.stop(drain=False)
        jnl2, pending = RequestJournal.recover(d)
        jnl2.close()
        assert pending == [], "bad record must not replay forever"

    def test_journal_append_failure_fails_submit(self, tmp_path):
        """A 202 the journal cannot back must not be issued: the
        submit raises and leaves no tracked request behind."""
        svc = _service(journal_dir=str(tmp_path))
        svc.start()
        try:
            svc._journal._f.close()  # simulate a dead disk
            with pytest.raises(RuntimeError,
                               match="journal append failed"):
                svc.submit(_instance(8, 1), params=PARAMS)
            assert svc.stats()["tracked_requests"] == 0
        finally:
            svc._journal = None  # already dead; stop() must not trip
            svc.stop(drain=False)


# ------------------------------------------------------------------ #
# deadlines


class TestDeadlines:
    def test_expired_before_dispatch_is_terminal_504(self):
        svc = _service(batch_window_s=0.05)
        # Hold the scheduler back so the deadline lapses while the
        # request is still queued.
        svc.start()
        gate = threading.Event()
        real = svc._run_batch
        svc._run_batch = lambda reqs, params: (
            gate.wait(30), real(reqs, params))[1]
        try:
            rid_live = svc.submit(_instance(8, 5), params=PARAMS)
            # Let the scheduler collect rid_live and block inside its
            # dispatch; THEN submit with a tight deadline — the
            # request must be stuck in the queue past the deadline,
            # not merely processed slowly.
            time.sleep(0.2)
            rid_dead = svc.submit(_instance(9, 6), params=PARAMS,
                                  deadline_s=0.01)
            time.sleep(0.15)  # let the deadline lapse in-queue
            gate.set()
            dead = _wait_done(svc, rid_dead)
            live = _wait_done(svc, rid_live)
            assert dead["status"] == "EXPIRED"
            assert "deadline" in dead["error"]
            assert live["status"] == "FINISHED", \
                "an expired bin-mate must not poison fresh work"
            assert svc.expired == 1
            assert svc.stats()["expired"] == 1
        finally:
            svc.stop(drain=False)

    def test_fresh_deadline_not_expired(self):
        svc = _service()
        svc.start()
        try:
            rid = svc.submit(_instance(8, 7), params=PARAMS,
                             deadline_s=60.0)
            assert _wait_done(svc, rid)["status"] == "FINISHED"
            assert svc.expired == 0
        finally:
            svc.stop(drain=False)

    @pytest.mark.parametrize("bad", [0, -1.5, "soon", float("nan")])
    def test_bad_deadline_rejected_as_400_class(self, bad):
        svc = _service()
        svc.start()
        try:
            with pytest.raises(ValueError):
                svc.submit(_instance(8, 8), params=PARAMS,
                           deadline_s=bad)
        finally:
            svc.stop(drain=False)

    def test_expired_request_never_resurrects(self, tmp_path):
        """EXPIRED is journaled terminal: a --recover restart must
        not replay it (the client already got its 504)."""
        d = str(tmp_path)
        svc = _service(journal_dir=d)
        svc.start()
        gate = threading.Event()
        real = svc._run_batch
        svc._run_batch = lambda reqs, params: (
            gate.wait(30), real(reqs, params))[1]
        try:
            decoy = svc.submit(_instance(8, 9), params=PARAMS)
            time.sleep(0.2)  # scheduler now blocked in dispatch
            rid = svc.submit(_instance(9, 9), params=PARAMS,
                             deadline_s=0.01)
            time.sleep(0.15)
            gate.set()
            assert _wait_done(svc, rid)["status"] == "EXPIRED"
            assert _wait_done(svc, decoy)["status"] == "FINISHED"
        finally:
            svc.stop(drain=False)
        jnl, pending = RequestJournal.recover(d)
        jnl.close()
        assert pending == []


# ------------------------------------------------------------------ #
# poison isolation


class TestPoisonIsolation:
    def _poisoned(self, svc, poison_ids):
        """Wrap the batch runner: any batch containing a poison id
        fails — the deterministic stand-in for one request whose
        tables break the engine."""
        real = svc._run_batch
        calls = []

        def wrapped(reqs, params):
            calls.append([r.id for r in reqs])
            if any(r.id in poison_ids for r in reqs):
                raise RuntimeError("poison request in batch")
            return real(reqs, params)

        svc._run_batch = wrapped
        return calls

    def test_bisection_isolates_single_poison(self):
        svc = _service(batch_window_s=0.3, max_batch=8)
        svc.start()
        poison = set()
        calls = self._poisoned(svc, poison)
        try:
            # Same-structure bin of 8; exactly one poison member.
            rids = [svc.submit(_instance(8, 20 + i), params=PARAMS)
                    for i in range(8)]
            poison.add(rids[3])
            results = {rid: _wait_done(svc, rid) for rid in rids}
            assert results[rids[3]]["status"] == "ERROR"
            assert "dispatch failed" in results[rids[3]]["error"]
            for rid in rids:
                if rid != rids[3]:
                    assert results[rid]["status"] == "FINISHED", \
                        "bin-mate of the poison request must succeed"
            # Log-bounded: one poison in a bin of n costs at most
            # 2·n - 1 dispatch attempts of that bin's work.
            bin_calls = [c for c in calls if len(c) <= 8]
            assert len(bin_calls) <= 2 * 8 - 1
            assert svc.dispatch_retries > 0
            assert svc.stats()["dispatch_retries"] == \
                svc.dispatch_retries
        finally:
            svc.stop(drain=False)

    def test_poison_does_not_trip_breaker(self):
        """Only the isolated singleton failure feeds the breaker: one
        poison client among healthy traffic must not open the circuit
        (the bin-mates' successes close any half-open state)."""
        from pydcop_tpu_torch.serving.admission import AdmissionPolicy

        svc = _service(batch_window_s=0.3, max_batch=8,
                       admission=AdmissionPolicy(
                           high_water=64, breaker_failures=2))
        svc.start()
        poison = set()
        self._poisoned(svc, poison)
        try:
            rids = [svc.submit(_instance(8, 40 + i), params=PARAMS)
                    for i in range(6)]
            poison.add(rids[0])
            for rid in rids:
                _wait_done(svc, rid)
            assert svc.admission.breaker.state != "open", (
                "one isolated poison failure must not open the "
                "dispatch breaker")
            # A fresh submit still admits.
            rid = svc.submit(_instance(8, 60), params=PARAMS)
            assert _wait_done(svc, rid)["status"] == "FINISHED"
        finally:
            svc.stop(drain=False)

    def test_all_poison_bin_fails_every_member_alone(self):
        """A genuinely down engine (every singleton fails) still
        fails everything and still feeds the breaker."""
        svc = _service(batch_window_s=0.3, max_batch=4)
        svc.start()
        calls = []

        def all_fail(reqs, params):
            calls.append([r.id for r in reqs])
            raise RuntimeError("engine down")

        svc._run_batch = all_fail
        try:
            rids = [svc.submit(_instance(8, 70 + i), params=PARAMS)
                    for i in range(4)]
            for rid in rids:
                assert _wait_done(svc, rid)["status"] == "ERROR"
            # Bisection bottoms out at singletons: every request saw
            # an isolated attempt.
            singles = [c for c in calls if len(c) == 1]
            assert {c[0] for c in singles} == set(rids)
        finally:
            svc.stop(drain=False)


# ------------------------------------------------------------------ #
# graceful drain under concurrent load (satellite 3)


class TestDrainUnderLoad:
    N_SUBMITTERS = 6

    def test_stop_drain_races_submitters_zero_lost(self, tmp_path):
        """6 submitter threads racing ``stop(drain=True)``: every id
        submit() acknowledged either completes or survives in the
        journal as replayable — zero lost, zero duplicated."""
        d = str(tmp_path)
        svc = _service(journal_dir=d, batch_window_s=0.01,
                       max_batch=4, max_queue=512)
        svc.start()
        real = svc._run_batch

        def slowed(reqs, params):
            time.sleep(0.05)  # keep a backlog alive at stop time
            return real(reqs, params)

        svc._run_batch = slowed
        accepted = [[] for _ in range(self.N_SUBMITTERS)]
        refused = [0] * self.N_SUBMITTERS
        stopping = threading.Event()

        def submitter(k):
            i = 0
            while not stopping.is_set():
                try:
                    rid = svc.submit(
                        _instance(8, 100 + 7 * k + i), params=PARAMS,
                        request_id=f"load-{k}-{i}")
                except Exception:
                    # No ack, no durability promise: a submit that
                    # raced the shutdown (journal closed / queue
                    # full) was REFUSED, not lost.
                    refused[k] += 1
                else:
                    accepted[k].append(rid)
                i += 1

        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(self.N_SUBMITTERS)]
        for t in threads:
            t.start()
        time.sleep(0.6)  # let a real backlog build
        stopping.set()
        summary = svc.stop(drain=True, timeout=3.0)
        for t in threads:
            t.join(timeout=10)
        acked = {rid for lane in accepted for rid in lane}
        assert len(acked) == sum(len(lane) for lane in accepted), \
            "duplicate ack"
        assert acked, "load test produced no accepted requests"
        finished = set()
        woken = set()
        for rid in acked:
            try:
                result = svc.result(rid)
            except KeyError:
                result = None
            assert result is not None, (
                f"acked request {rid} has no result after stop — a "
                "waiter would have slept out its whole window")
            if result["status"] == "FINISHED":
                finished.add(rid)
            else:
                # Not completed in-process: stop() must have woken it
                # as REPLAYABLE (the journal still holds it).
                assert result["status"] == "REPLAYABLE"
                woken.add(rid)
        jnl, pending = RequestJournal.recover(d)
        jnl.close()
        replayable = {r["id"] for r in pending}
        assert woken == replayable, (
            "REPLAYABLE wake-set must equal the journal's pending "
            f"set: {sorted(woken ^ replayable)[:5]}")
        # The accounting identity: acked = finished ⊎ replayable.
        assert finished | replayable == acked, (
            f"lost requests: "
            f"{sorted(acked - finished - replayable)[:5]}")
        assert not finished & replayable, (
            f"duplicated requests: "
            f"{sorted(finished & replayable)[:5]}")
        assert summary["failed_pending"] == 0, \
            "journaled service must never hard-fail pending work"
        assert summary["replayable"] == len(replayable)

    def test_stop_wakes_result_waiters_as_replayable(self, tmp_path):
        """A thread blocked in ``result(wait=...)`` when a journaled
        stop leaves its request replayable must be woken promptly
        with a REPLAYABLE result — not sleep out its whole window for
        an answer this process can no longer produce."""
        svc = _service(journal_dir=str(tmp_path),
                       batch_window_s=0.01, max_batch=2)
        svc.start()
        gate = threading.Event()
        real = svc._run_batch
        svc._run_batch = lambda reqs, params: (
            gate.wait(30), real(reqs, params))[1]
        rid = svc.submit(_instance(8, 950), params=PARAMS)
        out = {}
        waiter = threading.Thread(
            target=lambda: out.setdefault(
                "res", svc.result(rid, wait=30.0)))
        waiter.start()
        time.sleep(0.1)
        t0 = time.monotonic()
        svc.stop(drain=False, timeout=0.5)
        waiter.join(timeout=5.0)
        gate.set()  # release the parked scheduler thread
        assert not waiter.is_alive(), \
            "result() waiter still asleep after stop()"
        assert time.monotonic() - t0 < 5.0
        assert out["res"]["status"] == "REPLAYABLE"
        assert "recover" in out["res"]["error"]
        jnl, pending = RequestJournal.recover(str(tmp_path))
        jnl.close()
        assert rid in {r["id"] for r in pending}, \
            "the woken request must still replay on --recover"

    def test_journalless_stop_fails_pending_with_error(self):
        """Without a journal the same shutdown fails still-queued
        requests with an explicit error — never silence."""
        svc = _service(batch_window_s=0.01, max_batch=2,
                       max_queue=64)
        svc.start()
        real = svc._run_batch
        svc._run_batch = lambda reqs, params: (
            time.sleep(0.2), real(reqs, params))[1]
        rids = [svc.submit(_instance(8, 300 + i), params=PARAMS)
                for i in range(8)]
        summary = svc.stop(drain=False)
        statuses = {}
        for rid in rids:
            try:
                result = svc.result(rid)
            except KeyError:
                result = None
            if result is not None:
                statuses[rid] = result["status"]
        assert summary["replayable"] == 0
        errored = [r for r, s in statuses.items() if s == "ERROR"]
        assert len(errored) == summary["failed_pending"]
        for rid in errored:
            assert "stopped" in svc.result(rid)["error"]


# ------------------------------------------------------------------ #
# front-end regressions: strict wire-field validation


class TestHttpStrictFields:
    def _front(self, svc):
        from pydcop_tpu_torch.serving.http import ServeFrontEnd

        return ServeFrontEnd(svc, port=0).start()

    def _post(self, url, body):
        req = urllib.request.Request(
            url + "/solve", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())

    @pytest.mark.parametrize("field,value", [
        ("timeout", "thirty"), ("timeout", None), ("timeout", -1),
        ("timeout", 0), ("timeout", []), ("timeout", "inf"),
        ("deadline_s", "soon"), ("deadline_s", -2),
        ("deadline_s", 0), ("deadline_s", {}),
        ("deadline_s", float("inf")), ("deadline_s", float("nan")),
    ])
    def test_malformed_wire_field_is_400(self, field, value):
        """Regression: a malformed ``timeout``
        was silently coerced to 30.0 by a bare except — now every
        malformed wire field is a 400 naming the field, ledgered as
        ``rejected_bad_request``, with nothing submitted behind it."""
        svc = _service()
        svc.start()
        front = self._front(svc)
        try:
            before = svc._req_total.value(
                status="rejected_bad_request")
            code, body = self._post(front.url, {
                "dcop": dcop_yaml(_instance(8, 1)),
                "wait": True, field: value, "params": PARAMS,
            })
            assert code == 400
            assert field in body["error"]
            assert svc.stats()["tracked_requests"] == 0, \
                "a 400 must not leave an orphaned accepted request"
            after = svc._req_total.value(
                status="rejected_bad_request")
            assert after == before + 1
        finally:
            front.stop()
            svc.stop(drain=False)

    def test_valid_timeout_still_waits(self):
        svc = _service()
        svc.start()
        front = self._front(svc)
        try:
            code, body = self._post(front.url, {
                "dcop": dcop_yaml(_instance(8, 2)),
                "wait": True, "timeout": 60, "params": PARAMS,
            })
            assert code == 200 and body["status"] == "FINISHED"
        finally:
            front.stop()
            svc.stop(drain=False)

    def test_journal_append_failure_is_500_not_400(self, tmp_path):
        """A server-side journal failure (disk full, closed file)
        must surface as a 500 — a 400 would tell a well-behaved
        client its valid request is malformed and to stop
        retrying."""
        svc = _service(journal_dir=str(tmp_path))
        svc.start()
        front = self._front(svc)
        try:
            svc._journal._f.close()  # every append now fails
            code, body = self._post(front.url, {
                "dcop": dcop_yaml(_instance(8, 5)), "params": PARAMS,
            })
            assert code == 500
            assert "journal" in body["error"]
            assert svc.stats()["tracked_requests"] == 0, \
                "a failed submit must not leave an orphaned request"
        finally:
            front.stop()
            svc.stop(drain=False)

    def test_expired_request_is_504_on_the_wire(self):
        svc = _service()
        svc.start()
        gate = threading.Event()
        real = svc._run_batch
        svc._run_batch = lambda reqs, params: (
            gate.wait(30), real(reqs, params))[1]
        front = self._front(svc)
        try:
            code, _ = self._post(front.url, {
                "dcop": dcop_yaml(_instance(8, 4)),
                "params": PARAMS,
            })
            assert code == 202
            time.sleep(0.2)  # scheduler now blocked in dispatch
            code, body = self._post(front.url, {
                "dcop": dcop_yaml(_instance(9, 3)),
                "deadline_s": 0.01, "params": PARAMS,
            })
            assert code == 202
            rid = body["id"]
            time.sleep(0.15)
            gate.set()
            deadline = time.monotonic() + 30
            code = None
            while time.monotonic() < deadline:
                try:
                    with urllib.request.urlopen(
                            front.url + f"/result/{rid}",
                            timeout=10) as resp:
                        if resp.status == 200:
                            code = 200
                            break
                except urllib.error.HTTPError as err:
                    if err.code == 504:
                        code = 504
                        body = json.loads(err.read())
                        break
                    raise
                time.sleep(0.05)
            assert code == 504
            assert body["status"] == "EXPIRED"
        finally:
            front.stop()
            svc.stop(drain=False)
