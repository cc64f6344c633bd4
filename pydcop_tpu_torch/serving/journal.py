"""Durable request journal: crash recovery for the solve service.

A ``pydcop serve`` process crash loses every accepted request — the
client got its 202, the queue was in memory, the memory is gone.
This module makes the 202 a *durable* promise: every admitted request
is appended to an on-disk journal BEFORE the ack is returned, every
terminal outcome (finished / error / expired) is appended when it
happens, and a restart with ``--recover`` replays exactly the
accepted-but-unfinished entries through the normal queue.

On-disk format (one file, ``requests.jnl``, append-only):

- each record is ``[u32 length][u32 crc32][payload]`` (big-endian
  header, JSON payload) — the same verify-on-read discipline as the
  checkpoint checksums: the write path is trusted for nothing;
- a torn tail (the process died mid-append, or the disk lied) is
  detected by the length/crc check and TRUNCATED past the last valid
  record on recovery — every record before it is intact by
  construction, so a crash can only ever cost the unacknowledged
  suffix;
- recovery then COMPACTS the journal: the surviving file holds only
  the still-pending accepted records, so journals don't grow without
  bound across restarts and a second crash replays the same pending
  set again.

Durability model: ``append`` flushes to the OS on every record, so a
process kill (SIGKILL, OOM, crash) loses nothing acknowledged;
``sync=True`` adds an fsync per record for machine-crash durability
at a per-request latency cost.

The service side lives in serving/service.py (``journal_dir=`` /
``recover=``); the wire side in serving/http.py; ``pydcop serve
--journal_dir D --recover`` is the operational entry point
(docs/serving.md, docs/resilience.md "Serving & sharding fault
tolerance").

A copy of ``pydcop_tpu/serving/journal.py`` (pure Python): the record
format is byte for byte the reference's, so a journal either package
writes, the other replays.
"""

import binascii
import json
import logging
import os
import struct
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger("pydcop.serving.journal")

# Record header: payload byte length + crc32 of the payload.
_HEADER = struct.Struct(">II")
# Refuse absurd lengths on read: a corrupt header must not make the
# scanner allocate gigabytes before the crc check can call it torn.
MAX_RECORD_BYTES = 64 << 20
JOURNAL_FILE = "requests.jnl"

# Record kinds.
ACCEPTED = "accepted"
COMPLETED = "completed"
# Session records: a stateful session
# is replayed WHOLE after a crash — open record (the base problem),
# every acknowledged event batch, the newest engine-state checkpoint
# marker, and a close record that retires the lot.
SESSION_OPEN = "session_open"
SESSION_EVENT = "session_event"
SESSION_CKPT = "session_ckpt"
SESSION_CLOSE = "session_close"
SESSION_KINDS = (SESSION_OPEN, SESSION_EVENT, SESSION_CKPT,
                 SESSION_CLOSE)


def encode_record(record: Dict[str, Any]) -> bytes:
    payload = json.dumps(
        record, separators=(",", ":"), default=str).encode()
    return _HEADER.pack(
        len(payload), binascii.crc32(payload) & 0xFFFFFFFF) + payload


def scan_journal(path: str) -> Tuple[List[Dict[str, Any]], int, bool]:
    """Read every valid record off a journal file.

    Returns ``(records, valid_bytes, torn)``: ``valid_bytes`` is the
    offset just past the last record that verified (length plausible,
    payload complete, crc matching, JSON decoding) — the truncation
    point for a torn tail; ``torn`` says whether anything past it was
    found.  A missing file is an empty journal, never an error."""
    records: List[Dict[str, Any]] = []
    try:
        data = open(path, "rb").read()
    except FileNotFoundError:
        return records, 0, False
    offset = 0
    while offset + _HEADER.size <= len(data):
        length, crc = _HEADER.unpack_from(data, offset)
        start = offset + _HEADER.size
        end = start + length
        if length > MAX_RECORD_BYTES or end > len(data):
            break
        payload = data[start:end]
        if binascii.crc32(payload) & 0xFFFFFFFF != crc:
            break
        try:
            records.append(json.loads(payload))
        except ValueError:
            break
        offset = end
    return records, offset, offset < len(data)


def pending_requests(records: List[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
    """Accepted records with no terminal record — the replay set, in
    acceptance order.  A completion for an id the journal never
    accepted is ignored (it can only be debris from a pre-compaction
    file)."""
    accepted: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        kind = rec.get("kind")
        rid = rec.get("id")
        if kind == ACCEPTED and rid is not None:
            accepted[rid] = rec
        elif kind == COMPLETED and rid in accepted:
            del accepted[rid]
    return list(accepted.values())


# How many completed-with-result records a compaction retains.  The
# tail is the crash-durable result cache: big enough to cover every
# ack a client could still be polling across a restart, small enough
# that compaction actually compacts (a record with a result payload
# is a few hundred bytes — the accepted record's problem yaml, the
# bulky part, is already dropped with the pair).
COMPLETED_KEEP = 256


def completed_results(records: List[Dict[str, Any]],
                      keep: int = COMPLETED_KEEP
                      ) -> List[Dict[str, Any]]:
    """The newest ``keep`` completed records that carry a ``result``
    payload, newest-completion-last — what a restarted worker loads
    into its recovered-result cache so a pre-crash 202 still resolves
    to its outcome.  Plain completed records (no payload: older
    journals, or appends that could not serialize the result) are
    tombstones only and are never retained."""
    seen: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        if rec.get("kind") == COMPLETED and rec.get("id") is not None \
                and rec.get("result") is not None:
            # Re-insert so a re-completion (replay finishing a request
            # a prior segment also finished) keeps the newest outcome.
            seen.pop(rec["id"], None)
            seen[rec["id"]] = rec
    out = list(seen.values())
    return out[-keep:] if keep >= 0 else out


def pending_sessions(records: List[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
    """Open-but-not-closed sessions, each as ``{"open": rec,
    "ckpt": rec_or_None, "events": [recs]}`` in open order — the
    whole-session replay set.

    ``ckpt`` is the NEWEST checkpoint marker; ``events`` holds every
    acknowledged event batch in seq order, INCLUDING those at or
    before the checkpoint seq — recovery needs the pre-checkpoint
    events to rebuild the engine's factor layout structurally before
    the checkpointed message state can be restored onto it
    (serving/sessions.py SessionManager.recover).

    Exception — the recovery-time bound: a REBASED
    checkpoint marker carries the session's CURRENT problem
    serialized (``"dcop"`` key, serving/migration.engine_dcop_yaml),
    so the factor layout can be rebuilt from the marker alone and
    every batch at or before its seq is dead weight: those events are
    DROPPED here, which both bounds replay work and shrinks what
    compaction keeps for a long-lived session from its full event
    history to the post-checkpoint tail."""
    open_recs: Dict[str, Dict[str, Any]] = {}
    events: Dict[str, List[Dict[str, Any]]] = {}
    ckpts: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        kind = rec.get("kind")
        sid = rec.get("id")
        if sid is None:
            continue
        if kind == SESSION_OPEN:
            open_recs[sid] = rec
            events[sid] = []
            ckpts.pop(sid, None)
        elif kind == SESSION_EVENT and sid in open_recs:
            events[sid].append(rec)
        elif kind == SESSION_CKPT and sid in open_recs:
            prior = ckpts.get(sid)
            if prior is None or (rec.get("seq", 0)
                                 >= prior.get("seq", 0)):
                ckpts[sid] = rec
        elif kind == SESSION_CLOSE and sid in open_recs:
            del open_recs[sid]
            events.pop(sid, None)
            ckpts.pop(sid, None)
    out = []
    for sid, rec in open_recs.items():
        ckpt = ckpts.get(sid)
        evs = sorted(events.get(sid, []),
                     key=lambda r: r.get("seq", 0))
        if ckpt is not None and ckpt.get("dcop"):
            ckpt_seq = ckpt.get("seq", 0)
            evs = [r for r in evs if r.get("seq", 0) > ckpt_seq]
        out.append({"open": rec, "ckpt": ckpt, "events": evs})
    return out


def compact_journal(journal_dir: str
                    ) -> Tuple[List[Dict[str, Any]],
                               List[Dict[str, Any]],
                               List[Dict[str, Any]]]:
    """Compact a journal IN PLACE without opening it for appends:
    scan, truncate a torn tail, and atomically rewrite the file down
    to the pending requests, every open session's replay records
    (post-rebased-checkpoint only — see :func:`pending_sessions`),
    and the newest :data:`COMPLETED_KEEP` completed-with-result
    records (:func:`completed_results` — the crash-durable outcomes a
    restarted worker serves to clients still polling a pre-crash ack).

    Returns ``(pending_requests, pending_sessions, results)``.  This
    is the owner-less half of :meth:`RequestJournal.recover_full`:
    the fleet router runs it over a DEAD replica's segment before
    handing the segment to a replacement (or migrating its sessions
    to survivors), so the restarted worker's ``--recover`` replay
    visits only still-pending records instead of the segment's full
    history."""
    path = os.path.join(journal_dir, JOURNAL_FILE)
    records, valid_bytes, torn = scan_journal(path)
    if torn:
        logger.warning(
            "journal %s has a torn tail: truncating to the last "
            "valid record at byte %d", path, valid_bytes)
    pending = pending_requests(records)
    sessions = pending_sessions(records)
    results = completed_results(records)
    if os.path.exists(path):
        # Pending requests, retained results, plus every open
        # session's open/ckpt/event records, written to a temp file
        # and renamed over the old journal — a crash mid-compact
        # leaves the (longer but equivalent) original.
        fd, tmp = tempfile.mkstemp(
            dir=journal_dir, prefix=".jnl_tmp_")
        try:
            with os.fdopen(fd, "wb") as f:
                for rec in pending:
                    f.write(encode_record(rec))
                for rec in results:
                    f.write(encode_record(rec))
                for sess in sessions:
                    f.write(encode_record(sess["open"]))
                    if sess["ckpt"] is not None:
                        f.write(encode_record(sess["ckpt"]))
                    for rec in sess["events"]:
                        f.write(encode_record(rec))
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    return pending, sessions, results


def append_record(journal_dir: str, record: Dict[str, Any]) -> None:
    """One-shot durable append to a journal nobody holds open — the
    fleet router's tool for closing out a DEAD replica's sessions
    after migrating them to survivors (the restarted worker must not
    resurrect what a survivor already owns)."""
    os.makedirs(journal_dir, exist_ok=True)
    path = os.path.join(journal_dir, JOURNAL_FILE)
    with open(path, "ab") as f:
        f.write(encode_record(record))
        f.flush()
        os.fsync(f.fileno())


class RequestJournal:
    """Append-side handle on one journal directory.

    Thread-safe (submitting threads and the scheduler thread both
    append).  ``append`` returns only after the record reached the OS
    (``flush``; plus ``fsync`` with ``sync=True``) — the caller may
    then acknowledge the request."""

    def __init__(self, journal_dir: str, sync: bool = False):
        os.makedirs(journal_dir, exist_ok=True)
        self.journal_dir = journal_dir
        self.path = os.path.join(journal_dir, JOURNAL_FILE)
        self.sync = sync
        self._lock = threading.Lock()
        self._f = open(self.path, "ab")
        self.appended = 0

    def append(self, record: Dict[str, Any]) -> None:
        blob = encode_record(record)
        with self._lock:
            if self._f.closed:
                raise RuntimeError("journal is closed")
            self._f.write(blob)
            self._f.flush()
            if self.sync:
                os.fsync(self._f.fileno())
            self.appended += 1

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()

    @classmethod
    def recover(cls, journal_dir: str, sync: bool = False
                ) -> Tuple["RequestJournal", List[Dict[str, Any]]]:
        """:meth:`recover_full` without the session and result sets —
        kept for callers that predate stateful sessions (the
        compaction still preserves open-session and retained-result
        records either way: a request-only consumer must never
        silently destroy session or result durability)."""
        journal, pending, _sessions, _results = cls.recover_full(
            journal_dir, sync=sync)
        return journal, pending

    @classmethod
    def recover_full(cls, journal_dir: str, sync: bool = False
                     ) -> Tuple["RequestJournal",
                                List[Dict[str, Any]],
                                List[Dict[str, Any]],
                                List[Dict[str, Any]]]:
        """Open a journal directory for crash recovery.

        Scans the journal, truncates a torn tail past the last valid
        record, computes the pending (accepted-without-terminal)
        request set, the open-session set
        (:func:`pending_sessions`), and the retained
        completed-with-result set (:func:`completed_results`), and
        atomically compacts the file down to exactly those records
        before reopening it for appends (:func:`compact_journal`).
        Returns ``(journal, pending_requests, pending_sessions,
        results)`` in acceptance/open/completion order."""
        pending, sessions, results = compact_journal(journal_dir)
        journal = cls(journal_dir, sync=sync)
        if pending or sessions:
            logger.info(
                "journal recovery: %d pending request(s) and %d "
                "open session(s) to replay (%d completed result(s) "
                "retained)",
                len(pending), len(sessions), len(results))
        return journal, pending, sessions, results


def accepted_record(rid: str, dcop_yaml: str,
                    params: Dict[str, Any],
                    deadline_s: Optional[float] = None,
                    t_submit: Optional[float] = None,
                    trace_id: Optional[str] = None
                    ) -> Dict[str, Any]:
    rec = {"kind": ACCEPTED, "id": rid, "dcop": dcop_yaml,
           "params": params}
    if deadline_s is not None:
        rec["deadline_s"] = deadline_s
    if t_submit is not None:
        rec["t"] = t_submit
    if trace_id:
        # The request's causality key survives the crash with the
        # record: a replayed request keeps its original trace_id, so
        # `pydcop trace query` stitches pre- and post-crash spans
        # into one request tree.
        rec["trace_id"] = trace_id
    return rec


def completed_record(rid: str, status: str,
                     result: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """Terminal record.  ``result`` (the request's wire-form result
    dict) makes the OUTCOME crash-durable, not just the fact of
    completion: a client holding a durable 202 whose request finished
    moments before the process died polls the restarted worker and
    gets its 200 from the journal instead of a 404 (the in-memory
    result cache died with the process)."""
    rec = {"kind": COMPLETED, "id": rid, "status": status}
    if result is not None:
        rec["result"] = result
    return rec


# --------------------------------------------------------------------- #
# Session records (serving/sessions.py)


def session_open_record(sid: str, dcop_yaml: str,
                        params: Dict[str, Any],
                        trace_id: Optional[str] = None,
                        epoch: int = 1) -> Dict[str, Any]:
    """``epoch`` is the session's ownership fencing epoch:
    recovery restores it so a journal-recovered copy rejects writes
    minted for a NEWER owner, and a migrated-in copy (whose bundle
    carries the bumped epoch) outranks the fenced original."""
    rec = {"kind": SESSION_OPEN, "id": sid, "dcop": dcop_yaml,
           "params": params, "epoch": max(int(epoch), 1)}
    if trace_id:
        rec["trace_id"] = trace_id
    return rec


def session_event_record(sid: str, seq: int,
                         events: List[Dict[str, Any]],
                         trace_id: Optional[str] = None
                         ) -> Dict[str, Any]:
    """One acknowledged PATCH batch: ``seq`` is the batch's position
    in the session's event order (monotone per session — replay
    applies batches in seq order), ``events`` the wire-form event
    list exactly as acknowledged."""
    rec = {"kind": SESSION_EVENT, "id": sid, "seq": int(seq),
           "events": events}
    if trace_id:
        rec["trace_id"] = trace_id
    return rec


def session_ckpt_record(sid: str, seq: int, path: str,
                        cycle: int = 0,
                        dcop: Optional[str] = None
                        ) -> Dict[str, Any]:
    """Engine-state checkpoint marker: the NPZ at ``path`` holds the
    warm message state AFTER event batch ``seq`` was applied —
    recovery restores it and replays only the batches past ``seq``.

    ``dcop`` REBASES the checkpoint: the session's current problem
    (open-record problem + every batch through ``seq``, serialized
    back to dcop yaml by serving/migration.engine_dcop_yaml).  A
    rebased marker lets recovery rebuild the factor layout from the
    marker alone, so compaction drops the pre-checkpoint event tail
    entirely (:func:`pending_sessions`) — replay time is bounded by
    the checkpoint cadence, not session age."""
    rec = {"kind": SESSION_CKPT, "id": sid, "seq": int(seq),
           "path": path, "cycle": int(cycle)}
    if dcop:
        rec["dcop"] = dcop
    return rec


def session_close_record(sid: str, status: str) -> Dict[str, Any]:
    return {"kind": SESSION_CLOSE, "id": sid, "status": status}
