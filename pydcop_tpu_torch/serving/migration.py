"""Live session migration: move a warm solve session between replicas.

The reference pyDCOP's headline resilience feature is that
*computations migrate*: on agent failure its orchestration layer
re-homes replicated computations onto surviving agents.  The serve
plane's analogue moves a WHOLE warm session — engine message state,
problem, event history position — from one fleet replica to another,
reusing the replay machinery verbatim for the rebuild (restore
equals uninterrupted is already proven by scenario_session_replay).

**The bundle.**  One JSON document carries everything a target needs
to rebuild the session exactly as :meth:`SessionManager.recover`
would after a crash:

- ``dcop`` — the session's problem as dcop yaml.  Preferably REBASED:
  the engine's *current* factor graph serialized back to yaml
  (:func:`engine_dcop_yaml` — open problem + every applied event
  batch), so the target rebuilds structurally from one document and
  zero event replays.  When a live factor can't round-trip through
  yaml, the bundle falls back to the open-record problem plus the
  journaled event batches (``rebased: false``).
- ``npz_b64`` / ``npz_path`` — the drain-checkpoint engine NPZ (warm
  message state at ``ckpt_seq``); base64 over the wire for live
  migration, a filesystem path for same-box dead-replica adoption.
- ``seq`` / ``ckpt_seq`` / ``cycle`` — the event-order position the
  target continues from.

**The protocol** (:func:`migrate_session`, driven by the router):

1. ``POST /admin/export_session`` on the source — the scheduler
   thread drains the session (every acked batch applied), checkpoints
   it, freezes it MIGRATING (new PATCHes 409 until the move
   resolves) and returns the bundle;
2. ``POST /admin/import_session`` on the target — rebuild via the
   recovery path, journal the session into the target's own segment
   (the import ack is as durable as an open's 201);
3. the router atomically repoints the session pin;
4. ``POST /admin/retire_session`` on the source — journal a MIGRATED
   close (the source's --recover must not resurrect what the target
   now owns), retire the checkpoint, end the SSE streams (clients
   reconnect through the router and land on the target).

On import failure the source is resumed (``/admin/resume_session``)
— the session never has zero owners.  Dead-replica adoption
(:func:`adopt_dead_sessions`) builds the same bundles straight from
the dead segment's compacted journal instead of step 1, because there
is no live source to export from.

Durability guarantee: every acked PATCH is either inside the bundle
(applied before the drain checkpoint) or journaled on whichever side
acked it — a client holding durable 200s and an open SSE stream
observes at most a reconnect and a 409-retry window, never a lost
acked event.  docs/serving.md "Elastic fleet".

A copy of ``pydcop_tpu/serving/migration.py``: the same bundle
document.  The fleet router (serving/router.py) drives
``migrate_session`` (``POST /admin/migrate`` and the autoscaler's
scale-down drain) and ``adopt_dead_sessions`` (the death of a
spawned replica, or of a remote one that announced its journal).
"""

import base64
import binascii
import json
import logging
import os
import tempfile
import uuid
from typing import Any, Dict, List, Optional

from pydcop_tpu_torch.observability import fleettrace
from pydcop_tpu_torch.observability.trace import tracer
from pydcop_tpu_torch.serving import journal as journal_mod

logger = logging.getLogger("pydcop.serving.migration")

BUNDLE_VERSION = 1


def engine_dcop_yaml(engine, name: str = "session") -> str:
    """Serialize a live DynamicMaxSumEngine's CURRENT problem back to
    dcop yaml — the rebase step for checkpoints and migration
    bundles.  Raises when any live factor can't round-trip (e.g. an
    expression constraint without its source expression); callers
    fall back to open-problem + event replay."""
    from pydcop_tpu_torch.dcop.dcop import DCOP
    from pydcop_tpu_torch.dcop.objects import AgentDef
    from pydcop_tpu_torch.dcop.yamldcop import dcop_yaml, load_dcop

    mode = engine.mode if engine.mode in ("min", "max") else "min"
    dcop = DCOP(name, objective=mode)
    for v in engine.variables:
        dcop.add_variable(v)
    for c in engine.factors.values():
        dcop.add_constraint(c)
    agents = sorted(engine.agents) or ["a0"]
    dcop.add_agents([AgentDef(a) for a in agents])
    out = dcop_yaml(dcop)
    # Round-trip proof: a yaml that fails to load again would turn a
    # fast checkpoint into a poisoned recovery.  Cheap relative to
    # the engine checkpoint that accompanies it.
    load_dcop(out)
    return out


def build_bundle(session_id: str, trace_id: str, dcop_yaml: str,
                 rebased: bool, params: Dict[str, Any], seq: int,
                 cycle: int,
                 events: Optional[List[Dict[str, Any]]] = None,
                 npz_bytes: Optional[bytes] = None,
                 ckpt_seq: Optional[int] = None,
                 npz_path: Optional[str] = None,
                 epoch: int = 1) -> Dict[str, Any]:
    bundle: Dict[str, Any] = {
        "version": BUNDLE_VERSION,
        "session_id": session_id,
        "trace_id": trace_id,
        "dcop": dcop_yaml,
        "rebased": bool(rebased),
        "params": dict(params or {}),
        "seq": int(seq),
        "cycle": int(cycle),
        "epoch": max(int(epoch), 1),
        "events": [
            {"seq": int(r.get("seq", 0)),
             "events": r.get("events") or [],
             **({"trace_id": r["trace_id"]}
                if r.get("trace_id") else {})}
            for r in (events or [])
        ],
    }
    if npz_bytes is not None:
        bundle["npz_b64"] = base64.b64encode(npz_bytes).decode()
    if npz_path is not None:
        bundle["npz_path"] = npz_path
    if ckpt_seq is not None:
        bundle["ckpt_seq"] = int(ckpt_seq)
    return bundle


def _bundle_npz_bytes(bundle: Dict[str, Any]) -> Optional[bytes]:
    b64 = bundle.get("npz_b64")
    if b64:
        try:
            return base64.b64decode(b64)
        except (binascii.Error, ValueError) as exc:
            raise ValueError(f"bad npz_b64 in bundle: {exc}")
    path = bundle.get("npz_path")
    if path:
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError as exc:
            # Same-box adoption race (the checkpoint was retired
            # under us): degrade to a cold rebuild, exactly like a
            # bad snapshot during --recover.
            logger.warning("bundle npz_path %s unreadable (%s); "
                           "importing cold", path, exc)
    return None


def install_bundle(manager, bundle: Dict[str, Any]):
    """Target-side import: rebuild the session through the SAME
    recovery path a --recover restart uses, journal it into this
    service's own segment, and enqueue its first re-convergence
    segment.  Returns the installed SolveSession.  Runs on a
    submitting thread (like ``SessionManager.open``)."""
    from pydcop_tpu_torch.dcop.yamldcop import load_dcop

    if bundle.get("version") != BUNDLE_VERSION:
        raise ValueError(
            f"unsupported bundle version {bundle.get('version')!r}")
    sid = bundle.get("session_id")
    if not sid or not isinstance(sid, str):
        raise ValueError("bundle needs a 'session_id'")
    dcop_src = bundle.get("dcop")
    if not isinstance(dcop_src, str) or not dcop_src.strip():
        raise ValueError("bundle needs a 'dcop' yaml string")
    with manager._lock:
        existing = manager._sessions.get(sid)
        if existing is not None and existing.status == "OPEN":
            raise ValueError(f"session {sid!r} already live here")
    trace_id = bundle.get("trace_id") or ""
    params = bundle.get("params") or {}
    seq = int(bundle.get("seq") or 0)
    npz = _bundle_npz_bytes(bundle)
    ckpt_seq = bundle.get("ckpt_seq")

    # Land the NPZ next to this service's journal (tmp+rename) so a
    # later checkpoint of the imported session overwrites it in
    # place; a journal-less service parks it in tmpdir.
    npz_dest = None
    if npz is not None and ckpt_seq is not None:
        dest_dir = manager.service.journal_dir or tempfile.gettempdir()
        os.makedirs(dest_dir, exist_ok=True)
        npz_dest = os.path.join(dest_dir, f"session_{sid}.npz")
        tmp = npz_dest + ".tmp.npz"
        with open(tmp, "wb") as f:
            f.write(npz)
        os.replace(tmp, npz_dest)

    open_rec = journal_mod.session_open_record(
        sid, dcop_src, params, trace_id=trace_id or None,
        epoch=int(bundle.get("epoch") or 1))
    event_recs = [
        journal_mod.session_event_record(
            sid, r.get("seq", 0), r.get("events") or [],
            trace_id=r.get("trace_id"))
        for r in (bundle.get("events") or [])
    ]
    ckpt_rec = None
    if npz_dest is not None:
        ckpt_rec = journal_mod.session_ckpt_record(
            sid, int(ckpt_seq), npz_dest,
            cycle=int(bundle.get("cycle") or 0),
            dcop=dcop_src if bundle.get("rebased") else None)

    # Durability FIRST, like open(): the records reach this segment's
    # journal before the rebuild, so a crash mid-import replays the
    # session here (the source has not retired it yet — worst case
    # both sides replay and the router pin decides the owner).
    journal = manager.service._journal
    if journal is not None:
        journal.append(open_rec)
        for rec in event_recs:
            journal.append(rec)
        if ckpt_rec is not None:
            journal.append(ckpt_rec)

    sess = manager._recover_one(load_dcop, open_rec, ckpt_rec,
                                event_recs)
    # The event-order position continues from the source: a rebased
    # bundle carries no event records, so _recover_one's max-seq scan
    # alone would restart the order at zero.
    with manager._lock:
        sess.seq = max(seq, sess.seq)
        sess.applied_seq = sess.seq
    manager.migrated_in += 1
    logger.info("session %s imported (seq %d%s)", sid, sess.seq,
                ", rebased" if bundle.get("rebased") else "")
    return sess


# --------------------------------------------------------------------- #
# Router-side orchestration


def migrate_session(router, session_id: str,
                    target_index: Optional[int] = None,
                    timeout: float = 120.0) -> Dict[str, Any]:
    """Move one session between replicas (operator ``POST
    /admin/migrate``, scale-down drain).  Export → import → repoint
    pin → retire; on import failure the source session is resumed.
    Raises KeyError for an unpinned session, RuntimeError when a step
    fails unrecoverably."""
    source = router.pinned(session_id, router._session_pins)
    if source is None:
        raise KeyError(session_id)
    target = None
    if target_index is not None:
        if not 0 <= target_index < len(router.replicas):
            raise ValueError(f"no replica {target_index}")
        target = router.replicas[target_index]
        if target.status != "up":
            raise RuntimeError(
                f"target replica {target_index} is {target.status}")
    else:
        live = [r for r in router.candidates()
                if r.index != source.index]
        if not live:
            raise RuntimeError("no live target replica to migrate to")
        target = min(live, key=lambda r: r.in_flight)
    if target.index == source.index:
        raise ValueError("target is the session's current replica")

    # The whole export→import→retire hop rides ONE trace context —
    # the session's own when the router remembers it, a fresh one
    # otherwise — so forensics shows the migration inside the
    # session's causal tree.
    ctx = fleettrace.TraceContext(
        router.trace_for(session_id) or uuid.uuid4().hex[:16])
    status, _ctype, body = router._forward(
        source, "POST", "/admin/export_session",
        json.dumps({"session_id": session_id,
                    "wait": timeout}).encode(),
        timeout=timeout + 30.0, trace=ctx)
    if status != 200:
        raise RuntimeError(
            f"export failed on replica {source.index} ({status}): "
            f"{body[:300]!r}")
    bundle = json.loads(body)
    # Ownership epoch bumps ON THE MOVE: the target's copy
    # carries the new epoch, the router stamps it on every forwarded
    # PATCH, and any write still addressed to the source's epoch is
    # rejected as stale — split-brain fencing, not best-effort retire.
    new_epoch = router.bump_epoch(session_id)
    bundle["epoch"] = new_epoch

    try:
        status, _ctype, body = router._forward(
            target, "POST", "/admin/import_session",
            json.dumps(bundle).encode(), timeout=timeout + 30.0,
            trace=ctx)
        if status != 201:
            raise RuntimeError(
                f"import failed on replica {target.index} "
                f"({status}): {body[:300]!r}")
    except (OSError, RuntimeError):
        # The session must never have zero owners: un-freeze the
        # source before surfacing the failure.
        try:
            router._forward(
                source, "POST", "/admin/resume_session",
                json.dumps({"session_id": session_id}).encode(),
                timeout=30.0, trace=ctx)
        except OSError:
            logger.warning("session %s: import failed AND source "
                           "resume unreachable — the source journal "
                           "still owns it", session_id)
        raise

    router.pin(session_id, target, router._session_pins)
    try:
        router._forward(
            source, "POST", "/admin/retire_session",
            json.dumps({"session_id": session_id,
                        "moved_to": target.url}).encode(),
            timeout=30.0, trace=ctx)
    except OSError:
        # The target owns the session (pin repointed + epoch bumped);
        # an unretired source copy is fenced when the source heals —
        # arm the fence now so the next successful probe flushes it.
        router.record_fence(source.index, session_id, new_epoch)
        logger.warning("session %s: retire on replica %d "
                       "unreachable; fence armed at epoch %d",
                       session_id, source.index, new_epoch)
    with router._lock:
        router.migrations += 1
    if tracer.active:
        tracer.instant("router_migrate", "fleet",
                       trace_id=ctx.trace_id, session=session_id,
                       source=source.index, target=target.index)
    logger.info("session %s migrated: replica %d -> %d",
                session_id, source.index, target.index)
    return {"session_id": session_id, "from": source.index,
            "to": target.index}


def adopt_dead_sessions(router, dead) -> int:
    """Dead-replica failover: compact the dead segment's journal,
    build a same-box bundle per open session (checkpoint referenced
    by path — the survivors share the filesystem), import each into
    the least-loaded survivor, journal a MIGRATED close into the dead
    segment so its restart does not resurrect what a survivor now
    owns, and repoint the session pins.  Returns the adopted count;
    sessions that fail to import stay in the dead segment for the
    restart-in-place replay."""
    if not dead.journal_dir:
        return 0
    try:
        _pending, sessions, _results = journal_mod.compact_journal(
            dead.journal_dir)
    except OSError as exc:
        logger.warning("replica %d: dead-segment compaction failed "
                       "(%s); restart replays the full segment",
                       dead.index, exc)
        return 0
    if not sessions:
        return 0
    adopted = 0
    for rec in sessions:
        open_rec = rec["open"]
        ckpt = rec.get("ckpt") or {}
        sid = open_rec.get("id")
        live = [r for r in router.candidates()
                if r.index != dead.index]
        if not live:
            break
        target = min(live, key=lambda r: r.in_flight)
        seqs = [r.get("seq", 0) for r in rec.get("events") or []]
        seq = max([ckpt.get("seq", 0)] + seqs)
        # Adoption is a forced move: bump the ownership epoch past
        # whatever the (possibly merely partitioned) dead replica
        # journaled, so a healed original cannot double-apply.
        new_epoch = router.bump_epoch(
            sid, floor=int(open_rec.get("epoch") or 1) + 1)
        bundle = build_bundle(
            sid, open_rec.get("trace_id") or "",
            ckpt.get("dcop") or open_rec["dcop"],
            rebased=bool(ckpt.get("dcop")),
            params=open_rec.get("params") or {},
            seq=seq, cycle=int(ckpt.get("cycle") or 0),
            events=rec.get("events"),
            npz_path=ckpt.get("path"),
            ckpt_seq=(ckpt.get("seq")
                      if ckpt.get("path") else None),
            epoch=new_epoch)
        ctx = fleettrace.TraceContext(
            router.trace_for(sid) or open_rec.get("trace_id")
            or uuid.uuid4().hex[:16])
        try:
            status, _ctype, body = router._forward(
                target, "POST", "/admin/import_session",
                json.dumps(bundle).encode(), timeout=120.0,
                trace=ctx)
            if status != 201:
                raise RuntimeError(
                    f"import answered {status}: {body[:200]!r}")
        except (OSError, RuntimeError, ValueError) as exc:
            logger.warning(
                "session %s: adoption by replica %d failed (%s); "
                "left for the dead replica's restart replay",
                sid, target.index, exc)
            continue
        # The dead segment must forget the session BEFORE its slot
        # restarts with --recover.
        journal_mod.append_record(
            dead.journal_dir,
            journal_mod.session_close_record(sid, "MIGRATED"))
        router.pin(sid, target, router._session_pins)
        # The close record covers a restart-in-place; a replica that
        # was merely PARTITIONED never restarts, so arm a fence that
        # flushes the moment it answers the prober again.
        router.record_fence(dead.index, sid, new_epoch)
        adopted += 1
        with router._lock:
            router.migrations += 1
        if tracer.active:
            tracer.instant("router_migrate", "fleet",
                           trace_id=ctx.trace_id, session=sid,
                           source=dead.index, target=target.index,
                           adopted=True)
        logger.info("session %s adopted by replica %d after replica "
                    "%d death", sid, target.index, dead.index)
    return adopted
