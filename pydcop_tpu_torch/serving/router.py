"""Fleet router: N solve-service worker replicas behind one HTTP port.

A copy of ``pydcop_tpu/serving/router.py``'s fixed-size fleet (its
"unit cell"): ``python -m pydcop_tpu_torch serve --replicas N``
(``api.serve(replicas=N)``) spawns N worker processes — each a full
``serve`` instance with its own SolveService scheduler thread, its own
CUDA context on the same card (or the CPU with ``--device cpu``), its
own journal segment (``<journal_dir>/replica-<k>/``) and its own
/metrics — behind a stdlib-HTTP router that speaks the single
service's wire protocol unchanged: clients POST /solve and poll
/result/<id> exactly as against one service.

**Structure-affinity routing.**  The router computes the structure
bin key at admission (serving/binning.affinity_key, on the host) and
routes by RENDEZVOUS HASHING on it: every replica scores
``sha1(key || replica_id)`` and the highest healthy scorer wins, so
same-structure traffic lands where that structure's kernels are
loaded and its batch-mates wait (``affinity_hit_fraction`` in
/stats).  A replica death remaps ONLY the keys it owned.
**Least-loaded spillover**: a primary more than ``spill_slack``
requests deeper in flight than the idlest healthy replica loses the
request to it.  **Breaker-aware shedding**: a replica whose admission
breaker is open leaves the candidate set; if every replica sheds,
the router answers 503 as a single service would.

**Fleet lifecycle.**  A heartbeat prober GETs every replica's
/healthz on a short cadence and scores silence with the phi-accrual
estimator (resilience/health.PhiAccrualEstimator): ``dead_misses``
expected intervals of silence, or the worker process exiting, is the
death verdict.  A dead replica's journal segment is handed to its
replacement: the router first ADOPTS the segment's open sessions
onto survivors (serving/migration.py), then respawns worker k on the
segment with ``--recover``, so every request the dead worker
acknowledged replays — SIGKILL mid-burst loses no acknowledged
request.  Requests and sessions are PINNED: the router mints the
request id, remembers which replica owns it, and routes /result polls
there.  ``POST /admin/migrate`` moves a live session between
replicas.  Fleet SIGTERM drains every worker and exits 0.

The router process does no device work: it hashes structure keys on
the host and forwards bytes.  Every worker is spawned with the
router's ``--device`` and with ``PYDCOP_COMPILE_CACHE_DIR`` set to the
shared kernel-library directory (engine/aotcache.py), so a restarted
worker loads the libraries its predecessor built.  A worker that
cannot reach its device exits at startup (``_wait_ready`` raises
"died on startup"); none falls back to the CPU.

**Elastic fleet.**  Membership changes at run time:

- *Remote membership*: a worker started with ``--join <router_url>``
  announces its address at ``POST /fleet/join``
  (:meth:`FleetRouter.register_remote`) and is probed and phi-scored
  like a spawned one.  The router never restarts what it did not
  spawn: a dead remote goes DOWN, its sessions are adopted onto
  survivors when it announced a reachable journal, and the slot
  revives when it answers again or re-announces.
- *SLO autoscaling*: the monitor compares the rolling forwarded p99
  and the queue depth against ``slo_p99_ms`` and spawns a replica
  (prewarmed by replaying the latest admission exemplars, its kernel
  libraries loaded from the shared directory) or drains one — its
  sessions migrate to survivors — between ``min_replicas`` and
  ``max_replicas``.
"""

import contextlib
import hashlib
import heapq
import itertools
import json
import logging
import os
import random
import signal
import subprocess
import sys
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from pydcop_tpu_torch.observability import fleettrace
from pydcop_tpu_torch.observability.metrics import registry as metrics_registry
from pydcop_tpu_torch.observability.trace import tracer
from pydcop_tpu_torch.serving import netfault
from pydcop_tpu_torch.observability.server import (
    TelemetryServer,
    _Handler,
    get_health_provider,
    set_health_provider,
)

logger = logging.getLogger("pydcop.serving.router")

# Wire limits mirror the single-service front end (serving/http.py).
MAX_BODY_BYTES = 8 << 20
# Forward timeout headroom over the client's own wait window.
FORWARD_TIMEOUT_S = 330.0
# Bounded pin tables: oldest request pins evicted first (the same
# retention philosophy as SolveService.result_keep).
PIN_KEEP = 65536

UP = "up"
STARTING = "starting"
RESTARTING = "restarting"
DOWN = "down"
# Scale-down: out of the candidate set while its sessions migrate to
# survivors; resolves to DOWN (retired) or back to UP on a failed
# drain.
DRAINING = "draining"

# Fair-queue admission wait before a 429: long enough to absorb a
# burst, short enough that a starved client learns it is being
# shaped.
FAIR_WAIT_S = 30.0
# Ambiguous-forward retry budget when the client sent no deadline_s:
# a few backed-off resends, never minutes of hidden spinning.
DEFAULT_RETRY_BUDGET_S = 10.0
# How long a /result poll waits out a mid-restart pin before telling
# the client to retry: the journal-recovered twin usually answers
# within a couple of heartbeats.
RESULT_HEDGE_S = 2.0


class FleetUnavailable(Exception):
    """No healthy, non-shedding replica can take the request (503)."""


# A forward that failed BEFORE any request bytes were written (the
# connect itself was refused/reset — or the netfault plane injected a
# drop/partition).  The worker cannot have seen — let alone acked —
# the request, so re-picking a healthy replica and resending the
# identical body is unconditionally safe.  Any OSError past this
# point is ambiguous (bytes may have reached a worker that journaled
# the request before dying mid-response) and is retried only against
# the SAME replica, where the submit is idempotent on the minted id.
ForwardNotSent = netfault.NotSent


class FairScheduler:
    """Weighted fair queuing over request tenants (virtual-time WFQ,
    the classic start-time fair queue collapsed to unit-cost
    requests): each admission gets a finish tag
    ``max(vtime, tenant's last tag) + 1/weight`` and admissions leave
    the queue in tag order, so a tenant flooding N requests only
    advances its OWN tag N steps — a quiet tenant's next request tags
    just past the current virtual time and overtakes the flood's
    tail.  Capacity (concurrent admitted requests) scales with live
    replicas: ``up * fair_share``.  A request that can't get a slot
    within its wait window is rejected (429) — shaping, not failure.

    Deliberately tiny and lock-simple: the router's forward path is
    hundreds of requests per second, not millions, and the property
    that matters — one tenant's zipf storm cannot starve another's
    sessions — is a tag-ordering property, not a throughput one."""

    def __init__(self, fair_share: int = 8):
        self.fair_share = int(fair_share)
        self._cond = threading.Condition()
        self._vtime = 0.0
        self._last_tag: Dict[str, float] = {}
        self._heap: List[Tuple[float, int, str]] = []
        self._seq = itertools.count()
        self._active = 0
        self.admitted = 0
        self.rejected = 0
        self.queued_peak = 0

    def acquire(self, tenant: str, up: int,
                timeout: float = FAIR_WAIT_S,
                weight: float = 1.0) -> bool:
        deadline = time.monotonic() + timeout
        with self._cond:
            tag = (max(self._vtime,
                       self._last_tag.get(tenant, 0.0))
                   + 1.0 / max(weight, 1e-6))
            self._last_tag[tenant] = tag
            me = (tag, next(self._seq), tenant)
            heapq.heappush(self._heap, me)
            self.queued_peak = max(self.queued_peak,
                                   len(self._heap))
            while True:
                cap = max(up, 1) * self.fair_share
                if self._heap[0] == me and self._active < cap:
                    heapq.heappop(self._heap)
                    self._active += 1
                    self._vtime = max(self._vtime, tag)
                    self.admitted += 1
                    self._cond.notify_all()
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._heap.remove(me)
                    heapq.heapify(self._heap)
                    self.rejected += 1
                    self._cond.notify_all()
                    return False
                self._cond.wait(min(remaining, 0.1))

    def release(self) -> None:
        with self._cond:
            self._active = max(self._active - 1, 0)
            self._cond.notify_all()

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "fair_share": self.fair_share,
                "active": self._active,
                "queued": len(self._heap),
                "queued_peak": self.queued_peak,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "tenants": len(self._last_tag),
            }


class Replica:
    """One worker slot: the process handle (local spawns), its URL,
    health bookkeeping and the warm-structure set affinity accounting
    reads.  A slot survives its process — a restarted worker reuses
    the slot (same index, same journal segment), which is what keeps
    request pins valid across a replica death.

    ``managed=False`` marks a REMOTE replica that joined over the
    wire (``POST /fleet/join``): no process handle, no journal
    segment the router can touch — a dead remote goes DOWN and stays
    there until it answers again or re-announces.  ``host_id`` is the
    (possibly simulated) host identity; ``retired`` marks a slot
    drained away by scale-down — terminal for the slot, the prober
    must not resurrect it."""

    def __init__(self, index: int, journal_dir: Optional[str],
                 log_path: str, host: str = "127.0.0.1",
                 managed: bool = True,
                 host_id: Optional[str] = None):
        self.index = index
        self.journal_dir = journal_dir
        self.log_path = log_path
        self.host = host
        self.managed = managed
        self.host_id = host_id
        self.retired = False
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.status = STARTING
        self.estimator = None           # PhiAccrualEstimator, set on up
        self.anchor = 0.0
        self.breaker_open = False
        self.queue_depth = 0
        self.in_flight = 0
        self.forwarded = 0
        self.errors = 0
        self.restarts = 0
        self.warm: set = set()
        # Gray-failure scoring: EWMA of /healthz probe round-trip.
        # A link can be slow-but-alive (injected delay, a saturated
        # box) — that is suspicion, not death, and must neither kill
        # the replica nor hide on /healthz.
        self.probe_ewma_ms: Optional[float] = None
        self.gray = False
        # One death verdict per down-episode: mark_forward_error may
        # flip the slot DOWN before the prober's verdict, and a
        # verdict already acted on (restart/adoption) must not re-run
        # every beat while the slot stays dark.
        self.death_handled = False

    @property
    def url(self) -> Optional[str]:
        if self.port is None:
            return None
        return f"http://{self.host}:{self.port}"

    def summary(self) -> Dict[str, Any]:
        return {
            "index": self.index,
            "url": self.url,
            "status": self.status,
            "host_id": self.host_id,
            "managed": self.managed,
            "retired": self.retired,
            "pid": self.proc.pid if self.proc else None,
            "breaker_open": self.breaker_open,
            "queue_depth": self.queue_depth,
            "in_flight": self.in_flight,
            "forwarded": self.forwarded,
            "errors": self.errors,
            "restarts": self.restarts,
            "warm_structures": len(self.warm),
            "journal_dir": self.journal_dir,
            "probe_ms": (round(self.probe_ewma_ms, 2)
                         if self.probe_ewma_ms is not None else None),
            "gray": self.gray,
        }


def _rendezvous_score(digest: str, index: int) -> int:
    """Highest-random-weight score of one (structure, replica) pair —
    deterministic across processes and restarts (hash() is seeded per
    process and would reshuffle the whole map on every router
    restart, defeating the disk-warmed affinity)."""
    h = hashlib.sha1(f"{digest}|{index}".encode()).digest()
    return int.from_bytes(h[:8], "big")


class FleetRouter:
    """Spawn, monitor and route over N serve-worker replicas.

    ``worker_args`` is the raw ``serve`` CLI argument tail every
    worker is spawned with (batching/admission/session knobs — built
    by api.serve from its kwargs, so the single-service and fleet
    paths cannot drift); ``device`` (``"cuda"`` or ``"cpu"``) is
    every worker's ``--device``.  ``journal_dir`` enables per-replica
    durable journals (``replica-<k>/`` segments) and crash handoff;
    ``compile_cache_dir`` is exported to every worker as its
    kernel-library directory.  ``affinity`` is ``"structure"``
    (rendezvous on the bin key, the default) or ``"round_robin"``
    (the A/B baseline).  The autoscaler is armed only when both
    ``slo_p99_ms`` and ``max_replicas`` are set; it keeps between
    ``min_replicas`` (default 1) and ``max_replicas`` managed
    replicas, checking every ``autoscale_interval_s`` and scaling down
    after ``scale_down_quiet_checks`` quiet checks in a row."""

    def __init__(self, replicas: int = 2,
                 worker_args: Optional[List[str]] = None,
                 journal_dir: Optional[str] = None,
                 compile_cache_dir: Optional[str] = None,
                 affinity: str = "structure",
                 heartbeat_s: float = 0.25,
                 probe_timeout_s: Optional[float] = None,
                 dead_misses: float = 8.0,
                 spill_slack: int = 4,
                 restart_dead: bool = True,
                 worker_ready_timeout_s: float = 120.0,
                 default_params: Optional[Dict[str, Any]] = None,
                 hosts: int = 1,
                 slo_p99_ms: Optional[float] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 fair_share: int = 8,
                 autoscale_interval_s: float = 2.0,
                 scale_down_quiet_checks: int = 10,
                 device: str = "cuda"):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if affinity not in ("structure", "round_robin"):
            raise ValueError(
                f"affinity must be 'structure' or 'round_robin', "
                f"got {affinity!r}")
        if hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {hosts}")
        if max_replicas is not None and max_replicas < replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) must be >= replicas "
                f"({replicas})")
        if min_replicas is not None and min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas}")
        self.n_replicas = int(replicas)
        # Every worker runs on this device (``--device``); the router
        # itself places nothing on it.
        self.device = str(device)
        self.worker_args = list(worker_args or [])
        self.journal_dir = journal_dir
        self.compile_cache_dir = compile_cache_dir
        self.affinity = affinity
        self.heartbeat_s = float(heartbeat_s)
        # Probe timeout scales with the heartbeat instead of a
        # hardcoded constant: injected link delay should raise
        # SUSPICION (gray verdicts), not instantly false-kill a
        # replica whose answers arrive late but arrive.
        self.probe_timeout_s = (float(probe_timeout_s)
                                if probe_timeout_s
                                else max(self.heartbeat_s * 4, 1.0))
        self.dead_misses = float(dead_misses)
        self.spill_slack = int(spill_slack)
        self.restart_dead = bool(restart_dead)
        self.worker_ready_timeout_s = float(worker_ready_timeout_s)
        # The fleet's service-wide solver defaults: the affinity key
        # must normalize request params exactly the way the WORKERS
        # will (their SolveService merges over these same defaults).
        # Hashing against the module defaults instead would split
        # same-bin traffic whenever a client spells a service default
        # explicitly — e.g. params={} vs params={"max_cycles": 60}
        # on a --cycles 60 fleet.
        self.default_params = dict(default_params or {})
        self.replicas: List[Replica] = []
        self._lock = threading.Lock()
        self._rr = itertools.count()
        self._pins: "OrderedDict[str, int]" = OrderedDict()
        self._session_pins: "OrderedDict[str, int]" = OrderedDict()
        # Epoch-fenced session ownership: the router is the epoch
        # authority.  Every repoint (migration, adoption) bumps the
        # session's epoch; PATCHes carry it; a replica still holding
        # the pre-repoint copy rejects/gets fenced instead of
        # double-applying events after a healed partition.
        self._session_epochs: "OrderedDict[str, int]" = OrderedDict()
        # replica index -> {session_id: epoch}: stale copies to fence
        # the moment that replica answers the prober again.
        self._fences: Dict[int, Dict[str, int]] = {}
        self._monitor: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._started = False
        self._run_dir: Optional[str] = None
        # The elastic control plane.  Autoscaling is armed only when
        # BOTH slo_p99_ms and max_replicas are set; no control-loop
        # thread starts in __init__ (policy tests construct routers
        # without start()).
        self.hosts = int(hosts)
        self.slo_p99_ms = (float(slo_p99_ms)
                           if slo_p99_ms else None)
        self.min_replicas = (int(min_replicas)
                             if min_replicas else None)
        self.max_replicas = (int(max_replicas)
                             if max_replicas else None)
        self.autoscale_interval_s = float(autoscale_interval_s)
        self.scale_down_quiet_checks = int(scale_down_quiet_checks)
        self.fair = FairScheduler(fair_share)
        self._lat: "deque[float]" = deque(maxlen=512)
        self._scaling = False
        self._quiet_checks = 0
        self._last_autoscale = 0.0
        # Admission exemplars for prewarming scaled-up replicas: the
        # most recent (dcop yaml, params) per structure digest, LRU-
        # bounded — replayed against a fresh worker before it takes
        # traffic, so its first client request finds its kernel
        # libraries loaded (from the shared library directory: the
        # prewarm loads them, it builds none).
        self._exemplars: "OrderedDict[str, Tuple[str, Any]]" = (
            OrderedDict())
        self.exemplar_keep = 8
        self.migrations = 0
        self.adopted_sessions = 0
        self.scale_ups = 0
        self.scale_downs = 0
        # Routing ledger (all mirrored on /stats).
        self.routed = 0
        self.affinity_hits = 0
        self.spillovers = 0
        self.shed = 0
        self.reroutes = 0
        self.deaths = 0
        self.retries = 0
        self.retry_budget_exceeded = 0
        self.fenced_sessions = 0
        # Fleet trace plane: the collector exists once a
        # front end attaches (attach_collector — it needs the bound
        # URL to push to worker span shippers); the trace tables map
        # router-minted request/session ids to their trace contexts
        # for the /fleet/forensics lookup.
        self.collector: Optional[fleettrace.FleetCollector] = None
        self.collector_url: Optional[str] = None
        self._request_traces: "OrderedDict[str, str]" = OrderedDict()
        self._session_traces: "OrderedDict[str, str]" = OrderedDict()
        reg = metrics_registry
        self._routed_total = reg.counter(
            "pydcop_router_requests_total",
            "Requests routed to replicas, by outcome")
        self._affinity_total = reg.counter(
            "pydcop_router_affinity_hits_total",
            "Routed requests that landed on a structure-warm replica")
        self._up_gauge = reg.gauge(
            "pydcop_router_replicas_up",
            "Live (heartbeat-passing) worker replicas")
        self._restarts_total = reg.counter(
            "pydcop_router_replica_restarts_total",
            "Worker replicas restarted after a death verdict")
        self._burn_gauge = reg.gauge(
            "pydcop_slo_burn_rate",
            "Rolling forwarded p99 over the --slo_p99_ms target "
            "(>1 means the fleet is burning error budget)")

    # -- lifecycle ----------------------------------------------------- #

    def start(self) -> "FleetRouter":
        import tempfile

        if self._started:
            return self
        self._was_active = metrics_registry.active
        metrics_registry.active = True
        self._run_dir = tempfile.mkdtemp(prefix="pydcop_fleet_")
        try:
            for k in range(self.n_replicas):
                journal = (os.path.join(self.journal_dir,
                                        f"replica-{k}")
                           if self.journal_dir else None)
                replica = Replica(
                    k, journal,
                    os.path.join(self._run_dir, f"replica-{k}.log"),
                    # Striped simulated host identity: replicas of
                    # one "host" share a fate in the host_kill chaos
                    # scenario while remaining socket-distinct
                    # processes.
                    host_id=f"host{k % self.hosts}")
                self.replicas.append(replica)
                self._spawn(replica, recover=False)
            deadline = time.monotonic() + self.worker_ready_timeout_s
            for replica in self.replicas:
                self._wait_ready(replica, deadline)
        except BaseException:
            # Partial startup must not orphan detached workers: one
            # replica failing to come up kills every one already
            # spawned (stop() is a no-op before _started flips).
            for replica in self.replicas:
                if replica.proc is not None \
                        and replica.proc.poll() is None:
                    try:
                        replica.proc.kill()
                        replica.proc.wait(timeout=10.0)
                    except (OSError, subprocess.TimeoutExpired):
                        pass
            self.replicas = []
            metrics_registry.active = self._was_active
            raise
        self._stopping.clear()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="pydcop-fleet-monitor",
            daemon=True)
        self._monitor.start()
        self._started = True
        self._up_gauge.set(self.up_count())
        return self

    def stop(self, drain: bool = True,
             timeout: float = 120.0) -> Dict[str, Any]:
        """Drain and stop the whole fleet: SIGTERM every worker (each
        drains its queue and journals leftovers replayable — the
        single-service contract), wait for clean exits, reap
        stragglers.  Returns per-worker exit codes."""
        if not self._started:
            return {"workers": []}
        self._stopping.set()
        if self._monitor is not None:
            self._monitor.join(timeout=max(self.heartbeat_s * 4, 2.0))
            self._monitor = None
        sig = signal.SIGTERM if drain else signal.SIGKILL
        for replica in self.replicas:
            if replica.proc is not None and replica.proc.poll() is None:
                try:
                    replica.proc.send_signal(sig)
                except OSError:
                    pass
        exits = []
        deadline = time.monotonic() + timeout
        for replica in self.replicas:
            code = None
            if replica.proc is not None:
                try:
                    code = replica.proc.wait(
                        timeout=max(deadline - time.monotonic(), 1.0))
                except subprocess.TimeoutExpired:
                    replica.proc.kill()
                    try:
                        code = replica.proc.wait(timeout=10.0)
                    except subprocess.TimeoutExpired:
                        code = None
            replica.status = DOWN
            exits.append({"index": replica.index, "exit": code,
                          "restarts": replica.restarts})
        # Final sweep: a restart thread that raced the signal loop
        # above may have spawned a replacement after its slot was
        # signaled — nothing it spawns may outlive the fleet.
        for replica in self.replicas:
            if replica.proc is not None \
                    and replica.proc.poll() is None:
                try:
                    replica.proc.kill()
                    replica.proc.wait(timeout=10.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        self._started = False
        metrics_registry.active = self._was_active
        return {"workers": exits}

    def _spawn(self, replica: Replica, recover: bool) -> None:
        """Start (or restart) worker k.  ``recover`` replays the
        slot's journal segment — the handoff: the restarted process
        owns its predecessor's acknowledged requests."""
        port_file = os.path.join(self._run_dir,
                                 f"replica-{replica.index}.port")
        try:
            os.unlink(port_file)
        except OSError:
            pass
        cmd = [sys.executable, "-m", "pydcop_tpu_torch.dcop_cli", "serve",
               "--port", "0", "--host", "127.0.0.1",
               "--port_file", port_file]
        if replica.journal_dir:
            cmd += ["--journal_dir", replica.journal_dir]
            if recover or os.path.exists(os.path.join(
                    replica.journal_dir, "requests.jnl")):
                cmd += ["--recover"]
        cmd += ["--device", self.device]
        cmd += self.worker_args
        env = dict(os.environ)
        if self.compile_cache_dir:
            # The worker builds and loads its kernel libraries there
            # (engine/aotcache.py), set before its first load.
            env["PYDCOP_COMPILE_CACHE_DIR"] = self.compile_cache_dir
        log = open(replica.log_path, "ab")
        try:
            replica.proc = subprocess.Popen(
                cmd, env=env, stdout=log, stderr=log,
                start_new_session=True)
        finally:
            log.close()
        if self._stopping.is_set():
            # A scale-up or restart thread that raced stop(): stop()'s
            # final sweep may already have run, so nothing spawned now
            # may outlive the fleet.
            replica.proc.kill()
            replica.proc.wait(timeout=10.0)
            raise RuntimeError(
                f"fleet stopping: worker {replica.index} not started")
        replica.port = None
        replica.status = STARTING if replica.restarts == 0 \
            else RESTARTING
        replica.breaker_open = False
        # A fresh process is NOT warm, whatever its predecessor ran:
        # affinity hit accounting restarts from zero (the shared
        # library directory spares it the builds, but its dispatch
        # caches start empty — counting it as a hit would inflate
        # affinity_hit_fraction after every death).
        replica.warm = set()
        logger.info("replica %d spawned (pid %d%s)", replica.index,
                    replica.proc.pid,
                    ", recover" if recover else "")

    def _wait_ready(self, replica: Replica, deadline: float) -> None:
        port_file = os.path.join(self._run_dir,
                                 f"replica-{replica.index}.port")
        while time.monotonic() < deadline:
            if replica.proc.poll() is not None:
                raise RuntimeError(
                    f"fleet worker {replica.index} died on startup "
                    f"(exit {replica.proc.returncode}); log: "
                    f"{replica.log_path}")
            try:
                with open(port_file, encoding="utf-8") as f:
                    replica.port = int(f.read().strip())
            except (OSError, ValueError):
                time.sleep(0.05)
                continue
            try:
                status, _ctype, _body = self._forward(
                    replica, "GET", "/healthz", None,
                    timeout=self.probe_timeout_s, trace=None)
            except OSError:
                time.sleep(0.05)
                continue
            if status in (200, 503):
                from pydcop_tpu_torch.resilience.health import (
                    PhiAccrualEstimator,
                )

                now = time.monotonic()
                replica.estimator = PhiAccrualEstimator(
                    expected=self.heartbeat_s)
                replica.anchor = now
                replica.estimator.beat(now)
                replica.status = UP
                replica.death_handled = False
                # A (re)started worker's span shipper starts blank:
                # re-push the collector address so its spans keep
                # landing in the fleet trace (no-op before a front
                # end attaches).
                self.push_trace_config(replica)
                logger.info("replica %d ready on %s", replica.index,
                            replica.url)
                return
            time.sleep(0.05)
        raise RuntimeError(
            f"fleet worker {replica.index} never became ready; "
            f"log: {replica.log_path}")

    # -- health & restarts --------------------------------------------- #

    def up_count(self) -> int:
        return sum(1 for r in self.replicas if r.status == UP)

    def _monitor_loop(self) -> None:
        while not self._stopping.wait(self.heartbeat_s):
            # A snapshot: the autoscaler appends replicas concurrently.
            for replica in list(self.replicas):
                if self._stopping.is_set():
                    return
                try:
                    self._probe(replica)
                except Exception:  # noqa: BLE001 — the prober must
                    # outlive any single replica's weirdness.
                    logger.exception("heartbeat probe crashed for "
                                     "replica %d", replica.index)
            self._up_gauge.set(self.up_count())
            if self.slo_p99_ms:
                # SLO burn rate: rolling p99 over the target.  A
                # fleet with no recent traffic burns nothing.
                p99 = self.rolling_p99()
                self._burn_gauge.set(
                    round(p99 / self.slo_p99_ms, 6) if p99 else 0.0)
            try:
                self._maybe_autoscale()
            except Exception:  # noqa: BLE001 — the control loop must
                # never take the prober down with it.
                logger.exception("autoscale check crashed")

    def _probe(self, replica: Replica) -> None:
        if replica.retired:
            return  # scaled away on purpose — not a death
        if replica.status not in (UP, DOWN):
            return  # mid-(re)start/drain — that path owns it
        proc_dead = (replica.proc is not None
                     and replica.proc.poll() is not None)
        beat_ok = False
        t_probe = time.monotonic()
        if not proc_dead and replica.port is not None:
            try:
                status, _ctype, body = self._forward(
                    replica, "GET", "/healthz", None,
                    timeout=self.probe_timeout_s, trace=None)
                beat_ok = status in (200, 503)
                if beat_ok:
                    doc = json.loads(body)
                    serving = doc.get("serving") or {}
                    replica.breaker_open = (
                        serving.get("breaker_state") == "open")
                    replica.queue_depth = int(
                        serving.get("queue_depth") or 0)
            except (OSError, ValueError):
                beat_ok = False
        now = time.monotonic()
        if beat_ok:
            # Latency-aware scoring: an answer that took a large
            # fraction of the probe timeout marks the link GRAY
            # (slow-but-alive).  Gray is a /healthz verdict, not a
            # routing change — suspicion is advisory.
            dt_ms = (now - t_probe) * 1000.0
            replica.probe_ewma_ms = (
                dt_ms if replica.probe_ewma_ms is None
                else 0.7 * replica.probe_ewma_ms + 0.3 * dt_ms)
            replica.gray = (replica.probe_ewma_ms
                            > self.gray_threshold_ms())
            if replica.status == DOWN:
                # A replica marked down on a forward error but whose
                # process lived: it answered again — back in service.
                # A healed partition heals HERE, which is exactly
                # where its stale session copies must be fenced
                # before any client byte can reach them.
                replica.status = UP
                replica.death_handled = False
                self._flush_fences(replica)
            replica.estimator.beat(now)
            return
        replica.gray = False
        missed = (replica.estimator.missed(now, replica.anchor)
                  if replica.estimator else float("inf"))
        # One verdict per down-episode: re-declaring every beat would
        # inflate the death count and re-run adoption against an
        # already-drained segment.  The episode ends at the beat_ok
        # revival above.
        if not replica.death_handled \
                and (proc_dead or missed >= self.dead_misses):
            self._declare_dead(replica, proc_dead=proc_dead,
                               missed=missed)

    def _declare_dead(self, replica: Replica, proc_dead: bool,
                      missed: float) -> None:
        if replica.status == RESTARTING or self._stopping.is_set():
            # A fleet mid-shutdown SIGTERMs its own workers; the
            # monitor must not mistake those exits for deaths and
            # restart what stop() is draining.
            return
        replica.death_handled = True
        self.deaths += 1
        logger.warning(
            "replica %d declared dead (%s, %.1f expected heartbeats "
            "silent)", replica.index,
            "process exited" if proc_dead else "heartbeat silence",
            missed if missed != float("inf") else -1.0)
        replica.status = RESTARTING
        if replica.proc is not None and replica.proc.poll() is None:
            try:
                replica.proc.kill()
                replica.proc.wait(timeout=10.0)
            except (OSError, subprocess.TimeoutExpired):
                pass
        if not replica.managed:
            # A remote replica is not ours to restart: route around
            # it.  The DOWN slot revives when it answers the prober
            # again or re-announces at /fleet/join.  If it announced
            # a reachable journal segment (same-box remote), its warm
            # sessions are adoptable exactly like a managed death —
            # and the adoption's epoch bump is what fences the
            # partitioned original when it heals.
            replica.status = DOWN
            if replica.journal_dir:
                threading.Thread(
                    target=self._adopt_from, args=(replica,),
                    name=f"pydcop-fleet-adopt-{replica.index}",
                    daemon=True).start()
            return
        if not self.restart_dead:
            replica.status = DOWN
            return
        replica.restarts += 1
        self._restarts_total.inc()
        # Restart OFF the monitor thread: a replacement worker takes
        # seconds to import and become ready, and the prober must keep
        # watching the OTHER replicas meanwhile (a second simultaneous
        # death must still be detected within the advertised bound).
        # The status is already RESTARTING, so the monitor skips this
        # slot until the restart thread resolves it to UP or DOWN.
        threading.Thread(
            target=self._restart, args=(replica,),
            name=f"pydcop-fleet-restart-{replica.index}",
            daemon=True).start()

    def _adopt_from(self, replica: Replica) -> None:
        """Compact a dead replica's journal segment and ADOPT its
        open sessions onto survivors (serving/migration.py).  Safe to
        fail: whatever doesn't adopt stays in the segment for a
        restart-in-place replay."""
        try:
            from pydcop_tpu_torch.serving import migration as migration_mod

            adopted = migration_mod.adopt_dead_sessions(self, replica)
            if adopted:
                with self._lock:
                    self.adopted_sessions += adopted
        except Exception:  # noqa: BLE001 — adoption is an
            # optimization over restart-in-place, never a
            # precondition for it.
            logger.exception(
                "replica %d: dead-session adoption failed; "
                "falling back to restart-in-place replay",
                replica.index)

    def _restart(self, replica: Replica) -> None:
        if self._stopping.is_set():
            replica.status = DOWN
            return
        if replica.journal_dir:
            # Before the replacement replays anything: compact the
            # dead segment (torn tail truncated, completed records
            # dropped — the --recover replay visits only pending
            # records) and ADOPT its open sessions onto survivors.
            # Adopted sessions resume warm on a live replica in
            # seconds; whatever fails to adopt stays in the segment
            # for the restart-in-place replay — strictly the old
            # behavior, never worse.
            self._adopt_from(replica)
        try:
            # The journal handoff: --recover replays the dead
            # worker's acknowledged-but-unfinished requests and open
            # sessions through the fresh process.
            self._spawn(replica, recover=True)
            self._wait_ready(
                replica,
                time.monotonic() + self.worker_ready_timeout_s)
            # The fresh process recovered a journal whose adopted
            # sessions carry a MIGRATED close — but if that append
            # raced the death, the fence table still knows.
            self._flush_fences(replica)
        except Exception:  # noqa: BLE001
            logger.exception("replica %d restart failed",
                             replica.index)
            replica.status = DOWN

    # -- routing -------------------------------------------------------- #

    def candidates(self) -> List[Replica]:
        return [r for r in self.replicas
                if r.status == UP and not r.breaker_open]

    def pick(self, digest: Optional[str],
             detail: Optional[Dict[str, Any]] = None
             ) -> Tuple[Replica, bool]:
        """Choose the replica for one admission.  Returns
        ``(replica, affinity_hit)``; raises :class:`FleetUnavailable`
        when every replica is down or shedding.  ``detail`` (an
        optional caller-owned dict) is filled with the route-pick
        reason — chosen replica, affinity hit, spillover — so the
        trace plane can record WHY without a second lock trip."""
        with self._lock:
            live = self.candidates()
            if not live:
                self.shed += 1
                self._routed_total.inc(outcome="shed")
                raise FleetUnavailable(
                    "no healthy replica available (all down or "
                    "breaker-open)")
            if self.affinity == "round_robin" or digest is None:
                chosen = live[next(self._rr) % len(live)]
                spilled = False
            else:
                ranked = sorted(
                    live, key=lambda r: _rendezvous_score(
                        digest, r.index),
                    reverse=True)
                chosen = ranked[0]
                idlest = min(live, key=lambda r: r.in_flight)
                spilled = (chosen.in_flight
                           >= idlest.in_flight + self.spill_slack)
                if spilled:
                    # Hot-spot overflow: a structure-warm replica
                    # deep in flight loses to the idlest one — the
                    # cold compile there costs less than queueing
                    # behind the backlog (and warms a second home for
                    # the structure while it's hot).
                    chosen = idlest
                    self.spillovers += 1
            hit = digest is not None and digest in chosen.warm
            if digest is not None:
                chosen.warm.add(digest)
            chosen.in_flight += 1
            chosen.forwarded += 1
            self.routed += 1
            if hit:
                self.affinity_hits += 1
        if detail is not None:
            detail.update({
                "replica": chosen.index,
                "host_id": chosen.host_id,
                "affinity_hit": hit,
                "spilled": spilled,
                "reason": ("spillover" if spilled
                           else "affinity" if hit
                           else "round_robin"
                           if (self.affinity == "round_robin"
                               or digest is None)
                           else "rendezvous"),
            })
        self._routed_total.inc(outcome="spillover" if spilled
                               else "affinity" if hit else "routed")
        if hit:
            self._affinity_total.inc()
        return chosen, hit

    def release(self, replica: Replica) -> None:
        with self._lock:
            replica.in_flight = max(replica.in_flight - 1, 0)

    def pin(self, request_id: str, replica: Replica,
            table: Optional["OrderedDict[str, int]"] = None) -> None:
        table = self._pins if table is None else table
        with self._lock:
            table[request_id] = replica.index
            while len(table) > PIN_KEEP:
                table.popitem(last=False)

    def pinned(self, request_id: str,
               table: Optional["OrderedDict[str, int]"] = None
               ) -> Optional[Replica]:
        table = self._pins if table is None else table
        with self._lock:
            index = table.get(request_id)
        return self.replicas[index] if index is not None else None

    def mark_forward_error(self, replica: Replica) -> None:
        """A live forward failed at the socket: stop routing there
        NOW; the heartbeat prober (or the process reaper) confirms
        death and owns the restart."""
        with self._lock:
            replica.errors += 1
            if replica.status == UP:
                replica.status = DOWN

    def gray_threshold_ms(self) -> float:
        """Probe EWMA above this marks a link gray: a healthy
        in-box probe answers in single-digit milliseconds, so a
        sustained large fraction of the probe timeout is a slow link,
        not noise."""
        return max(0.35 * self.probe_timeout_s * 1000.0, 120.0)

    # -- epoch-fenced session ownership --------------------------------- #

    def session_epoch(self, session_id: str) -> int:
        with self._lock:
            return self._session_epochs.get(session_id, 1)

    def note_session(self, session_id: str) -> None:
        """A session opened through the router: epoch authority
        starts at 1 (what the worker journaled)."""
        with self._lock:
            self._session_epochs.setdefault(session_id, 1)
            while len(self._session_epochs) > PIN_KEEP:
                self._session_epochs.popitem(last=False)

    def bump_epoch(self, session_id: str, floor: int = 0) -> int:
        """Advance a session's ownership epoch — called by every
        repoint (migration, dead-session adoption) BEFORE the new
        owner takes traffic.  Monotonic for the session's lifetime:
        the returned epoch is journaled by the new owner and carried
        on every PATCH the router forwards.  ``floor`` lets a caller
        that saw a higher epoch in a journal (adoption of a copy that
        itself migrated in) keep the advance strictly past it."""
        with self._lock:
            epoch = max(self._session_epochs.get(session_id, 1) + 1,
                        int(floor))
            self._session_epochs[session_id] = epoch
            self._session_epochs.move_to_end(session_id)
            while len(self._session_epochs) > PIN_KEEP:
                self._session_epochs.popitem(last=False)
            return epoch

    def record_fence(self, index: int, session_id: str,
                     epoch: int) -> None:
        """Remember that replica ``index`` holds a STALE copy of the
        session as of ``epoch``: the moment that replica answers the
        prober again (healed partition, revived slot) it gets fenced
        before a client byte can reach the stale copy."""
        with self._lock:
            table = self._fences.setdefault(index, {})
            table[session_id] = max(epoch,
                                    table.get(session_id, 0))

    def _flush_fences(self, replica: Replica) -> None:
        with self._lock:
            pending = self._fences.pop(replica.index, None)
        if not pending:
            return
        for sid, epoch in pending.items():
            # The fence travels in the session's own fleet trace:
            # forensics on a migrated session shows WHEN its stale
            # copy was revoked, not just that it was.
            ctx = fleettrace.TraceContext(
                self.trace_for(sid) or uuid.uuid4().hex[:16])
            try:
                self._forward(
                    replica, "POST", "/admin/fence_session",
                    json.dumps({"session_id": sid,
                                "epoch": epoch}).encode(),
                    timeout=self.probe_timeout_s, trace=ctx)
                with self._lock:
                    self.fenced_sessions += 1
                if tracer.active:
                    tracer.instant("router_fence_flush", "fleet",
                                   trace_id=ctx.trace_id, session=sid,
                                   epoch=epoch, replica=replica.index)
                logger.info("fenced stale session %s (epoch %d) on "
                            "replica %d", sid, epoch, replica.index)
            except OSError:
                # It answered once, it will answer the prober again —
                # re-arm so the next heal attempt retries the fence.
                self.record_fence(replica.index, sid, epoch)

    # -- fleet trace plane ---------------------------------------------- #

    def attach_collector(self, url: str) -> None:
        """Arm the fleet trace plane: create the collector, tap the
        router's own flight recorder into it (route-pick/retry/fence
        spans land in the merged trace's ``router`` lane), and push
        the collector address to every live replica's span shipper.
        The front end calls this once it knows its bound URL;
        idempotent, and a no-op with ``PYDCOP_FLEET_TRACE=0``."""
        self.collector_url = url
        if not fleettrace.enabled():
            return
        if self.collector is None:
            self.collector = fleettrace.FleetCollector()
        self.collector.attach_router_tap()
        for replica in list(self.replicas):
            if replica.status == UP:
                self.push_trace_config(replica)

    def detach_collector(self) -> None:
        """Disarm the plane: stop observing router spans, tell live
        replicas to stop shipping.  Collected events stay queryable
        (a stopped fleet's trace is still forensics material)."""
        if self.collector is not None:
            self.collector.detach_router_tap()
        for replica in list(self.replicas):
            if replica.status == UP:
                self.push_trace_config(replica, enable=False)

    def set_fleet_trace(self, on: bool) -> None:
        """Runtime toggle (the perf-smoke pairwise gate flips this
        between timed phases): sets the env knob gating this
        process's header stamping and minting, then re-arms or
        disarms the collector and every worker's shipper."""
        os.environ[fleettrace.ENV_KNOB] = "1" if on else "0"
        if on and self.collector_url:
            self.attach_collector(self.collector_url)
        elif not on:
            self.detach_collector()

    def push_trace_config(self, replica: Replica,
                          enable: bool = True) -> None:
        """Tell one replica where to ship completed spans.  Best
        effort by contract: telemetry config must never become a
        lifecycle dependency — a failed push just means that
        replica's lane stays empty until the next heal/restart."""
        if self.collector_url is None:
            return
        body = json.dumps({
            "url": self.collector_url,
            "source": f"replica-{replica.index}",
            "enable": bool(enable and fleettrace.enabled()),
        }).encode()
        try:
            self._forward(replica, "POST", "/admin/trace_collector",
                          body, timeout=10.0, trace=None)
        except OSError:
            logger.debug("replica %d trace-collector config push "
                         "failed", replica.index)

    def note_request_trace(self, rid: str, trace_id: str) -> None:
        with self._lock:
            self._request_traces[rid] = trace_id
            while len(self._request_traces) > PIN_KEEP:
                self._request_traces.popitem(last=False)

    def note_session_trace(self, sid: str, trace_id: str) -> None:
        with self._lock:
            self._session_traces[sid] = trace_id
            while len(self._session_traces) > PIN_KEEP:
                self._session_traces.popitem(last=False)

    def trace_for(self, handle: str) -> Optional[str]:
        """The trace id behind a router-minted request id or a
        session id — the ``/fleet/forensics/<id>`` entry point."""
        with self._lock:
            return (self._request_traces.get(handle)
                    or self._session_traces.get(handle))

    # -- multi-host membership ------------------------------------------ #

    def register_remote(self, url: str,
                        host_id: Optional[str] = None,
                        journal_dir: Optional[str] = None
                        ) -> Dict[str, Any]:
        """Admit a remote replica that announced itself (``POST
        /fleet/join`` — a worker started with ``--join``).  The slot
        is probed before admission and then heartbeat-scored exactly
        like a local one; a re-announce of the same address revives
        its existing slot (same index → existing pins stay valid).
        ``journal_dir`` is the worker's own journal segment when the
        router can reach it on disk (same-box remotes, the CI
        topology): it makes the remote's sessions adoptable after a
        death/partition verdict.  Raises ValueError for a bad
        address, RuntimeError when the announced endpoint doesn't
        answer /healthz."""
        from urllib.parse import urlparse

        parsed = urlparse(url if "//" in url else f"http://{url}")
        host, port = parsed.hostname, parsed.port
        if not host or not port:
            raise ValueError(
                f"bad replica url {url!r} (need host:port)")
        with self._lock:
            replica = next(
                (r for r in self.replicas
                 if not r.managed and r.host == host
                 and r.port == port), None)
            if replica is None:
                import tempfile

                index = len(self.replicas)
                log_path = os.path.join(
                    self._run_dir or tempfile.gettempdir(),
                    f"remote-{index}.log")
                replica = Replica(index, None, log_path, host=host,
                                  managed=False, host_id=host_id)
                replica.port = int(port)
                self.replicas.append(replica)
            if journal_dir and os.path.isdir(journal_dir):
                replica.journal_dir = journal_dir
        try:
            status, _ctype, _body = self._forward(
                replica, "GET", "/healthz", None, timeout=5.0,
                trace=None)
        except OSError as exc:
            with self._lock:
                if replica.status != UP:
                    replica.status = DOWN
            raise RuntimeError(
                f"joining replica {url} failed its admission probe: "
                f"{exc}")
        if status not in (200, 503):
            raise RuntimeError(
                f"joining replica {url} answered /healthz with "
                f"{status}")
        from pydcop_tpu_torch.resilience.health import PhiAccrualEstimator

        now = time.monotonic()
        with self._lock:
            replica.estimator = PhiAccrualEstimator(
                expected=self.heartbeat_s)
            replica.anchor = now
            replica.estimator.beat(now)
            replica.retired = False
            if host_id:
                replica.host_id = host_id
            replica.status = UP
            replica.death_handled = False
        # A re-announce is a heal: stale session copies recorded
        # against this slot get fenced before it serves.
        self._flush_fences(replica)
        # Joined replicas ship spans like spawned ones: hand the
        # fresh member the collector address.
        self.push_trace_config(replica)
        self._up_gauge.set(self.up_count())
        logger.info("remote replica %d joined from %s (host %s)",
                    replica.index, replica.url, replica.host_id)
        return {"index": replica.index, "status": UP,
                "heartbeat_s": self.heartbeat_s}

    # -- SLO autoscaling ------------------------------------------------ #

    def record_latency(self, ms: float) -> None:
        with self._lock:
            self._lat.append(float(ms))

    def rolling_p99(self) -> Optional[float]:
        with self._lock:
            lat = sorted(self._lat)
        if not lat:
            return None
        return lat[min(int(0.99 * len(lat)), len(lat) - 1)]

    def note_exemplar(self, digest: Optional[str], dcop_yaml: str,
                      params: Optional[Dict[str, Any]]) -> None:
        """Remember one admission per structure digest for replica
        prewarming (LRU over ``exemplar_keep`` structures)."""
        if digest is None:
            return
        with self._lock:
            self._exemplars[digest] = (dcop_yaml, params)
            self._exemplars.move_to_end(digest)
            while len(self._exemplars) > self.exemplar_keep:
                self._exemplars.popitem(last=False)

    def autoscale_decision(self) -> Optional[str]:
        """The scaling policy, side-effect-free except for the quiet-
        streak counter: ``"up"`` when the rolling p99 breaches the
        SLO (or queues run deep) with headroom below max_replicas;
        ``"down"`` after ``scale_down_quiet_checks`` consecutive
        checks comfortably under it with an idle replica above the
        floor; None otherwise.  Inert unless both ``slo_p99_ms`` and
        ``max_replicas`` are configured."""
        if not self.slo_p99_ms or not self.max_replicas:
            return None
        p99 = self.rolling_p99()
        with self._lock:
            managed = [r for r in self.replicas
                       if r.managed and not r.retired]
            live = [r for r in managed if r.status == UP]
            n_active = len([r for r in managed
                            if r.status in (UP, STARTING,
                                            RESTARTING, DRAINING)])
            queue_depth = sum(r.queue_depth for r in live)
        floor = self.min_replicas or 1
        if n_active < self.max_replicas and (
                (p99 is not None and p99 > self.slo_p99_ms)
                or queue_depth > 2 * max(len(live), 1)):
            self._quiet_checks = 0
            return "up"
        if n_active > floor and (
                (p99 is None or p99 < self.slo_p99_ms / 2)
                and queue_depth == 0
                and any(r.in_flight == 0 for r in live)):
            self._quiet_checks += 1
            if self._quiet_checks >= self.scale_down_quiet_checks:
                self._quiet_checks = 0
                return "down"
            return None
        self._quiet_checks = 0
        return None

    def _maybe_autoscale(self) -> None:
        if not self.slo_p99_ms or not self.max_replicas:
            return
        if self._scaling or self._stopping.is_set():
            return
        now = time.monotonic()
        if now - self._last_autoscale < self.autoscale_interval_s:
            return
        decision = self.autoscale_decision()
        if decision is None:
            return
        self._last_autoscale = now
        self._scaling = True
        # Off the monitor thread: a spawn takes seconds of import
        # and the prober must keep watching the fleet meanwhile.
        threading.Thread(
            target=self._scale, args=(decision,),
            name="pydcop-fleet-scale", daemon=True).start()

    def _scale(self, decision: str) -> None:
        try:
            if decision == "up":
                self._scale_up()
            else:
                self._scale_down()
        except Exception:  # noqa: BLE001
            logger.exception("autoscale %s failed", decision)
        finally:
            self._scaling = False

    def _scale_up(self) -> None:
        with self._lock:
            index = len(self.replicas)
            journal = (os.path.join(self.journal_dir,
                                    f"replica-{index}")
                       if self.journal_dir else None)
            replica = Replica(
                index, journal,
                os.path.join(self._run_dir, f"replica-{index}.log"),
                host_id=f"host{index % self.hosts}")
            self.replicas.append(replica)
            self.n_replicas += 1
        logger.info("autoscale up: spawning replica %d", index)
        self._spawn(replica, recover=False)
        self._wait_ready(
            replica, time.monotonic() + self.worker_ready_timeout_s)
        # Prewarm BEFORE taking traffic: _wait_ready flipped the slot
        # UP; hold it back out of the candidate set while the
        # exemplars replay (each loads its kernel libraries from the
        # shared library directory and builds none).
        replica.status = STARTING
        self._prewarm(replica)
        replica.status = UP
        with self._lock:
            self.scale_ups += 1
            # The SLO window must not keep scaling on latencies
            # measured by the smaller fleet.
            self._lat.clear()
        self._up_gauge.set(self.up_count())
        logger.info("autoscale up: replica %d serving", index)

    def _prewarm(self, replica: Replica) -> None:
        with self._lock:
            exemplars = list(self._exemplars.items())
        for digest, (dcop_yaml, params) in exemplars[-4:]:
            body: Dict[str, Any] = {"dcop": dcop_yaml,
                                    "wait": True, "timeout": 60.0}
            if params:
                body["params"] = params
            try:
                self._forward(replica, "POST", "/solve",
                              json.dumps(body).encode(),
                              timeout=90.0, trace=None)
                # Unlike a crash respawn, this replica genuinely
                # executed the structure: its libraries are loaded and
                # its dispatch caches warm for it.
                replica.warm.add(digest)
            except OSError as exc:
                logger.warning(
                    "replica %d prewarm forward failed (%s)",
                    replica.index, exc)
                return

    def _scale_down(self) -> None:
        with self._lock:
            live = [r for r in self.replicas
                    if r.managed and not r.retired
                    and r.status == UP]
            floor = self.min_replicas or 1
            if len(live) <= floor:
                return
            victim = next(
                (r for r in reversed(live)
                 if r.in_flight == 0 and r.queue_depth == 0), None)
            if victim is None:
                return
            victim.status = DRAINING
        logger.info("autoscale down: draining replica %d",
                    victim.index)
        with self._lock:
            sids = [sid for sid, idx in self._session_pins.items()
                    if idx == victim.index]
        from pydcop_tpu_torch.serving import migration as migration_mod

        for sid in sids:
            try:
                migration_mod.migrate_session(self, sid)
            except Exception:  # noqa: BLE001 — a drain that can't
                # move every session aborts: the replica goes back to
                # serving rather than stranding a warm session.
                logger.exception(
                    "autoscale down aborted: session %s would not "
                    "migrate off replica %d", sid, victim.index)
                victim.status = UP
                return
        if victim.proc is not None and victim.proc.poll() is None:
            try:
                victim.proc.send_signal(signal.SIGTERM)
                victim.proc.wait(timeout=60.0)
            except (OSError, subprocess.TimeoutExpired):
                try:
                    victim.proc.kill()
                    victim.proc.wait(timeout=10.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        with self._lock:
            victim.status = DOWN
            victim.retired = True
            self.scale_downs += 1
            self.n_replicas = max(self.n_replicas - 1, 1)
            self._lat.clear()
        self._up_gauge.set(self.up_count())
        logger.info("autoscale down: replica %d retired",
                    victim.index)

    # -- plumbing ------------------------------------------------------- #

    def _forward(self, replica: Replica, method: str, path: str,
                 body: Optional[bytes],
                 timeout: float = FORWARD_TIMEOUT_S,
                 trace: Optional[fleettrace.TraceContext] = None
                 ) -> Tuple[int, str, bytes]:
        # Every router->replica byte crosses the netfault seam: a
        # connect refusal (or an injected drop/partition) surfaces as
        # ForwardNotSent — zero bytes delivered, retry-safe — while
        # anything past the connect stays a plain, ambiguous OSError
        # (including an injected lost response).
        #
        # ``trace`` is mandatory at every call site (the static-check
        # trace-seam lint enforces the explicit kwarg): request-plane
        # forwards carry the admission context so the replica's spans
        # join the fleet trace; telemetry-plane probes pass
        # ``trace=None`` on purpose.
        headers = None
        trace_cm = contextlib.nullcontext()
        if trace is not None and fleettrace.enabled():
            headers = {fleettrace.HEADER: trace.encode()}
            if tracer.active:
                # Thread-bound context: anything recorded UNDER this
                # exchange (a netfault injection instant, most
                # usefully) lands inside the request's causal tree.
                trace_cm = tracer.context(trace_ids=[trace.trace_id])
        with trace_cm:
            return netfault.exchange(
                "router",
                (f"replica-{replica.index}", replica.host_id or ""),
                replica.host, replica.port, method, path,
                body=body, timeout=timeout, headers=headers)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            routed = self.routed
            hits = self.affinity_hits
            doc = {
                "replicas": self.n_replicas,
                "up": self.up_count(),
                "affinity": self.affinity,
                "routed": routed,
                "affinity_hits": hits,
                "affinity_hit_fraction": (round(hits / routed, 4)
                                          if routed else None),
                "spillovers": self.spillovers,
                "shed": self.shed,
                "reroutes": self.reroutes,
                "deaths": self.deaths,
                "retries": self.retries,
                "retry_budget_exceeded": self.retry_budget_exceeded,
                "fenced_sessions": self.fenced_sessions,
                "migrations": self.migrations,
                "adopted_sessions": self.adopted_sessions,
                "spill_slack": self.spill_slack,
                "heartbeat_s": self.heartbeat_s,
                "probe_timeout_s": self.probe_timeout_s,
                "hosts": self.hosts,
                "pinned_requests": len(self._pins),
                "pinned_sessions": len(self._session_pins),
                "workers": [r.summary() for r in self.replicas],
            }
        doc["fairness"] = self.fair.stats()
        if self.slo_p99_ms:
            doc["autoscale"] = {
                "slo_p99_ms": self.slo_p99_ms,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "rolling_p99_ms": self.rolling_p99(),
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
            }
        from pydcop_tpu_torch.engine import aotcache

        # The router loads no kernel library, so its own cache counts
        # mean nothing; report the SHARED directory its workers build
        # into and load from.
        doc["compile_cache"] = {"dir": self.compile_cache_dir}
        if self.compile_cache_dir:
            doc["compile_cache"].update(
                aotcache.disk_stats(self.compile_cache_dir))
        return doc

    def link_verdicts(self) -> List[Dict[str, Any]]:
        """Per-link router->replica health verdicts: ``ok``, ``gray``
        (slow-but-alive — answers arrive, late), ``starting``
        (mid-(re)start/drain) or ``dead``.  Retired slots (scaled
        away on purpose) don't count against the fleet."""
        out = []
        for r in self.replicas:
            if r.retired:
                continue
            if r.status == UP:
                verdict = "gray" if r.gray else "ok"
            elif r.status in (STARTING, RESTARTING, DRAINING):
                verdict = "starting"
            else:
                verdict = "dead"
            out.append({
                "replica": r.index, "host_id": r.host_id,
                "status": r.status, "verdict": verdict,
                "probe_ms": (round(r.probe_ewma_ms, 2)
                             if r.probe_ewma_ms is not None
                             else None),
            })
        return out

    def health_summary(self) -> Dict[str, Any]:
        """The fleet /healthz: failing (503) only when NOTHING can
        serve; degraded while any replica is down/restarting OR any
        link's verdict is not ok (gray failure must not hide behind a
        green fleet light)."""
        up = self.up_count()
        links = self.link_verdicts()
        degraded = (up < self.n_replicas
                    or any(l["verdict"] != "ok" for l in links))
        status = ("failing" if up == 0
                  else "degraded" if degraded else "ok")
        doc = {"status": status, "fleet": {
            "replicas": self.n_replicas, "up": up,
            "links": links,
            "workers": [r.summary() for r in self.replicas],
        }}
        injected = netfault.counters()
        if injected:
            doc["fleet"]["netfault_injected"] = injected
        return doc


class _RouterHandler(_Handler):
    """The fleet's client-facing wire protocol — same routes as the
    single-service front end (serving/http.py), implemented by
    admission-time routing + forwarding."""

    def _json(self, code: int, payload: Dict[str, Any],
              close: bool = False):
        self._reply(code, json.dumps(payload, default=str).encode(),
                    "application/json", close=close)

    def _read_body(self) -> Optional[bytes]:
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = 0
        if length <= 0 or length > MAX_BODY_BYTES:
            self._json(400, {"error": "body required (JSON, "
                                      f"<= {MAX_BODY_BYTES} bytes)"},
                       close=True)
            return None
        return self.rfile.read(length)

    @property
    def router(self) -> FleetRouter:
        return self.telemetry.router

    def _proxy(self, replica: Replica, method: str, path: str,
               body: Optional[bytes],
               timeout: float = FORWARD_TIMEOUT_S,
               trace=None) -> None:
        try:
            status, ctype, payload = self.router._forward(
                replica, method, path, body, timeout=timeout,
                trace=trace)
        except ForwardNotSent as exc:
            # Zero bytes reached the worker: the operation certainly
            # did not happen.
            self.router.mark_forward_error(replica)
            self._json(503, {
                "error": f"replica {replica.index} unreachable "
                         f"({exc}); recovering — retry",
                "status": "rejected", "retry": True})
            return
        except OSError as exc:
            # The request MAY have been received (and, for a PATCH,
            # acked into the journal) before the socket died: the
            # client must reconcile, not blind-resend.
            self.router.mark_forward_error(replica)
            self._json(503, {
                "error": f"replica {replica.index} failed mid-"
                         f"request ({exc}); outcome unknown — "
                         "reconcile before retrying",
                "status": "unknown", "retry": True})
            return
        self._reply(status, payload, ctype)

    # -- request plane -------------------------------------------------- #

    def do_POST(self):  # noqa: N802 — stdlib name
        path = self.path.split("?", 1)[0]
        if path == "/solve":
            self._route_solve()
        elif path == "/session":
            self._route_session_open()
        elif path == "/fleet/join":
            self._fleet_join()
        elif path == "/fleet/spans":
            self._fleet_spans()
        elif path == "/admin/migrate":
            self._admin_migrate()
        else:
            self._json(404, {"error": "unknown path"}, close=True)

    def _fleet_join(self):
        raw = self._read_body()
        if raw is None:
            return
        try:
            doc = json.loads(raw)
            url = doc.get("url")
            if not url or not isinstance(url, str):
                raise ValueError("body needs a 'url' string "
                                 "(the joining replica's address)")
        except ValueError as exc:
            self._json(400, {"error": f"bad join body: {exc}"})
            return
        try:
            out = self.router.register_remote(
                url, doc.get("host_id"),
                journal_dir=doc.get("journal_dir"))
        except ValueError as exc:
            self._json(400, {"error": str(exc)})
            return
        except RuntimeError as exc:
            self._json(503, {"error": str(exc), "retry": True})
            return
        self._json(200, out)

    def _admin_migrate(self):
        raw = self._read_body()
        if raw is None:
            return
        try:
            doc = json.loads(raw)
            sid = doc.get("session_id")
            if not sid or not isinstance(sid, str):
                raise ValueError("body needs a 'session_id'")
            target = doc.get("target")
            if target is not None and not isinstance(target, int):
                raise ValueError("'target' must be a replica index")
        except ValueError as exc:
            self._json(400, {"error": f"bad migrate body: {exc}"})
            return
        from pydcop_tpu_torch.serving import migration as migration_mod

        try:
            out = migration_mod.migrate_session(
                self.router, sid, target_index=target)
        except KeyError:
            self._json(404, {"error": f"unknown session {sid!r}"})
            return
        except ValueError as exc:
            self._json(400, {"error": str(exc)})
            return
        except (OSError, RuntimeError) as exc:
            self._json(503, {"error": str(exc), "retry": True})
            return
        self._json(200, out)

    def _admission_key(self, raw: bytes
                       ) -> Tuple[Optional[dict], Optional[str]]:
        """Parse the body far enough to route: returns (body json,
        affinity digest).  Malformed bodies get their 4xx HERE — the
        router is the client's first contact and must speak the same
        validation language as a worker."""
        try:
            body = json.loads(raw)
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as exc:
            self._json(400, {"error": f"bad request body: {exc}"})
            return None, None
        yaml_src = body.get("dcop")
        if not isinstance(yaml_src, str) or not yaml_src.strip():
            self._json(400, {"error": "bad request body: body needs "
                                      "a 'dcop' key holding the "
                                      "problem as a dcop yaml string"})
            return None, None
        digest = None
        try:
            from pydcop_tpu_torch.dcop.yamldcop import load_dcop
            from pydcop_tpu_torch.serving import binning

            merged = dict(self.router.default_params)
            merged.update(body.get("params") or {})
            digest = binning.affinity_key(load_dcop(yaml_src),
                                          merged)
        except Exception as exc:  # noqa: BLE001 — malformed problem
            self._json(400, {"error": f"bad problem: {exc}"})
            return None, None
        return body, digest

    def _route_solve(self):
        raw = self._read_body()
        if raw is None:
            return
        body, digest = self._admission_key(raw)
        if body is None:
            return
        router = self.router
        # Weighted-fair admission by tenant (an optional body key the
        # workers never see): one tenant's zipf storm queues behind
        # its own tag chain while other tenants' requests overtake
        # it.  Absent tenants share one lane, which is exactly the
        # pre-fairness behavior.
        tenant = str(body.pop("tenant", "") or "default")
        if not router.fair.acquire(tenant, router.up_count()):
            self._json(429, {
                "error": f"fair-queue admission timed out for "
                         f"tenant {tenant!r}; retry with backoff",
                "status": "rejected", "retry": True})
            return
        try:
            self._route_solve_admitted(body, digest)
        finally:
            router.fair.release()

    def _route_solve_admitted(self, body: dict,
                              digest: Optional[str]):
        router = self.router
        router.note_exemplar(digest, body.get("dcop"),
                             body.get("params"))
        # The router ALWAYS mints the id (a client-supplied one is
        # ignored): worker-local counters collide across replicas,
        # the pin table needs a fleet-unique handle before the worker
        # ever answers, and an externally chosen id could clobber
        # another request's pin — duplicate-id rejection is
        # per-worker, so two replicas would happily accept the same
        # spoofed id.
        rid = f"f{uuid.uuid4().hex[:16]}"
        body["request_id"] = rid
        payload = json.dumps(body).encode()
        # Admission is where the causal trace is born: the minted
        # context travels on every forward (and retry) of this
        # request, and the rid→trace map lets /fleet/forensics and
        # later /result reads rejoin the same trace.
        ctx = fleettrace.mint()
        router.note_request_trace(rid, ctx.trace_id)
        t0 = time.monotonic()
        # The ambiguous-failure retry budget is the client's own
        # remaining patience: a deadline_s in the body bounds it (a
        # retry that lands after the client gave up helps nobody),
        # else a modest default.
        try:
            deadline_s = float(body.get("deadline_s") or 0.0)
        except (TypeError, ValueError):
            deadline_s = 0.0
        budget = t0 + (deadline_s if deadline_s > 0
                       else DEFAULT_RETRY_BUDGET_S)
        tried: set = set()
        span_cm = (tracer.span("router_request", "fleet",
                               trace_id=ctx.trace_id, request=rid)
                   if tracer.active else contextlib.nullcontext())
        with span_cm:
            while True:
                detail: Dict[str, Any] = {}
                try:
                    replica, _hit = router.pick(digest, detail=detail)
                except FleetUnavailable as exc:
                    self._json(503, {"error": str(exc),
                                     "status": "rejected",
                                     "retry": True})
                    return
                if tracer.active:
                    tracer.instant("router_route_pick", "fleet",
                                   trace_id=ctx.trace_id, request=rid,
                                   **detail)
                if replica.index in tried:
                    # pick() charged this replica's in_flight; this
                    # exit path never forwards, so it must release
                    # here or the slot leaks and the spillover
                    # heuristic sees a permanently-busier replica.
                    router.release(replica)
                    self._json(503, {
                        "error": "every healthy replica failed the "
                                 "forward; retry",
                        "status": "rejected", "retry": True})
                    return
                tried.add(replica.index)
                router.pin(rid, replica)
                try:
                    result = self._forward_retrying(
                        replica, payload, rid, budget, ctx)
                except ForwardNotSent as exc:
                    # The connect was refused before ANY attempt
                    # reached the worker: zero bytes delivered,
                    # nothing acked — re-picking a healthy replica
                    # and resending the identical body (the id
                    # travels with it) is unconditionally safe.
                    if tracer.active:
                        tracer.instant("router_repick", "fleet",
                                       trace_id=ctx.trace_id,
                                       request=rid,
                                       replica=replica.index,
                                       error=str(exc))
                    router.mark_forward_error(replica)
                    with router._lock:
                        router.reroutes += 1
                    router.release(replica)
                    continue
                router.release(replica)
                if result is None:
                    return  # budget exhausted; 503 already sent
                status, ctype, out = result
                router.record_latency(
                    (time.monotonic() - t0) * 1000.0)
                self._reply(status, out, ctype)
                return

    def _forward_retrying(self, replica: Replica, payload: bytes,
                          rid: str, budget: float,
                          ctx: Optional[fleettrace.TraceContext] = None
                          ) -> Optional[Tuple[int, str, bytes]]:
        """Forward one /solve to ONE replica, absorbing ambiguous
        failures with jittered exponential backoff while the deadline
        budget lasts.

        Resending after bytes went out is safe ONLY here: the pinned
        replica dedupes on the router-minted id (same table, and —
        across a restart — the same journal segment), so N deliveries
        execute once.  Another replica has a different journal;
        re-picking after an ambiguous failure could double-execute,
        which is why a first-attempt connect refusal (ForwardNotSent)
        propagates to the caller's re-pick loop while everything
        later retries HERE.  Returns the response tuple, or None
        after answering the 503-outcome-unknown itself."""
        router = self.router
        attempt = 0
        while True:
            try:
                return router._forward(replica, "POST", "/solve",
                                       payload, trace=ctx)
            except OSError as exc:
                if attempt == 0 and isinstance(exc, ForwardNotSent):
                    raise
                attempt += 1
                if tracer.active and ctx is not None:
                    tracer.instant(
                        "router_retry", "fleet",
                        trace_id=ctx.trace_id, request=rid,
                        attempt=attempt, replica=replica.index,
                        not_sent=isinstance(exc, ForwardNotSent),
                        error=str(exc))
                backoff = min(0.05 * (2 ** attempt), 1.0)
                backoff *= 0.5 + random.random() * 0.5
                if time.monotonic() + backoff > budget:
                    with router._lock:
                        router.retry_budget_exceeded += 1
                    router.mark_forward_error(replica)
                    # The client gets the minted id — the pin
                    # survives the replica's restart, so
                    # /result/<id> either finds the journaled
                    # request's replayed result (it was acked) or
                    # 404s (it never landed; resubmitting is safe).
                    self._json(503, {
                        "error": f"replica {replica.index} failed "
                                 f"mid-forward ({exc}); outcome "
                                 "unknown — poll the result url, "
                                 "resubmit on 404",
                        "status": "unknown", "retry": True,
                        "request_id": rid,
                        "result_url": f"/result/{rid}"})
                    return None
                with router._lock:
                    router.retries += 1
                time.sleep(backoff)

    # -- result / stats / sessions -------------------------------------- #

    def do_GET(self):  # noqa: N802 — stdlib name
        path = self.path.split("?", 1)[0]
        if path.startswith("/result/"):
            self._route_result(path[len("/result/"):], path)
        elif path.startswith("/session/"):
            sid = path[len("/session/"):].split("/", 1)[0]
            replica = self.router.pinned(
                sid, self.router._session_pins)
            if replica is None:
                self._json(404, {"error": f"unknown session {sid!r}"})
                return
            tid = self.router.trace_for(sid)
            ctx = fleettrace.TraceContext(tid) if tid else None
            if path.endswith("/events"):
                self._proxy_sse(replica, path, ctx)
            else:
                self._proxy(replica, "GET", path, None, timeout=30.0,
                            trace=ctx)
        elif path == "/stats":
            self._fleet_stats()
        elif path == "/fleet/metrics":
            self._fleet_metrics()
        elif path == "/fleet/profile":
            self._fleet_profile()
        elif path == "/fleet/trace":
            self._fleet_trace()
        elif path.startswith("/fleet/forensics/"):
            self._fleet_forensics(path[len("/fleet/forensics/"):])
        else:
            super().do_GET()

    def _route_result(self, rid: str, path: str) -> None:
        """Hedged /result read: the pin may point at a replica that
        is mid-restart — its journal-recovered twin answers for every
        COMPLETED record within a couple of heartbeats, so wait
        briefly (re-reading the pin: adoption may repoint it
        meanwhile) instead of bouncing every poll straight to 503."""
        router = self.router
        tid = router.trace_for(rid)
        ctx = fleettrace.TraceContext(tid) if tid else None
        deadline = time.monotonic() + RESULT_HEDGE_S
        while True:
            replica = router.pinned(rid)
            if replica is None:
                self._json(404, {"error": f"unknown request {rid!r}"})
                return
            if replica.status == UP:
                try:
                    status, ctype, payload = router._forward(
                        replica, "GET", path, None, timeout=30.0,
                        trace=ctx)
                except OSError:
                    status = None
                if status is not None:
                    self._reply(status, payload, ctype)
                    return
            if time.monotonic() >= deadline:
                self._json(503, {
                    "error": f"replica {replica.index} recovering; "
                             "retry", "retry": True})
                return
            time.sleep(min(max(router.heartbeat_s, 0.05), 0.25))

    def _fleet_stats(self):
        """Router stats + a live per-worker /stats fetch: ONE surface
        that answers both "how is traffic spread" and "what is each
        replica doing"."""
        doc = self.router.stats()
        for worker in doc["workers"]:
            replica = self.router.replicas[worker["index"]]
            if replica.status != UP:
                continue
            try:
                status, _ctype, body = self.router._forward(
                    replica, "GET", "/stats", None, timeout=10.0,
                    trace=None)
                if status == 200:
                    worker["stats"] = json.loads(body)
            except (OSError, ValueError):
                pass
        self._json(200, doc)

    def _route_session_open(self):
        raw = self._read_body()
        if raw is None:
            return
        body, digest = self._admission_key(raw)
        if body is None:
            return
        payload = json.dumps(body).encode()
        # Session opens mint their own context: the worker adopts it
        # as the session trace_id, so every later event batch, SSE
        # attach, and migration hop for this session can be stitched
        # back to this admission.
        ctx = fleettrace.mint()
        tried: set = set()
        while True:
            try:
                replica, _hit = self.router.pick(digest)
            except FleetUnavailable as exc:
                self._json(503, {"error": str(exc),
                                 "status": "rejected", "retry": True})
                return
            if replica.index in tried:
                self.router.release(replica)
                self._json(503, {
                    "error": "every healthy replica refused the "
                             "session open; retry",
                    "status": "rejected", "retry": True})
                return
            tried.add(replica.index)
            try:
                status, ctype, out = self.router._forward(
                    replica, "POST", "/session", payload, trace=ctx)
            except ForwardNotSent:
                # Connect refused: no worker saw the open — re-pick.
                self.router.mark_forward_error(replica)
                with self.router._lock:
                    self.router.reroutes += 1
                self.router.release(replica)
                continue
            except OSError as exc:
                # The open may have been journaled before the socket
                # died; a blind re-open would mint a second session.
                self.router.mark_forward_error(replica)
                self.router.release(replica)
                self._json(503, {
                    "error": f"replica failed mid-open ({exc}); "
                             "outcome unknown — retry with an "
                             "explicit session_id to stay idempotent",
                    "status": "unknown", "retry": True})
                return
            self.router.release(replica)
            break
        if status == 201:
            try:
                sid = json.loads(out).get("session_id")
                if sid:
                    # Sessions are stateful: every later PATCH/GET/
                    # DELETE must land on the replica holding the
                    # warm engine.
                    self.router.pin(sid, replica,
                                    self.router._session_pins)
                    self.router.note_session(sid)
                    self.router.note_session_trace(sid, ctx.trace_id)
                    if tracer.active:
                        tracer.instant("router_session_open", "fleet",
                                       trace_id=ctx.trace_id,
                                       session=sid,
                                       replica=replica.index)
            except ValueError:
                pass
        self._reply(status, out, ctype)

    def _session_replica(self, path: str) -> Optional[Replica]:
        sid = path[len("/session/"):].split("/", 1)[0]
        replica = self.router.pinned(sid, self.router._session_pins)
        if replica is None:
            self._json(404, {"error": f"unknown session {sid!r}"},
                       close=True)
            return None
        return replica

    def do_PATCH(self):  # noqa: N802 — stdlib name
        path = self.path.split("?", 1)[0]
        if not (path.startswith("/session/")
                and path.endswith("/events")):
            self._json(404, {"error": "unknown path"}, close=True)
            return
        raw = self._read_body()
        if raw is None:
            return
        replica = self._session_replica(path)
        if replica is None:
            return
        if replica.status != UP:
            # Affinity-stranded: the warm state lives (or lived) on
            # that replica; shed honestly instead of silently
            # re-homing — adoption repoints the pin when it can.
            self._json(503, {
                "error": f"session owner (replica {replica.index}) "
                         "is recovering; retry",
                "status": "rejected", "retry": True})
            return
        sid = path[len("/session/"):].split("/", 1)[0]
        try:
            doc = json.loads(raw)
            if isinstance(doc, dict):
                # The ownership fence travels with every forwarded
                # event batch: a replica holding a pre-repoint copy
                # of the session rejects this epoch with a 409
                # instead of double-applying.
                doc["epoch"] = self.router.session_epoch(sid)
                raw = json.dumps(doc).encode()
        except ValueError:
            pass  # the worker's validation answers malformed bodies
        tid = self.router.trace_for(sid)
        ctx = fleettrace.TraceContext(tid) if tid else fleettrace.mint()
        if tracer.active:
            tracer.instant("router_session_events", "fleet",
                           trace_id=ctx.trace_id, session=sid,
                           replica=replica.index)
        self._proxy(replica, "PATCH", path, raw, trace=ctx)

    def do_DELETE(self):  # noqa: N802 — stdlib name
        path = self.path.split("?", 1)[0]
        if not path.startswith("/session/"):
            self._json(404, {"error": "unknown path"}, close=True)
            return
        replica = self._session_replica(path)
        if replica is not None:
            sid = path[len("/session/"):].split("/", 1)[0]
            tid = self.router.trace_for(sid)
            self._proxy(replica, "DELETE", path, None,
                        trace=fleettrace.TraceContext(tid)
                        if tid else None)

    # -- fleet trace / telemetry surfaces -------------------------------- #

    def _fleet_spans(self):
        """Collector ingest: replicas POST batches of completed spans
        here.  Shipping is lossy-by-design on the worker side; this
        endpoint only validates and files what arrives."""
        raw = self._read_body()
        if raw is None:
            return
        collector = self.router.collector
        if collector is None:
            self._json(503, {"error": "fleet trace collector is not "
                                      "attached", "retry": True})
            return
        try:
            doc = json.loads(raw)
            if not isinstance(doc, dict):
                raise ValueError("body must be a JSON object")
            out = collector.ingest(doc)
        except ValueError as exc:
            self._json(400, {"error": f"bad span batch: {exc}"})
            return
        self._json(200, out)

    def _fleet_trace(self):
        """The merged fleet trace, live: one lane per source (router
        + each replica), rebased onto the router's clock — the same
        document `pydcop fleet forensics --trace` consumes offline."""
        collector = self.router.collector
        if collector is None:
            self._json(503, {"error": "fleet tracing is disabled "
                                      "(PYDCOP_FLEET_TRACE=0)"})
            return
        self._json(200, collector.merged_doc())

    def _fleet_metrics(self):
        """Every replica's metric registry plus the router's own,
        merged under a `replica` label.  Per-source samples survive
        the merge, so conservation checks (summed replica counters ==
        router admission ledger) read straight off this surface."""
        from pydcop_tpu_torch.observability import metrics as metrics_mod

        router = self.router
        snaps: Dict[str, Dict] = {
            "router": self.telemetry.registry.snapshot()}
        for replica in router.replicas:
            if replica.status != UP:
                continue
            try:
                status, _ctype, body = router._forward(
                    replica, "GET", "/metrics.json", None,
                    timeout=10.0, trace=None)
                if status == 200:
                    snaps[f"replica-{replica.index}"] = \
                        json.loads(body)
            except (OSError, ValueError):
                continue  # a recovering replica just skips one scrape
        merged = metrics_mod.merge_snapshots(snaps)
        query = (self.path.split("?", 1)[1]
                 if "?" in self.path else "")
        if "format=json" in query:
            self._json(200, {"sources": sorted(snaps),
                             "metrics": merged})
            return
        text = metrics_mod.render_snapshot_prometheus(merged)
        self._reply(200, text.encode(),
                    "text/plain; version=0.0.4; charset=utf-8")

    def _fleet_profile(self):
        """Pooled efficiency rollup: each UP replica's /profile doc,
        device-time-weighted into one fleet attainment + summed
        ledgers."""
        from pydcop_tpu_torch.observability import efficiency

        router = self.router
        docs: Dict[str, Dict] = {}
        for replica in router.replicas:
            if replica.status != UP:
                continue
            try:
                status, _ctype, body = router._forward(
                    replica, "GET", "/profile", None,
                    timeout=10.0, trace=None)
                if status == 200:
                    docs[f"replica-{replica.index}"] = \
                        json.loads(body)
            except (OSError, ValueError):
                continue
        self._json(200, efficiency.pooled_rollup(docs))

    def _fleet_forensics(self, rid: str):
        """One request's full causal story, reconstructed from the
        merged fleet trace: the admission span, every route pick and
        retry, and the winning replica's serve ledger — as the same
        query document `pydcop fleet forensics` renders."""
        from pydcop_tpu_torch.observability.trace import query_request

        collector = self.router.collector
        if collector is None:
            self._json(503, {"error": "fleet tracing is disabled "
                                      "(PYDCOP_FLEET_TRACE=0)"})
            return
        rid = rid.split("?", 1)[0].strip("/")
        if not rid:
            self._json(400, {"error": "need /fleet/forensics/<id>"})
            return
        events = collector.merged_events()
        trace_id = self.router.trace_for(rid)
        if trace_id is None:
            # Fall back to scanning: a request (or session) id that
            # aged out of the bounded map may still live in the
            # retained spans themselves.
            for ev in events:
                args = ev.get("args") or {}
                if rid in (args.get("request"), args.get("session")):
                    trace_id = args.get("trace_id")
                    if trace_id:
                        break
        if not trace_id:
            self._json(404, {"error": f"unknown request {rid!r}: no "
                                      "trace recorded (tracing off, "
                                      "spans dropped, or id aged "
                                      "out)"})
            return
        doc = query_request(events, trace_id)
        doc["request_id"] = rid
        doc["dropped_spans"] = collector.dropped_spans()
        self._json(200, doc)

    def _proxy_sse(self, replica: Replica, path: str, trace=None):
        """Stream a worker's per-session SSE through: chunks are
        relayed as they arrive until either side closes.

        The upstream read runs on a SHORT timeout (a few worker
        keepalive periods) instead of the forward timeout: when the
        owning replica is SIGKILLed the TCP peer may simply go
        silent, and a client must observe a clean reconnectable EOF
        within seconds — not a five-minute hang.  A timeout while the
        replica is still UP just keeps reading (the worker's 1 s
        keepalives make that rare)."""
        read_timeout = max(self.router.heartbeat_s * 8, 3.0)
        headers = ({fleettrace.HEADER: trace.encode()}
                   if trace is not None and fleettrace.enabled()
                   else None)
        try:
            conn, resp = netfault.open_stream(
                "router",
                (f"replica-{replica.index}", replica.host_id or ""),
                replica.host, replica.port, "GET", path, None,
                FORWARD_TIMEOUT_S, headers=headers)
        except OSError as exc:
            self._json(503, {"error": f"replica unreachable ({exc})"})
            return
        if resp.status != 200:
            self._reply(resp.status, resp.read(),
                        resp.getheader("Content-Type",
                                       "application/json"))
            conn.close()
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        if conn.sock is not None:
            conn.sock.settimeout(read_timeout)
        try:
            while not self.telemetry._stopping.is_set():
                try:
                    chunk = resp.read1(65536)
                except TimeoutError:  # socket.timeout is its alias
                    if replica.status != UP:
                        # The owner died under the stream: end it
                        # cleanly; the client reconnects through the
                        # router and lands on whoever owns the
                        # session now (the restarted replica, or a
                        # survivor that adopted it).
                        break
                    continue
                if not chunk:
                    break
                self.wfile.write(chunk)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # either side went away — normal SSE termination
        finally:
            conn.close()


class RouterFrontEnd(TelemetryServer):
    """The fleet's single client-facing HTTP server.  Mounts the
    router wire protocol over the telemetry routes; while running,
    the fleet health summary feeds the process-wide /healthz
    provider (zero live replicas → 503, like a single service's open
    breaker)."""

    handler_class = _RouterHandler

    def __init__(self, router: FleetRouter, port: int = 0,
                 host: str = "127.0.0.1", registry=None):
        super().__init__(port=port, host=host, registry=registry)
        self.router = router
        self._prior_provider = None

    def start(self) -> "RouterFrontEnd":
        super().start()
        self._prior_provider = get_health_provider()
        set_health_provider(self.router.health_summary)
        if fleettrace.enabled():
            # The front end's own URL is the collector address every
            # replica ships spans to; attaching also pushes that
            # config to workers already UP.
            self.router.attach_collector(self.url)
        return self

    def stop(self):
        self.router.detach_collector()
        set_health_provider(self._prior_provider)
        self._prior_provider = None
        super().stop()
