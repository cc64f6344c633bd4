"""High-level solve API of the port.

Port of the device backend of ``pydcop_tpu/api.py`` ``solve``: compile
the DCOP, run the algorithm's device engine, and score the assignment
on the host with ``DCOP.solution_cost``.  The result carries the same
keys as the reference's device solve.  ``device`` defaults to
``"cuda"``; without a card it raises unless ``device="cpu"`` is passed.
Checkpointing, recovery, decimation and observation route the solve
through the engine's segmented loop (``MaxSumEngine.run_checkpointed``),
as the reference's ``_solve`` does.

:func:`serve` is the reference's ``api.serve`` for one replica: the
solve service (``serving/service.py``) and its HTTP front end on one
device.
"""

import time
from typing import Any, Dict, Optional, Union

from pydcop_tpu_torch.algorithms import AlgorithmDef, load_algorithm_module
from pydcop_tpu_torch.dcop.dcop import DCOP
from pydcop_tpu_torch.device import DeviceLike, resolve_device


class SolveResult(dict):
    """Dict-like result: assignment, cost, violations, cycles, times."""

    @property
    def assignment(self) -> Dict[str, Any]:
        return self["assignment"]

    @property
    def cost(self) -> float:
        return self["cost"]


def solve(dcop: DCOP, algo_def: Union[str, AlgorithmDef],
          max_cycles: int = 1000,
          algo_params: Optional[Dict[str, Any]] = None,
          mesh=None, n_devices: Optional[int] = None,
          shards: Optional[int] = None,
          warmup: bool = False,
          checkpoint_dir: Optional[str] = None,
          checkpoint_every: Optional[int] = None,
          checkpoint_async: bool = True,
          checkpoint_keep: int = 2,
          resume: bool = False,
          recovery=None,
          trace: Optional[str] = None,
          trace_format: str = "chrome",
          metrics_file: Optional[str] = None,
          metrics_every: Optional[int] = None,
          serve_metrics: Optional[int] = None,
          device: DeviceLike = "cuda") -> SolveResult:
    """Solve a DCOP on one torch device and return assignment +
    quality metrics.

    Keys: ``status`` (FINISHED when the messages converged, else
    TIMEOUT), ``assignment``, ``cost``, ``violations``, ``cycles``,
    ``time`` (engine wall time, see ``DeviceRunResult``),
    ``compile_time``, ``total_time``, ``metrics``, ``backend``.
    ``warmup=True`` runs the solve once untimed first.

    Resilience knobs (the reference's): ``checkpoint_dir`` chunks the
    solve into ``checkpoint_every``-cycle segments (default 100) with
    an NPZ snapshot between segments; ``resume=True`` continues from
    the newest valid snapshot there (same final result as the
    uninterrupted solve).  ``checkpoint_async`` (default True) copies
    and writes each snapshot off the solve loop; ``checkpoint_keep``
    bounds the snapshots kept (default 2).  ``recovery`` (a
    ``resilience.recovery.RecoveryPolicy``) arms the segment-boundary
    guards: NaN/Inf scan, optional cost-divergence window, rollback
    with escalating intervention, ``RecoveryExhausted`` once the
    restart budget is spent.  A decimated MaxSum solve is segmented
    too.  ``warmup=True`` keeps the plain path.

    Observability knobs (the reference's): ``trace`` records the whole
    solve on the process tracer and writes a Chrome ``trace_event``
    JSON (``trace_format="chrome"``) or line-delimited JSON
    (``"jsonl"``) to that path.  ``metrics_file`` activates the
    metrics registry, appends a JSONL snapshot per
    ``metrics_every``-cycle engine segment (default 100) and writes a
    Prometheus text dump to ``<metrics_file>.prom`` when the solve
    ends; ``serve_metrics`` (a port; 0 = OS-assigned) serves
    ``/metrics``, ``/healthz``, ``/events`` and ``/profile`` over HTTP
    while the solve runs.  An observed solve runs segmented with an
    engine probe and returns ``metrics['cost_curve']`` (cycle, cost
    per segment; the last point is the solve's cost) and
    ``metrics['convergence_curve']`` (cycle, mean |Δ| of the f2v
    messages, flip rate per segment from the second on); with
    metrics, the first call of each segment key is also profiled
    (``metrics['xla_cost']``: the card's kernels from
    ``torch.profiler``, or an unavailable marker on the CPU).  With
    ``checkpoint_dir`` the segments follow ``checkpoint_every``;
    ``warmup=True`` keeps the plain path, traced but without curves.
    All default off and cost nothing while off.

    Scaling knobs: ``shards=N`` runs the maxsum family on the
    PARTITIONED engine (a min-edge-cut partition over N devices of
    ``device``'s kind, only the cut edges' halo exchanged per
    superstep; ``engine/sharding.py``).  More shards than the machine
    has devices raises (on the CPU the count is the reference's:
    ``XLA_FLAGS=--xla_force_host_platform_device_count=N``).  The
    replicated-variable mesh (``mesh``, ``n_devices > 1``) is not
    ported yet and raises ``NotImplementedError`` (ROADMAP.md Queue A
    item 6(b)).

    ``algo_def="auto"`` picks the algorithm with the portfolio racer
    (``engine/autotune.py``): a stored decision for the DCOP's shape is
    replayed before compiling, else the candidates race on the compiled
    graph on ``device``; ``metrics["portfolio"]`` says which and how."""
    resolve_device(device)
    if mesh is not None or (n_devices is not None and n_devices > 1):
        from pydcop_tpu_torch.engine.sharding import REPLICATED_NOT_PORTED

        raise NotImplementedError(REPLICATED_NOT_PORTED)
    portfolio_info = None
    if isinstance(algo_def, str) and algo_def == "auto":
        algo_def, portfolio_info = _resolve_auto_algo(
            dcop, algo_params or {}, device)
    if isinstance(algo_def, str):
        algo_def = AlgorithmDef.build_with_default_param(
            algo_def, algo_params or {}, mode=dcop.objective
        )
    module = load_algorithm_module(algo_def.algo)
    if resume and checkpoint_dir is None:
        raise ValueError(
            "resume=True needs checkpoint_dir: there is no snapshot "
            "location to resume from"
        )
    if shards is not None and shards > 1 \
            and not getattr(module, "SUPPORTS_SHARDS", False):
        raise NotImplementedError(
            f"Algorithm {algo_def.algo} has no partitioned engine "
            "(maxsum family only); use n_devices= for "
            "replicated-variable sharding")
    session = None
    if (trace is not None or metrics_file is not None
            or serve_metrics is not None):
        from pydcop_tpu_torch.observability import ObservabilitySession

        session = ObservabilitySession(
            trace, trace_format, metrics_file,
            serve_port=serve_metrics,
        ).start()
    try:
        from pydcop_tpu_torch.observability.trace import tracer

        with tracer.span("solve", "api", algo=algo_def.algo,
                         backend="device", max_cycles=max_cycles):
            result = _solve(
                dcop, algo_def, module, max_cycles=max_cycles,
                shards=shards,
                warmup=warmup, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every,
                checkpoint_async=checkpoint_async,
                checkpoint_keep=checkpoint_keep, resume=resume,
                recovery=recovery, observing=session is not None,
                metrics_file=metrics_file, metrics_every=metrics_every,
                device=device)
            if portfolio_info is not None:
                result.setdefault("metrics", {})[
                    "portfolio"] = portfolio_info
            return result
    finally:
        if session is not None:
            session.finish()


def _resolve_auto_algo(dcop: DCOP, algo_params: Dict[str, Any],
                       device: DeviceLike):
    """Resolve ``algo="auto"`` through the portfolio racer: replay a
    stored decision for the DCOP's shape, else compile once and race
    the candidates (DPOP under its width gate) on ``device``.  Returns
    ``(AlgorithmDef, info)``, the winner's extra parameters merged over
    the caller's (those the winner does not take are dropped, with a
    warning)."""
    from pydcop_tpu_torch.engine.autotune import (
        PORTFOLIO_PARAMS,
        autotune_portfolio,
        cached_portfolio_choice,
        dcop_portfolio_key,
        dpop_portfolio_runner,
    )

    dev = resolve_device(device)
    key = dcop_portfolio_key(dcop, dev.type)
    choice = cached_portfolio_choice(key)
    if choice is not None:
        info = {"algo": choice, "portfolio_source": "cache",
                "portfolio_key": key}
    else:
        from pydcop_tpu_torch.engine.compile import compile_dcop

        graph, meta = compile_dcop(
            dcop, noise_level=float(
                algo_params.get("noise", 0.01) or 0.0))
        info = autotune_portfolio(
            graph, key=key, meta=meta, device=dev,
            extra_runners={
                "dpop": dpop_portfolio_runner(dcop, graph, meta, dev)})
    algo, extra = PORTFOLIO_PARAMS[info["algo"]]
    module = load_algorithm_module(algo)
    allowed = {p.name for p in module.algo_params}
    params = {k: v for k, v in algo_params.items() if k in allowed}
    dropped = sorted(set(algo_params) - set(params))
    if dropped:
        import logging

        logging.getLogger("pydcop_tpu_torch.api").warning(
            "algo='auto' winner %s does not take parameter(s) %s; "
            "ignored", algo, ", ".join(dropped))
    params.update(extra)
    return AlgorithmDef.build_with_default_param(
        algo, params, mode=dcop.objective), info


def _solve(dcop: DCOP, algo_def: AlgorithmDef, module, *,
           max_cycles: int, shards: Optional[int], warmup: bool,
           checkpoint_dir, checkpoint_every,
           checkpoint_async: bool, checkpoint_keep: int, resume: bool,
           recovery, observing: bool, metrics_file: Optional[str],
           metrics_every: Optional[int], device: DeviceLike) -> SolveResult:
    """The device solve (the reference's ``_solve``, device backend):
    segmented when checkpointing, recovering, decimating or observed
    (the engine probe needs segment boundaries; ``warmup=True`` keeps
    the plain path), else the algorithm's one-loop solve.  A
    multihost environment is joined first (a no-op on one host)."""
    from pydcop_tpu_torch.engine.multihost import initialize_multihost

    initialize_multihost()
    t0 = time.perf_counter()
    # Only the maxsum family takes shards (checked by the caller).
    extra = {"shards": shards} if shards is not None and shards > 1 \
        else {}
    decim_plan = None
    if hasattr(module, "decimation_plan_from_params"):
        decim_plan = module.decimation_plan_from_params(algo_def.params)
    probed = observing and not warmup and hasattr(module, "build_engine")
    if checkpoint_dir is not None or probed or recovery is not None \
            or (decim_plan is not None and not warmup):
        res = _solve_segmented(
            dcop, algo_def, module, max_cycles=max_cycles,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            checkpoint_async=checkpoint_async,
            checkpoint_keep=checkpoint_keep, resume=resume,
            recovery=recovery, decim_plan=decim_plan, probed=probed,
            metrics_file=metrics_file, metrics_every=metrics_every,
            device=device, **extra)
    else:
        res = module.solve_on_device(
            dcop, algo_def, max_cycles=max_cycles, warmup=warmup,
            device=device, **extra,
        )
    cost, violations = dcop.solution_cost(res.assignment)
    return SolveResult(
        status="FINISHED" if res.converged else "TIMEOUT",
        assignment=res.assignment,
        cost=cost,
        violations=violations,
        cycles=res.cycles,
        time=res.time_s,
        compile_time=res.compile_time_s,
        total_time=time.perf_counter() - t0,
        metrics=res.metrics,
        backend="device",
    )


def _solve_segmented(dcop: DCOP, algo_def: AlgorithmDef, module, *,
                     max_cycles: int, checkpoint_dir: Optional[str],
                     checkpoint_every: Optional[int],
                     checkpoint_async: bool, checkpoint_keep: int,
                     resume: bool, recovery, decim_plan,
                     probed: bool = False,
                     metrics_file: Optional[str] = None,
                     metrics_every: Optional[int] = None,
                     device: DeviceLike = "cuda",
                     shards: Optional[int] = None):
    """The segmented solve: the algorithm's engine, run by
    ``run_checkpointed`` or resumed by ``resume_from_checkpoint``, with
    an engine probe when ``probed`` (its curves folded into the
    result's metrics)."""
    if not hasattr(module, "build_engine"):
        raise NotImplementedError(
            f"Algorithm {algo_def.algo} has no segmentable engine: "
            "checkpointing/recovery supports maxsum-family solves"
        )
    from pydcop_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
        resume_from_checkpoint,
    )

    engine = module.build_engine(dcop, algo_def.params, shards=shards,
                                 device=device)
    probe = None
    if probed:
        from pydcop_tpu_torch.observability.engine_probe import EngineProbe

        # Snapshots fire at segment boundaries; with checkpointing the
        # segment is the checkpoint cadence.
        probe = EngineProbe(engine, metrics_path=metrics_file,
                            metrics_every=metrics_every or 1)
    manager = None
    segment_cycles = None
    if checkpoint_dir is not None:
        manager = CheckpointManager(
            checkpoint_dir, every=checkpoint_every or 100,
            keep=checkpoint_keep,
        )
    elif decim_plan is not None:
        # Decimation rounds set the boundaries unless an explicit
        # metrics cadence asks for finer points.
        segment_cycles = metrics_every or decim_plan.cycles_per_round
    else:
        segment_cycles = metrics_every or 100
    if resume:
        res = resume_from_checkpoint(
            engine, manager, max_cycles=max_cycles, probe=probe,
            checkpoint_async=checkpoint_async, recovery=recovery,
            decimation=decim_plan,
        )
    else:
        res = engine.run_checkpointed(
            max_cycles=max_cycles, manager=manager,
            segment_cycles=segment_cycles, probe=probe,
            checkpoint_async=checkpoint_async, recovery=recovery,
            decimation=decim_plan,
        )
    if probe is not None:
        from pydcop_tpu_torch.observability.engine_probe import (
            attach_result_metrics,
        )

        attach_result_metrics(res, probe)
    return res


# ------------------------------------------------------------------ #
# Serving (port of the reference's ``api.serve``: one replica, or a
# fixed-size fleet of worker processes behind the router).


class ServeHandle:
    """A running solve service + HTTP front end.

    ``url``/``port`` locate the front end; ``service`` is the
    underlying :class:`~pydcop_tpu_torch.serving.service.SolveService`
    (submit/result work in-process too); ``stop()`` drains the queue
    and shuts both down.  Context-manager friendly."""

    def __init__(self, service, front_end):
        self.service = service
        self.front_end = front_end

    @property
    def url(self):
        return self.front_end.url

    @property
    def port(self):
        return self.front_end.port

    def stop(self, drain: bool = True) -> Dict[str, Any]:
        """Stop front end + service; returns the service's drain
        summary (``drained`` / ``replayable`` / ``failed_pending``)."""
        self.front_end.stop()
        return self.service.stop(drain=drain)

    def __enter__(self) -> "ServeHandle":
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class FleetHandle:
    """A running fleet: N serve-worker processes behind one router
    front end.  ``router`` is the
    :class:`~pydcop_tpu_torch.serving.router.FleetRouter` (replica
    states, routing stats); ``stop()`` SIGTERM-drains every worker and
    shuts the front end down."""

    def __init__(self, router, front_end):
        self.router = router
        self.front_end = front_end

    @property
    def url(self):
        return self.front_end.url

    @property
    def port(self):
        return self.front_end.port

    def stop(self, drain: bool = True) -> Dict[str, Any]:
        self.front_end.stop()
        return self.router.stop(drain=drain)

    def __enter__(self) -> "FleetHandle":
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def _write_port_file(path: str, port: int) -> None:
    """Atomically publish the bound port (handy for scripts wrapping
    ``--port 0``)."""
    import os
    import tempfile

    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".port_")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(f"{port}\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def serve(port: int = 8080, host: str = "127.0.0.1",
          max_queue: int = 256, batch_window_s: float = 0.02,
          max_batch: int = 16, high_water: Optional[int] = None,
          default_params: Optional[Dict[str, Any]] = None,
          breaker_failures: int = 3, breaker_reset_s: float = 5.0,
          result_keep: int = 4096,
          journal_dir: Optional[str] = None,
          journal_sync: bool = False,
          recover: bool = False,
          envelope_packing: bool = True,
          envelope_overhead_ms: Optional[float] = None,
          pipeline: bool = True,
          speculate: bool = True,
          session_max: int = 64,
          session_segment_cycles: Optional[int] = None,
          session_checkpoint_every_events: int = 8,
          session_certify_after: Optional[float] = None,
          replicas: int = 1,
          affinity: str = "structure",
          compile_cache_dir: Optional[str] = None,
          heartbeat_s: float = 0.25,
          probe_timeout_s: Optional[float] = None,
          spill_slack: int = 4,
          hosts: int = 1,
          slo_p99_ms: Optional[float] = None,
          min_replicas: Optional[int] = None,
          max_replicas: Optional[int] = None,
          join: Optional[str] = None,
          host_id: Optional[str] = None,
          fleet_trace: Optional[bool] = None,
          port_file: Optional[str] = None,
          block: bool = False,
          device: DeviceLike = "cuda") -> Optional[Any]:
    """Start the multi-tenant solve service on one torch device (the
    reference's ``api.serve``, docs/serving.md).

    Incoming problems are binned by structure signature and
    same-structure requests are stacked into ONE device dispatch;
    different-structure singletons are packed into envelope-padded or
    lane-packed dispatches when the per-flush cost model says so
    (``envelope_packing``, ``envelope_overhead_ms``).  The front end
    serves ``POST /solve`` / ``GET /result/<id>`` / ``GET /stats``,
    the stateful sessions (``/session``) and the telemetry routes
    (``/metrics``, ``/healthz``, ``/events``, ``/profile``).
    Admission control: a submit past ``high_water`` (default
    ``max_queue``) is a 429; ``breaker_failures`` dispatch failures in
    a row open the breaker (503) for ``breaker_reset_s``.
    ``journal_dir`` makes every 202 crash-durable; ``recover=True``
    replays the journal's unfinished requests and open sessions on
    start.  ``pipeline`` queues warm dispatches on a side stream of the
    card while the previous one is decoded; ``speculate`` builds the
    kernel libraries predicted dispatches will load on a background
    thread.  ``compile_cache_dir`` (or ``PYDCOP_COMPILE_CACHE_DIR``)
    keeps those libraries in a directory shared across processes
    (engine/aotcache.py).

    ``device`` (default ``"cuda"``) is where every dispatch runs;
    without a card this raises unless ``device="cpu"``.

    ``replicas=N`` (N > 1) spawns N ``serve`` worker processes on
    ``device`` — each a full solve service with its own scheduler
    thread, journal segment (``<journal_dir>/replica-<k>/``) and
    /metrics — behind a structure-affinity router speaking this same
    wire protocol (serving/router.py); the return value is then a
    :class:`FleetHandle`.  The device is resolved before any worker is
    spawned.  ``affinity`` (``"structure"`` or ``"round_robin"``),
    ``heartbeat_s``, ``probe_timeout_s``, ``spill_slack`` and
    ``hosts`` (simulated host ids striped over the replicas) shape the
    fleet; ``fleet_trace`` turns its causal tracing on or off (exported
    as ``PYDCOP_FLEET_TRACE`` so the workers inherit it).

    Elastic fleet: ``slo_p99_ms`` + ``max_replicas`` arm the SLO
    autoscaler (the router grows the fleet toward ``max_replicas``
    when the rolling p99 or the queue depth breaches the SLO, each new
    worker prewarmed on ``device`` before it takes traffic, and drains
    back toward ``min_replicas`` when quiet, migrating warm sessions
    off).  ``join`` turns a SINGLE-replica serve into a remote fleet
    member: after the front end binds, the worker announces its own
    URL to the router at ``join`` via ``POST /fleet/join``
    (``host_id`` overrides the announced host identity, default
    :func:`pydcop_tpu_torch.engine.multihost.fleet_host_id`);
    incompatible with ``replicas > 1`` (``ValueError``).

    ``port=0`` asks the OS for a free port (``port_file`` atomically
    publishes it).  ``block=True`` (the CLI) serves until
    SIGTERM/SIGINT, then stops WITH drain and returns None;
    ``block=False`` returns a :class:`ServeHandle` (or
    :class:`FleetHandle`)."""
    import os

    if join and replicas > 1:
        raise ValueError(
            "join= is for single-replica remote workers; a local "
            "fleet (replicas > 1) IS the router — point the workers' "
            "join at its URL instead")
    dev = resolve_device(device)
    if fleet_trace is not None:
        os.environ["PYDCOP_FLEET_TRACE"] = "1" if fleet_trace else "0"
    if replicas > 1:
        return _serve_fleet(
            port=port, host=host, max_queue=max_queue,
            batch_window_s=batch_window_s, max_batch=max_batch,
            high_water=high_water, default_params=default_params,
            breaker_failures=breaker_failures,
            breaker_reset_s=breaker_reset_s, result_keep=result_keep,
            journal_dir=journal_dir, journal_sync=journal_sync,
            envelope_packing=envelope_packing,
            envelope_overhead_ms=envelope_overhead_ms,
            pipeline=pipeline, speculate=speculate,
            session_max=session_max,
            session_segment_cycles=session_segment_cycles,
            session_checkpoint_every_events=(
                session_checkpoint_every_events),
            session_certify_after=session_certify_after,
            replicas=replicas, affinity=affinity,
            compile_cache_dir=compile_cache_dir,
            heartbeat_s=heartbeat_s,
            probe_timeout_s=probe_timeout_s,
            spill_slack=spill_slack, hosts=hosts,
            slo_p99_ms=slo_p99_ms, min_replicas=min_replicas,
            max_replicas=max_replicas,
            port_file=port_file, block=block, device=dev.type)
    if compile_cache_dir:
        # Before the service loads any kernel library.
        from pydcop_tpu_torch.engine.aotcache import (
            enable_persistent_compile_cache,
        )

        enable_persistent_compile_cache(compile_cache_dir)
    from pydcop_tpu_torch.serving.admission import AdmissionPolicy
    from pydcop_tpu_torch.serving.http import ServeFrontEnd
    from pydcop_tpu_torch.serving.service import SolveService

    service = SolveService(
        max_queue=max_queue,
        batch_window_s=batch_window_s,
        max_batch=max_batch,
        default_params=default_params,
        admission=AdmissionPolicy(
            high_water=(high_water if high_water is not None
                        else max_queue),
            breaker_failures=breaker_failures,
            breaker_reset_s=breaker_reset_s,
        ),
        result_keep=result_keep,
        journal_dir=journal_dir,
        journal_sync=journal_sync,
        recover=recover,
        envelope_packing=envelope_packing,
        envelope_overhead_ms=envelope_overhead_ms,
        pipeline=pipeline,
        speculate=speculate,
        session_max=session_max,
        session_segment_cycles=session_segment_cycles,
        session_checkpoint_every_events=(
            session_checkpoint_every_events),
        session_certify_after=session_certify_after,
        device=device,
    ).start()
    try:
        front_end = ServeFrontEnd(service, port=port, host=host).start()
    except Exception:
        service.stop(drain=False)
        raise
    handle = ServeHandle(service, front_end)
    import sys

    print(f"pydcop serve: listening on {handle.url} "
          "(POST /solve, GET /result/<id>, /metrics, /healthz)",
          file=sys.stderr)
    if port_file:
        _write_port_file(port_file, handle.port)
    if join:
        # Announce AFTER the front end binds: the router health-probes
        # the announced URL before admitting it to the fleet.
        _announce_join(join, handle.url, host_id,
                       journal_dir=journal_dir)
    if not block:
        return handle
    _serve_until_signal(
        handle,
        lambda summary: (
            "pydcop serve: shut down — "
            f"{summary['drained']} request(s) drained, "
            f"{summary['replayable']} journaled replayable, "
            f"{summary['failed_pending']} failed pending"))
    return None


def _announce_join(join_url: str, own_url: str,
                   host_id: Optional[str] = None,
                   journal_dir: Optional[str] = None) -> bool:
    """Announce this worker to a fleet router's ``POST /fleet/join``.

    Best-effort with small retries (the router may still be binding
    during a parallel bring-up): a failed announce leaves the worker
    serving standalone with a warning — operators re-announce by
    restarting or posting to /fleet/join themselves — rather than
    refusing to serve at all.

    ``journal_dir`` rides along when the worker journals: a router
    that can see the same filesystem uses it for dead-session
    adoption (serving/migration.adopt_dead_sessions).  The socket I/O
    routes through the netfault seam like every other fleet link, so
    an injected partition also severs discovery."""
    import json
    import sys
    import urllib.parse

    from pydcop_tpu_torch.engine.multihost import fleet_host_id
    from pydcop_tpu_torch.serving import netfault

    own_host_id = host_id or fleet_host_id()
    doc = {"url": own_url, "host_id": own_host_id}
    if journal_dir:
        doc["journal_dir"] = journal_dir
    payload = json.dumps(doc).encode()
    parsed = urllib.parse.urlsplit(join_url)
    router_host = parsed.hostname or "127.0.0.1"
    router_port = parsed.port or 80
    path = (parsed.path.rstrip("/") or "") + "/fleet/join"
    last: Optional[Exception] = None
    for attempt in range(5):
        if attempt:
            time.sleep(min(0.5 * attempt, 2.0))
        try:
            status, _ctype, body = netfault.exchange(
                ("worker", own_host_id), ("router", router_host),
                router_host, router_port, "POST", path,
                body=payload, timeout=5.0)
            if status >= 400:
                raise ValueError(
                    f"join answered {status}: {body[:200]!r}")
            print(f"pydcop serve: joined fleet at {join_url}",
                  file=sys.stderr)
            return True
        except (OSError, ValueError) as exc:
            last = exc
    print(f"pydcop serve: fleet join at {join_url} failed ({last}); "
          "serving standalone", file=sys.stderr)
    return False


def _serve_fleet(*, port, host, max_queue, batch_window_s, max_batch,
                 high_water, default_params, breaker_failures,
                 breaker_reset_s, result_keep, journal_dir,
                 journal_sync, envelope_packing, envelope_overhead_ms,
                 pipeline, speculate,
                 session_max, session_segment_cycles,
                 session_checkpoint_every_events,
                 session_certify_after, replicas, affinity,
                 compile_cache_dir, heartbeat_s, probe_timeout_s,
                 spill_slack, hosts, slo_p99_ms, min_replicas,
                 max_replicas, port_file, block,
                 device: str) -> Optional[FleetHandle]:
    """The ``replicas > 1`` serve path: build the worker CLI tail
    from the same kwargs the single-service path consumes (so the two
    cannot drift), spawn the fleet on ``device`` (``"cuda"`` or
    ``"cpu"``, already resolved), mount the router front end."""
    import json
    import sys

    from pydcop_tpu_torch.serving.router import (
        FleetRouter,
        RouterFrontEnd,
    )

    params = dict(default_params or {})
    worker_args = [
        "--max_queue", str(max_queue),
        "--batch_window", str(batch_window_s),
        "--max_batch", str(max_batch),
        "--breaker_failures", str(breaker_failures),
        "--breaker_reset", str(breaker_reset_s),
        "--result_keep", str(result_keep),
        "--session_max", str(session_max),
        "--session_checkpoint_every",
        str(session_checkpoint_every_events),
    ]
    if high_water is not None:
        worker_args += ["--high_water", str(high_water)]
    if "max_cycles" in params:
        worker_args += ["--cycles", str(params["max_cycles"])]
    if "damping" in params:
        worker_args += ["--damping", str(params["damping"])]
    # Every other default-param key rides as JSON: a replicas=2
    # service dropping the caller's stability/noise/prune defaults
    # would solve differently than replicas=1.
    extra_params = {k: v for k, v in params.items()
                    if k not in ("max_cycles", "damping")}
    if extra_params:
        worker_args += ["--params_json", json.dumps(extra_params)]
    if journal_sync:
        worker_args += ["--journal_sync"]
    if not envelope_packing:
        worker_args += ["--no_envelope"]
    if not pipeline:
        worker_args += ["--no_pipeline"]
    if not speculate:
        worker_args += ["--no_speculate"]
    if envelope_overhead_ms is not None:
        worker_args += ["--envelope_overhead_ms",
                        str(envelope_overhead_ms)]
    if session_segment_cycles is not None:
        worker_args += ["--session_segment_cycles",
                        str(session_segment_cycles)]
    if session_certify_after is not None:
        worker_args += ["--session_certify_after",
                        str(session_certify_after)]
    router = FleetRouter(
        replicas=replicas, worker_args=worker_args,
        journal_dir=journal_dir,
        compile_cache_dir=compile_cache_dir, affinity=affinity,
        heartbeat_s=heartbeat_s, probe_timeout_s=probe_timeout_s,
        spill_slack=spill_slack, default_params=params, hosts=hosts,
        slo_p99_ms=slo_p99_ms, min_replicas=min_replicas,
        max_replicas=max_replicas, device=device,
    ).start()
    try:
        front_end = RouterFrontEnd(router, port=port,
                                   host=host).start()
    except Exception:
        router.stop(drain=False)
        raise
    handle = FleetHandle(router, front_end)
    print(f"pydcop serve: fleet of {replicas} replica(s) on {device} "
          f"behind {handle.url} (affinity={affinity})", file=sys.stderr)
    if port_file:
        _write_port_file(port_file, handle.port)
    if not block:
        return handle
    _serve_until_signal(
        handle,
        lambda summary: (
            "pydcop serve: fleet shut down — worker exits "
            + ", ".join(
                f"replica-{w['index']}={w['exit']}"
                for w in summary["workers"])))
    return None


def _serve_until_signal(handle, summarize) -> None:
    """``block=True`` tail: wait for SIGTERM/SIGINT, cut the black-box
    bundle, drain-stop the handle, log the summary."""
    import signal
    import sys
    import threading

    stop_event = threading.Event()
    got_signal = []

    def _on_signal(signum, frame):  # noqa: ARG001 — signal signature
        got_signal.append(signum)
        stop_event.set()

    # Original handlers are restored on exit; handlers can only be
    # installed from the main thread — a background-thread caller just
    # blocks on the event.
    previous = {}
    if threading.current_thread() is threading.main_thread():
        previous = {
            sig: signal.signal(sig, _on_signal)
            for sig in (signal.SIGTERM, signal.SIGINT)
        }
    try:
        stop_event.wait()
        print("pydcop serve: signal received, draining…",
              file=sys.stderr)
        from pydcop_tpu_torch.observability import flight

        flight.trigger("fatal_signal", force=True,
                       signum=(got_signal[0] if got_signal else None))
    finally:
        summary = handle.stop(drain=True)
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        print(summarize(summary), file=sys.stderr)
