"""``python -m pydcop_tpu_torch serve``: run the multi-tenant solve
service.

Port of ``pydcop_tpu/commands/serve.py`` (the same flags) on one device
(``--device cuda|cpu``, default ``cuda``: without a card the command
exits with an error — there is no CPU fallback).  ``--replicas N``
(N > 1) serves a fleet: N worker processes of this command, each on
``--device``, behind the router (serving/router.py).  ``--slo_p99_ms``
with ``--max_replicas`` arms the router's SLO autoscaler (between
``--min_replicas`` and ``--max_replicas`` workers); ``--join
ROUTER_URL`` makes a single-replica serve announce itself to a
router as a remote member (``--host_id`` names its host; with
``--replicas > 1`` the command exits 2).
"""

import logging

logger = logging.getLogger("pydcop.cli.serve")


def set_parser(subparsers):
    parser = subparsers.add_parser(
        "serve",
        help="serve solve requests over HTTP with structure-binned "
             "device batching")
    parser.add_argument("--port", type=int, default=8080,
                        help="HTTP port (0 = OS-assigned, printed on "
                             "stderr)")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address")
    parser.add_argument("--max_queue", "--max-queue", type=int,
                        default=256,
                        help="request queue bound; also the default "
                             "admission high-water mark")
    parser.add_argument("--high_water", "--high-water", type=int,
                        default=None,
                        help="queue depth past which submits get 429 "
                             "(default: --max_queue)")
    parser.add_argument("--batch_window", "--batch-window",
                        type=float, default=0.02, metavar="SECONDS",
                        help="how long the scheduler lingers after "
                             "the first request collecting "
                             "same-structure batch-mates")
    parser.add_argument("--max_batch", "--max-batch", type=int,
                        default=16,
                        help="largest number of instances stacked "
                             "into one device dispatch")
    parser.add_argument("--breaker_failures", type=int, default=3,
                        help="consecutive dispatch failures before "
                             "the admission breaker opens (503s)")
    parser.add_argument("--breaker_reset", type=float, default=5.0,
                        metavar="SECONDS",
                        help="seconds the breaker stays open before "
                             "a half-open probe dispatch")
    parser.add_argument("--cycles", type=int, default=200,
                        help="default max_cycles for requests that "
                             "don't set params.max_cycles")
    parser.add_argument("--damping", type=float, default=0.5,
                        help="default MaxSum damping for requests")
    parser.add_argument("--params_json", "--params-json",
                        default=None, metavar="JSON",
                        help="service-wide solver-parameter defaults "
                             "as a JSON object (any serving/binning "
                             "PARAM_KEYS key: stability, noise, "
                             "damping_nodes, prune, ...); merged over "
                             "--cycles/--damping — how the fleet "
                             "router forwards api.serve's full "
                             "default_params to every worker")
    parser.add_argument("--result_keep", type=int, default=4096,
                        help="completed results retained for "
                             "GET /result/<id> (oldest evicted)")
    parser.add_argument("--journal_dir", "--journal-dir",
                        default=None, metavar="DIR",
                        help="durable request journal directory: "
                             "every 202 is journaled before it is "
                             "returned, so a crash loses zero "
                             "acknowledged requests")
    parser.add_argument("--recover", action="store_true",
                        help="replay accepted-but-unfinished journal "
                             "entries through the queue on startup "
                             "(requires --journal_dir; torn journal "
                             "tails are truncated past the last "
                             "valid record)")
    parser.add_argument("--journal_sync", "--journal-sync",
                        action="store_true",
                        help="fsync the journal per record "
                             "(machine-crash durability; the default "
                             "flush already survives a process kill)")
    parser.add_argument("--no_envelope", "--no-envelope",
                        action="store_true",
                        help="disable the envelope batching tier: "
                             "different-structure requests always "
                             "dispatch solo (docs/serving.md "
                             "\"Envelope batching\")")
    parser.add_argument("--envelope_overhead_ms",
                        "--envelope-overhead-ms",
                        type=float, default=None, metavar="MS",
                        help="modeled per-dispatch fixed cost the "
                             "envelope pack-vs-solo decision weighs "
                             "against padding waste (default 0.3; "
                             "raise to pack more aggressively)")
    parser.add_argument("--no_pipeline", "--no-pipeline",
                        action="store_true",
                        help="disable pipelined flush decode: every "
                             "dispatch waits for its results before "
                             "the next one launches (docs/"
                             "performance.md \"Closed-loop "
                             "efficiency\")")
    parser.add_argument("--no_speculate", "--no-speculate",
                        action="store_true",
                        help="disable speculative envelope "
                             "compilation: programs compile on the "
                             "request path, on first use only")
    parser.add_argument("--flight_recorder_events",
                        "--flight-recorder-events",
                        type=int, default=None, metavar="N",
                        help="size of the always-on flight-recorder "
                             "ring (trace events kept for anomaly "
                             "postmortem bundles; 0 disables; "
                             "default: PYDCOP_FLIGHT_RECORDER or "
                             "2048 — docs/observability.md)")
    parser.add_argument("--session_max", "--session-max", type=int,
                        default=64,
                        help="live stateful sessions allowed at once "
                             "(each keeps a warm engine; opens past "
                             "it get 429 — docs/sessions.md)")
    parser.add_argument("--session_segment_cycles",
                        "--session-segment-cycles",
                        type=int, default=None, metavar="CYCLES",
                        help="session anytime-segment granularity: "
                             "cycles per engine segment between SSE "
                             "updates (default 50; smaller = fresher "
                             "streams, more host syncs)")
    parser.add_argument("--session_checkpoint_every",
                        "--session-checkpoint-every",
                        type=int, default=8, metavar="EVENTS",
                        help="event batches between session "
                             "engine-state checkpoints (journaled "
                             "services; smaller = faster --recover, "
                             "more snapshot writes; 0 disables)")
    parser.add_argument("--session_certify_after",
                        "--session-certify-after",
                        type=float, default=None, metavar="SECONDS",
                        help="exact-inference oracle tier: after a "
                             "session's event stream quiesces for "
                             "this many seconds, a background DPOP "
                             "solve certifies (or improves) the warm "
                             "fixpoint and publishes the certified-"
                             "cost delta (default: off — "
                             "docs/sessions.md)")
    parser.add_argument("--replicas", type=int, default=1,
                        help="worker replicas: N > 1 spawns N serve "
                             "worker processes (each its own "
                             "scheduler/journal segment/metrics) "
                             "behind a structure-affinity router on "
                             "--port (docs/serving.md \"Fleet-scale "
                             "serving\")")
    parser.add_argument("--affinity",
                        choices=("structure", "round_robin"),
                        default="structure",
                        help="fleet routing policy: 'structure' "
                             "rendezvous-hashes the admission-time "
                             "structure key so same-structure "
                             "traffic lands where the compiled "
                             "program is warm; 'round_robin' is the "
                             "A/B baseline")
    parser.add_argument("--compile_cache_dir", "--compile-cache-dir",
                        default=None, metavar="DIR",
                        help="persistent kernel-library cache: the "
                             "CUDA libraries are built into and "
                             "loaded from DIR, so a fresh process "
                             "finds them built (engine/aotcache.py; "
                             "also PYDCOP_COMPILE_CACHE_DIR)")
    parser.add_argument("--heartbeat", type=float, default=0.25,
                        metavar="SECONDS",
                        help="fleet router heartbeat cadence; a "
                             "replica silent for ~8 expected beats "
                             "(phi-accrual model) is declared dead "
                             "and restarted on its journal segment")
    parser.add_argument("--probe_timeout_s", "--probe-timeout-s",
                        type=float, default=None, metavar="SECONDS",
                        help="liveness probe timeout (default: "
                             "max(4x heartbeat, 1.0)); raise it when "
                             "links are slow so latency reads as "
                             "GRAY degradation on /healthz instead "
                             "of false-killing replicas")
    parser.add_argument("--spill_slack", "--spill-slack", type=int,
                        default=4,
                        help="affinity spillover threshold: a "
                             "structure-warm replica more than this "
                             "many requests deeper in flight than "
                             "the idlest one loses the request to it")
    parser.add_argument("--hosts", type=int, default=1,
                        help="simulated host identities the local "
                             "fleet's replicas stripe over (host-kill "
                             "chaos + CI two-host topologies; replica "
                             "k gets host id 'host<k %% hosts>')")
    parser.add_argument("--join", default=None, metavar="ROUTER_URL",
                        help="single-replica remote fleet member: "
                             "after binding, announce this worker's "
                             "URL to the fleet router at ROUTER_URL "
                             "via POST /fleet/join (incompatible "
                             "with --replicas > 1)")
    parser.add_argument("--host_id", "--host-id", default=None,
                        help="host identity announced with --join "
                             "(default: PYDCOP_HOST_ID or the "
                             "machine hostname)")
    parser.add_argument("--slo_p99_ms", "--slo-p99-ms", type=float,
                        default=None, metavar="MS",
                        help="autoscaling SLO: with --max_replicas, "
                             "the router grows the fleet when rolling "
                             "p99 latency or queue depth breaches "
                             "this target and drains back when quiet "
                             "(docs/serving.md \"Elastic fleet\")")
    parser.add_argument("--min_replicas", "--min-replicas", type=int,
                        default=None,
                        help="autoscale floor (default: 1)")
    parser.add_argument("--max_replicas", "--max-replicas", type=int,
                        default=None,
                        help="autoscale ceiling; must be >= "
                             "--replicas (autoscaling is armed only "
                             "when both this and --slo_p99_ms are "
                             "set)")
    parser.add_argument("--fleet_trace", "--fleet-trace",
                        action="store_true", dest="fleet_trace",
                        default=None,
                        help="force fleet-wide causal tracing ON: "
                             "the router mints a trace context per "
                             "admission, stamps it on every forward, "
                             "and collects replica spans for "
                             "/fleet/forensics (default: on unless "
                             "PYDCOP_FLEET_TRACE=0)")
    parser.add_argument("--no_fleet_trace", "--no-fleet-trace",
                        action="store_false", dest="fleet_trace",
                        help="disable fleet tracing (headers, span "
                             "shipping and the router collector; "
                             "sets PYDCOP_FLEET_TRACE=0 for spawned "
                             "workers too)")
    parser.add_argument("--port_file", "--port-file", default=None,
                        metavar="PATH",
                        help="atomically write the bound port to "
                             "PATH once listening (with --port 0: "
                             "how wrappers and the fleet router "
                             "learn the assignment)")
    parser.add_argument("--device", default="cuda",
                        choices=["cuda", "cpu"],
                        help="torch device every dispatch runs on "
                             "(default cuda; there is no silent CPU "
                             "fallback)")
    parser.set_defaults(func=run_cmd)


def run_cmd(args) -> int:
    # FIRST, before any kernel library is loaded: a library loaded
    # earlier stays where it was built (engine/aotcache.py).
    from pydcop_tpu_torch.engine import aotcache

    if args.compile_cache_dir:
        aotcache.enable_persistent_compile_cache(
            args.compile_cache_dir)
    else:
        aotcache.maybe_enable_from_env()

    from pydcop_tpu_torch.api import serve

    if args.recover and not args.journal_dir:
        logger.error("--recover requires --journal_dir")
        return 2
    if args.replicas > 1 and args.recover:
        logger.error("--recover is per-worker in a fleet: the router "
                     "always recovers journaled replica segments")
        return 2
    if args.join and args.replicas > 1:
        logger.error("--join is for single-replica remote workers; "
                     "a local fleet (--replicas > 1) IS the router — "
                     "point remote workers' --join at its URL")
        return 2
    if args.flight_recorder_events is not None:
        from pydcop_tpu_torch.observability import flight

        flight.install(events=args.flight_recorder_events)
    default_params = {
        "max_cycles": args.cycles,
        "damping": args.damping,
    }
    if args.params_json:
        import json

        try:
            extra = json.loads(args.params_json)
            if not isinstance(extra, dict):
                raise ValueError("--params_json must be a JSON "
                                 "object")
        except ValueError as exc:
            logger.error("bad --params_json: %s", exc)
            return 2
        default_params.update(extra)
    serve(
        port=args.port, host=args.host,
        max_queue=args.max_queue, high_water=args.high_water,
        batch_window_s=args.batch_window, max_batch=args.max_batch,
        breaker_failures=args.breaker_failures,
        breaker_reset_s=args.breaker_reset,
        default_params=default_params,
        result_keep=args.result_keep,
        journal_dir=args.journal_dir,
        journal_sync=args.journal_sync,
        recover=args.recover,
        envelope_packing=not args.no_envelope,
        envelope_overhead_ms=args.envelope_overhead_ms,
        pipeline=not args.no_pipeline,
        speculate=not args.no_speculate,
        session_max=args.session_max,
        session_segment_cycles=args.session_segment_cycles,
        session_checkpoint_every_events=args.session_checkpoint_every,
        session_certify_after=args.session_certify_after,
        replicas=args.replicas,
        affinity=args.affinity,
        compile_cache_dir=(args.compile_cache_dir
                           or aotcache.cache_dir()),
        heartbeat_s=args.heartbeat,
        probe_timeout_s=args.probe_timeout_s,
        spill_slack=args.spill_slack,
        hosts=args.hosts,
        slo_p99_ms=args.slo_p99_ms,
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        join=args.join,
        host_id=args.host_id,
        fleet_trace=args.fleet_trace,
        port_file=args.port_file,
        block=True,
        device=args.device,
    )
    return 0
