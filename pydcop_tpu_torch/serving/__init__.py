"""Multi-tenant solve service: the request plane over the device engine.

Port of ``pydcop_tpu/serving`` (docs/serving.md), the in-process plane:

- :mod:`.service` — :class:`SolveService`: bounded request queue,
  per-request compile, result store with latency accounting,
  request-plane telemetry (``pydcop_requests_total{status}``,
  ``pydcop_request_latency_seconds``, batch-occupancy gauge);
- :mod:`.scheduler` — the batching scheduler: drains the queue,
  coalesces a batch window, dispatches each structure bin as ONE
  device dispatch (engine/batch.run_stacked, padded up the bin-size
  ladder), pipelining warm dispatches on a side stream of the card;
- :mod:`.binning` — structure-signature bin keys plus the envelope
  tier (shape-envelope keys, cell accounting and the pack-vs-solo
  cost model);
- :mod:`.admission` — backpressure (queue high-water → 429) and the
  dispatch circuit breaker (repeated engine failure → 503);
- :mod:`.journal` — the durable request journal (the reference's
  record format: either package replays the other's journal);
- :mod:`.http` — stdlib HTTP front end (``POST /solve``,
  ``GET /result/<id>``, ``GET /stats``, ``/session``, ``/admin/*``)
  mounting the telemetry routes (``/metrics``, ``/healthz``,
  ``/events``) alongside;
- :mod:`.sessions` — stateful solve sessions (docs/sessions.md) on
  the port's ``DynamicMaxSumEngine``;
- :mod:`.router` — the fleet: :class:`FleetRouter` spawns N
  serve-worker processes and routes over them by structure affinity,
  admits remote members over ``POST /fleet/join`` and scales between
  ``min_replicas`` and ``max_replicas`` against an SLO;
  :class:`RouterFrontEnd` speaks the single service's wire protocol
  in front of them;
- :mod:`.speculate`, :mod:`.migration`, :mod:`.netfault`.

The exports are the reference's.  They are resolved on first use, so
``engine/batch.py`` can import :mod:`.binning` without loading the
service.

Entry points: ``python -m pydcop_tpu_torch serve`` (commands/serve.py)
and :func:`pydcop_tpu_torch.api.serve`.
"""

import importlib

_EXPORTS = {
    "AdmissionController": "admission",
    "AdmissionPolicy": "admission",
    "AdmissionRejected": "admission",
    "QueueFull": "admission",
    "FleetRouter": "router",
    "RouterFrontEnd": "router",
    "ServiceUnavailable": "admission",
    "RequestJournal": "journal",
    "SolveRequest": "service",
    "SolveService": "service",
    "SessionClosed": "sessions",
    "SessionLimit": "sessions",
    "SessionManager": "sessions",
    "SolveSession": "sessions",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
