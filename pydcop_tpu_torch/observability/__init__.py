"""Unified observability: tracing, metrics registry, engine telemetry.

Port of ``pydcop_tpu/observability``, with the reference's span names,
metric names, JSON keys and file formats, so one reader (Chrome
``trace_event`` JSON, JSONL snapshots, Prometheus text) serves both
packages:

- :mod:`.efficiency` — the solve-side efficiency tracker behind
  ``/profile`` and ``profile report``;
- :mod:`.trace` — process-wide :data:`~pydcop_tpu_torch.observability.
  trace.tracer` of timestamped, parent-correlated spans with Chrome
  ``trace_event`` and JSONL exporters, merge and diff;
- :mod:`.metrics` — :data:`~pydcop_tpu_torch.observability.metrics.
  registry` of counters/gauges/histograms with Prometheus text export
  and JSONL snapshots;
- :mod:`.engine_probe` — per-segment honest timings, cost and
  convergence for the segmented solve;
- :mod:`.profiler` — per-segment device cost attribution from
  ``torch.profiler`` (kernels, device time, peak memory);
- :mod:`.server` — live HTTP telemetry (``/metrics``, ``/healthz``,
  ``/events``, ``/profile``) for scraping a running solve;
- :mod:`.flight` — the always-on flight recorder: a bounded ring of
  trace events that dumps postmortem bundles on anomaly triggers
  (``PYDCOP_FLIGHT_RECORDER=0`` opts out);
- the instrumentation in the engine, compile and resilience modules
  (each guarded on one flag check, no cost when off).

:class:`ObservabilitySession` is the run-scoped front door used by
``api.solve``: it enables the tracer/registry/profiler for one solve,
optionally serves live telemetry while it runs, and exports trace +
Prometheus files on the way out.
"""

from typing import Optional

from pydcop_tpu_torch.observability.efficiency import (  # noqa: F401
    EfficiencyTracker,
    get_tracker,
)
from pydcop_tpu_torch.observability.metrics import (  # noqa: F401
    MetricsRegistry,
    get_registry,
    registry,
)
from pydcop_tpu_torch.observability.profiler import (  # noqa: F401
    DeviceCostProfiler,
    get_profiler,
    profiler,
)
from pydcop_tpu_torch.observability.trace import (  # noqa: F401
    Tracer,
    get_tracer,
    tracer,
)
from pydcop_tpu_torch.observability import flight as _flight
from pydcop_tpu_torch.observability.flight import (  # noqa: F401
    FlightRecorder,
    get_flight,
)

# The flight recorder is ALWAYS ON by default (PYDCOP_FLIGHT_RECORDER
# =0 opts out): the black box only helps if it was recording before
# the anomaly.  Ring-only until a trigger fires — nothing is written
# to disk on the happy path.
_flight.install()


class ObservabilitySession:
    """Enable tracing/metrics for one solve; export on finish.

    ``trace_path`` + ``trace_format`` ('chrome'|'jsonl') control the
    trace export; ``metrics_path`` activates the registry's optional
    instrumentation — and the device cost profiler, unless
    ``PYDCOP_XLA_PROFILE=0`` vetoes it — and, on finish, writes a
    Prometheus text dump next to the JSONL snapshots
    (``<metrics_path>.prom``).  ``serve_port`` (0 = OS-assigned, see
    :attr:`server`) additionally serves ``/metrics`` + ``/healthz`` +
    ``/events`` over HTTP for the duration of the session, so a long
    run is scrapeable WHILE it runs (observability/server.py).
    """

    def __init__(self, trace_path: Optional[str] = None,
                 trace_format: str = "chrome",
                 metrics_path: Optional[str] = None,
                 serve_port: Optional[int] = None):
        if trace_format not in ("chrome", "jsonl"):
            raise ValueError(
                f"trace_format must be 'chrome' or 'jsonl', got "
                f"{trace_format!r}"
            )
        self.trace_path = trace_path
        self.trace_format = trace_format
        self.metrics_path = metrics_path
        self.serve_port = serve_port
        self.server = None
        self._was_active = registry.active
        self._was_profiling = profiler.enabled

    def start(self) -> "ObservabilitySession":
        # Bind the server FIRST: it is the only step that can fail
        # (port in use), and failing after enabling would leak
        # tracer/registry/profiler enabled process-wide with no
        # finish() ever running (the caller never got a session).
        if self.serve_port is not None:
            import sys

            from pydcop_tpu_torch.observability.server import TelemetryServer

            self.server = TelemetryServer(port=self.serve_port).start()
            # The OS picks the port when serve_port=0: announce it, or
            # nothing can scrape the run it was requested for.
            print(
                "telemetry: serving /metrics /healthz /events on "
                f"{self.server.url}", file=sys.stderr,
            )
        if self.trace_path:
            tracer.enable()
        if self.metrics_path or self.serve_port is not None:
            registry.active = True
            profiler.enabled = True
        return self

    def finish(self):
        if self.server is not None:
            self.server.stop()
            self.server = None
        if self.trace_path:
            tracer.disable()
            tracer.export(self.trace_path, self.trace_format)
        if self.metrics_path or self.serve_port is not None:
            registry.active = self._was_active
            profiler.enabled = self._was_profiling
        if self.metrics_path:
            with open(f"{self.metrics_path}.prom", "w",
                      encoding="utf-8") as f:
                f.write(registry.to_prometheus())

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.finish()
        return False
