"""Metrics registry: counters / gauges / histograms with Prometheus
text-format export and periodic JSONL snapshots.

A copy of ``pydcop_tpu/observability/metrics.py`` (pure Python): the
same metric names, Prometheus text and JSONL snapshot format.

One process-wide :data:`registry` serves every instrumented site
(transport counters, queue depth, breaker trips, engine cycle/cost
progress).  Counters are monotone by construction (negative increments
raise), which is what makes the exported cycle counter trustworthy.

Cost discipline: always-on sites (the agent/messaging totals that feed
``Agent.metrics()``) use :class:`BoundMetric` handles — the label key
is computed once at bind time, so a hot-path increment is one dict
update under the metric's lock, the same order of cost as the ad-hoc
dicts it replaces.  Optional detail (per-message-type counters, queue
depth) guards on ``registry.active``, set by ``api.solve`` only when
the caller asked for metrics.

Prometheus output follows the text exposition format (``# HELP`` /
``# TYPE`` preamble per metric, ``name{label="value"} v`` samples,
histograms as cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``)
so a scrape endpoint or pushgateway relay needs no translation.
"""

import json
import math
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    for name in labels:
        if not _LABEL_RE.match(name):
            raise ValueError(f"invalid label name {name!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    # HELP lines terminate at the newline: per the exposition format
    # only backslash and newline are escaped here (quotes stay raw).
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _format_sample(name: str, key: LabelKey, value: float) -> str:
    if key:
        labels = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
        return f"{name}{{{labels}}} {_format_value(value)}"
    return f"{name} {_format_value(value)}"


def _format_value(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _exemplar_suffix(sample: str, cell: Optional[Tuple]) -> str:
    """Append an OpenMetrics exemplar (``# {trace_id="..."} v ts``)
    to a bucket sample line; plain Prometheus parsers that stop at
    the value are unaffected, OpenMetrics-aware ones pick up the
    trace link."""
    if cell is None:
        return sample
    trace_id, value, unix = cell
    return (f'{sample} # {{trace_id="{_escape(trace_id)}"}} '
            f"{_format_value(value)} {unix:.3f}")


class BoundMetric:
    """A metric handle with its label key pre-computed — the hot-path
    form of ``metric.inc(..., **labels)``."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "Metric", key: LabelKey):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0):
        self._metric._update_key(self._key, amount)

    def set(self, value: float):
        self._metric._set_key(self._key, value)

    def value(self) -> float:
        return self._metric._value_key(self._key)


class Metric:
    """Base: a named family of samples keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str = ""):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._values: Dict[LabelKey, float] = {}

    def bind(self, **labels) -> BoundMetric:
        return BoundMetric(self, _label_key(labels))

    def value(self, **labels) -> float:
        return self._value_key(_label_key(labels))

    def _value_key(self, key: LabelKey) -> float:
        with self._lock:
            return self._values.get(key, 0.0)

    def _update_key(self, key: LabelKey, amount: float):
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def _set_key(self, key: LabelKey, value: float):
        with self._lock:
            self._values[key] = value

    def samples(self) -> List[Tuple[LabelKey, float]]:
        with self._lock:
            return sorted(self._values.items())

    def _family_name(self, openmetrics: bool) -> str:
        """The HELP/TYPE family name.  OpenMetrics reserves ``_total``
        as a counter SAMPLE suffix and forbids it in the family name
        (family ``x`` exposes sample ``x_total``); the classic text
        format keeps the full name in both places."""
        if (openmetrics and self.kind == "counter"
                and self.name.endswith("_total")):
            return self.name[:-len("_total")]
        return self.name

    def to_prometheus(self, openmetrics: bool = False) -> List[str]:
        family = self._family_name(openmetrics)
        lines = [f"# HELP {family} {_escape_help(self.help)}",
                 f"# TYPE {family} {self.kind}"]
        lines.extend(
            _format_sample(self.name, key, value)
            for key, value in self.samples()
        )
        return lines

    def snapshot(self) -> List[Dict[str, Any]]:
        return [
            {"labels": dict(key), "value": value}
            for key, value in self.samples()
        ]


class Counter(Metric):
    """Monotone counter: increments only."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        self._update_key(_label_key(labels), amount)

    def _update_key(self, key: LabelKey, amount: float):
        if amount < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc {amount})"
            )
        Metric._update_key(self, key, amount)

    def _set_key(self, key: LabelKey, value: float):
        raise ValueError(f"counter {self.name} cannot be set, only inc'd")


class Gauge(Metric):
    """Point-in-time value: set / inc / dec."""

    kind = "gauge"

    def set(self, value: float, **labels):
        self._set_key(_label_key(labels), value)

    def inc(self, amount: float = 1.0, **labels):
        self._update_key(_label_key(labels), amount)

    def dec(self, amount: float = 1.0, **labels):
        self._update_key(_label_key(labels), -amount)


class Histogram(Metric):
    """Cumulative-bucket histogram (Prometheus semantics).

    **Latency exemplars**: ``observe(value, exemplar=trace_id)``
    remembers the last (trace_id, value, unix time) observed per
    NATIVE bucket — the bucket the value lands in, not every
    cumulative bucket above it — so a p99 spike in the exposition is
    one hop from a concrete request trace (``pydcop trace query
    --request <trace_id>``).  Exposed in the text exposition with the
    OpenMetrics exemplar syntax (``... # {trace_id="..."} v ts``), in
    :meth:`snapshot` (the ``/stats`` and JSONL form), and resolvable
    by quantile via :meth:`quantile_exemplar`.
    """

    kind = "histogram"

    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                       10.0, 60.0)

    def __init__(self, name: str, help_text: str = "",
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help_text)
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        # key -> [per-bucket counts..., +Inf count, sum]
        self._hist: Dict[LabelKey, List[float]] = {}
        # key -> [(trace_id, value, unix) or None] per native bucket
        # (len(buckets) + 1: the last slot is the +Inf bucket).
        self._exemplars: Dict[LabelKey, List[Optional[Tuple]]] = {}

    def _native_bucket(self, value: float) -> int:
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                return i
        return len(self.buckets)

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels):
        key = _label_key(labels)
        with self._lock:
            entry = self._hist.get(key)
            if entry is None:
                entry = [0.0] * (len(self.buckets) + 2)
                self._hist[key] = entry
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    entry[i] += 1
            entry[-2] += 1        # +Inf / total count
            entry[-1] += value    # sum
            if exemplar is not None:
                cells = self._exemplars.get(key)
                if cells is None:
                    cells = [None] * (len(self.buckets) + 1)
                    self._exemplars[key] = cells
                cells[self._native_bucket(value)] = (
                    str(exemplar), float(value), time.time())

    def count(self, **labels) -> float:
        with self._lock:
            entry = self._hist.get(_label_key(labels))
            return entry[-2] if entry else 0.0

    def sum(self, **labels) -> float:
        with self._lock:
            entry = self._hist.get(_label_key(labels))
            return entry[-1] if entry else 0.0

    def to_prometheus(self, openmetrics: bool = False) -> List[str]:
        """Text exposition.  Exemplar suffixes are OPENMETRICS-ONLY
        syntax: the classic Prometheus v0.0.4 text parser errors on
        the ``#`` after a sample value (failing the whole scrape), so
        they are appended only when the caller negotiated the
        OpenMetrics content type (``Accept:
        application/openmetrics-text`` on the /metrics endpoint)."""
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = sorted(self._hist.items())
            exemplars = ({k: list(v)
                          for k, v in self._exemplars.items()}
                         if openmetrics else {})
        for key, entry in items:
            cells = exemplars.get(key)
            for i, bound in enumerate(self.buckets):
                bkey = key + (("le", _format_value(bound)),)
                sample = _format_sample(
                    f"{self.name}_bucket", tuple(sorted(bkey)),
                    entry[i])
                lines.append(_exemplar_suffix(
                    sample, cells[i] if cells else None))
            inf_key = tuple(sorted(key + (("le", "+Inf"),)))
            lines.append(_exemplar_suffix(
                _format_sample(f"{self.name}_bucket", inf_key,
                               entry[-2]),
                cells[-1] if cells else None))
            lines.append(_format_sample(f"{self.name}_sum", key,
                                        entry[-1]))
            lines.append(_format_sample(f"{self.name}_count", key,
                                        entry[-2]))
        return lines

    def quantile_exemplar(self, q: float, **labels
                          ) -> Optional[Dict[str, Any]]:
        """The exemplar of the bucket holding the q-quantile
        observation (e.g. ``q=0.99`` → the p99 bucket), or the
        nearest lower bucket holding one — None when nothing with an
        exemplar was ever observed.  Returns ``{le, trace_id, value,
        unix}``."""
        key = _label_key(labels)
        with self._lock:
            entry = self._hist.get(key)
            cells = self._exemplars.get(key)
        if entry is None or cells is None or entry[-2] <= 0:
            return None
        rank = max(float(q), 0.0) * entry[-2]
        target = len(self.buckets)  # +Inf slot by default
        for i in range(len(self.buckets)):
            if entry[i] >= rank:
                target = i
                break
        les = ([_format_value(b) for b in self.buckets] + ["+Inf"])
        # Prefer the quantile's own bucket; a cumulative count can
        # cross the rank in a bucket whose native observations all
        # lacked exemplars, so fall back to the nearest LOWER bucket
        # that holds one (per the docstring contract — a p99 labeled
        # with a slower-than-p99 exemplar would overstate the tail),
        # and only then look above.
        order = (list(range(target, -1, -1))
                 + list(range(target + 1, len(cells))))
        for i in order:
            if cells[i] is not None:
                trace_id, value, unix = cells[i]
                return {"le": les[i], "trace_id": trace_id,
                        "value": value, "unix": unix}
        return None

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = sorted(self._hist.items())
            exemplars = {k: list(v)
                         for k, v in self._exemplars.items()}
        les = [_format_value(b) for b in self.buckets] + ["+Inf"]
        return [
            {
                "labels": dict(key),
                "count": entry[-2],
                "sum": entry[-1],
                "buckets": {
                    _format_value(b): entry[i]
                    for i, b in enumerate(self.buckets)
                },
                "exemplars": {
                    les[i]: {"trace_id": cell[0], "value": cell[1],
                             "unix": cell[2]}
                    for i, cell in enumerate(
                        exemplars.get(key) or [])
                    if cell is not None
                },
            }
            for key, entry in items
        ]


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors.

    ``active`` gates the *optional* high-cardinality instrumentation
    (per-message-type counters, queue-depth gauges); the always-on
    totals ignore it.  Creation is idempotent; re-registering a name
    as a different kind raises — two subsystems silently sharing a
    name would corrupt both series.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}
        self.active = False

    def _get_or_create(self, cls, name: str, help_text: str, **kwargs):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = cls(name, help_text, **kwargs)
                self._metrics[name] = metric
            elif not isinstance(metric, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{metric.kind}, not {cls.kind}"
                )
            return metric

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_create(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help_text)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Optional[Sequence[float]] = None
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help_text,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def value(self, name: str, **labels) -> float:
        metric = self.get(name)
        return metric.value(**labels) if metric is not None else 0.0

    def metrics(self) -> List[Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def to_prometheus(self, openmetrics: bool = False) -> str:
        """Text exposition; ``openmetrics=True`` switches to the
        OpenMetrics dialect (histogram exemplar suffixes + the
        mandatory ``# EOF`` terminator) — only for responses whose
        content type was negotiated as
        ``application/openmetrics-text``."""
        lines: List[str] = []
        for metric in self.metrics():
            lines.extend(metric.to_prometheus(openmetrics))
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n" if lines else ""

    def snapshot(self) -> Dict[str, Any]:
        return {
            metric.name: {
                "kind": metric.kind,
                "samples": metric.snapshot(),
            }
            for metric in self.metrics()
        }

    def write_snapshot(self, path: str, **extra):
        """Append one JSONL snapshot line: ``{"ts": ..., **extra,
        "metrics": {...}}``."""
        row = {"ts": time.time(), **extra, "metrics": self.snapshot()}
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(row, default=str) + "\n")

    def reset(self):
        """Drop every metric (tests); ``active`` is untouched."""
        with self._lock:
            self._metrics = {}


registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return registry


def merge_snapshots(snapshots: Dict[str, Dict[str, Any]],
                    label: str = "replica") -> Dict[str, Any]:
    """Merge per-process registry snapshots (``registry.snapshot()``
    shape, keyed by source name) into one snapshot whose every sample
    gains a ``label`` identifying where it came from — the
    ``GET /fleet/metrics`` aggregation.  Summation is deliberately
    NOT done here: keeping the per-source samples (distinguished by
    the label) preserves conservation checks — summing
    ``pydcop_requests_total`` across ``replica`` labels must
    reproduce the router's own admission ledger, which a pre-summed
    view could fake."""
    merged: Dict[str, Any] = {}
    for source in sorted(snapshots):
        snap = snapshots[source] or {}
        for name, family in snap.items():
            out = merged.setdefault(
                name, {"kind": family.get("kind", "untyped"),
                       "samples": []})
            for sample in family.get("samples", []):
                row = dict(sample)
                labels = dict(row.get("labels") or {})
                labels[label] = source
                row["labels"] = labels
                out["samples"].append(row)
    return merged


def render_snapshot_prometheus(merged: Dict[str, Any]) -> str:
    """Prometheus text exposition for a merged snapshot (the
    ``merge_snapshots`` shape).  Counter/gauge samples render
    directly; histogram snapshot rows expand back into
    ``_bucket``/``_sum``/``_count`` series.  HELP lines are omitted —
    help text does not survive the snapshot wire format."""
    lines: List[str] = []
    for name in sorted(merged):
        family = merged[name]
        lines.append(f"# TYPE {name} {family.get('kind', 'untyped')}")
        for sample in family.get("samples", []):
            labels = sample.get("labels") or {}
            base = tuple(sorted(
                (str(k), str(v)) for k, v in labels.items()))
            if "value" in sample:
                lines.append(_format_sample(name, base,
                                            sample["value"]))
                continue
            # Histogram snapshot row: buckets + the implicit +Inf.
            for le, count in sorted(
                    (sample.get("buckets") or {}).items()):
                bkey = tuple(sorted(base + (("le", str(le)),)))
                lines.append(_format_sample(f"{name}_bucket", bkey,
                                            count))
            inf_key = tuple(sorted(base + (("le", "+Inf"),)))
            lines.append(_format_sample(f"{name}_bucket", inf_key,
                                        sample.get("count", 0.0)))
            lines.append(_format_sample(f"{name}_sum", base,
                                        sample.get("sum", 0.0)))
            lines.append(_format_sample(f"{name}_count", base,
                                        sample.get("count", 0.0)))
    return "\n".join(lines) + "\n" if lines else ""


class CycleSnapshotter:
    """Progress recorder shared by both backends: maintains the
    monotone ``pydcop_cycles_total`` counter, the ``pydcop_cycle`` /
    ``pydcop_cost`` gauges, and (optionally) appends a JSONL snapshot
    each time the global cycle advances by ``every``.

    The device engine calls it once per K-cycle chunk (already paced,
    ``every=1``); the threaded orchestrator calls it on every
    cycle-change report and the cadence check here rate-limits the
    writes.  ``cost_fn`` is only invoked when a snapshot actually
    fires, so per-cycle reports never pay a cost evaluation.

    Fired snapshots are also pushed to listeners — per-instance ones
    (:meth:`add_listener`) and the class-wide set
    (:meth:`add_global_listener`), which is how the live telemetry
    endpoint's ``/events`` SSE stream observes whichever snapshotter
    the current run happens to drive without holding a reference to
    it.  Listener errors are swallowed: a slow or dead subscriber
    must never stall the solve.
    """

    # Class-wide listeners: every instance notifies these.
    _global_listeners: List = []
    _global_lock = threading.Lock()

    @classmethod
    def add_global_listener(cls, fn):
        with cls._global_lock:
            cls._global_listeners.append(fn)

    @classmethod
    def remove_global_listener(cls, fn):
        with cls._global_lock:
            if fn in cls._global_listeners:
                cls._global_listeners.remove(fn)

    @classmethod
    def publish(cls, event: Dict[str, Any]):
        """Push one event to every class-wide listener — the shared
        fan-out behind the SSE ``/events`` stream.  Producers other
        than the cycle snapshotters (the serve plane's
        request-lifecycle events) publish here; listener errors are
        swallowed like everywhere else (a dead subscriber must never
        stall the producer)."""
        with cls._global_lock:
            listeners = list(cls._global_listeners)
        for fn in listeners:
            try:
                fn(event)
            except Exception:  # noqa: BLE001 — never stall producers
                pass

    def __init__(self, path: Optional[str] = None, every: int = 1,
                 reg: Optional[MetricsRegistry] = None,
                 cost_fn=None):
        self.path = path
        self.every = max(int(every), 1)
        self.registry = reg if reg is not None else registry
        self.cost_fn = cost_fn
        self._last: Optional[int] = None
        self._lock = threading.Lock()
        self._cycles = self.registry.counter(
            "pydcop_cycles_total",
            "Global solver cycles completed (monotone)")
        self._cycle_g = self.registry.gauge(
            "pydcop_cycle", "Current global solver cycle")
        self._cost_g = self.registry.gauge(
            "pydcop_cost", "Cost of the current best-known assignment")
        self.points: List[Tuple[int, Optional[float]]] = []
        self._listeners: List = []

    def add_listener(self, fn):
        self._listeners.append(fn)

    def __call__(self, cycle: int, cost: Optional[float] = None,
                 **extra):
        """Record one progress point.  ``extra`` (non-None values
        only) rides into the snapshot event — the engine probe adds
        its convergence-health signals (``residual``, ``flip_rate``)
        here so the SSE stream carries them per chunk."""
        cycle = int(cycle)
        with self._lock:
            last = self._last
            if last is not None and cycle - last < self.every:
                return
            delta = cycle - (last or 0)
            if delta <= 0:
                return
            self._last = cycle
        if cost is None and self.cost_fn is not None:
            try:
                cost = self.cost_fn()
            except Exception:
                cost = None
        self._cycles.inc(delta)
        self._cycle_g.set(cycle)
        if cost is not None:
            cost = float(cost)
            self._cost_g.set(cost)
        self.points.append((cycle, cost))
        if self.path:
            self.registry.write_snapshot(self.path, cycle=cycle,
                                         cost=cost)
        event = {"ts": time.time(), "cycle": cycle, "cost": cost}
        for k, v in extra.items():
            if v is not None:
                event[k] = v
        with self._global_lock:
            listeners = self._listeners + self._global_listeners
        for fn in listeners:
            try:
                fn(event)
            except Exception:  # noqa: BLE001 — never stall the solve
                pass
